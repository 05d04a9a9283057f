"""PyTorch/CUDA port of the SLW system, beside the JAX package ``repro``.

It imports ``torch`` and numpy, never ``jax`` and never ``repro``.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
