"""The benchmark of ``repro_torch``, the PyTorch/CUDA port (see README.md)."""
