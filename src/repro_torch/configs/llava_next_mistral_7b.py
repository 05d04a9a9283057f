"""llava-next-mistral-7b, a mistral-7b backbone under an anyres patch
prefix (``repro/configs/llava_next_mistral_7b.py``;
hf:llava-hf/llava-v1.6-mistral-7b-hf): 32 layers, d_model 4096, 32 heads
of 128 (kv 8), d_ff 14336, vocab 32000.  The vision tower is a stub:
batches carry precomputed patch embeddings (B, 576, d_model), prepended to
the text embeddings; SLW warms up only the text."""
from repro_torch.configs.base import ArchSpec, ModelConfig

LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision_patches",
    prefix_tokens=576,  # one 24 x 24 anyres base tile
)

SPEC = ArchSpec(model=LLAVA_NEXT_MISTRAL_7B, source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified tier)",
               notes=("vision frontend stubbed (precomputed patch embeddings); "
           "long_500k skipped: full attention"))
