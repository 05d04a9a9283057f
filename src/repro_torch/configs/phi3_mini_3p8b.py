"""phi3-mini-3.8b, dense with RoPE, SwiGLU and GQA
(``repro/configs/phi3_mini_3p8b.py``; arXiv:2404.14219): 32 layers,
d_model 3072, 32 heads of 96 (kv 32), d_ff 8192, vocab 32064.  Blockwise
attention and the plain decode, as the reference's preset."""
from repro_torch.configs.base import ArchSpec, ModelConfig

PHI3_MINI_3P8B = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
)

SPEC = ArchSpec(model=PHI3_MINI_3P8B, source="arXiv:2404.14219 (unverified tier)",
               notes="long_500k skipped: pure full attention (quadratic)")
