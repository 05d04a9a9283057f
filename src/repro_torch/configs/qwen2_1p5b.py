"""qwen2-1.5b, dense GQA with QKV bias (``repro/configs/qwen2_1p5b.py``;
arXiv:2407.10671): 28 layers, d_model 1536, 12 heads of 128 (kv 2), d_ff
8960, vocab 151936, tied embeddings; flash attention and the decode
kernel."""
from repro_torch.configs.base import ArchSpec, ModelConfig

QWEN2_1P5B = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    attn_backend="flash",
    decode_backend="kernel",
)

SPEC = ArchSpec(model=QWEN2_1P5B, source="arXiv:2407.10671",
               notes="long_500k skipped: pure full attention (quadratic)")
