"""rwkv6-7b (Finch), attention-free with data-dependent decay
(``repro/configs/rwkv6_7b.py``; arXiv:2404.05892): 32 layers, d_model
4096, 64 heads of 64, d_ff 14336, vocab 65536."""
from repro_torch.configs.base import ArchSpec, ModelConfig

RWKV6_7B = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    rwkv_backend="kernel",
)

SPEC = ArchSpec(model=RWKV6_7B, source="arXiv:2404.05892",
               notes=("attention-free: decode state is O(1) per layer; long_500k runs "
           "(the 500K 'cache' is a constant-size WKV state + token-shift buffers)"))
