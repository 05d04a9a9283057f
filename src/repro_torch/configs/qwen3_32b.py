"""qwen3-32b, dense GQA with qk-norm (``repro/configs/qwen3_32b.py``;
hf:Qwen/Qwen3 family): 64 layers, d_model 5120, 64 heads of 80 (kv 8),
d_ff 25600, vocab 151936; flash attention and the decode kernel, both at
head dim 80."""
from repro_torch.configs.base import ArchSpec, ModelConfig

QWEN3_32B = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    attn_backend="flash",
    decode_backend="kernel",
)

SPEC = ArchSpec(model=QWEN3_32B, source="hf:Qwen/Qwen3 family",
               notes="largest dense cell; long_500k skipped: pure full attention")
