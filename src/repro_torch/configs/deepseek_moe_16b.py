"""deepseek-moe-16b, fine-grained MoE (``repro/configs/deepseek_moe_16b.py``;
arXiv:2401.06066): 28 layers, d_model 2048, 16 heads of 128 (kv 16), 2
shared + 64 routed experts of d_ff 1408, top-6, vocab 102400."""
from repro_torch.configs.base import ArchSpec, ModelConfig

DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
)

SPEC = ArchSpec(model=DEEPSEEK_MOE_16B, source="arXiv:2401.06066",
               notes="EP: experts sharded over the model axis; long_500k skipped: full attention")
