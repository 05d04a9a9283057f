"""moonshot-v1-16b-a3b (Moonlight), fine-grained MoE
(``repro/configs/moonshot_v1_16b_a3b.py``; hf:moonshotai/Moonlight-16B-A3B):
48 layers, d_model 2048, 16 heads (kv 16), 2 shared + 64 routed experts of
d_ff 1408, top-6, vocab 163840."""
from repro_torch.configs.base import ArchSpec, ModelConfig

MOONSHOT_V1_16B_A3B = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
)

SPEC = ArchSpec(model=MOONSHOT_V1_16B_A3B, source="hf:moonshotai/Moonlight-16B-A3B",
               notes="EP: experts sharded over the model axis; long_500k skipped: full attention")
