"""smollm-360m, a small llama-architecture dense model
(``repro/configs/smollm_360m.py``; hf:HuggingFaceTB/SmolLM-360M): 32
layers, d_model 960, 15 heads of 64 (kv 5), d_ff 2560, vocab 49152, tied
embeddings; flash attention and the decode kernel."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SMOLLM_360M = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
    attn_backend="flash",
    decode_backend="kernel",
)

SPEC = ArchSpec(model=SMOLLM_360M, source="hf:HuggingFaceTB/SmolLM-360M",
               notes="long_500k skipped: pure full attention (quadratic)")
