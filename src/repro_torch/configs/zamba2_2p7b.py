"""zamba2-2.7b, a hybrid of a Mamba-2 backbone and one shared attention +
MLP block (``repro/configs/zamba2_2p7b.py``; arXiv:2411.15242): 54 Mamba-2
layers, d_model 2560, SSD state 64, heads of 64; the shared block (32
heads of 80, d_ff 10240) after every 6 layers, 9 applications, each with
its own KV cache; vocab 32000."""
from repro_torch.configs.base import ArchSpec, ModelConfig

ZAMBA2_2P7B = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    ssm_backend="kernel",
    decode_backend="kernel",
)

SPEC = ArchSpec(model=ZAMBA2_2P7B, source="arXiv:2411.15242 (hf-verified)",
               notes=("hybrid: long_500k runs (sub-quadratic backbone; shared-attn KV caches "
           "are sequence-sharded over the data axis)"))
