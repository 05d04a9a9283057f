"""The paper's own models (``repro/configs/gpt2.py:9-34``): GPT-2 117M and
the GPT-3 125M replica, with learned positions, LayerNorm, tanh-GELU MLPs
and tied embeddings."""
from repro_torch.configs.base import ModelConfig

GPT2_117M = ModelConfig(
    name="gpt2-117m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50257,
    pos_emb="learned",
    norm="layernorm",
    mlp="gelu",
    tie_embeddings=True,
    max_seq_len=2048,
    attn_backend="flash",
    decode_backend="kernel",
)

GPT3_125M = GPT2_117M.replace(name="gpt3-125m", max_seq_len=2048)
