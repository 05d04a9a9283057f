"""The paper's own models (``repro/configs/gpt2.py:9-36``): GPT-2 117M and
1.5B and the GPT-3 125M replica, with learned positions, LayerNorm,
tanh-GELU MLPs and tied embeddings."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ShapeConfig

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

# ``gpt2.py:31-34``: 48 layers, d 1600, 25 heads of 64
GPT2_1P5B = GPT2_117M.replace(
    name="gpt2-1.5b", n_layers=48, d_model=1600, n_heads=25, n_kv_heads=25,
    d_ff=6400, head_dim=64,
)

GPT3_125M = GPT2_117M.replace(name="gpt3-125m", max_seq_len=2048)

# the paper's training shapes (``gpt2.py:39-50``): seqlen 1K for GPT-2,
# 2K for the GPT-3-style runs
PAPER_SHAPES = (
    ShapeConfig("train_1k_b512", "train", 1024, 512),
    ShapeConfig("train_1k_b4k", "train", 1024, 4096),
    ShapeConfig("train_2k_b512", "train", 2048, 512),
)

SPEC_GPT2_117M = ArchSpec(model=GPT2_117M, shapes=PAPER_SHAPES,
                          source="paper §3 (Radford et al. 2019)")
# ``gpt2.py:47-48``
SPEC_GPT2_1P5B = ArchSpec(model=GPT2_1P5B, shapes=PAPER_SHAPES,
                          source="paper §3 (Radford et al. 2019)")
SPEC_GPT3_125M = ArchSpec(model=GPT3_125M, shapes=PAPER_SHAPES,
                          source="paper §5.2 (Brown et al. 2020)")
