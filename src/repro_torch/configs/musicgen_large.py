"""musicgen-large, a decoder over EnCodec tokens, backbone only
(``repro/configs/musicgen_large.py``; arXiv:2306.05284): 48 layers,
d_model 2048, 32 heads (kv 32), d_ff 8192, vocab 2048, learned positions,
LayerNorm, GELU.  The EnCodec frontend is a stub: batches carry
precomputed frame embeddings (B, S, d_model)."""
from repro_torch.configs.base import ArchSpec, ModelConfig

MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_frames",
    pos_emb="learned",
    norm="layernorm",
    mlp="gelu",
    max_seq_len=32768,
)

SPEC = ArchSpec(model=MUSICGEN_LARGE, source="arXiv:2306.05284",
               notes=("audio backbone; frontend stubbed (precomputed frame embeddings); "
           "long_500k skipped: full attention"))
