"""Dense decoder-only LM: training loss, prefill and cached decode
(``repro/models/transformer.py:26-213``).

GPT-2 style when the config says so: learned positions, LayerNorm, GELU
MLPs, tied embeddings, vocab padded to a multiple of 128.  A Python loop
over the per-layer parameter list replaces ``lax.scan``.  The model runs in
the dtype of the parameters it is given (the trainer and the engine run
fp32).  ``remat="full"`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on the
scan body); ``"none"`` keeps every activation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamDef, advance_pos, apply_norm,
                                       cross_entropy_loss, mlp_apply, mlp_def,
                                       norm_def, round_up)

REMATS = ("none", "full")


def dense_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter tree; ``layers`` is a list of ``n_layers`` per-layer dicts
    (the reference stacks them along a leading axis)."""
    d = cfg.d_model
    pv = round_up(cfg.vocab_size, 128)
    layer = {"ln1": norm_def(d, cfg.norm), "attn": attn_mod.attention_def(cfg),
             "ln2": norm_def(d, cfg.norm), "mlp": mlp_def(d, cfg.d_ff, cfg.mlp)}
    defs: Dict[str, Any] = {
        "embed": ParamDef((pv, d), "embed", 0.02),
        "layers": [layer] * cfg.n_layers,
        "final_norm": norm_def(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, pv), "normal", 1.0 / math.sqrt(d))
    if cfg.pos_emb == "learned":
        defs["pos_embed"] = ParamDef((cfg.max_seq_len, d), "embed", 0.02)
    return defs


def embed_inputs(params, tokens: torch.Tensor, cfg: ModelConfig,
                 start_pos: torch.Tensor) -> torch.Tensor:
    """Token (+ learned position) embedding of tokens (B, S).

    ``start_pos`` is a 0-dim tensor (positions (S,)) or a (B,) vector
    (positions (B, S)).  Position indices clamp at the table's end: only a
    slot saturated at a capacity equal to ``max_seq_len`` reaches it, and
    its output is never surfaced (the reference's gather fills there).
    """
    x = params["embed"][tokens]
    if cfg.pos_emb == "learned":
        offs = torch.arange(tokens.shape[1], device=tokens.device)
        positions = (start_pos[:, None] + offs if start_pos.dim()
                     else start_pos + offs)
        table = params["pos_embed"]
        x = x + table[positions.clamp_max(table.shape[0] - 1)]
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def _block(lp, x: torch.Tensor, cfg: ModelConfig,
           block_kv: int) -> torch.Tensor:
    """One pre-norm block, the training forward (``transformer.py:72-83``)."""
    h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    a, _ = attn_mod.full_attention(lp["attn"], h, cfg, block_kv=block_kv)
    x = x + a
    h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.mlp)


@dataclass
class DenseLM:
    cfg: ModelConfig
    block_kv: int = 512
    remat: str = "full"

    def __post_init__(self):
        if self.remat == "dots":
            raise NotImplementedError('remat="dots" is not ported yet')
        if self.remat not in REMATS:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token loss over tokens (B, S) against labels (B, S)
        (``transformer.py:104-120``) -> (loss, {"loss", "tokens"})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_inputs(params, tokens, cfg,
                         torch.zeros((), dtype=torch.int64,
                                     device=tokens.device))
        for lp in params["layers"]:
            if self.remat == "full":
                x = torch.utils.checkpoint.checkpoint(
                    _block, lp, x, cfg, self.block_kv, use_reentrant=False)
            else:
                x = _block(lp, x, cfg, self.block_kv)
        logits = _logits(params, x, cfg)
        loss, denom = cross_entropy_loss(logits, batch["labels"],
                                         batch.get("loss_mask"),
                                         cfg.vocab_size)
        return loss, {"loss": loss, "tokens": denom}

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Full forward over tokens (B, S) -> (last-position logits (B, V),
        cache {"k", "v": (L, B, cache_len, KV, D), "pos": 0-dim S})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        x = embed_inputs(params, tokens, cfg,
                         torch.zeros((), dtype=torch.int64,
                                     device=tokens.device))
        shape, dtype = self.cache_shapes(b, cache_len)["k"], x.dtype
        ks = torch.zeros(shape, dtype=dtype, device=x.device)
        vs = torch.zeros(shape, dtype=dtype, device=x.device)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
            a, (k, v) = attn_mod.full_attention(lp["attn"], h, cfg,
                                                block_kv=self.block_kv)
            ks[i, :, :s] = k
            vs[i, :, :s] = v
            x = x + a
            h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.mlp)
        logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
        pos = torch.tensor(s, dtype=torch.int64, device=x.device)
        return logits, {"k": ks, "v": vs, "pos": pos}

    @torch.no_grad()
    def decode(self, params, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Decode tokens (B, s_q) against the cache -> (logits (B, V) at the
        first new position, as the reference's ``[:, 0]``; new cache).

        The k/v leaves are written in place and returned as the same
        tensors.  A slot cache also carries ``active`` (per-slot
        occupancy): inactive slots freeze ``pos`` and keep their rows.
        """
        cfg = self.cfg
        pos = cache["pos"]
        active = cache.get("active")
        x = embed_inputs(params, tokens, cfg, pos)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
            a, _, _ = attn_mod.decode_attention(
                lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos,
                active=active)
            x = x + a
            h = apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.mlp)
        logits = _logits(params, x[:, :1, :], cfg)[:, 0]
        new_pos = advance_pos(pos, tokens.shape[1], active,
                              limit=cache["k"].shape[2] if pos.dim() else None)
        out = {"k": cache["k"], "v": cache["v"], "pos": new_pos}
        if active is not None:
            out["active"] = active
        return logits, out

    def cache_shapes(self, batch_size: int, seq_len: int) -> Dict[str, tuple]:
        cfg = self.cfg
        kv = (cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        return {"k": kv, "v": kv, "pos": ()}

    def cache_axes(self) -> Dict[str, tuple]:
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv, "pos": ()}
