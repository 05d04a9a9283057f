"""Zamba-2: a Mamba-2 backbone and one *shared* attention + MLP block
(``repro/models/zamba2.py``).

The shared block, one set of weights, is applied after every
``attn_every`` Mamba-2 layers, each application with its own KV cache; its
gradient is the sum over the applications.  The reference's two-level
``lax.scan`` (groups, then the group's layers) is a Python loop over the
per-layer parameter list.  As ``DenseLM``, the model runs in the dtype of
the parameters it is given; ``remat="full"`` recomputes each Mamba-2 block
and each shared-block application in the backward.

The decode cache is a flat dict of axis-tagged leaves, the reference's
nested ``{"mamba": {...}}`` tree flattened: ``ssm_state``, ``conv_x``,
``conv_b``, ``conv_c`` with a leading "layers" axis, ``attn_k`` and
``attn_v`` with a leading "groups" axis, and ``pos``.  Decode updates the
SSM and conv state of every slot, as the reference does; ``active``
freezes ``pos`` and the KV writes of free slots.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2
from repro_torch.models.layers import (ParamDef, advance_pos, apply_norm,
                                       cache_dtypes, cross_entropy_loss,
                                       mlp_apply, mlp_def, norm_def, round_up)
from repro_torch.models.transformer import REMATS, _logits, embed_inputs

MAMBA_LEAVES = ("ssm_state", "conv_x", "conv_b", "conv_c")


def zamba2_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter tree (``zamba2.py:30-46``); ``mamba_layers`` is a list of
    ``n_layers`` per-layer dicts (the reference stacks them)."""
    if cfg.attn_every < 1 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_every {cfg.attn_every}")
    d = cfg.d_model
    pv = round_up(cfg.vocab_size, 128)
    return {
        "embed": ParamDef((pv, d), "embed", 0.02),
        "mamba_layers": [mamba2.mamba2_def(cfg)] * cfg.n_layers,
        "shared": {"ln1": norm_def(d, cfg.norm),
                   "attn": attn_mod.attention_def(cfg),
                   "ln2": norm_def(d, cfg.norm),
                   "mlp": mlp_def(d, cfg.d_ff, cfg.mlp)},
        "final_norm": norm_def(d, cfg.norm),
        "lm_head": ParamDef((d, pv), "normal", 1.0 / math.sqrt(d)),
    }


def _shared_block(shared, x: torch.Tensor, cfg: ModelConfig, block_kv: int
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One application of the shared block (``zamba2.py:56-63``) -> (x,
    (k, v))."""
    h = apply_norm(shared["ln1"], x, cfg.norm, cfg.norm_eps)
    a, kv = attn_mod.full_attention(shared["attn"], h, cfg, block_kv=block_kv)
    x = x + a
    h = apply_norm(shared["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(shared["mlp"], h, cfg.mlp), kv


@dataclass
class Zamba2LM:
    """``zamba2.py:66-237``."""

    cfg: ModelConfig
    remat: str = "full"
    block_kv: int = 512

    def __post_init__(self):
        if self.remat == "dots":
            raise NotImplementedError('remat="dots" is not ported yet')
        if self.remat not in REMATS:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers // self.cfg.attn_every

    def _embed(self, params, tokens: torch.Tensor,
               pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pos is None:
            pos = torch.zeros((), dtype=torch.int64, device=tokens.device)
        return embed_inputs(params, tokens, self.cfg, pos)

    def _run(self, fn, *args):
        if self.remat == "full":
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    # -- training ------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token loss over tokens (B, S) against labels (B, S)
        (``zamba2.py:80-105``) -> (loss, {"loss", "tokens"})."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        for i, lp in enumerate(params["mamba_layers"]):
            x = self._run(mamba2.mamba2_block, lp, x, cfg)
            if (i + 1) % cfg.attn_every == 0:
                x, _ = self._run(_shared_block, params["shared"], x, cfg,
                                 self.block_kv)
        loss, denom = cross_entropy_loss(_logits(params, x, cfg),
                                         batch["labels"],
                                         batch.get("loss_mask"),
                                         cfg.vocab_size)
        return loss, {"loss": loss, "tokens": denom}

    # -- serving ---------------------------------------------------------------
    def cache_shapes(self, batch_size: int, seq_len: int
                     ) -> Dict[str, Tuple[tuple, str]]:
        """(shape, kind) per cache leaf; kind "float" is the model's
        dtype."""
        cfg = self.cfg
        kv = ((self.n_groups, batch_size, seq_len, cfg.n_kv_heads,
               cfg.resolved_head_dim), "float")
        return {**mamba2.mamba2_cache_shapes(cfg, cfg.n_layers, batch_size),
                "attn_k": kv, "attn_v": kv, "pos": ((), "int")}

    def cache_axes(self) -> Dict[str, tuple]:
        kv = ("groups", "batch", "seq", "kv_heads", "head_dim")
        return {**mamba2.mamba2_cache_axes(), "attn_k": kv, "attn_v": kv,
                "pos": ()}

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Full forward over tokens (B, S) -> (last-position logits (B, V),
        cache: the Mamba-2 leaves per layer, ``attn_k``/``attn_v`` (G, B,
        cache_len, KV, D) per application, ``pos`` 0-dim S)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        kinds = cache_dtypes(x.dtype)
        cache = {name: torch.zeros(shape, dtype=kinds[kind], device=x.device)
                 for name, (shape, kind) in
                 self.cache_shapes(b, cache_len or s).items()
                 if name != "pos"}
        for i, lp in enumerate(params["mamba_layers"]):
            x, layer = mamba2.mamba2_block(lp, x, cfg, with_cache=True)
            for name in MAMBA_LEAVES:
                cache[name][i] = layer[name]
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x, (k, v) = _shared_block(params["shared"], x, cfg,
                                          self.block_kv)
                cache["attn_k"][g, :, :s] = k
                cache["attn_v"][g, :, :s] = v
        logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
        cache["pos"] = torch.tensor(s, dtype=torch.int64, device=x.device)
        return logits, cache

    @torch.no_grad()
    def decode(self, params, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Decode tokens (B, 1) -> (logits (B, V), new cache).

        Every leaf is written in place and returned as the same tensor.
        As in the reference (``zamba2.py:184-237``) the Mamba-2 state of
        every slot advances; where ``active`` is False ``pos`` is frozen and
        the KV write dropped.  ``active`` and ``page_table`` (the KV leaves
        are then page pools, see serve/paging.py) pass through unchanged.
        """
        cfg = self.cfg
        pos = cache["pos"]
        active = cache.get("active")
        page_table = cache.get("page_table")
        write = (attn_mod.paged_write_rows(page_table, pos, active,
                                           cache["attn_k"].shape[2])
                 if page_table is not None else None)
        shared = params["shared"]
        x = self._embed(params, tokens, pos)
        for i, lp in enumerate(params["mamba_layers"]):
            x, layer = mamba2.mamba2_decode_block(
                lp, x, {name: cache[name][i] for name in MAMBA_LEAVES}, cfg)
            for name in MAMBA_LEAVES:
                cache[name][i] = layer[name]
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                h = apply_norm(shared["ln1"], x, cfg.norm, cfg.norm_eps)
                a, _, _ = attn_mod.decode_attention(
                    shared["attn"], h, cfg, cache["attn_k"][g],
                    cache["attn_v"][g], pos, active=active,
                    page_table=page_table, paged_write=write)
                x = x + a
                h = apply_norm(shared["ln2"], x, cfg.norm, cfg.norm_eps)
                x = x + mlp_apply(shared["mlp"], h, cfg.mlp)
        logits = _logits(params, x, cfg)[:, 0]
        if page_table is not None:
            cap = page_table.shape[1] * cache["attn_k"].shape[2]
        else:
            cap = cache["attn_k"].shape[2]
        out = dict(cache)
        out["pos"] = advance_pos(pos, tokens.shape[1], active,
                                 limit=cap if pos.dim() else None)
        return logits, out
