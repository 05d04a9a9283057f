"""Dense decoder-only LM: training loss, prefill and cached decode
(``repro/models/transformer.py:26-213``).

GPT-2 style when the config says so: learned positions, LayerNorm, GELU
MLPs, tied embeddings, vocab padded to a multiple of 128; the llama-style
presets with rope, RMSNorm, SwiGLU, GQA, qk-norm or QKV bias; and the two
frontend stubs (``audio_frames``, ``vision_patches``).  A Python loop
over the per-layer parameter list replaces ``lax.scan``.  The model runs in
the dtype of the parameters it is given (the trainer and the engine run
fp32).  ``remat`` checkpoints each block (``layers.remat_call``):
``"full"`` recomputes it in the backward, ``"dots"`` keeps its matmul
outputs, ``"none"`` keeps every activation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, zeros_like_act
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (REMATS, ParamDef, advance_pos,
                                       apply_norm, cross_entropy_loss,
                                       mlp_apply, mlp_def, norm_def,
                                       remat_call, round_up)


def dense_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter tree; ``layers`` is a list of ``n_layers`` per-layer dicts
    (the reference stacks them along a leading axis)."""
    d = cfg.d_model
    pv = round_up(cfg.vocab_size, 128)
    layer = {"ln1": norm_def(d, cfg.norm), "attn": attn_mod.attention_def(cfg),
             "ln2": norm_def(d, cfg.norm), "mlp": mlp_def(d, cfg.d_ff, cfg.mlp)}
    defs: Dict[str, Any] = {
        "embed": ParamDef((pv, d), "embed", 0.02, ("vocab", "embed")),
        "layers": [layer] * cfg.n_layers,
        "final_norm": norm_def(d, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, pv), "normal", 1.0 / math.sqrt(d),
                                   ("embed", "vocab"))
    if cfg.pos_emb == "learned":
        defs["pos_embed"] = ParamDef((cfg.max_seq_len, d), "embed", 0.02,
                                     ("pos", "embed"))
    return defs


def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 start_pos: torch.Tensor) -> torch.Tensor:
    """Token or frontend embedding (``transformer.py:49-71``), in the
    dtype of the embedding table.

    ``audio_frames``: the batch's ``frames`` (B, S, d) replace the token
    embedding; ``vision_patches``: its ``patch_embeds`` (B, P, d) are
    prepended to it.  Without those keys (decode) the tokens (B, S) are
    embedded.  Learned positions run over the whole sequence, prefix
    included, from ``start_pos``: a 0-dim tensor (positions (S,)) or a
    (B,) vector (positions (B, S)).  Position indices clamp at the table's
    end: only a slot saturated at a capacity equal to ``max_seq_len``
    reaches it, and its output is never surfaced (the reference's gather
    fills there).
    """
    dtype = params["embed"].dtype
    if cfg.frontend == "audio_frames" and "frames" in batch:
        x = batch["frames"].to(dtype)
    else:
        x = params["embed"][batch["tokens"]]
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(dtype), x], dim=1)
    if cfg.pos_emb == "learned":
        offs = torch.arange(x.shape[1], device=x.device)
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


def _zero_pos(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=x.device)


def _first(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return batch["frames"] if "frames" in batch else batch["tokens"]


@dataclass
class DenseLM:
    """``transformer.py:86-213``.  A layer's feed-forward half is
    :meth:`_ffn`, which ``MoELM`` (``models/moe.py``) replaces; the rest of
    the skeleton is shared."""

    cfg: ModelConfig
    block_kv: int = 512
    remat: str = "full"

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    def _ffn(self, lp, h: torch.Tensor, with_aux: bool = True
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """The feed-forward half of a layer -> (output, aux losses or
        None; serving asks for none)."""
        return mlp_apply(lp["mlp"], h, self.cfg.mlp), None

    def _block(self, lp, x: torch.Tensor):
        """One pre-norm block, the training forward (``transformer.py:72-83``)
        -> (x, aux)."""
        cfg = self.cfg
        h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
        a, _ = attn_mod.full_attention(lp["attn"], h, cfg,
                                       block_kv=self.block_kv)
        # Megatron's all-reduce after the attention: the residual stream
        # stays whole over "model" (DTensor would otherwise shard it
        # where GSPMD would not)
        x = constrain(x + a, ("batch", "seq", "embed"))
        y, aux = self._ffn(lp, apply_norm(lp["ln2"], x, cfg.norm,
                                          cfg.norm_eps))
        return constrain(x + y, ("batch", "seq", "embed")), aux

    def _metrics(self, loss: torch.Tensor, denom: torch.Tensor, auxes: list
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return loss, {"loss": loss, "tokens": denom}

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token loss against labels (B, S) (``transformer.py:
        104-120``) -> (loss, {"loss", "tokens"}); the logits of a patch
        prefix are dropped.  A vision batch without its prefix (the
        pipeline's text-only eval batches) is a text batch here; the
        reference raises on it."""
        cfg = self.cfg
        x = embed_inputs(params, batch, cfg, _zero_pos(_first(batch)))
        x = constrain(x, ("batch", "seq", "embed"))
        auxes = []
        for lp in params["layers"]:
            x, aux = remat_call(self._block, self.remat, lp, x)
            auxes.append(aux)
        logits = _logits(params, x, cfg)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            logits = logits[:, batch["patch_embeds"].shape[1]:, :]
        loss, denom = cross_entropy_loss(logits, batch["labels"],
                                         batch.get("loss_mask"),
                                         cfg.vocab_size)
        return self._metrics(loss, denom, auxes)

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Full forward over the batch's S positions (prefix included) ->
        (last-position logits (B, V), cache {"k", "v": (L, B, cache_len,
        KV, D), "pos": 0-dim S})."""
        cfg = self.cfg
        x = embed_inputs(params, batch, cfg, _zero_pos(_first(batch)))
        b, s = x.shape[:2]
        cache_len = cache_len or s
        shape, dtype = self.cache_shapes(b, cache_len)["k"][0], x.dtype
        axes = self.cache_axes()["k"]
        ks = zeros_like_act(shape, dtype, x, axes)
        vs = zeros_like_act(shape, dtype, x, axes)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
            a, (k, v) = attn_mod.full_attention(lp["attn"], h, cfg,
                                                block_kv=self.block_kv)
            ks[i, :, :s] = k
            vs[i, :, :s] = v
            x = constrain(x + a, ("batch", "seq", "embed"))
            x = x + self._ffn(lp, apply_norm(lp["ln2"], x, cfg.norm,
                                             cfg.norm_eps), False)[0]
            # the block's constraint (``transformer.py:89``), which the
            # reference's prefill scan runs too
            x = constrain(x, ("batch", "seq", "embed"))
        logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
        pos = torch.tensor(s, dtype=torch.int64, device=x.device)
        return logits, {"k": ks, "v": vs, "pos": pos}

    @torch.no_grad()
    def decode(self, params, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Decode tokens (B, s_q) against the cache -> (logits (B, V) at the
        first new position, as the reference's ``[:, 0]``; new cache).

        The k/v leaves are written in place and returned as the same
        tensors.  A slot cache may also carry ``active`` (per-slot
        occupancy: inactive slots freeze ``pos`` and keep their rows) and
        ``page_table`` (the k/v leaves are shared page pools, see
        serve/paging.py); both pass through unchanged.
        """
        cfg = self.cfg
        pos = cache["pos"]
        active = cache.get("active")
        page_table = cache.get("page_table")
        # a paged step selects its writing rows once for all layers
        write = (attn_mod.paged_write_rows(page_table, pos, active,
                                           cache["k"].shape[2])
                 if page_table is not None else None)
        x = embed_inputs(params, {"tokens": tokens}, cfg, pos)
        for i, lp in enumerate(params["layers"]):
            h = apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
            a, _, _ = attn_mod.decode_attention(
                lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos,
                active=active, page_table=page_table, paged_write=write)
            x = x + a
            x = x + self._ffn(lp, apply_norm(lp["ln2"], x, cfg.norm,
                                             cfg.norm_eps), False)[0]
        logits = _logits(params, x[:, :1, :], cfg)[:, 0]
        if page_table is not None:
            cap = page_table.shape[1] * cache["k"].shape[2]  # pages x size
        else:
            cap = cache["k"].shape[2]  # dense per-slot row length
        new_pos = advance_pos(pos, tokens.shape[1], active,
                              limit=cap if pos.dim() else None)
        out = {"k": cache["k"], "v": cache["v"], "pos": new_pos}
        if active is not None:
            out["active"] = active
        if page_table is not None:
            out["page_table"] = page_table
        return logits, out

    def cache_shapes(self, batch_size: int, seq_len: int
                     ) -> Dict[str, Tuple[tuple, str]]:
        """(shape, kind) per cache leaf; kind "float" is the model's
        dtype."""
        cfg = self.cfg
        kv = ((cfg.n_layers, batch_size, seq_len, cfg.n_kv_heads,
               cfg.resolved_head_dim), "float")
        return {"k": kv, "v": kv, "pos": ((), "int")}

    def cache_axes(self) -> Dict[str, tuple]:
        kv = ("layers", "batch", "seq", "kv_heads", "head_dim")
        return {"k": kv, "v": kv, "pos": ()}
