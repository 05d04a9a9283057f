"""Fine-grained MoE, shared + routed experts (``repro/models/moe.py``).

Top-k token-choice routing into a capacity buffer.  Dispatch is sort-free:
the position of each (token, expert) assignment inside its expert's buffer
is a cumulative count over a one-hot matrix, and assignments past the
capacity are dropped.  ``row_local`` ranks and sizes the buffers per batch
row; ``global`` ranks over all B * S tokens, which is the row-local
dispatch of the batch flattened into one row.  The experts run as batched
matmuls over the expert axis (no custom kernel: the reference's are
``jnp.einsum`` outside any Pallas call).  The expert buffers carry the
reference's sharding constraints (``moe.py:75``, ``:83`` global,
``:150``, ``:158`` row-local); the block's and the loss's (``:220``,
``:230``) are ``DenseLM``'s, whose skeleton ``MoELM`` runs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import trace
from repro_torch.distributed.sharding import constrain, local_call
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ParamDef, mlp_apply, mlp_def,
                                       norm_def, round_up)
from repro_torch.models.transformer import DenseLM

AUX_KEYS = ("load_balance", "router_z", "dropped_frac")
# the tracer's counters a training forward adds while it records, summed
# over the layers: top-k assignments, those inside the capacity, slots
COUNTER_KEYS = tuple(trace.METRIC_PREFIX + k for k in
                     ("moe.assigned", "moe.kept", "moe.slots"))
Aux = Optional[Dict[str, torch.Tensor]]


def moe_ffn_def(cfg: ModelConfig) -> Dict[str, Any]:
    """``moe.py:29-41``: the router (d, E), the experts' SwiGLU weights
    (E, d, f) / (E, f, d) and the shared experts as one SwiGLU MLP of
    width ``d_ff * n_shared_experts``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)
    defs: Dict[str, Any] = {
        "router": ParamDef((d, e), "normal", s_in, ("embed", "experts")),
        "w_gate": ParamDef((e, d, f), "normal", s_in,
                           ("experts", "embed", "mlp")),
        "w_up": ParamDef((e, d, f), "normal", s_in,
                         ("experts", "embed", "mlp")),
        "w_down": ParamDef((e, f, d), "normal", s_out,
                           ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = mlp_def(d, cfg.d_ff * cfg.n_shared_experts, "swiglu")
    return defs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``tokens`` tokens (``moe.py:44-46``)."""
    return max(1, int(math.ceil(
        tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def top_k_experts(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing decision: the ``k`` largest router probabilities of
    each token and their experts, largest first (``jax.lax.top_k``)."""
    return torch.topk(probs, k, dim=-1)


class Routing(NamedTuple):
    """One call's routing of x (B, S, d) into (B, E, C) slots."""

    logits: torch.Tensor      # (B, S, E) fp32 router logits
    probs: torch.Tensor       # (B, S, E) their softmax
    gate: torch.Tensor        # (B, S, k) renormalized top-k probabilities
    expert_idx: torch.Tensor  # (B, S, k) int64
    onehot: torch.Tensor      # (B, S*k, E) bool, the assignments
    keep: torch.Tensor        # (B, S*k) bool, inside the capacity
    dest: torch.Tensor        # (B, S*k) slot e*C + pos, or E*C (dropped)
    c: int                    # capacity


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
          ) -> Routing:
    """Router, top-k and the per-row capacity ranking (``moe.py:119-132``)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(s, cfg)
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = top_k_experts(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = expert_idx.reshape(b, s * k)
    # one-hot by comparison: F.one_hot checks its input's range on the
    # host, a device sync each call
    onehot = flat_e[..., None] == torch.arange(e, device=x.device)
    pos = onehot.cumsum(dim=1).gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos < c
    dest = torch.where(keep, flat_e * c + pos, e * c)
    return Routing(logits, probs, gate, expert_idx, onehot, keep, dest, c)


def _dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Each row's routing and expert buffers: ``(buf (B, E, C, d), dest,
    w (B, S*k, 1) the kept assignments' gates, probs, the router logits'
    logsumexp (B, S), onehot, keep)``.

    Each row's slots are filled through an inverse slot -> assignment map
    (drops all land in the one sentinel slot E*C, which is cut off; an
    empty slot reads a zero row appended to x)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    with trace.span("moe.route", device=True):
        r = route(router, x, cfg)
    with trace.span("moe.dispatch", device=True):
        c = r.c
        inv = torch.full((b, e * c + 1), s * k, dtype=torch.int64,
                         device=x.device)
        inv.scatter_(1, r.dest, torch.arange(s * k, device=x.device)
                     .expand(b, s * k))
        # (B, E*C): the token in each slot, s (the zero row) where empty
        tok = inv[:, :e * c] // k
        buf = F.pad(x, (0, 0, 0, 1)).gather(
            1, tok[..., None].expand(-1, -1, d))
        w = r.gate.reshape(b, s * k, 1).to(x.dtype)
    return (buf.reshape(b, e, c, d), r.dest, w, r.probs,
            torch.logsumexp(r.logits, dim=-1), r.onehot, r.keep)


def _combine(y_buf: torch.Tensor, dest: torch.Tensor, w: torch.Tensor,
             k: int) -> torch.Tensor:
    """Each token's sum of its assignments' outputs times their gates (a
    dropped one reads a zero row, so its gate times ``keep`` is the
    reference's same zero): y_buf (B, E, C, d) -> (B, S, d)."""
    b, e, c, d = y_buf.shape
    y_flat = F.pad(y_buf.reshape(b, e * c, d), (0, 0, 0, 1))
    y_assign = y_flat.gather(1, dest[..., None].expand(-1, -1, d))
    return (y_assign * w).reshape(b, -1, k, d).sum(dim=2)


def moe_ffn_rowlocal(params, x: torch.Tensor, cfg: ModelConfig,
                     with_aux: bool = True,
                     batch_axis: Optional[str] = "batch"
                     ) -> Tuple[torch.Tensor, Aux]:
    """Row-local dispatch (``moe.py:105-176``): x (B, S, d) -> (y, aux),
    aux None unless ``with_aux`` (serving reads no aux loss).

    The routing and the slot gathers (:func:`_dispatch`, :func:`_combine`)
    are index ops of whole rows: under sharding rules each rank runs them
    on its own rows (``local_call`` over ``batch_axis``; the global
    dispatch's one row is no batch axis, so every rank runs all of it).
    The experts run as three ``bmm`` over the expert axis, whose buffers
    are constrained to (``batch_axis``, "experts", ...).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(s, cfg)
    rows = (batch_axis, None, None)
    buf, dest, w, probs, lse, onehot, keep = local_call(
        functools.partial(_dispatch, cfg=cfg), (params["router"], x),
        ((None, None), rows),
        ((batch_axis, None, None, None), (batch_axis, None), rows, rows,
         (batch_axis, None), rows, (batch_axis, None)))
    buf_axes = (batch_axis, "experts", None, None)
    buf = constrain(buf, buf_axes)
    with trace.span("moe.experts"):
        xb = buf.transpose(0, 1).reshape(e, b * c, d)
        h = F.silu(torch.bmm(xb, params["w_gate"])) * torch.bmm(
            xb, params["w_up"])
        y_buf = torch.bmm(h, params["w_down"]).reshape(e, b, c, d)
        y_buf = constrain(y_buf.transpose(0, 1), buf_axes)
    with trace.span("moe.combine", device=True):
        y = local_call(functools.partial(_combine, k=k), (y_buf, dest, w),
                       ((batch_axis, None, None, None), (batch_axis, None),
                        rows), (rows,))
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, "swiglu")
    if not with_aux:
        return y, None
    me = probs.reshape(-1, e).mean(dim=0)
    ce_frac = onehot.sum(dim=(0, 1)).float() / (b * s * k)
    aux = {
        "load_balance": e * torch.sum(me * ce_frac),
        "router_z": lse.square().mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    if trace.enabled():
        aux.update(zip(COUNTER_KEYS, (b * s * k, keep.sum(), b * e * c)))
    return y, aux


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            with_aux: bool = True) -> Tuple[torch.Tensor, Aux]:
    """Global dispatch (``moe.py:49-102``): one capacity buffer over all
    B * S tokens, ranked in token order, which is the row-local dispatch
    of the batch flattened into a single row."""
    b, s, d = x.shape
    y, aux = moe_ffn_rowlocal(params, x.reshape(1, b * s, d), cfg, with_aux,
                              batch_axis=None)
    return y.reshape(b, s, d), aux


def apply_moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
                  with_aux: bool = True):
    """``moe.py:179-182``."""
    if cfg.moe_dispatch == "row_local":
        return moe_ffn_rowlocal(params, x, cfg, with_aux)
    return moe_ffn(params, x, cfg, with_aux)


def moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """``moe.py:185-201``: always an ``lm_head``, never ``pos_embed``."""
    d = cfg.d_model
    pv = round_up(cfg.vocab_size, 128)
    layer = {"ln1": norm_def(d, cfg.norm),
             "attn": attn_mod.attention_def(cfg),
             "ln2": norm_def(d, cfg.norm),
             "moe": moe_ffn_def(cfg)}
    return {"embed": ParamDef((pv, d), "embed", 0.02, ("vocab", "embed")),
            "layers": [layer] * cfg.n_layers,
            "final_norm": norm_def(d, cfg.norm),
            "lm_head": ParamDef((d, pv), "normal", 1.0 / math.sqrt(d),
                                ("embed", "vocab"))}


@dataclass
class MoELM(DenseLM):
    """MoE decoder (``moe.py:204-310``): ``DenseLM``'s attention, prefill
    and per-slot / paged decode, the feed-forward half swapped for shared
    + routed experts.  ``loss`` adds the router's aux losses, averaged over
    the layers: ``total = loss + router_aux_coef * load_balance +
    router_z_coef * router_z``; its metrics carry the three averages."""

    def _ffn(self, lp, h: torch.Tensor, with_aux: bool = True):
        return apply_moe_ffn(lp["moe"], h, self.cfg, with_aux)

    def _metrics(self, loss, denom, auxes):
        cfg = self.cfg
        mean = {key: torch.stack([a[key] for a in auxes]).mean()
                for key in AUX_KEYS}
        total = (loss + cfg.router_aux_coef * mean["load_balance"]
                 + cfg.router_z_coef * mean["router_z"])
        counts = {key: sum(a[key] for a in auxes)
                  for key in COUNTER_KEYS if key in auxes[0]}
        return total, {"loss": loss, "tokens": denom, **mean, **counts}
