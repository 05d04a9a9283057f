"""Parameter declarations and common layers (``repro/models/layers.py:19-247``).

A model is declared as a nested dict of :class:`ParamDef` leaves; the same
tree gives materialized fp32 parameters (:func:`init_params`) and the
parameter count.  Where the reference stacks per-layer leaves along a
leading ``n_layers`` axis for ``lax.scan``, the port keeps a list of
per-layer dicts and loops over it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class ParamDef(NamedTuple):
    """Declaration of one parameter leaf (``layers.py:19``)."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed | uniform_conv
    scale: float = 1.0    # stddev for "normal" / "embed"; the uniform's limit

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=torch.float32, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=torch.float32, device=device)
        if self.init in ("normal", "embed"):
            # scale * truncated_normal(-3, 3), as jax.random.truncated_normal,
            # drawn on the generator's device: a CPU generator gives the same
            # weights on any device, a CUDA generator draws on the card
            t = torch.empty(self.shape, dtype=torch.float32,
                            device=generator.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                        generator=generator)
            return (self.scale * t).to(device)
        if self.init == "uniform_conv":  # conv1d default: U(-1/sqrt(k), 1/sqrt(k))
            t = torch.empty(self.shape, dtype=torch.float32,
                            device=generator.device)
            t.uniform_(-self.scale, self.scale, generator=generator)
            return t.to(device)
        raise ValueError(f"unknown init {self.init!r}")


def _walk(defs: Any, fn):
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: _walk(defs[k], fn) for k in sorted(defs)}
    return [_walk(d, fn) for d in defs]


def init_params(defs: Any, generator: torch.Generator,
                device: torch.device) -> Any:
    """Materialize a ParamDef tree into fp32 tensors, leaves in sorted-key
    order from one generator."""
    return _walk(defs, lambda d: d.materialize(generator, device))


def param_count(defs: Any) -> int:
    total = 0

    def add(d: ParamDef):
        nonlocal total
        total += math.prod(d.shape)
    _walk(defs, add)
    return total


def cache_dtypes(dtype: torch.dtype) -> Dict[str, torch.dtype]:
    """torch dtype of each decode-cache leaf kind (``cache_shapes``) for a
    model running in ``dtype``."""
    return {"float": dtype, "fp32": torch.float32, "int": torch.int64,
            "bool": torch.bool}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with the population variance (``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor, kind: str,
               eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


def norm_def(d: int, kind: str) -> Dict[str, ParamDef]:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), "ones")}
    return {"scale": ParamDef((d,), "ones"), "bias": ParamDef((d,), "zeros")}


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """The (D / 2,) rotary frequencies (``layers.py:152-154``)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary positions, rotate-half convention (``layers.py:157-168``):
    x (..., S, H, D) with positions (S,) or (..., S), in fp32 inside."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D / 2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over the heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_def(d_model: int, d_ff: int, kind: str) -> Dict[str, ParamDef]:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(d_ff)
    if kind == "swiglu":
        return {"w_gate": ParamDef((d_model, d_ff), "normal", s_in),
                "w_up": ParamDef((d_model, d_ff), "normal", s_in),
                "w_down": ParamDef((d_ff, d_model), "normal", s_out)}
    return {"w_up": ParamDef((d_model, d_ff), "normal", s_in),
            "b_up": ParamDef((d_ff,), "zeros"),
            "w_down": ParamDef((d_ff, d_model), "normal", s_out),
            "b_down": ParamDef((d_model,), "zeros")}


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        gate = F.silu(x @ params["w_gate"])
        return (gate * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def advance_pos(pos: torch.Tensor, n: int,
                active: Optional[torch.Tensor] = None,
                limit: Optional[int] = None) -> torch.Tensor:
    """Advance decode position(s) by ``n`` (``layers.py:206-226``): positions
    saturate at ``limit`` (cache capacity) and inactive slots stay frozen.
    With both ``None`` it is exactly ``pos + n`` (the scalar replay path)."""
    new = pos + n
    if limit is not None:
        new = new.clamp_max(limit)
    if active is not None:
        new = torch.where(active, new, pos)
    return new


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor], vocab_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean masked next-token loss in fp32 (``layers.py:229-247``).  Logit
    columns of the padded vocab get -1e9, as in the reference.  Returns
    (loss, number of counted tokens), both 0-dim."""
    logits = logits.float()
    padded = logits.shape[-1]
    if padded != vocab_size:
        iota = torch.arange(padded, device=logits.device)
        logits = torch.where(iota < vocab_size, logits,
                             torch.full((), -1e9, device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    total = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / total, total
