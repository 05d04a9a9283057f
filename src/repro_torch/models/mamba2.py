"""Mamba-2 (SSD) block: the chunked state-space dual scan, the causal convs
and single-token decode (``repro/models/mamba2.py``).

``ssd_mix`` picks the backend by ``cfg.ssm_backend``: "kernel" is the
``torch.autograd.Function`` over the CUDA forward and backward kernels
(their plain versions on CPU tensors), "reference" is ``ssd_reference``,
the chunked forward in plain PyTorch differentiated by autograd.  The
decode step and the convs have no kernel in the reference and stay plain
PyTorch.  ``mamba2_block`` serves training and prefill: with
``with_cache`` it also returns the layer's decode cache (the reference
copies the block's body into ``Zamba2LM.prefill`` for that,
``zamba2.py:129-157``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_call
from repro_torch.kernels import SSM_BACKENDS, chunk_padding, wants_kernel
from repro_torch.kernels.ssd import ssd, ssd_fwd_plain
from repro_torch.models.layers import ParamDef, rms_norm

Cache = Dict[str, torch.Tensor]


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, ...) <-> (B, H, S, ...)."""
    return t.transpose(1, 2)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
                  b_in: torch.Tensor, c_in: torch.Tensor, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (``mamba2.py:32-95``) in plain PyTorch.

    x (B, S, H, P) per-head inputs, dt (B, S, H) post-softplus steps,
    a_coef (H,) negative decay coefficients, b_in/c_in (B, S, N) shared by
    the heads.  A ragged tail is padded with dt = 0 steps, which leave the
    state unchanged.  Returns (y (B, S, H, P), final state (B, H, N, P)
    fp32).
    """
    s = x.shape[1]
    chunk, pad = chunk_padding(s, chunk)
    xs, dts = _heads(x), _heads(dt)
    if pad:
        xs, dts = F.pad(xs, (0, 0, 0, pad)), F.pad(dts, (0, pad))
        b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in (b_in, c_in))
    y, state = ssd_fwd_plain(xs, dts, a_coef, b_in, c_in, chunk=chunk)
    return _heads(y[:, :, :s]), state


def ssd_mix(xh: torch.Tensor, dt: torch.Tensor, a_coef: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend dispatch at the model layout (``mamba2.py:98-116``): xh
    (B, S, H, P), dt (B, S, H), b_in/c_in (B, S, N) -> (y (B, S, H, P),
    final state (B, H, N, P))."""
    if wants_kernel(cfg.ssm_backend, "ssm_backend", SSM_BACKENDS):
        def run(xh, dt, a_coef, b_in, c_in):
            y, state = ssd(_heads(xh), _heads(dt), a_coef, b_in, c_in,
                           chunk=cfg.ssm_chunk)
            return _heads(y).contiguous(), state

        # under sharding rules each rank's kernel takes its batch rows and
        # its heads; B and C are shared by the heads
        bsh = ("batch", None, "ssm_heads", None)
        return local_call(run, (xh, dt, a_coef, b_in, c_in),
                          (bsh, bsh[:3], ("ssm_heads",), ("batch", None, None),
                           ("batch", None, None)),
                          (bsh, ("batch", "ssm_heads", None, None)))
    return ssd_reference(xh, dt, a_coef, b_in, c_in, cfg.ssm_chunk)


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a_coef: torch.Tensor, b_in: torch.Tensor,
                    c_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token (``mamba2.py:119-129``): state (B, H, N, P) fp32; x
    (B, H, P), dt (B, H), b_in/c_in (B, N) -> (y (B, H, P), new state)."""
    decay = torch.exp(dt * a_coef)
    x_dt = (x * dt[..., None]).float()
    state = (decay[..., None, None] * state
             + b_in.float()[:, None, :, None] * x_dt[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), state)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# conv helpers (``mamba2.py:136-166``)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, D), w (K, D), bias (D,)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + bias.to(x.dtype)


def conv_decode_step(conv_state: torch.Tensor, x_t: torch.Tensor,
                     w: torch.Tensor, bias: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_state (B, K - 1, D), x_t (B, D) -> (y_t, new state)."""
    window = torch.cat([conv_state.to(x_t.dtype), x_t[:, None]], dim=1)
    y = torch.einsum("bkd,kd->bd", window, w.to(x_t.dtype)) + bias.to(
        x_t.dtype)
    return y, window[:, 1:]


def conv_prefill_state(x_raw: torch.Tensor, kernel: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """The rolling conv window after a prefill: the last K - 1 raw inputs,
    zero-left-padded when S < K - 1 (zeros are the conv's own implicit
    history, so a short prompt hands the decode step what a token-by-token
    decode would)."""
    kk = kernel - 1
    if x_raw.shape[1] < kk:
        x_raw = F.pad(x_raw, (0, 0, kk - x_raw.shape[1], 0))
    return x_raw[:, -kk:].to(dtype)


# ---------------------------------------------------------------------------
# the Mamba-2 block (``mamba2.py:173-290``)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, head dim P, state N)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim, \
        cfg.ssm_state


def mamba2_def(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_inner, h, _, n = mamba2_dims(cfg)
    k = cfg.conv_kernel
    s = 1.0 / math.sqrt(d)
    cl = 1.0 / math.sqrt(k)
    return {
        "norm_in": {"scale": ParamDef((d,), "ones", axes=("embed",))},
        "wz": ParamDef((d, d_inner), "normal", s, ("embed", "ssm_inner")),
        "wx": ParamDef((d, d_inner), "normal", s, ("embed", "ssm_inner")),
        "wb": ParamDef((d, n), "normal", s, ("embed", "state")),
        "wc": ParamDef((d, n), "normal", s, ("embed", "state")),
        "wdt": ParamDef((d, h), "normal", s, ("embed", "ssm_heads")),
        "conv_x": {"w": ParamDef((k, d_inner), "uniform_conv", cl,
                                 ("conv", "ssm_inner")),
                   "b": ParamDef((d_inner,), "zeros", axes=("ssm_inner",))},
        "conv_b": {"w": ParamDef((k, n), "uniform_conv", cl,
                                 ("conv", "state")),
                   "b": ParamDef((n,), "zeros", axes=("state",))},
        "conv_c": {"w": ParamDef((k, n), "uniform_conv", cl,
                                 ("conv", "state")),
                   "b": ParamDef((n,), "zeros", axes=("state",))},
        "a_log": ParamDef((h,), "zeros", axes=("ssm_heads",)),  # A = -exp(a_log)
        "d_skip": ParamDef((h,), "ones", axes=("ssm_heads",)),
        "dt_bias": ParamDef((h,), "zeros", axes=("ssm_heads",)),
        "norm_gate": {"scale": ParamDef((d_inner,), "ones",
                                        axes=("ssm_inner",))},
        "wo": ParamDef((d_inner, d), "normal", 1.0 / math.sqrt(d_inner),
                       ("ssm_inner", "embed")),
    }


def _proj_inputs(lp, h_in: torch.Tensor):
    """z, x, B, C and raw dt projections of the normalized input."""
    return (h_in @ lp["wz"], h_in @ lp["wx"], h_in @ lp["wb"],
            h_in @ lp["wc"], h_in @ lp["wdt"])


def _step_and_decay(lp, dt_raw: torch.Tensor):
    """dt = softplus(dt_raw + dt_bias) and a = -exp(a_log), fp32."""
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float())
    return dt, -torch.exp(lp["a_log"].float())


def _gate_out(lp, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """x + wo (rms_norm(y * silu(z)))."""
    y = rms_norm(y * F.silu(z), lp["norm_gate"]["scale"], cfg.norm_eps)
    return x + y @ lp["wo"]


def mamba2_block(lp, x: torch.Tensor, cfg: ModelConfig,
                 with_cache: bool = False):
    """The full-sequence block, pre-norm residual inside: x (B, S, d) ->
    x; with ``with_cache`` also the layer's decode cache (the SSD's final
    state and each conv's last K - 1 raw inputs)."""
    d_inner, h, p, _ = mamba2_dims(cfg)
    b, s, _ = x.shape
    h_in = rms_norm(x, lp["norm_in"]["scale"], cfg.norm_eps)
    z, x_in, b_raw, c_raw, dt_raw = _proj_inputs(lp, h_in)
    x_conv, b_conv, c_conv = (
        F.silu(causal_conv1d(t, lp[name]["w"], lp[name]["b"]))
        for t, name in ((x_in, "conv_x"), (b_raw, "conv_b"),
                        (c_raw, "conv_c")))
    dt, a_coef = _step_and_decay(lp, dt_raw)
    xh = x_conv.reshape(b, s, h, p)
    y, state = ssd_mix(xh, dt, a_coef, b_conv, c_conv, cfg)
    y = y + lp["d_skip"].to(y.dtype)[:, None] * xh
    out = _gate_out(lp, x, y.reshape(b, s, d_inner), z, cfg)
    if not with_cache:
        return out
    k = cfg.conv_kernel
    return out, {"ssm_state": state,
                 "conv_x": conv_prefill_state(x_in, k, x.dtype),
                 "conv_b": conv_prefill_state(b_raw, k, x.dtype),
                 "conv_c": conv_prefill_state(c_raw, k, x.dtype)}


def mamba2_cache_shapes(cfg: ModelConfig, n_layers: int, batch: int
                        ) -> Dict[str, Tuple[tuple, str]]:
    """(shape, kind) per cache leaf; kind "float" is the model's dtype."""
    d_inner, h, p, n = mamba2_dims(cfg)
    kk = cfg.conv_kernel - 1
    return {"ssm_state": ((n_layers, batch, h, n, p), "fp32"),
            "conv_x": ((n_layers, batch, kk, d_inner), "float"),
            "conv_b": ((n_layers, batch, kk, n), "float"),
            "conv_c": ((n_layers, batch, kk, n), "float")}


def mamba2_cache_axes() -> Dict[str, tuple]:
    return {"ssm_state": ("layers", "batch", "ssm_heads", "state", None),
            "conv_x": ("layers", "batch", None, "ssm_inner"),
            "conv_b": ("layers", "batch", None, "state"),
            "conv_c": ("layers", "batch", None, "state")}


def mamba2_decode_block(lp, x: torch.Tensor, cache: Cache, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, Cache]:
    """One token x (B, 1, d) against one layer's cache leaves (no layer
    axis) -> (x, the layer's new cache)."""
    d_inner, h, p, _ = mamba2_dims(cfg)
    b = x.shape[0]
    h_in = rms_norm(x[:, 0], lp["norm_in"]["scale"], cfg.norm_eps)
    z, x_in, b_raw, c_raw, dt_raw = _proj_inputs(lp, h_in)
    new: Cache = {}
    convs = []
    for t, name in ((x_in, "conv_x"), (b_raw, "conv_b"), (c_raw, "conv_c")):
        y_t, new[name] = conv_decode_step(cache[name], t, lp[name]["w"],
                                          lp[name]["b"])
        convs.append(F.silu(y_t))
    x_c, b_c, c_c = convs
    dt, a_coef = _step_and_decay(lp, dt_raw)
    xh = x_c.reshape(b, h, p)
    y, new["ssm_state"] = ssd_decode_step(cache["ssm_state"], xh, dt, a_coef,
                                          b_c, c_c)
    y = y + lp["d_skip"].to(y.dtype)[:, None] * xh
    out = _gate_out(lp, x[:, 0], y.reshape(b, d_inner), z, cfg)
    return out[:, None], new
