"""RWKV-6 (Finch): attention-free mixer with data-dependent per-channel
decay (``repro/models/rwkv6.py``).

The WKV recurrence runs in chunked form: within a chunk the pairwise
per-channel decay is exp of a non-positive difference of cumulative
log-decays, across chunks a (H, D, D) state is carried.  ``wkv6_mix``
picks the backend by ``cfg.rwkv_backend``: "kernel" is the
``torch.autograd.Function`` over the CUDA forward and backward kernels
(their plain versions on CPU tensors), "reference" is ``wkv6_reference``,
the chunked forward in plain PyTorch differentiated by autograd.  Decode is
one step of the recurrence per token, plain PyTorch (the reference has no
kernel for it).  As ``DenseLM``, the model runs in the dtype of the
parameters it is given, and a Python loop over the per-layer list replaces
``lax.scan``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, local_call
from repro_torch.kernels import RWKV_BACKENDS, chunk_padding, wants_kernel
from repro_torch.kernels.rwkv6 import wkv6, wkv6_fwd_plain
from repro_torch.models.layers import (REMATS, ParamDef, advance_pos,
                                       cache_dtypes, cross_entropy_loss,
                                       layer_norm, norm_def, remat_call,
                                       round_up)
from repro_torch.models.transformer import _logits, embed_inputs


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) <-> (B, H, S, D)."""
    return t.transpose(1, 2)


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_w: torch.Tensor, u: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV-6 (``rwkv6.py:36-93``) in plain PyTorch.

    r, k, v, log_w (B, S, H, D) (log_w <= 0), u (H, D).  Per head:
    ``y_t = r_t . (S_{t-1} + u * k_t (x) v_t)`` and ``S_t = diag(w_t)
    S_{t-1} + k_t (x) v_t``.  A ragged tail is padded with log_w = 0, k = 0
    rows, which leave the state unchanged.  Returns (y (B, S, H, D),
    final state (B, H, D, D) fp32).
    """
    s = r.shape[1]
    chunk, pad = chunk_padding(s, chunk)
    xs = [_heads(t) for t in (r, k, v, log_w)]
    if pad:
        xs = [F.pad(t, (0, 0, 0, pad)) for t in xs]
    y, state = wkv6_fwd_plain(*xs, u, chunk=chunk)
    return _heads(y[:, :, :s]), state


def wkv6_mix(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_w: torch.Tensor, u: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend dispatch at the model layout (``rwkv6.py:96-112``): r, k, v,
    log_w (B, S, H, D), u (H, D) -> (y (B, S, H, D), final state)."""
    if wants_kernel(cfg.rwkv_backend, "rwkv_backend", RWKV_BACKENDS):
        def run(r, k, v, log_w, u):
            y, state = wkv6(*(_heads(t) for t in (r, k, v, log_w)), u,
                            chunk=cfg.rwkv_chunk)
            return _heads(y).contiguous(), state

        # under sharding rules each rank's kernel takes its batch rows and
        # its heads
        bsh = ("batch", None, "rwkv_heads", None)
        return local_call(run, (r, k, v, log_w, u),
                          (bsh,) * 4 + (("rwkv_heads", None),),
                          (bsh, ("batch", "rwkv_heads", None, None)))
    return wkv6_reference(r, k, v, log_w, u, cfg.rwkv_chunk)


def wkv6_decode_step(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, log_w: torch.Tensor, u: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of WKV (``rwkv6.py:115-125``): state (B, H, D, D) fp32;
    r, k, v, log_w (B, H, D) -> (y (B, H, D), new state)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    bonus = (rf * u.float() * kf).sum(dim=-1, keepdim=True)
    y = torch.einsum("bhd,bhde->bhe", rf, state) + bonus * vf
    state = (torch.exp(log_w.float())[..., None] * state
             + kf[..., :, None] * vf[..., None, :])
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# the RWKV-6 block (``rwkv6.py:132-220``)
# ---------------------------------------------------------------------------

def rwkv6_def(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    rank = cfg.rwkv_lora_rank
    s = 1.0 / math.sqrt(d)
    return {
        "ln1": norm_def(d, "layernorm"),
        # r, k, v, w, g token-shift lerps
        "mix": ParamDef((5, d), "zeros", axes=(None, "embed")),
        "w_base": ParamDef((d,), "zeros", axes=("rwkv_inner",)),
        "w_lora_a": ParamDef((d, rank), "normal", s, ("embed", None)),
        "w_lora_b": ParamDef((rank, d), "zeros", axes=(None, "rwkv_inner")),
        "wr": ParamDef((d, d), "normal", s, ("embed", "rwkv_inner")),
        "wk": ParamDef((d, d), "normal", s, ("embed", "rwkv_inner")),
        "wv": ParamDef((d, d), "normal", s, ("embed", "rwkv_inner")),
        "wg": ParamDef((d, d), "normal", s, ("embed", "rwkv_inner")),
        "u": ParamDef((d // hd, hd), "normal", 0.5, ("rwkv_heads", None)),
        "ln_x": norm_def(d, "layernorm", ("rwkv_inner",)),
        "wo": ParamDef((d, d), "normal", s, ("rwkv_inner", "embed")),
        "ln2": norm_def(d, "layernorm"),
        # channel-mix k, r lerps
        "mix_c": ParamDef((2, d), "zeros", axes=(None, "embed")),
        "wck": ParamDef((d, cfg.d_ff), "normal", s, ("embed", "mlp")),
        "wcv": ParamDef((cfg.d_ff, d), "normal", 1.0 / math.sqrt(cfg.d_ff),
                        ("mlp", "embed")),
        "wcr": ParamDef((d, d), "normal", s, ("embed", "rwkv_inner")),
    }


def _time_mix_inputs(lp, xn: torch.Tensor, x_prev: torch.Tensor,
                     cfg: ModelConfig):
    """Token-shift lerps and projections.  xn (B, S, D) normalized, x_prev
    the previous token's xn -> r, k, v (B, S, H, D), the gate g (B, S, D)
    and log_w (B, S, H, D) fp32, <= 0 and data-dependent."""
    hd = cfg.rwkv_head_dim
    shp = xn.shape[:-1] + (cfg.d_model // hd, hd)
    mix = lp["mix"]
    delta = x_prev - xn
    xr, xk, xv, xw, xg = (xn + mix[i] * delta for i in range(5))
    r = (xr @ lp["wr"]).reshape(shp)
    k = (xk @ lp["wk"]).reshape(shp)
    v = (xv @ lp["wv"]).reshape(shp)
    g = F.silu(xg @ lp["wg"])
    w_raw = (lp["w_base"].float() + torch.tanh(xw.float()
                                               @ lp["w_lora_a"].float())
             @ lp["w_lora_b"].float())
    log_w = -torch.exp(w_raw.clamp(-8.0, 4.0))
    return r, k, v, g, log_w.reshape(shp)


def _group_norm_heads(y: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, h: int, eps: float) -> torch.Tensor:
    """Per-head LayerNorm (GroupNorm with H groups) over (B, S, H * Dh),
    fp32 out."""
    b, s, _ = y.shape
    yh = y.reshape(b, s, h, -1).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yn = ((yh - mu) * torch.rsqrt(var + eps)).reshape(b, s, -1)
    return yn * scale.float() + bias.float()


def _shift(xn: torch.Tensor) -> torch.Tensor:
    """The previous token's row, zeros before the first."""
    return F.pad(xn[:, :-1], (0, 0, 1, 0))


def _time_mix(lp, x: torch.Tensor, cfg: ModelConfig):
    """x + the time mix of x (B, S, D); also the WKV final state and the
    normalized input (whose last row is the decode cache's shift)."""
    b, s, d = x.shape
    xn = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], cfg.norm_eps)
    r, k, v, g, log_w = _time_mix_inputs(lp, xn, _shift(xn), cfg)
    y, state = wkv6_mix(r, k, v, log_w, lp["u"], cfg)
    y = _group_norm_heads(y.reshape(b, s, d), lp["ln_x"]["scale"],
                          lp["ln_x"]["bias"], d // cfg.rwkv_head_dim,
                          cfg.norm_eps)
    return x + (y.to(x.dtype) * g) @ lp["wo"], state, xn


def _channel_mix(lp, x: torch.Tensor, xn: torch.Tensor,
                 x_prev: torch.Tensor) -> torch.Tensor:
    """x + the channel mix of the normalized xn against the previous
    token's x_prev (rows (B, S, D) or single tokens (B, D))."""
    mix = lp["mix_c"]
    delta = x_prev - xn
    xk = xn + mix[0] * delta
    xr = xn + mix[1] * delta
    kk = torch.square(torch.relu(xk @ lp["wck"]))
    return x + (kk @ lp["wcv"]) * torch.sigmoid(xr @ lp["wcr"])


def rwkv6_block(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One block, the training forward (``rwkv6.py:190-220``)."""
    x, _, _ = _time_mix(lp, x, cfg)
    xn = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"], cfg.norm_eps)
    return constrain(_channel_mix(lp, x, xn, _shift(xn)),
                     ("batch", "seq", "embed"))


def rwkv6_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter tree (``rwkv6.py:227-237``); ``layers`` is a list of
    ``n_layers`` per-layer dicts."""
    d = cfg.d_model
    pv = round_up(cfg.vocab_size, 128)
    return {
        "embed": ParamDef((pv, d), "embed", 0.02, ("vocab", "embed")),
        "ln_in": norm_def(d, "layernorm"),
        "layers": [rwkv6_def(cfg)] * cfg.n_layers,
        "final_norm": norm_def(d, "layernorm"),
        "lm_head": ParamDef((d, pv), "normal", 1.0 / math.sqrt(d),
                            ("embed", "vocab")),
    }


@dataclass
class RWKV6LM:
    """``rwkv6.py:240-382``."""

    cfg: ModelConfig
    remat: str = "full"

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"unknown remat policy {self.remat!r}")

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_inputs(params, {"tokens": tokens}, self.cfg,
                         torch.zeros((), dtype=torch.int64,
                                     device=tokens.device))
        return layer_norm(x, params["ln_in"]["scale"],
                          params["ln_in"]["bias"], self.cfg.norm_eps)

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token loss over tokens (B, S) against labels (B, S)
        -> (loss, {"loss", "tokens"})."""
        cfg = self.cfg
        x = constrain(self._embed(params, batch["tokens"]),
                      ("batch", "seq", "embed"))
        for lp in params["layers"]:
            x = remat_call(rwkv6_block, self.remat, lp, x, cfg)
        loss, denom = cross_entropy_loss(_logits(params, x, cfg),
                                         batch["labels"],
                                         batch.get("loss_mask"),
                                         cfg.vocab_size)
        return loss, {"loss": loss, "tokens": denom}

    # -- serving ------------------------------------------------------------
    # per layer: the wkv state (B, H, D, D) fp32 and the token-shift rows of
    # the two mixers (B, D); no "seq" axis, so paging leaves them dense
    def cache_shapes(self, batch_size: int, seq_len: int
                     ) -> Dict[str, Tuple[tuple, str]]:
        """(shape, kind) per cache leaf; kind "float" is the model's dtype.
        ``seq_len`` is unused: the state does not grow."""
        cfg = self.cfg
        hd = cfg.rwkv_head_dim
        n, d = cfg.n_layers, cfg.d_model
        return {"wkv": ((n, batch_size, d // hd, hd, hd), "fp32"),
                "shift_t": ((n, batch_size, d), "float"),
                "shift_c": ((n, batch_size, d), "float"),
                "pos": ((), "int")}

    def cache_axes(self) -> Dict[str, tuple]:
        return {"wkv": ("layers", "batch", "rwkv_heads", None, None),
                "shift_t": ("layers", "batch", "embed"),
                "shift_c": ("layers", "batch", "embed"),
                "pos": ()}

    @torch.no_grad()
    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Full forward over tokens (B, S) -> (last-position logits (B, V),
        cache {"wkv", "shift_t", "shift_c": per layer, "pos": 0-dim S}).
        ``cache_len`` is unused: the state does not grow."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        kinds = cache_dtypes(x.dtype)
        cache = {name: torch.zeros(shape, dtype=kinds[kind], device=x.device)
                 for name, (shape, kind) in self.cache_shapes(b, s).items()
                 if name != "pos"}
        for i, lp in enumerate(params["layers"]):
            x, state, xn = _time_mix(lp, x, cfg)
            xn2 = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                             cfg.norm_eps)
            x = _channel_mix(lp, x, xn2, _shift(xn2))
            cache["wkv"][i] = state
            cache["shift_t"][i] = xn[:, -1]
            cache["shift_c"][i] = xn2[:, -1]
        logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
        cache["pos"] = torch.tensor(s, dtype=torch.int64, device=x.device)
        return logits, cache

    def _decode_layer(self, lp, x: torch.Tensor, wkv: torch.Tensor,
                      shift_t: torch.Tensor, shift_c: torch.Tensor):
        """One token x (B, D) through one layer against its cache rows ->
        (x, new wkv state, new shift_t, new shift_c)."""
        cfg = self.cfg
        b, d = x.shape
        xn = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"], cfg.norm_eps)
        r, k, v, g, log_w = _time_mix_inputs(
            lp, xn[:, None], shift_t.to(xn.dtype)[:, None], cfg)
        y, state = wkv6_decode_step(wkv, r[:, 0], k[:, 0], v[:, 0],
                                    log_w[:, 0], lp["u"])
        y = _group_norm_heads(y.reshape(b, 1, d), lp["ln_x"]["scale"],
                              lp["ln_x"]["bias"], d // cfg.rwkv_head_dim,
                              cfg.norm_eps)
        x = x + (y.to(x.dtype) * g)[:, 0] @ lp["wo"]
        xn2 = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                         cfg.norm_eps)
        x = _channel_mix(lp, x, xn2, shift_c.to(xn2.dtype))
        return x, state, xn, xn2

    @torch.no_grad()
    def decode(self, params, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """Decode tokens (B, 1) -> (logits (B, V), new cache).

        The state leaves are written in place, every slot's, and returned
        as the same tensors; as in the reference (``rwkv6.py:343-346``)
        only ``pos`` is frozen where ``active`` is False: a free slot's
        state is never read, since an insert overwrites it.  ``active`` and
        a paged state's ``page_table`` pass through unchanged.
        """
        cfg = self.cfg
        x = self._embed(params, tokens)[:, 0]
        for i, lp in enumerate(params["layers"]):
            x, state, xn, xn2 = self._decode_layer(
                lp, x, cache["wkv"][i], cache["shift_t"][i],
                cache["shift_c"][i])
            cache["wkv"][i] = state
            cache["shift_t"][i] = xn
            cache["shift_c"][i] = xn2
        logits = _logits(params, x[:, None, :], cfg)[:, 0]
        out = dict(cache)
        out["pos"] = advance_pos(cache["pos"], tokens.shape[1],
                                 cache.get("active"))
        return logits, out
