"""Plain PyTorch reference of the decoder-only transformers the benchmark
trains: the GPT-2 family (learned positions, LayerNorm, tanh-GELU MLP, tied
embeddings) and the fine-grained MoE family (rope, RMSNorm, shared plus
top-k routed SwiGLU experts into a per-row capacity buffer).

fp32 throughout, written from the architectures' definitions with no kernel,
cache or batching trick.  It imports nothing of the program under test and
reads only a configuration's ``model`` dict.  Parameters are stacked over the
layers (``layers.attn.wq`` has shape (L, d, H, D)); :func:`param_groups`
declares every group, its per-layer shape and its draw, and the benchmark
draws the same numbers for the program and for this reference.

Departures from a straight transcription, each with its reason:

* Every block runs under ``torch.utils.checkpoint``, so that the backward
  of a full-width model at the timed batch fits beside the optimizer state.
  Recomputation replays the same operations; the result is unchanged.
* The experts run one at a time over the token rows routed to them
  (``index_add_`` back into the output), in place of capacity buffers.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as tcp

NEG_MASK = -1e9  # logit of a padded vocabulary column


class Group(NamedTuple):
    """One parameter group: ``shape`` is per layer when ``layered``."""

    name: str
    shape: Tuple[int, ...]
    init: str  # normal | ones | zeros
    scale: float
    layered: bool


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def is_moe(m: Dict) -> bool:
    return m["family"] == "moe"


def param_groups(m: Dict) -> List[Group]:
    """Every parameter group, in a fixed order (the order of the draws)."""
    d, h, kv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], head_dim(m)
    f, pv = m["d_ff"], padded_vocab(m)
    s_d = 1.0 / math.sqrt(d)
    layernorm = m.get("norm", "rmsnorm") == "layernorm"
    out: List[Group] = [Group("embed", (pv, d), "normal", 0.02, False)]
    if m.get("pos_emb", "rope") == "learned":
        out.append(Group("pos_embed", (m["max_seq_len"], d), "normal",
                         0.02, False))
    if not m.get("tie_embeddings", False):
        out.append(Group("lm_head", (d, pv), "normal", s_d, False))
    out.append(Group("final_norm.scale", (d,), "ones", 1.0, False))
    if layernorm:
        out.append(Group("final_norm.bias", (d,), "zeros", 0.0, False))
    for ln in ("ln1", "ln2"):
        out.append(Group(f"layers.{ln}.scale", (d,), "ones", 1.0, True))
        if layernorm:
            out.append(Group(f"layers.{ln}.bias", (d,), "zeros", 0.0, True))
    out += [Group("layers.attn.wq", (d, h, hd), "normal", s_d, True),
            Group("layers.attn.wk", (d, kv, hd), "normal", s_d, True),
            Group("layers.attn.wv", (d, kv, hd), "normal", s_d, True),
            Group("layers.attn.wo", (h, hd, d), "normal",
                  1.0 / math.sqrt(h * hd), True)]
    if is_moe(m):
        e = m["n_experts"]
        out += [Group("layers.moe.router", (d, e), "normal", s_d, True),
                Group("layers.moe.w_gate", (e, d, f), "normal", s_d, True),
                Group("layers.moe.w_up", (e, d, f), "normal", s_d, True),
                Group("layers.moe.w_down", (e, f, d), "normal",
                      1.0 / math.sqrt(f), True)]
        if m.get("n_shared_experts", 0):
            fs = f * m["n_shared_experts"]
            out += [Group("layers.moe.shared.w_gate", (d, fs), "normal",
                          s_d, True),
                    Group("layers.moe.shared.w_up", (d, fs), "normal",
                          s_d, True),
                    Group("layers.moe.shared.w_down", (fs, d), "normal",
                          1.0 / math.sqrt(fs), True)]
    elif m.get("mlp", "swiglu") == "gelu":
        out += [Group("layers.mlp.w_up", (d, f), "normal", s_d, True),
                Group("layers.mlp.b_up", (f,), "zeros", 0.0, True),
                Group("layers.mlp.w_down", (f, d), "normal",
                      1.0 / math.sqrt(f), True),
                Group("layers.mlp.b_down", (d,), "zeros", 0.0, True)]
    else:
        out += [Group("layers.mlp.w_gate", (d, f), "normal", s_d, True),
                Group("layers.mlp.w_up", (d, f), "normal", s_d, True),
                Group("layers.mlp.w_down", (f, d), "normal",
                      1.0 / math.sqrt(f), True)]
    return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict
         ) -> torch.Tensor:
    eps = m.get("norm_eps", 1e-5)
    if "bias" in p:  # LayerNorm, population variance
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


def rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0 .. S-1 on x (B, S, H, D), rotate-half pairing
    (channel i with channel i + D/2)."""
    s, dd = x.shape[1], x.shape[-1]
    half = dd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def attention(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict
              ) -> torch.Tensor:
    """Causal softmax attention over the whole (S, S) square."""
    b, s, d = x.shape
    h, kv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    q = (x @ p["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = (x @ p["wk"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].reshape(d, kv * hd)).reshape(b, s, kv, hd)
    if m.get("pos_emb", "rope") == "rope":
        theta = float(m.get("rope_theta", 10000.0))
        q, k = rotate(q, theta), rotate(k, theta)
    if kv != h:  # query head i reads kv head i // (h / kv)
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return ctx.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


def capacity(tokens: int, m: Dict) -> int:
    """Slots of each expert for a row of ``tokens`` tokens."""
    return max(1, int(math.ceil(tokens * m["top_k"] / m["n_experts"]
                                * m["capacity_factor"])))


def moe(x: torch.Tensor, p: Dict[str, torch.Tensor], m: Dict
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared plus routed experts -> (y, load-balance loss, router z-loss).

    Each token takes its ``top_k`` most probable experts, largest first;
    their probabilities, renormalised to sum to one, weight the experts'
    outputs.  Within a batch row, assignments are ranked in token order
    (token t's j-th choice is assignment t * k + j), and an assignment whose
    rank among its expert's assignments reaches the capacity is dropped.
    """
    b, s, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    c = capacity(s, m)
    logits = x @ p["router"]  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    gate = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(b, s * k)
    chosen = F.one_hot(flat_e, e)  # (B, S*k, E)
    rank = (chosen.cumsum(dim=1) * chosen).sum(-1) - 1  # (B, S*k)
    kept = rank < c
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    token = (rows * s + torch.arange(s * k, device=x.device) // k)
    xs = x.reshape(b * s, d)
    y = torch.zeros_like(xs)
    g_flat = gate.reshape(b, s * k)
    for ex in range(e):
        sel = kept & (flat_e == ex)
        tok = token[sel]
        if tok.numel() == 0:
            continue
        out = swiglu(xs[tok], p["w_gate"][ex], p["w_up"][ex],
                     p["w_down"][ex])
        y = y.index_add(0, tok, out * g_flat[sel][:, None])
    y = y.reshape(b, s, d)
    if m.get("n_shared_experts", 0):
        y = y + swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                       p["shared.w_down"])
    mean_prob = probs.reshape(-1, e).mean(0)
    share = chosen.reshape(-1, e).sum(0).float() / (b * s * k)
    load_balance = e * (mean_prob * share).sum()
    router_z = torch.logsumexp(logits, dim=-1).square().mean()
    return y, load_balance, router_z


def block(x: torch.Tensor, lp: Dict[str, torch.Tensor], m: Dict):
    """One pre-norm block -> (x, load balance, router z) (zeros for a
    dense block)."""
    sub = lambda prefix: {k[len(prefix):]: v for k, v in lp.items()
                          if k.startswith(prefix)}
    x = x + attention(norm(x, sub("ln1."), m), sub("attn."), m)
    h = norm(x, sub("ln2."), m)
    if is_moe(m):
        y, lb, z = moe(h, sub("moe."), m)
    else:
        zero = torch.zeros((), device=x.device)
        y, lb, z = gelu_mlp(h, sub("mlp.")), zero, zero
    return x + y, lb, z


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, m: Dict
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objective, mean next-token cross-entropy) of a batch (B, S).

    The objective adds the MoE auxiliary losses, each averaged over the
    layers and weighted by ``router_aux_coef`` and ``router_z_coef``."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    if "pos_embed" in params:
        x = x + params["pos_embed"][:s]
    layered = [name for name in params if name.startswith("layers.")]
    lbs, zs = [], []
    for i in range(m["n_layers"]):
        lp = {name[len("layers."):]: params[name][i] for name in layered}
        x, lb, z = tcp.checkpoint(block, x, lp, m, use_reentrant=False)
        lbs.append(lb)
        zs.append(z)
    x = norm(x, {"scale": params["final_norm.scale"],
                 **({"bias": params["final_norm.bias"]}
                    if "final_norm.bias" in params else {})}, m)
    head = (params["lm_head"] if "lm_head" in params
            else params["embed"].t())
    logits = x @ head  # (B, S, padded vocab)
    pad = torch.arange(logits.shape[-1], device=x.device) >= m["vocab_size"]
    logits = logits.masked_fill(pad, NEG_MASK)
    ce = F.cross_entropy(logits.reshape(b * s, -1), labels.reshape(-1))
    total = ce
    if is_moe(m):
        total = (ce + m["router_aux_coef"] * torch.stack(lbs).mean()
                 + m["router_z_coef"] * torch.stack(zs).mean())
    return total, ce.detach()


def leaf_names(m: Dict) -> List[str]:
    """The program's per-layer leaf paths (``layers.3.attn.wq``) and the
    top-level ones (``final_norm.scale``), in group order."""
    out = []
    for g in param_groups(m):
        if g.layered:
            rest = g.name[len("layers."):]
            out += [f"layers.{i}.{rest}" for i in range(m["n_layers"])]
        else:
            out.append(g.name)
    return out

