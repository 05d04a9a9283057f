"""The default optimizer chain: optax-shaped gradient transforms on torch
tensors (copy of ``repro/optim/transforms.py:46-177, 337-377, 411-461``).

A :class:`GradientTransform` is an ``init(params) -> state`` /
``update(updates, state, params, hyper) -> (updates, state, telemetry)``
pair; ``hyper`` carries the runtime scalars (``lr``, ``clip_scale``).  The
chain produces the quantity subtracted from the params.  The default chain

    clip_global_norm -> scale_by_adam -> add_decayed_weights -> scale_by_lr

is the only one ported: SM3, Shampoo, adaptive gradient clipping, per-leaf
LR scales and per-leaf telemetry raise "not ported yet".  Chain state is a
dict keyed by transform name (``{"clip": {}, "adam": {"m", "v", "count"},
"decay": {}, "lr": {}}``), ``m`` and ``v`` shaped like the params, so a
reference state maps onto it leaf for leaf (``repro_torch.bridge``).

Params are nested dicts and lists of tensors (the port keeps ``layers`` as
a list of per-layer dicts).  Updates run as ``torch._foreach_*`` ops over
the leaves, and the Adam moments and the params are updated in place: the
reference donates those buffers to its jitted step.  Telemetry stays on the
device as 0-dim tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.stability import momentum_stats, variance_stats

Hyper = Dict[str, Any]
Telemetry = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# trees: nested dicts (sorted keys, as jax.tree_util) and lists of tensors
# ---------------------------------------------------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree shaped like ``like`` with ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class GradientTransform(NamedTuple):
    """One chain link."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Hyper], Tuple[Any, Any, Telemetry]]


def chain(*transforms: GradientTransform) -> GradientTransform:
    """Compose transforms left to right; state is keyed by transform name."""
    names = [t.name for t in transforms]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate transform names in chain: {names}")

    def init(params):
        return {t.name: t.init(params) for t in transforms}

    def update(updates, state, params, hyper):
        new_state, telemetry = {}, {}
        for t in transforms:
            updates, st, tel = t.update(updates, state[t.name], params, hyper)
            new_state[t.name] = st
            telemetry.update(tel)
        return updates, new_state, telemetry

    return GradientTransform("chain", init, update)


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """``p - u``, in place on the params' storage; returns ``params``."""
    torch._foreach_sub_(tree_leaves(params), tree_leaves(updates))
    return params


def _no_state(params):
    return {}


def clip_global_norm(max_norm: float) -> GradientTransform:
    """fp32, measure the global norm, clip to ``max_norm *
    hyper["clip_scale"]`` (``max_norm <= 0`` measures only), in place on
    fp32 updates.  Telemetry: ``grad_norm`` is the raw pre-clip norm,
    ``grad_norm_clipped`` the post-clip one."""

    def update(updates, state, params, hyper):
        leaves = [g.float() for g in tree_leaves(updates)]
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(leaves, 2)))
        if max_norm > 0:
            limit = max_norm * hyper["clip_scale"]
            scale = torch.clamp(limit / gnorm.clamp_min(1e-12), max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        torch._foreach_mul_(leaves, scale)
        return (tree_unflatten(updates, leaves), state,
                {"grad_norm": gnorm, "grad_norm_clipped": gnorm * scale})

    return GradientTransform("clip", _no_state, update)


def scale_by_adam(cfg: OptimizerConfig) -> GradientTransform:
    """Adam: m/v EMAs, bias correction, ``mhat / (sqrt(vhat) + eps)``, and
    the paper's variance telemetry on the new v and m."""
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        leaves = tree_leaves(params)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device)}

    def update(updates, state, params, hyper):
        count = state["count"] + 1
        cf = count.float()
        bc1 = 1.0 - b1 ** cf
        bc2 = 1.0 - b2 ** cf
        g = tree_leaves(updates)
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(g, g), alpha=1.0 - b2)
        # one temporary the size of the params at a time besides the output
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(m, bc1)
        torch._foreach_div_(out, denom)
        del denom
        tel = {**variance_stats(v), **momentum_stats(m)}
        new_state = {"m": state["m"], "v": state["v"], "count": count}
        return tree_unflatten(updates, out), new_state, tel

    return GradientTransform("adam", init, update)


def decay_mask_tree(params: Any, mode: str) -> Any:
    """Which leaves get weight decay.  ``all``: every leaf.  ``std``: a
    leaf decays when at least two of its dims have size > 1 (matrices, not
    biases or norm gains).  The reference strips the scan axis of its
    stacked ``layers`` leaves first (``transforms.py:352-358``); the port's
    per-layer leaves have no such axis, so a bias is ``(d,)`` on both
    sides of the count and gets the same mask."""
    if mode == "all":
        return tree_map(lambda p: True, params)
    if mode != "std":
        raise ValueError(f"unknown decay_mask {mode!r} (all | std)")
    return tree_map(lambda p: sum(d > 1 for d in p.shape) >= 2, params)


def add_decayed_weights(weight_decay: float,
                        mask_mode: str = "all") -> GradientTransform:
    """``u + weight_decay * p`` on masked leaves (decoupled decay, before
    the LR scale), in place on the updates."""

    def update(updates, state, params, hyper):
        if weight_decay == 0.0:
            return updates, state, {}
        pairs = [(u, p) for u, p, m in zip(
            tree_leaves(updates), tree_leaves(params),
            tree_leaves(decay_mask_tree(params, mask_mode))) if m]
        if pairs:
            us, ps = zip(*pairs)
            torch._foreach_add_(list(us), list(ps), alpha=weight_decay)
        return updates, state, {}

    return GradientTransform("decay", _no_state, update)


def scale_by_lr() -> GradientTransform:
    """Final LR scale, in place on the updates."""

    def update(updates, state, params, hyper):
        torch._foreach_mul_(tree_leaves(updates), hyper["lr"])
        return updates, state, {}

    return GradientTransform("lr", _no_state, update)


def build_optimizer(cfg: OptimizerConfig) -> GradientTransform:
    """The default chain an :class:`OptimizerConfig` describes; options
    the port has not taken over yet raise."""
    refused = {"optimizer": cfg.optimizer != "adamw",
               "agc_clip": cfg.agc_clip > 0, "lr_scales": bool(cfg.lr_scales),
               "telemetry_level": cfg.telemetry_level != "scalar"}
    for name, on in refused.items():
        if on:
            raise NotImplementedError(
                f"OptimizerConfig.{name}={getattr(cfg, name)!r} is not "
                f"ported yet (the port runs the default AdamW chain)")
    return chain(clip_global_norm(cfg.grad_clip), scale_by_adam(cfg),
                 add_decayed_weights(cfg.weight_decay, cfg.decay_mask),
                 scale_by_lr())
