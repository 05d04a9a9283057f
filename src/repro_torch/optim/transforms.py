"""The optimizer chain: optax-shaped gradient transforms on torch tensors
(copy of ``repro/optim/transforms.py:46-471``).

A :class:`GradientTransform` is an ``init(params) -> state`` /
``update(updates, state, params, hyper) -> (updates, state, telemetry)``
pair; ``hyper`` carries the runtime scalars (``lr``, ``clip_scale``) and,
optionally, the ``(n_leaves,)`` vector ``leaf_lr_scale``.  The chain
produces the quantity subtracted from the params.  The default chain

    clip_global_norm -> scale_by_adam -> add_decayed_weights -> scale_by_lr

reproduces the reference's; :func:`build_optimizer` also builds SM3,
Shampoo grafted onto Adam, adaptive gradient clipping, per-leaf LR scales
and per-leaf telemetry.  Chain state is a dict keyed by transform name.
State shaped like the params (Adam's ``m`` and ``v``, SM3's momentum) is
kept in the port's layout, so it maps onto the reference's leaf for leaf
(``repro_torch.bridge``).  State the reference keeps per stacked leaf
(SM3's accumulators, Shampoo's statistics) couples the layers of a group,
so it is kept in the reference's stacked shapes, one entry per label of
``repro_torch.core.telemetry.leaf_groups``.

Every per-leaf quantity (AGC's norms, the per-leaf LR, the telemetry
vectors) is per group of that map, as the reference's is per stacked
leaf.  Params are nested dicts and lists of tensors (the port keeps
``layers`` as a list of per-layer dicts).  Updates run as
``torch._foreach_*`` ops over the leaves, and the Adam moments and the
params are updated in place: the reference donates those buffers to its
jitted step.  Telemetry stays on the device.

:func:`optimizer_step` runs a chain and updates the params.  The default
AdamW chain (clip -> adam -> decay -> lr, no AGC, ``lr_scales`` or per-leaf
telemetry) has a fused route beside its links: on CUDA leaves it updates
the params in place in one kernel pass (``kernels/fused_adamw``), and
raises for leaves that are not plain fp32 tensors of one card; off the
card the chain itself, its plain version, runs.  A step that trains
DTensors (``launch/steps.py`` under sharding rules) drops the route
(``fused=None``) and runs the chain.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import trace
from repro_torch.core.stability import momentum_stats, variance_stats
from repro_torch.core.telemetry import (leaf_groups, leaf_norms,
                                        leaf_sq_norms, leaf_var_max)
from repro_torch.kernels import fused_adamw as kernel

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
    """One chain link.  ``fused(grads, state, params, hyper)``, where a
    chain has one, does ``update`` and the params' update in one in-place
    pass and returns ``(state, telemetry)``, or None for leaves it does not
    take (then ``update`` runs)."""

    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Hyper], Tuple[Any, Any, Telemetry]]
    fused: Optional[Callable[[Any, Any, Any, Hyper],
                             Optional[Tuple[Any, Telemetry]]]] = None


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


@torch.no_grad()
def optimizer_step(tx: GradientTransform, grads: Any, state: Any,
                   params: Any, hyper: Hyper) -> Tuple[Any, Any, Telemetry]:
    """One step of ``tx`` on ``grads``, the params updated in place:
    ``(params, state, telemetry)``: ``tx.fused`` where the chain has a fused
    route that takes the leaves, else ``update`` and :func:`apply_updates`.
    Counts, while the tracer records, the parameter elements updated
    (``optim.params``) and those the fused route updated (``optim.fused``)."""
    n = sum(p.numel() for p in tree_leaves(params)) if trace.enabled() else 0
    trace.count("optim.params", n)
    got = tx.fused(grads, state, params, hyper) if tx.fused else None
    if got is not None:
        trace.count("optim.fused", n)
        return (params, *got)
    updates, state, telemetry = tx.update(grads, state, params, hyper)
    return apply_updates(params, updates), state, telemetry


def abstract_chain_state(tx: GradientTransform, params_shapes: Any) -> Any:
    """The chain state's tree of ``meta`` tensors (shapes and dtypes, no
    storage) for params shaped like ``params_shapes``
    (``transforms.py:80``)."""
    return tx.init(tree_map(
        lambda p: torch.empty(tuple(p.shape), device="meta"), params_shapes))


def _no_state(params):
    return {}


def _zeros_like_tree(tree: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _peaks(tensors: List[torch.Tensor]) -> torch.Tensor:
    """(n,) max of sqrt(x) of each tensor (x >= 0)."""
    return torch.sqrt(torch.stack(torch._foreach_norm(tensors, math.inf)))


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------

def clip_global_norm(max_norm: float,
                     per_leaf_telemetry: bool = False) -> GradientTransform:
    """fp32, measure the global norm, clip to ``max_norm *
    hyper["clip_scale"]`` (``max_norm <= 0`` measures only), in place on
    fp32 updates.  Telemetry: ``grad_norm`` is the raw pre-clip norm,
    ``grad_norm_clipped`` the post-clip one; per leaf, ``leaf_grad_norm``
    the raw norm of each group."""

    def update(updates, state, params, hyper):
        leaves = [g.float() for g in tree_leaves(updates)]
        norms = torch.stack(torch._foreach_norm(leaves, 2))
        gnorm = torch.linalg.vector_norm(norms)
        if max_norm > 0:
            limit = max_norm * hyper["clip_scale"]
            scale = torch.clamp(limit / gnorm.clamp_min(1e-12), max=1.0)
        else:
            scale = torch.ones((), device=gnorm.device)
        torch._foreach_mul_(leaves, scale)
        tel = {"grad_norm": gnorm, "grad_norm_clipped": gnorm * scale}
        if per_leaf_telemetry:
            tel["leaf_grad_norm"] = torch.sqrt(
                leaf_groups(updates).reduce(norms * norms, "sum"))
        return tree_unflatten(updates, leaves), state, tel

    return GradientTransform("clip", _no_state, update)


def adaptive_grad_clip(clipping: float,
                       eps: float = 1e-3) -> GradientTransform:
    """AGC (Brock et al.): clip each group's grad-norm / param-norm ratio
    at ``clipping`` (``transforms.py:128``), in place on the updates.  The
    norms, and the factor they give, are per group, as the reference's are
    per stacked leaf."""

    def update(updates, state, params, hyper):
        groups = leaf_groups(params)
        pn = torch.sqrt(leaf_sq_norms(tree_leaves(params), groups))
        leaves = tree_leaves(updates)
        gn = torch.sqrt(leaf_sq_norms(leaves, groups))
        limit = clipping * pn.clamp_min(eps)
        factor = torch.clamp(limit / gn.clamp_min(1e-6), max=1.0)
        torch._foreach_mul_(leaves, groups.expand(factor))
        return updates, state, {}

    return GradientTransform("agc", _no_state, update)


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

def scale_by_adam(cfg: OptimizerConfig,
                  per_leaf_telemetry: bool = False) -> GradientTransform:
    """Adam: m/v EMAs, bias correction, ``mhat / (sqrt(vhat) + eps)``, and
    the paper's variance telemetry on the new v and m (per group too:
    ``leaf_var_max``)."""
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps

    def init(params):
        return {"m": _zeros_like_tree(params), "v": _zeros_like_tree(params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}

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
        if per_leaf_telemetry:
            tel["leaf_var_max"] = leaf_var_max(state["v"])
        new_state = {"m": state["m"], "v": state["v"], "count": count}
        return tree_unflatten(updates, out), new_state, tel

    return GradientTransform("adam", init, update)


def _sm3_accs(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor, ...]:
    """One accumulator per axis of a stacked leaf, each of its shape with
    every other axis 1 (``transforms.py:189-195``)."""
    if not shape:
        return (torch.zeros((), device=device),)
    return tuple(torch.zeros(tuple(d if i == axis else 1
                                   for i, d in enumerate(shape)),
                             device=device)
                 for axis in range(len(shape)))


def scale_by_sm3(cfg: OptimizerConfig,
                 per_leaf_telemetry: bool = False) -> GradientTransform:
    """SM3 (Anil et al., ``transforms.py:179``): per-axis max accumulators
    instead of a full second moment, with optional heavy-ball momentum on
    the preconditioned update.  The accumulators are those of the
    reference's stacked leaf: the one of axis 0 is per layer, and those of
    the other axes take the max over the layers too, so each group is
    stacked, preconditioned and unstacked.  The variance telemetry reduces
    the estimated second moment ``nu``."""
    b1, eps = cfg.sm3_momentum, cfg.eps

    def init(params):
        groups, leaves = leaf_groups(params), tree_leaves(params)
        st = {"acc": tuple(
            _sm3_accs(groups.stacked_shape(leaves, g), leaves[0].device)
            for g in range(len(groups.labels)))}
        if b1 > 0:
            st["m"] = _zeros_like_tree(params)
        return st

    def update(updates, state, params, hyper):
        groups, leaves = leaf_groups(updates), tree_leaves(updates)
        outs: List[Optional[torch.Tensor]] = [None] * len(leaves)
        new_accs, nus = [], []
        for g, (accs, members) in enumerate(zip(state["acc"],
                                                groups.gather(leaves))):
            x = groups.stack(members, g)
            est = accs[0]
            for a in accs[1:]:
                est = torch.minimum(est, a)
            nu = est + x * x
            new_accs.append(tuple(
                nu.amax(dim=tuple(i for i in range(x.ndim) if i != axis),
                        keepdim=True) if x.ndim > 1 else nu
                for axis in range(max(x.ndim, 1))))
            nus.append(nu)
            for i, o in zip(groups.members[g],
                            groups.unstack(x / (torch.sqrt(nu) + eps), g)):
                outs[i] = o
        new_state = {"acc": tuple(new_accs)}
        tel = variance_stats(nus)
        if b1 > 0:
            m = tree_leaves(state["m"])
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, outs, alpha=1.0 - b1)
            new_state["m"] = state["m"]
            outs = [t.clone() for t in m]
            tel.update(momentum_stats(m))
        if per_leaf_telemetry:
            tel["leaf_var_max"] = _peaks(nus)
        return tree_unflatten(updates, outs), new_state, tel

    return GradientTransform("sm3", init, update)


def _inv_pth_root(s: torch.Tensor, p: float, eps: float) -> torch.Tensor:
    """Symmetric inverse p-th root by eigendecomposition, fp32, batched
    over the leading dim (``transforms.py:239``)."""
    n = s.shape[-1]
    w, v = torch.linalg.eigh(s + eps * torch.eye(n, dtype=s.dtype,
                                                 device=s.device))
    w = w.clamp_min(eps) ** (-1.0 / p)
    return (v * w.unsqueeze(-2)) @ v.transpose(-1, -2)


def scale_by_shampoo(cfg: OptimizerConfig,
                     per_leaf_telemetry: bool = False) -> GradientTransform:
    """Shampoo-style block-diagonal preconditioning grafted onto the Adam
    update magnitude (``transforms.py:248``).  Each eligible stacked leaf
    (ndim >= 2, last two dims <= ``shampoo_block_size``) is a stack of
    (rows, cols) blocks over its leading dims, with decayed L/R statistics
    and inverse-4th-root preconditioners refreshed every
    ``shampoo_interval`` steps of the shared Adam count; each block's
    preconditioned direction is rescaled to the norm of its Adam update.
    Ineligible leaves take the Adam update.  ``stats`` is one entry per
    group in the reference's stacked layout, ``None`` where ineligible.
    The refresh decision reads the Adam count on the host, one sync a
    step."""
    adam = scale_by_adam(cfg, per_leaf_telemetry=per_leaf_telemetry)
    beta, eps = cfg.beta2, cfg.shampoo_eps
    block, interval = cfg.shampoo_block_size, max(cfg.shampoo_interval, 1)

    def leaf_stats(shape, device):
        if len(shape) < 2 or shape[-2] > block or shape[-1] > block:
            return None
        lead = math.prod(shape[:-2])
        r, c = shape[-2], shape[-1]
        eye = lambda n: torch.eye(n, device=device).expand(lead, n, n).clone()
        return {"l": torch.zeros((lead, r, r), device=device),
                "r": torch.zeros((lead, c, c), device=device),
                "pl": eye(r), "pr": eye(c)}

    def init(params):
        groups, leaves = leaf_groups(params), tree_leaves(params)
        return {"adam": adam.init(params),
                "stats": tuple(leaf_stats(groups.stacked_shape(leaves, g),
                                          leaves[0].device)
                               for g in range(len(groups.labels)))}

    def update(updates, state, params, hyper):
        groups = leaf_groups(updates)
        g_members = groups.gather(tree_leaves(updates))
        adam_u, adam_state, tel = adam.update(updates, state["adam"],
                                              params, hyper)
        count = adam_state["count"]
        stale = (count - 1) % interval
        recompute = int(stale) == 0
        outs = tree_leaves(adam_u)
        new_stats = []
        for g, st in enumerate(state["stats"]):
            if st is None:
                new_stats.append(None)
                continue
            x = groups.stack(g_members[g], g)
            shape = x.shape
            gb = x.reshape((-1,) + tuple(shape[-2:]))
            l_new = beta * st["l"] + (1.0 - beta) * (gb @ gb.transpose(1, 2))
            r_new = beta * st["r"] + (1.0 - beta) * (gb.transpose(1, 2) @ gb)
            pl = _inv_pth_root(l_new, 4.0, eps) if recompute else st["pl"]
            pr = _inv_pth_root(r_new, 4.0, eps) if recompute else st["pr"]
            precond = pl @ gb @ pr
            ab = groups.stack([outs[i] for i in groups.members[g]], g)
            ab = ab.reshape(gb.shape)
            a_norm = torch.sqrt(torch.sum(ab * ab, dim=(-2, -1),
                                          keepdim=True))
            p_norm = torch.sqrt(torch.sum(precond * precond, dim=(-2, -1),
                                          keepdim=True))
            grafted = precond * (a_norm / p_norm.clamp_min(1e-16))
            new_stats.append({"l": l_new, "r": r_new, "pl": pl, "pr": pr})
            for i, o in zip(groups.members[g],
                            groups.unstack(grafted.reshape(shape), g)):
                outs[i] = o
        # steps since the last eigh refresh: one scalar for every block,
        # since the refresh keys off the shared Adam count
        tel = dict(tel, shampoo_staleness=stale.float())
        return (tree_unflatten(updates, outs),
                {"adam": adam_state, "stats": tuple(new_stats)}, tel)

    return GradientTransform("shampoo", init, update)


# ---------------------------------------------------------------------------
# decay / scaling / telemetry tails
# ---------------------------------------------------------------------------

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


def scale_per_leaf(lr_scales: Tuple[Tuple[str, float], ...]
                   ) -> GradientTransform:
    """Per-leaf LR scaling (``transforms.py:379``): each ``(pattern,
    factor)`` multiplies the update of every group whose reference label
    contains ``pattern`` (factors compose when several match)."""

    def update(updates, state, params, hyper):
        groups = leaf_groups(updates)
        leaves = tree_leaves(updates)
        for label, members in zip(groups.labels, groups.members):
            factor = 1.0
            for pattern, f in lr_scales:
                if pattern in label:
                    factor *= f
            if factor != 1.0:
                torch._foreach_mul_([leaves[i] for i in members], factor)
        return updates, state, {}

    return GradientTransform("leaf_lr", _no_state, update)


def per_leaf_update_telemetry() -> GradientTransform:
    """Final-update and param norms per group (after decay, before the LR
    scale: the step direction's magnitude), ``transforms.py:400``."""

    def update(updates, state, params, hyper):
        return updates, state, {"leaf_update_norm": leaf_norms(updates),
                                "leaf_param_norm": leaf_norms(params)}

    return GradientTransform("leaf_tel", _no_state, update)


def scale_by_lr() -> GradientTransform:
    """Final LR scale, in place on the updates.  ``hyper["leaf_lr_scale"]``,
    when given, is a ``(n_leaves,)`` vector in the reference's leaf order
    whose entry ``i`` also multiplies every member of group ``i``
    (``transforms.py:411``)."""

    def update(updates, state, params, hyper):
        leaves = tree_leaves(updates)
        scales = hyper.get("leaf_lr_scale")
        if scales is None:
            torch._foreach_mul_(leaves, hyper["lr"])
        else:
            factor = hyper["lr"] * scales.to(leaves[0].dtype)
            torch._foreach_mul_(leaves,
                                leaf_groups(updates).expand(factor))
        return updates, state, {}

    return GradientTransform("lr", _no_state, update)


def build_optimizer(cfg: OptimizerConfig) -> GradientTransform:
    """The chain an :class:`OptimizerConfig` describes
    (``transforms.py:437``); with default fields, the AdamW chain."""
    per_leaf = cfg.telemetry_level == "per_leaf"
    ts: List[GradientTransform] = [
        clip_global_norm(cfg.grad_clip, per_leaf_telemetry=per_leaf)]
    if cfg.agc_clip > 0:
        ts.append(adaptive_grad_clip(cfg.agc_clip, cfg.agc_eps))
    if cfg.optimizer == "adamw":
        ts.append(scale_by_adam(cfg, per_leaf_telemetry=per_leaf))
    elif cfg.optimizer == "sm3":
        ts.append(scale_by_sm3(cfg, per_leaf_telemetry=per_leaf))
    elif cfg.optimizer == "shampoo":
        ts.append(scale_by_shampoo(cfg, per_leaf_telemetry=per_leaf))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r} "
                         f"(adamw | sm3 | shampoo)")
    ts.append(add_decayed_weights(cfg.weight_decay, cfg.decay_mask))
    if cfg.lr_scales:
        ts.append(scale_per_leaf(cfg.lr_scales))
    if per_leaf:
        ts.append(per_leaf_update_telemetry())
    ts.append(scale_by_lr())
    tx = chain(*ts)
    if (cfg.optimizer == "adamw" and cfg.agc_clip <= 0 and not cfg.lr_scales
            and not per_leaf):
        tx = tx._replace(fused=fused_adamw_step(cfg))
    return tx


def _plain_f32(t: Any, device: torch.device) -> bool:
    """A float32 tensor on ``device`` that is no tensor subclass (a DTensor
    or a fake tensor is one)."""
    return (type(t) is torch.Tensor and t.dtype == torch.float32
            and t.device == device)


def fused_adamw_step(cfg: OptimizerConfig) -> Callable:
    """The fused route of the default AdamW chain of ``cfg`` (see
    :class:`GradientTransform`): on CUDA leaves the kernel of
    ``kernels/fused_adamw`` (its leaf table built once a parameter set); it
    raises for CUDA leaves that are not plain fp32 tensors of one card, and
    takes no others (returns None: the chain runs).  The chain's state tree
    comes back with the same ``m`` and ``v`` tensors and a new ``count``,
    as the chain's does; the five telemetry scalars keep their names."""
    tables: List[Any] = [None]  # the last parameter set's table

    def step(grads, state, params, hyper):
        ps, gs = tree_leaves(params), tree_leaves(grads)
        dev = ps[0].device
        if dev.type != "cuda":
            return None
        adam = state["adam"]
        ms, vs = tree_leaves(adam["m"]), tree_leaves(adam["v"])
        bad = next((t for leaves in (ps, gs, ms, vs) for t in leaves
                    if not _plain_f32(t, dev)), None)
        if bad is not None:
            raise TypeError(
                f"the fused AdamW route takes plain float32 tensors on {dev}, "
                f"got a {type(bad).__name__} of {bad.dtype} on {bad.device}; "
                f"the chain without it (fused=None) takes any leaves")
        table = tables[0]
        if table is None or not table.holds(ps, ms, vs):
            decay = [cfg.weight_decay != 0.0 and d for d in
                     tree_leaves(decay_mask_tree(params, cfg.decay_mask))]
            table = tables[0] = kernel.LeafTable(
                ps, ms, vs, decay, leaf_groups(params).group_of)
        count, telemetry = kernel.fused_adamw(
            table, gs, adam["count"], lr=float(hyper["lr"]),
            clip=cfg.grad_clip > 0,
            limit=float(cfg.grad_clip * hyper["clip_scale"]),
            b1=cfg.beta1, b2=cfg.beta2, eps=cfg.eps,
            weight_decay=cfg.weight_decay,
            leaf_lr_scale=hyper.get("leaf_lr_scale"))
        torch.autograd.graph.increment_version(ps + ms + vs)
        return ({**state, "adam": {**adam, "count": count}}, telemetry)

    return step


def migrate_opt_state(opt: Dict[str, Any]) -> Dict[str, Any]:
    """Upgrade a legacy in-memory ``{"m", "v", "count"}`` opt state into the
    default chain's format (``{"clip": {}, "adam": {...}, "decay": {},
    "lr": {}}``).  Already-migrated states pass through unchanged."""
    if "m" in opt and "v" in opt and "count" in opt:
        return {"clip": {}, "adam": {"m": opt["m"], "v": opt["v"],
                                     "count": opt["count"]},
                "decay": {}, "lr": {}}
    return opt
