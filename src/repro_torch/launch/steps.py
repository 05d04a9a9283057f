"""Step builders and their sharding contract (``repro/launch/steps.py``):
the train, prefill and serve steps, the train state, and the shardings of
the state, the batch and the cache under logical-axis rules.

``make_train_step`` computes the loss and its gradient, runs the optimizer
chain with ``hyper = {"lr", "clip_scale"}`` and returns the new state and
``{**metrics, **telemetry, **gns, "lr"}``.  The reference jits the step and
donates the state; here the step runs eagerly and updates the params and
the Adam moments in place.

``grad_scale`` and ``leaf_lr`` are optional ``(n_leaves,)`` runtime
vectors in the reference's leaf order (``core.telemetry.leaf_groups``):
the first multiplies the raw gradients of each group before the chain (the
fault injector's hook), the second goes to the chain as
``hyper["leaf_lr_scale"]`` (the recovery controller's per-layer LR
backoff).  Without them, and without GNS, the step is the plain one.

With ``gns`` enabled the batch is viewed as ``k`` emulated data-parallel
shards (contiguous row groups).  The reference vmaps ``value_and_grad``
over them; the flash-attention, WKV-6 and SSD kernels are autograd
Functions with no vmap rule that take one batch, so here each shard runs
its own forward and ``torch.autograd.grad`` in turn.  A shard's per-group
``sum g^2`` is taken before its gradient is dropped, and ``sum tokens_i *
g_i`` accumulates in one params-sized buffer, divided by ``sum tokens_i``
at the end (the shard weights are token shares, known only after each
forward), so one accumulator and one shard's gradients are alive at a
time.  The full-batch gradient equals the reference's ``tensordot(w, g)``
up to fp32 summation order.

With ``rules`` (``distributed.sharding.ShardingRules`` on a
``DeviceMesh``) the step runs on DTensors: the state is placed by
:func:`train_state_shardings` (:func:`shard_train_state`), the batch by
:func:`batch_shardings`, and DTensor's sharding propagation stands in for
GSPMD.  Each gradient leaves autograd partial over the batch axes and is
redistributed to its parameter's placements (the FSDP reduce-scatter, or
the DP all-reduce of a replicated leaf) before the chain, so the clip's
global norm and the Adam-variance statistics reduce over every shard.
The step's metrics come back as plain tensors, whole on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNSConfig, ModelConfig, OptimizerConfig
from repro_torch.core import trace
from repro_torch.core.telemetry import LeafGroups, leaf_groups, leaf_sq_norms
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import (distribute_tensor, is_dtensor)
from repro_torch.models import model_zoo
from repro_torch.optim import transforms as optim_tx


def _gns_shard_count(gns: GNSConfig, batch_rows: int) -> int:
    """Realized emulated-replica count: the largest divisor of the step's
    rows that is <= the configured shard count (1: no GNS pair for this
    batch, e.g. one row or a prime row count above the shard count)."""
    for k in range(min(gns.shards, batch_rows), 1, -1):
        if batch_rows % k == 0:
            return k
    return 1


def gns_sketch(members: List[torch.Tensor], signs: torch.Tensor,
               d: int) -> torch.Tensor:
    """(d,) random-sign bucket sketch of one group's gradient
    (``steps.py:63-73``): the group flattened layer-major, as the
    reference's stacked leaf, padded to ``m * d`` (``m = ceil(n / d)``),
    multiplied by ``signs`` (length ``m * d``) and summed over ``d``
    contiguous buckets of ``m`` elements.  The buckets cross layer
    boundaries, as the reference's do.  A pure function of (gradient,
    signs, d); E[<s_t, s_u>] = <g_t, g_u> over the signs."""
    flat = torch.cat([g.float().reshape(-1) for g in members])
    m = -(-flat.numel() // d)
    flat = F.pad(flat, (0, m * d - flat.numel()))
    return torch.sum((flat * signs).reshape(d, m), dim=1)


class SketchSigns:
    """The per-group Rademacher signs of the sketch, fixed for the run.
    The reference draws them from ``jax.random.rademacher(fold_in(
    PRNGKey(sketch_seed), i))``, which torch cannot reproduce; here group
    ``i``'s come from a ``torch.Generator`` on the gradients' device
    seeded from ``(sketch_seed, i)``.  They are drawn at the first step
    and cached as int8 (one byte a parameter: 124 MB for gpt2-117m)."""

    def __init__(self, seed: int):
        self.seed = seed
        self._cache: Dict[int, torch.Tensor] = {}

    def __call__(self, i: int, n: int, device: torch.device) -> torch.Tensor:
        got = self._cache.get(i)
        if got is None or got.numel() != n or got.device != device:
            gen = torch.Generator(device=device).manual_seed(
                self.seed * 1_000_003 + i)
            got = torch.randint(0, 2, (n,), generator=gen, device=device,
                                dtype=torch.int8) * 2 - 1
            self._cache[i] = got
        return got


def loss_grads(loss: torch.Tensor,
               leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradient of ``loss`` for each leaf, zeros for a leaf the loss
    does not reach (an audio model's token table), as ``jax.grad``
    gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else _synced(g, p)
            for g, p in zip(grads, leaves)]


def _synced(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements: partial sums over
    the batch axes reduced (reduce-scatter where the parameter is sharded,
    all-reduce where it is replicated)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(x: Any) -> Any:
    """A DTensor metric as the whole plain tensor on every rank."""
    return x.full_tensor() if is_dtensor(x) else x


def _vector(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scale_grads(grads: List[torch.Tensor], grad_scale: Optional[Any],
                 groups: LeafGroups) -> None:
    if grad_scale is not None:
        torch._foreach_mul_(grads, groups.expand(
            _vector(grad_scale, grads[0].device)))


def _summed(name: str) -> bool:
    """Whether a metric sums over shards (the tokens, a tracer counter)
    rather than taking their token-weighted mean."""
    return name == "tokens" or name.startswith(trace.METRIC_PREFIX)


def sharded_grads(model, params, batch: Dict[str, torch.Tensor], k: int,
                  grad_scale: Optional[Any] = None,
                  groups: Optional[LeafGroups] = None,
                  axes: Optional[Any] = None):
    """``(grads, metrics, leaf_small)`` of ``k`` emulated shards of
    ``batch`` (contiguous row groups): the full-batch gradient (a list in
    ``tree_leaves`` order) and metrics as the token-weighted shard means
    (``tokens`` and the tracer's counters summed), and the per-group mean
    over the shards of ``sum g^2`` (``steps.py:92-124``).  ``grad_scale``
    multiplies each shard's gradient groups first, so the measurement sees
    what the chain sees.  ``axes`` (the params' logical axes) gathers
    sharded params for compute under the active rules."""
    leaves = optim_tx.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    groups = groups or leaf_groups(params)
    rows = next(iter(batch.values())).shape[0] // k
    acc = small = total = None
    sums: Dict[str, torch.Tensor] = {}
    for i in range(k):
        shard = {key: v[i * rows:(i + 1) * rows] for key, v in batch.items()}
        with trace.span("step.forward"):
            loss, metrics = model.loss(shd.gather_params(params, axes),
                                       shard)
        with trace.span("step.backward"):
            grads = loss_grads(loss, leaves)
        with torch.no_grad():
            _scale_grads(grads, grad_scale, groups)
            sq = leaf_sq_norms(grads, groups)
            small = sq if small is None else small + sq
            tok = metrics.get("tokens")
            w = (tok.detach().float() if tok is not None
                 else torch.ones((), device=loss.device))
            total = w if total is None else total + w
            torch._foreach_mul_(grads, w)
            if acc is None:
                acc = grads
            else:
                torch._foreach_add_(acc, grads)
            for name, v in metrics.items():
                v = v.detach() if torch.is_tensor(v) else v
                add = v if _summed(name) else w * v.float()
                sums[name] = add if name not in sums else sums[name] + add
        del grads, loss, metrics
    denom = total.clamp_min(1.0)
    torch._foreach_div_(acc, denom)
    out = {name: (v if _summed(name) else v / denom)
           for name, v in sums.items()}
    return acc, out, small / k


def make_train_step(model, opt_cfg: OptimizerConfig,
                    rules: Optional[shd.ShardingRules] = None,
                    optimizer: Optional[optim_tx.GradientTransform] = None,
                    gns: Optional[GNSConfig] = None,
                    sketch_signs: Optional[Callable] = None):
    """``train_step(state, batch, lr, clip_scale=1.0, grad_scale=None,
    leaf_lr=None) -> (state, metrics)``; ``batch`` holds tensors on the
    params' device.  The metrics are tensors on that device (0-dim, or the
    per-leaf vectors), ``lr`` and the GNS batch sizes floats.
    ``optimizer`` replaces the chain ``opt_cfg`` builds; ``rules`` shard
    the step (see the module's docstring: the state and batch are then
    DTensors placed by those rules, and the chain runs without its fused
    route).  ``sketch_signs(i, n, device)`` gives
    group ``i``'s ``n`` signs (default :class:`SketchSigns` of
    ``gns.sketch_seed``)."""
    if opt_cfg.grad_compression:
        raise NotImplementedError(
            "grad_compression: no train step syncs its gradients through "
            "optim.compression.compressed_allreduce yet")
    tx = optimizer if optimizer is not None else \
        optim_tx.build_optimizer(opt_cfg)
    if rules is not None:
        # the fused AdamW route takes plain tensors, not DTensors
        tx = tx._replace(fused=None)
    axes = model_zoo.param_axes(model.cfg) if rules is not None else None
    gns_cfg = gns if (gns is not None and gns.enabled) else None
    if gns_cfg is not None and gns_cfg.precursor_window > 0:
        sketch_dim = max(gns_cfg.precursor_dim, 1)
        signs_of = sketch_signs or SketchSigns(gns_cfg.sketch_seed)

    def train_step(state, batch, lr, clip_scale=1.0, grad_scale=None,
                   leaf_lr=None):
        with shd.use_rules(rules):
            new_state, out = _step(state, batch, lr, clip_scale, grad_scale,
                                   leaf_lr)
        if rules is not None:
            out = {k: _plain(v) for k, v in out.items()}
        return new_state, out

    def _step(state, batch, lr, clip_scale, grad_scale, leaf_lr):
        params = state["params"]
        leaves = optim_tx.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        gns_tel: Dict[str, Any] = {}
        rows = next(iter(batch.values())).shape[0]
        k = _gns_shard_count(gns_cfg, rows) if gns_cfg is not None else 1
        groups = (leaf_groups(params)
                  if k >= 2 or grad_scale is not None else None)
        if k >= 2:
            grads, metrics, leaf_small = sharded_grads(
                model, params, batch, k, grad_scale, groups, axes)
            with torch.no_grad():
                leaf_big = leaf_sq_norms(grads, groups)
                gns_tel = {"gns_small_sq": leaf_small.sum(),
                           "gns_big_sq": leaf_big.sum(),
                           "gns_b_small": float(rows // k),
                           "gns_b_big": float(rows),
                           "leaf_gns_small_sq": leaf_small,
                           "leaf_gns_big_sq": leaf_big}
                if gns_cfg.precursor_window > 0:
                    sketches = []
                    for i, members in enumerate(groups.gather(grads)):
                        n = sum(g.numel() for g in members)
                        m = -(-n // sketch_dim)
                        sketches.append(gns_sketch(
                            members, signs_of(i, m * sketch_dim,
                                              members[0].device),
                            sketch_dim))
                    gns_tel["leaf_gns_sketch"] = torch.stack(sketches)
        else:
            with trace.span("step.forward"):
                loss, metrics = model.loss(shd.gather_params(params, axes),
                                           batch)
            with trace.span("step.backward"):
                grads = loss_grads(loss, leaves)
            with torch.no_grad():
                _scale_grads(grads, grad_scale, groups)
            metrics = {k_: v.detach() if torch.is_tensor(v) else v
                       for k_, v in metrics.items()}
        with torch.no_grad():
            hyper = {"lr": lr, "clip_scale": clip_scale}
            if leaf_lr is not None:
                hyper["leaf_lr_scale"] = _vector(leaf_lr, leaves[0].device)
            with trace.span("step.optimizer", device=True):
                new_params, new_opt, telemetry = optim_tx.optimizer_step(
                    tx, optim_tx.tree_unflatten(params, grads), state["opt"],
                    params, hyper)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {**metrics, **telemetry, **gns_tel, "lr": lr}

    return train_step


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     opt_cfg: Optional[OptimizerConfig] = None,
                     device: torch.device = torch.device("cuda")
                     ) -> Dict[str, Any]:
    """Params drawn from ``generator`` (the reference's distributions, not
    its numbers), the chain's initial state and step 0."""
    params = model_zoo.init_params(cfg, generator, device)
    tx = optim_tx.build_optimizer(opt_cfg or OptimizerConfig())
    return {"params": params, "opt": tx.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_prefill_step(model, rules: Optional[shd.ShardingRules] = None):
    """``prefill_step(params, batch) -> (logits, cache)`` under ``rules``
    (``steps.py:156-160``)."""
    axes = model_zoo.param_axes(model.cfg) if rules is not None else None

    def prefill_step(params, batch):
        with shd.use_rules(rules):
            return model.prefill(shd.gather_params(params, axes), batch)
    return prefill_step


def make_serve_step(model, rules: Optional[shd.ShardingRules] = None):
    """``serve_step(params, cache, tokens) -> (logits, cache)``, one decode
    step under ``rules`` (``steps.py:163-167``)."""
    axes = model_zoo.param_axes(model.cfg) if rules is not None else None

    def serve_step(params, cache, tokens):
        with shd.use_rules(rules):
            return model.decode(shd.gather_params(params, axes), cache,
                                tokens)
    return serve_step


# ---------------------------------------------------------------------------
# abstract state and sharding trees (``steps.py:174-259``)
# ---------------------------------------------------------------------------

def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: Optional[OptimizerConfig] = None
                         ) -> Dict[str, Any]:
    """The train state as ``meta`` tensors: no storage.  ``opt_cfg``
    selects the chain whose state rides under ``"opt"`` (default AdamW)."""
    params = model_zoo.abstract_params(cfg)
    tx = optim_tx.build_optimizer(opt_cfg or OptimizerConfig())
    return {"params": params,
            "opt": optim_tx.abstract_chain_state(tx, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_shardings(rules: shd.ShardingRules, cfg: ModelConfig,
                          opt_cfg: Optional[OptimizerConfig] = None
                          ) -> Dict[str, Any]:
    """:class:`~repro_torch.distributed.sharding.NamedSharding` tree of the
    train state: params by the param rules, the optimizer state by
    :func:`_opt_state_shardings`, the step replicated."""
    shapes = model_zoo.abstract_params(cfg)
    p_sh = shd.tree_param_shardings(rules, model_zoo.param_axes(cfg), shapes)
    replicated = shd.NamedSharding(rules.mesh, ())
    return {"params": p_sh,
            "opt": _opt_state_shardings(cfg, opt_cfg, shapes, p_sh,
                                        replicated),
            "step": replicated}


def _paths(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs of a tree of dicts and lists, keys as strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and \
            not isinstance(tree, shd.NamedSharding):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


def _opt_state_shardings(cfg: ModelConfig,
                         opt_cfg: Optional[OptimizerConfig],
                         params_abs, p_sh, replicated):
    """Shardings of the chain state (``steps.py:210-246``): an ``m`` or
    ``v`` subtree that mirrors the params (Adam's and SM3's moments) takes
    the params' shardings leaf for leaf, looked up by the path after the
    marker; everything else (counts, SM3 accumulators, Shampoo statistics)
    is replicated."""
    tx = optim_tx.build_optimizer(opt_cfg or OptimizerConfig())
    abs_opt = optim_tx.abstract_chain_state(tx, params_abs)
    p_by_path = dict(_paths(p_sh))

    def one(path):
        for i, k in enumerate(path):
            if k in ("m", "v") and path[i + 1:] in p_by_path:
                return p_by_path[path[i + 1:]]
        return replicated

    leaves = [one(path) for path, _ in _paths(abs_opt)]
    it = iter(leaves)
    return optim_tx.tree_map(lambda _: next(it), abs_opt)


def batch_shardings(rules: shd.ShardingRules, cfg: ModelConfig,
                    specs: Dict[str, Any]) -> Dict[str, Any]:
    """Shardings of the batch leaves in ``specs`` (tensors or (shape,
    kind) specs) under the activation rules."""
    axes = {k: v for k, v in model_zoo.batch_logical_axes(cfg).items()
            if k in specs}
    return shd.tree_act_shardings(rules, axes, {k: specs[k] for k in axes})


def cache_shardings(rules: shd.ShardingRules, model, batch_size: int,
                    seq_len: int) -> Dict[str, Any]:
    """Shardings of the model's prefill/decode cache under the activation
    rules."""
    return shd.tree_act_shardings(rules, model.cache_axes(),
                                  model.cache_shapes(batch_size, seq_len))


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Place a tree of tensors (the same global values on every rank) by a
    tree of shardings on a ``DeviceMesh``: the counterpart of
    ``jax.device_put`` with shardings.  Non-tensor leaves pass through."""
    def one(t, sh):
        if not isinstance(t, torch.Tensor) or is_dtensor(t):
            return t
        return distribute_tensor(t.detach(), sh.mesh, sh.placements)
    return optim_tx.tree_map(one, tree, shardings)


def shard_train_state(state: Dict[str, Any], rules: shd.ShardingRules,
                      cfg: ModelConfig,
                      opt_cfg: Optional[OptimizerConfig] = None
                      ) -> Dict[str, Any]:
    """A concrete train state placed by :func:`train_state_shardings`."""
    return shard_tree(state, train_state_shardings(rules, cfg, opt_cfg))


def unshard_tree(tree: Any) -> Any:
    """Every DTensor leaf as its whole plain tensor (on every rank)."""
    return optim_tx.tree_map(_plain, tree)
