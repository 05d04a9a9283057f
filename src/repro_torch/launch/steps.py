"""The train step and the train state (``repro/launch/steps.py:25-153,
219-226``).

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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNSConfig, ModelConfig, OptimizerConfig
from repro_torch.core.telemetry import LeafGroups, leaf_groups, leaf_sq_norms
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
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, leaves)]


def _vector(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _scale_grads(grads: List[torch.Tensor], grad_scale: Optional[Any],
                 groups: LeafGroups) -> None:
    if grad_scale is not None:
        torch._foreach_mul_(grads, groups.expand(
            _vector(grad_scale, grads[0].device)))


def sharded_grads(model, params, batch: Dict[str, torch.Tensor], k: int,
                  grad_scale: Optional[Any] = None,
                  groups: Optional[LeafGroups] = None):
    """``(grads, metrics, leaf_small)`` of ``k`` emulated shards of
    ``batch`` (contiguous row groups): the full-batch gradient (a list in
    ``tree_leaves`` order) and metrics as the token-weighted shard means
    (``tokens`` summed), and the per-group mean over the shards of ``sum
    g^2`` (``steps.py:92-124``).  ``grad_scale`` multiplies each shard's
    gradient groups first, so the measurement sees what the chain sees."""
    leaves = optim_tx.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    groups = groups or leaf_groups(params)
    rows = next(iter(batch.values())).shape[0] // k
    acc = small = total = None
    sums: Dict[str, torch.Tensor] = {}
    for i in range(k):
        shard = {key: v[i * rows:(i + 1) * rows] for key, v in batch.items()}
        loss, metrics = model.loss(params, shard)
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
                v = v.detach()
                add = v if name == "tokens" else w * v.float()
                sums[name] = add if name not in sums else sums[name] + add
        del grads, loss, metrics
    denom = total.clamp_min(1.0)
    torch._foreach_div_(acc, denom)
    out = {name: (v if name == "tokens" else v / denom)
           for name, v in sums.items()}
    return acc, out, small / k


def make_train_step(model, opt_cfg: OptimizerConfig,
                    gns: Optional[GNSConfig] = None,
                    sketch_signs: Optional[Callable] = None):
    """``train_step(state, batch, lr, clip_scale=1.0, grad_scale=None,
    leaf_lr=None) -> (state, metrics)``; ``batch`` holds tensors on the
    params' device.  The metrics are tensors on that device (0-dim, or the
    per-leaf vectors), ``lr`` and the GNS batch sizes floats.
    ``sketch_signs(i, n, device)`` gives group ``i``'s ``n`` signs
    (default :class:`SketchSigns` of ``gns.sketch_seed``)."""
    tx = optim_tx.build_optimizer(opt_cfg)
    gns_cfg = gns if (gns is not None and gns.enabled) else None
    if gns_cfg is not None and gns_cfg.precursor_window > 0:
        sketch_dim = max(gns_cfg.precursor_dim, 1)
        signs_of = sketch_signs or SketchSigns(gns_cfg.sketch_seed)

    def train_step(state, batch, lr, clip_scale=1.0, grad_scale=None,
                   leaf_lr=None):
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
                model, params, batch, k, grad_scale, groups)
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
            loss, metrics = model.loss(params, batch)
            grads = loss_grads(loss, leaves)
            with torch.no_grad():
                _scale_grads(grads, grad_scale, groups)
            metrics = {k_: v.detach() for k_, v in metrics.items()}
        with torch.no_grad():
            hyper = {"lr": lr, "clip_scale": clip_scale}
            if leaf_lr is not None:
                hyper["leaf_lr_scale"] = _vector(leaf_lr, leaves[0].device)
            updates, new_opt, telemetry = tx.update(
                optim_tx.tree_unflatten(params, grads), state["opt"],
                params, hyper)
            new_params = optim_tx.apply_updates(params, updates)
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
