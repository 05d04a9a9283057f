"""Logical-axis sharding on DTensor (``repro/distributed/sharding.py``).

Params, optimizer state, batches and caches carry *logical* axis names
(the models' ``ParamDef`` trees, ``model_zoo.batch_logical_axes``, the
models' ``cache_axes``).  A rule set maps them to mesh axes, and one
resolution gives the reference's spec (a mesh axis, a tuple of mesh axes
or ``None`` per tensor dim) and its DTensor placements (one per mesh dim).
Moving from the (16, 16) mesh to (2, 16, 16), or to a restart with another
device count, changes rules and mesh, not the model.

Rule sets, copied from ``sharding.py:37-117``:

* ``baseline``: Megatron-style DP + TP, params replicated over ``data``
  and sharded over ``model`` (vocab, heads, mlp, experts).
* ``fsdp``: baseline plus params and optimizer state sharded over
  ``data`` (ZeRO-3).
* ``fsdp_pure``: fsdp's storage, pure data-parallel compute (the batch
  over every mesh axis).
* ``serve_tp``: the inference layout, TP over ``model`` only.

Conflict and divisibility fallback (``sharding.py:139-167``): a dim whose
mesh axis an earlier dim of the same tensor uses, or whose size the mesh
axes do not divide (after dropping trailing axes of a tuple), stays
unsharded and is recorded in ``fallbacks``.  DTensor would shard such a
dim unevenly where the reference replicates, so the fallback is kept.
Resolutions are cached per (kind, axes, shape): the eager port resolves
an activation every step, and ``fallbacks`` lists each once, as one trace
of the reference does.

``constrain`` is the counterpart of ``with_sharding_constraint``: it
redistributes a DTensor to the active rules' activation placements and
returns a plain tensor unchanged.  ``local_call`` is the kernel boundary:
no ``torch.autograd.Function`` of a kernel sees a DTensor; each rank's
kernel runs on its local tensors through ``local_map``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

MeshAxes = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[MeshAxes], ...]

# logical axis -> mesh axis (or tuple of mesh axes) templates; axes absent
# from the active mesh are dropped at resolution time
PARAM_RULES: Dict[str, Dict[str, MeshAxes]] = {
    "baseline": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "rwkv_heads": "model",
        "rwkv_inner": "model",
    },
    "fsdp": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "rwkv_heads": "model",
        "rwkv_inner": "model",
        "embed": "data",  # ZeRO-3-style: weights sharded over the data axis
        "pos": "data",
    },
    # fsdp_pure: weights stored sharded over both axes (as fsdp), compute
    # purely data-parallel: the batch spreads over every mesh axis and
    # layers run with gathered weights
    "fsdp_pure": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "rwkv_heads": "model",
        "rwkv_inner": "model",
        "embed": "data",
        "pos": "data",
    },
    # serve_tp: params replicated over data and TP-sharded over model
    # only; the KV cache's seq axis carries the memory
    "serve_tp": {
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "rwkv_heads": "model",
        "rwkv_inner": "model",
    },
}

ACT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "mlp": "model",
    "vocab": "model",
    "ssm_heads": "model",
    "ssm_inner": "model",
    "rwkv_heads": "model",
    "rwkv_inner": "model",
}

# fsdp_pure: batch over the whole mesh; no activation TP entries
ACT_RULES_PURE: Dict[str, MeshAxes] = {
    "batch": ("pod", "data", "model"),
    "vocab": "model",
}

# long-context decode: KV caches also sharded along the sequence axis
SEQ_SHARDED_CACHE_RULE = {"seq": "data"}

# where each rule set's params are computed with (the weights a layer
# multiplies by): fsdp gathers its data-axis shards (ZeRO-3) and keeps
# TP, fsdp_pure gathers everything (pure data parallelism), baseline and
# serve_tp compute where they are stored
COMPUTE_RULES: Dict[str, Dict[str, MeshAxes]] = {
    "baseline": PARAM_RULES["baseline"],
    "fsdp": PARAM_RULES["baseline"],
    "fsdp_pure": {},
    "serve_tp": PARAM_RULES["serve_tp"],
}


def mesh_axes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in mesh order, of a ``DeviceMesh`` or of any
    stand-in with ``axis_names`` and a ``shape`` mapping (as a JAX mesh
    has): resolution reads nothing else of a mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def spec_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """One DTensor placement per mesh dim for a spec: a tensor dim on mesh
    axis ``a`` is ``Shard(dim)`` on ``a``'s mesh dim; a dim on a tuple of
    mesh axes is ``Shard(dim)`` on each, the tuple major to minor, which
    must be the mesh's order (DTensor shards a dim over several mesh dims
    outermost mesh dim first)."""
    from repro_torch.distributed.compat import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return spec_placements(self.spec, self.mesh)


@dataclass
class ShardingRules:
    mesh: Any
    param_rules: Dict[str, MeshAxes]
    act_rules: Dict[str, MeshAxes]
    fallbacks: List[str] = field(default_factory=list)
    compute_rules: Optional[Dict[str, MeshAxes]] = None
    _cache: Dict[tuple, Spec] = field(default_factory=dict, repr=False)

    @classmethod
    def make(cls, mesh, rule_set: str = "fsdp",
             seq_sharded_cache: bool = False,
             seq_shard_axis: str = "data") -> "ShardingRules":
        act = dict(ACT_RULES_PURE if rule_set == "fsdp_pure" else ACT_RULES)
        if seq_sharded_cache:
            act["seq"] = seq_shard_axis
        return cls(mesh=mesh, param_rules=dict(PARAM_RULES[rule_set]),
                   act_rules=act,
                   compute_rules=dict(COMPUTE_RULES[rule_set]))

    # -- resolution (``sharding.py:139-167``) -----------------------------
    def _resolve(self, rules: Dict[str, MeshAxes],
                 axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]], what: str) -> Spec:
        key = (what, tuple(axes), None if shape is None else tuple(shape))
        got = self._cache.get(key)
        if got is not None:
            return got
        sizes = mesh_axes(self.mesh)
        used: set = set()
        out: List[Optional[MeshAxes]] = []
        for i, name in enumerate(axes):
            target = rules.get(name) if name else None
            if target is None:
                out.append(None)
                continue
            cand = tuple(a for a in (
                (target,) if isinstance(target, str) else target)
                if a in sizes and a not in used)
            if not cand:
                out.append(None)
                continue
            if shape is not None:
                size = int(np.prod([sizes[a] for a in cand]))
                if shape[i] % size != 0:
                    # divisibility fallback: try prefix subsets
                    while cand and shape[i] % int(
                            np.prod([sizes[a] for a in cand])) != 0:
                        cand = cand[:-1]
                    if not cand:
                        if what != "compute":
                            self.fallbacks.append(
                                f"{what}: dim {i} ({name}={shape[i]}) "
                                f"replicated")
                        out.append(None)
                        continue
            used.update(cand)
            out.append(cand[0] if len(cand) == 1 else cand)
        spec = tuple(out)
        self._cache[key] = spec
        return spec

    def param_spec(self, axes, shape=None) -> Spec:
        return self._resolve(self.param_rules, axes, shape, "param")

    def act_spec(self, axes, shape=None) -> Spec:
        return self._resolve(self.act_rules, axes, shape, "act")

    def compute_placements(self, axes, shape=None) -> Tuple[Any, ...]:
        """Where a param is computed with (``COMPUTE_RULES``); the
        storage rules when the rules were built by hand."""
        rules = (self.param_rules if self.compute_rules is None
                 else self.compute_rules)
        return spec_placements(self._resolve(rules, axes, shape, "compute"),
                               self.mesh)

    def param_placements(self, axes, shape=None) -> Tuple[Any, ...]:
        return spec_placements(self.param_spec(axes, shape), self.mesh)

    def act_placements(self, axes, shape=None) -> Tuple[Any, ...]:
        return spec_placements(self.act_spec(axes, shape), self.mesh)

    def param_sharding(self, axes, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.param_spec(axes, shape))

    def act_sharding(self, axes, shape=None) -> NamedSharding:
        return NamedSharding(self.mesh, self.act_spec(axes, shape))


def is_axes_leaf(x: Any) -> bool:
    """A logical-axes tuple leaf in an axes tree (e.g. ("batch", "seq"))."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def shape_of(x: Any) -> Tuple[int, ...]:
    """The shape of a tensor, a (shape, kind) spec or a shape tuple."""
    if hasattr(x, "shape"):
        return tuple(x.shape)
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple):
        return tuple(x[0])
    return tuple(x)


def map_axes_tree(fn: Callable, axes_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over an axes tree (dicts and lists, leaves the
    axes tuples) and trees of the same structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes_tree(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    return [map_axes_tree(fn, a, *ts) for a, *ts in zip(axes_tree, *trees)]


def _tree_shardings(method, axes_tree: Any, shape_tree: Any) -> Any:
    return map_axes_tree(lambda axes, s: method(axes, shape_of(s)),
                         axes_tree, shape_tree)


def tree_param_shardings(rules: ShardingRules, axes_tree: Any,
                         shape_tree: Any) -> Any:
    """:class:`NamedSharding` tree from a logical-axes tree and a tree of
    shapes (meta tensors, tensors or (shape, kind) specs)."""
    return _tree_shardings(rules.param_sharding, axes_tree, shape_tree)


def tree_act_shardings(rules: ShardingRules, axes_tree: Any,
                       shape_tree: Any) -> Any:
    """:class:`NamedSharding` tree under the activation rules: the serve
    caches, whose slot axis is their "batch" axis (``sharding.py:196-210``)."""
    return _tree_shardings(rules.act_sharding, axes_tree, shape_tree)


# ---------------------------------------------------------------------------
# activation constraints inside model code (no-op when no rules active)
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` the active rules; with rules, plain tensors that meet
    DTensors inside (aranges, masks, scalars) count as replicated."""
    prev = getattr(_ACTIVE, "rules", None)
    _ACTIVE.rules = rules
    try:
        if rules is None:
            yield
        else:
            from repro_torch.distributed.compat import implicit_replication
            with implicit_replication():
                yield
    finally:
        _ACTIVE.rules = prev


def active_rules() -> Optional[ShardingRules]:
    return getattr(_ACTIVE, "rules", None)


def zeros_like_act(shape: Sequence[int], dtype, ref,
                   axes: Sequence[Optional[str]]):
    """Zeros of ``shape``: a DTensor on the activation rules' placements
    for ``axes`` (each rank allocating its own shard) when ``ref`` is a
    DTensor under active rules, else a plain tensor on ``ref``'s device
    (the buffers a prefill writes its caches into)."""
    rules = active_rules()
    from repro_torch.distributed.compat import dtensor_zeros, is_dtensor
    if rules is None or not is_dtensor(ref):
        return torch.zeros(tuple(shape), dtype=dtype, device=ref.device)
    pl = spec_placements(rules.act_spec(tuple(axes), tuple(shape)),
                         ref.device_mesh)
    return dtensor_zeros(tuple(shape), ref.device_mesh, pl, dtype)


def gather_params(params: Any, axes_tree: Any) -> Any:
    """The params on their compute placements under the active rules: an
    fsdp step all-gathers each weight's data-axis shards here, and the
    backward of that redistribution reduce-scatters its gradient back to
    the stored shards.  Identity with no rules or on plain tensors."""
    rules = active_rules()
    from repro_torch.distributed.compat import is_dtensor
    if rules is None or axes_tree is None:
        return params

    def one(axes, p):
        if not is_dtensor(p):
            return p
        pl = rules.compute_placements(axes, tuple(p.shape))
        return p if tuple(p.placements) == pl else p.redistribute(
            p.device_mesh, pl)
    return map_axes_tree(one, axes_tree, params)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the active rules' activation placements
    for ``axes``; a plain tensor, or any tensor with no rules active, is
    returned unchanged."""
    rules = active_rules()
    from repro_torch.distributed.compat import is_dtensor
    if rules is None or not is_dtensor(x):
        return x
    spec = rules.act_spec(axes, tuple(x.shape))
    placements = spec_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


class _GradAsValue(torch.autograd.Function):
    """Identity whose backward puts the gradient on the value's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _with_contiguous_grads(fn: Callable) -> Callable:
    """``fn`` whose tensor arguments' gradients leave it contiguous: a
    kernel Function's input gradient may be a transposed view, and
    DTensor's view ops in the backward outside need a contiguous local
    tensor (plain autograd would reshape)."""
    def run(*xs):
        return fn(*(_ContiguousGrad.apply(x)
                    if isinstance(x, torch.Tensor) and x.requires_grad
                    else x for x in xs))
    return run


def grad_as_value(x):
    """``x``, and in the backward its gradient redistributed to ``x``'s own
    placements when ``x`` is a DTensor.  Put after a flatten whose
    backward view must split the gradient's dim again: DTensor may shard
    a matmul's gradient on a flattened dim that its parts do not divide
    (a weight's 12 heads on a 16-way axis)."""
    from repro_torch.distributed.compat import is_dtensor
    if active_rules() is None or not is_dtensor(x):
        return x
    return _GradAsValue.apply(x)


def unflatten_last(x, sizes: Sequence[int],
                   axes: Sequence[Optional[str]]):
    """``x.unflatten(-1, sizes)``; under rules a DTensor's last dim first
    takes the placement that the first of the split dims resolves to
    (``axes`` names the unflattened tensor's dims), or none: DTensor
    cannot split a dim sharded unevenly over the parts, where GSPMD would
    pad (e.g. 8 KV heads flattened with their head dim on a 16-way model
    axis)."""
    rules = active_rules()
    from repro_torch.distributed.compat import is_dtensor
    if rules is not None and is_dtensor(x):
        shape = tuple(x.shape[:-1]) + tuple(sizes)
        spec = rules.act_spec(tuple(axes), shape)
        n = len(sizes)
        tail = spec[-n] if all(e is None for e in spec[-n + 1:]) else None
        placements = spec_placements(spec[:-n] + (tail,), x.device_mesh)
        if tuple(x.placements) != placements:
            x = x.redistribute(x.device_mesh, placements)
    return x.unflatten(-1, tuple(sizes))


def local_call(fn: Callable, args: Sequence[Any],
               in_axes: Sequence[Optional[Sequence[Optional[str]]]],
               out_axes: Sequence[Sequence[Optional[str]]]):
    """``fn(*args)`` on each rank's local tensors when any argument is a
    DTensor, else ``fn(*args)`` itself.

    Each DTensor argument is redistributed to the active rules' activation
    placements of its logical axes (``in_axes``; ``None`` for a non-tensor
    argument), and the outputs come back as DTensors placed by the same
    resolution: an output dim named ``n`` goes where the inputs' dim ``n``
    went (``out_axes``, one tuple per output).  The query heads follow the
    KV heads: where one of "heads" and "kv_heads" shards and the other
    cannot, both stay whole, so each rank's kernel sees whole GQA groups.
    This is where a kernel's ``torch.autograd.Function`` meets a sharded
    step: it gets plain local tensors, so on the card it launches the
    kernel and never a DTensor decomposition of its plain version."""
    from repro_torch.distributed.compat import (Partial, Replicate, Shard,
                                                from_local, is_dtensor,
                                                local_map)
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    rules = active_rules()
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    resolved: Dict[str, Optional[MeshAxes]] = {}
    specs: List[Optional[List[Optional[MeshAxes]]]] = []
    for a, axes in zip(args, in_axes):
        if axes is None:
            specs.append(None)
            continue
        spec = (list(rules.act_spec(axes, tuple(a.shape))) if rules
                else [None] * a.ndim)
        specs.append(spec)
        for name, entry in zip(axes, spec):
            if name is not None:
                resolved.setdefault(name, entry)
    if "heads" in resolved and "kv_heads" in resolved and \
            resolved["heads"] != resolved["kv_heads"]:
        resolved["heads"] = resolved["kv_heads"] = None
    moved, in_pl = [], []
    for a, axes, spec in zip(args, in_axes, specs):
        if spec is None:
            moved.append(a)
            in_pl.append(None)
            continue
        if not is_dtensor(a):  # a plain tensor counts as replicated
            a = from_local(a, mesh, [Replicate()] * mesh.ndim)
        spec = [resolved.get(n) if n is not None else None for n in axes]
        pl = spec_placements(tuple(spec), mesh)
        moved.append(a if tuple(a.placements) == pl
                     else a.redistribute(mesh, pl))
        in_pl.append(list(pl))
    # local_map reads a tuple as one entry per output, a list as one
    # output's placements
    out_pl = tuple(list(spec_placements(tuple(resolved.get(n) if n else None
                                              for n in axes), mesh))
                   for axes in out_axes)
    # an input whole along a mesh dim that the call splits (another
    # input's rows or heads) gets from each rank the gradient of that
    # rank's part only: partial sums over that dim
    split = {i for pl in in_pl if pl for i, p in enumerate(pl)
             if isinstance(p, Shard)}
    grad_pl = tuple(None if pl is None else [
        Partial() if i in split and isinstance(p, Replicate) else p
        for i, p in enumerate(pl)] for pl in in_pl)
    return local_map(_with_contiguous_grads(fn),
                     out_pl if len(out_pl) > 1 else out_pl[0],
                     tuple(in_pl), mesh, grad_pl)(*moved)
