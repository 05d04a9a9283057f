"""Per-parameter instability telemetry over the port's parameter tree
(``repro/core/telemetry.py:38-150``).

The reference stacks each layer's parameters on a leading scan axis, so
one of its leaves (``layers/attn/wq``, shape (L, ...)) is one parameter
group of the whole network, and every per-leaf quantity it defines is a
reduction over that stacked leaf.  The port keeps ``layers`` (and
Zamba-2's ``mamba_layers``) as a list of per-layer dicts, so its
``tree_leaves`` are per layer and interleaved (``layers[0]/attn/wk``,
``layers[0]/attn/wo``, ..., ``layers[1]/attn/wk``).  :func:`leaf_groups`
maps one onto the other: the reference's labels, in the reference's
order, and for each label the port leaves that form it, in layer order.
Every per-leaf computation of the port goes through that map, so a
``(n_leaves,)`` vector here has the reference's length, order and values.

* :func:`param_labels`, :func:`leaf_norms`, :func:`leaf_var_max` — the
  labels and the per-group reductions, on the device.
* :func:`split_metrics` — a train step's metrics to the host in one
  transfer: the scalars as floats, the per-leaf vectors as numpy arrays.
* :func:`per_leaf_to_host` / :func:`per_leaf_from_host`,
  :func:`read_metrics_jsonl`, :func:`blame` — host-side plumbing.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# keys of the per-leaf vectors a train step may emit in its metrics (each
# (n_leaves,) fp32 in param_labels order, except leaf_gns_sketch:
# (n_leaves, d), the direction sketch the precursor rings up)
PER_LEAF_KEYS = ("leaf_var_max", "leaf_grad_norm", "leaf_update_norm",
                 "leaf_param_norm", "leaf_gns_small_sq", "leaf_gns_big_sq",
                 "leaf_gns_sketch")


class LeafGroups(NamedTuple):
    """The reference's leaves over the port's ``tree_leaves``: ``labels[g]``
    is formed by the port leaves ``members[g]`` (indices, layer order),
    stacked on a leading axis in the reference when ``stacked[g]``.
    ``group_of[i]`` is the group of port leaf ``i``."""

    labels: Tuple[str, ...]
    members: Tuple[Tuple[int, ...], ...]
    stacked: Tuple[bool, ...]
    group_of: Tuple[int, ...]

    def gather(self, leaves: Sequence[Any]) -> List[List[Any]]:
        """The port leaves of each group, in layer order."""
        return [[leaves[i] for i in m] for m in self.members]

    def stack(self, members: Sequence[torch.Tensor], g: int) -> torch.Tensor:
        """Group ``g``'s members in the reference's stacked layout."""
        return torch.stack(list(members)) if self.stacked[g] else members[0]

    def unstack(self, x: torch.Tensor, g: int) -> List[torch.Tensor]:
        return list(x.unbind(0)) if self.stacked[g] else [x]

    def stacked_shape(self, leaves: Sequence[Any], g: int) -> Tuple[int, ...]:
        first = tuple(leaves[self.members[g][0]].shape)
        return ((len(self.members[g]),) + first if self.stacked[g]
                else first)

    def reduce(self, per_leaf: torch.Tensor, op: str) -> torch.Tensor:
        """(n_groups,) sum or max over each group of a (n_port_leaves,)
        vector, in a fixed order (no atomics: reruns are bit-identical)."""
        idx = _gather_index(self, per_leaf.device)
        fill = 0.0 if op == "sum" else -math.inf
        padded = torch.cat([per_leaf, per_leaf.new_full((1,), fill)])[idx]
        return padded.sum(1) if op == "sum" else padded.amax(1)

    def expand(self, per_group: torch.Tensor) -> List[torch.Tensor]:
        """The entry of each port leaf's group, as 0-dim tensors in
        ``tree_leaves`` order (no host sync)."""
        return list(per_group[_group_index(self, per_group.device)].unbind())


_INDEX_CACHE: Dict[Any, torch.Tensor] = {}


def _gather_index(groups: LeafGroups, device) -> torch.Tensor:
    """(n_groups, widest group) indices of each group's members, padded
    with the index one past the leaves."""
    key = ("gather", groups.members, str(device))
    if key not in _INDEX_CACHE:
        n = len(groups.group_of)
        width = max(len(m) for m in groups.members)
        rows = [list(m) + [n] * (width - len(m)) for m in groups.members]
        _INDEX_CACHE[key] = torch.tensor(rows, dtype=torch.int64,
                                         device=device)
    return _INDEX_CACHE[key]


def _group_index(groups: LeafGroups, device) -> torch.Tensor:
    key = ("group_of", groups.group_of, str(device))
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = torch.tensor(groups.group_of, dtype=torch.int64,
                                         device=device)
    return _INDEX_CACHE[key]


def _walk(tree: Any, path: Tuple[str, ...], stacked: bool,
          out: List[Tuple[str, bool]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (str(k),), stacked, out)
    elif isinstance(tree, (list, tuple)):
        # a per-layer list: one stacked leaf of the reference per path
        for t in tree:
            _walk(t, path, True, out)
    else:
        out.append(("/".join(path), stacked))


def leaf_groups(params: Any) -> LeafGroups:
    """The leaf-group map of a parameter tree (or any tree shaped like
    one).  Labels come in order of first appearance in ``tree_leaves``,
    which is the reference's ``tree_leaves`` order of the stacked tree:
    both sort dict keys, and every layer of a list has the same keys."""
    walked: List[Tuple[str, bool]] = []
    _walk(params, (), False, walked)
    labels: List[str] = []
    members: Dict[str, List[int]] = {}
    stacked: Dict[str, bool] = {}
    for i, (label, st) in enumerate(walked):
        if label not in members:
            labels.append(label)
            members[label] = []
            stacked[label] = st
        members[label].append(i)
    pos = {label: g for g, label in enumerate(labels)}
    return LeafGroups(tuple(labels), tuple(tuple(members[k]) for k in labels),
                      tuple(stacked[k] for k in labels),
                      tuple(pos[label] for label, _ in walked))


def param_labels(params: Any) -> Tuple[str, ...]:
    """The reference's leaf labels (``telemetry.py:55``), in its order."""
    return leaf_groups(params).labels


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def leaf_sq_norms(leaves: Sequence[torch.Tensor],
                  groups: LeafGroups) -> torch.Tensor:
    """(n_groups,) sum of squares of each group, fp32."""
    norms = torch.stack(torch._foreach_norm([x.float() for x in leaves], 2))
    return groups.reduce(norms * norms, "sum")


def leaf_norms(tree: Any) -> torch.Tensor:
    """(n_groups,) l2 norm of each group (``telemetry.py:63``): the square
    root of the sum over its members of their sums of squares."""
    return torch.sqrt(leaf_sq_norms(_leaves(tree), leaf_groups(tree)))


def leaf_var_max(v_tree: Any) -> torch.Tensor:
    """(n_groups,) max of sqrt(v) over each group (``telemetry.py:70``),
    the paper's Fig. 1 series per parameter group.  sqrt is monotone and
    v >= 0, so this is sqrt of the max v, exactly."""
    peaks = torch.stack(torch._foreach_norm(
        [x.float() for x in _leaves(v_tree)], math.inf))
    return torch.sqrt(leaf_groups(v_tree).reduce(peaks, "max"))


# ---------------------------------------------------------------------------
# host-side plumbing
# ---------------------------------------------------------------------------

def split_metrics(metrics: Dict[str, Any]
                  ) -> Tuple[Dict[str, float], Optional[Dict[str, np.ndarray]]]:
    """A train step's metrics on the host (``telemetry.py:82``): the
    tensors go over in one transfer; the scalars come back as floats and
    the per-leaf vectors, renamed without their ``leaf_`` prefix, as
    float32 arrays, with ``grad_to_weight`` added when both norms are
    there.  ``(scalars, None)`` when the step emitted no vector."""
    tensors = {k: v for k, v in metrics.items() if torch.is_tensor(v)}
    flat = (torch.cat([v.detach().reshape(-1).double()
                       for v in tensors.values()]).cpu().numpy()
            if tensors else np.zeros(0))
    host, off = {}, 0
    for k, v in tensors.items():
        n = v.numel()
        host[k] = flat[off:off + n].reshape(tuple(v.shape))
        off += n
    scalars = {k: (float(host[k]) if k in host else float(v))
               for k, v in metrics.items() if k not in PER_LEAF_KEYS}
    vectors = {k[len("leaf_"):]: np.asarray(host[k], np.float32)
               for k in PER_LEAF_KEYS if k in metrics}
    if not vectors:
        return scalars, None
    if "grad_norm" in vectors and "param_norm" in vectors:
        vectors["grad_to_weight"] = (
            vectors["grad_norm"] / np.maximum(vectors["param_norm"], 1e-12))
    return scalars, vectors


def per_leaf_to_host(per_leaf: Optional[Dict[str, np.ndarray]]
                     ) -> Optional[Dict[str, List[float]]]:
    """JSON-serializable form (checkpoints, JSONL rows)."""
    if per_leaf is None:
        return None
    return {k: np.asarray(v, np.float64).tolist() for k, v in per_leaf.items()}


def per_leaf_from_host(d: Optional[Dict[str, Any]]
                       ) -> Optional[Dict[str, np.ndarray]]:
    if d is None:
        return None
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def read_metrics_jsonl(path: str
                       ) -> Tuple[Tuple[str, ...], List[Dict[str, Any]]]:
    """``(leaf_labels, rows)`` of a metrics JSONL file: the labels of the
    one-time header row (empty when there is none) and the row dicts in
    file order, each ``per_leaf`` dict's lists as float32 arrays."""
    labels: Tuple[str, ...] = ()
    rows: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "leaf_labels" in row:
                labels = tuple(row["leaf_labels"])
            if row.get("per_leaf") is not None:
                row["per_leaf"] = per_leaf_from_host(row["per_leaf"])
            rows.append(row)
    return labels, rows


def blame(labels: Tuple[str, ...], ratios: np.ndarray) -> str:
    """The label with the largest excursion ratio (empty when the shapes
    don't line up, e.g. telemetry from another model)."""
    if not labels or ratios.shape[0] != len(labels):
        return ""
    return labels[int(np.argmax(ratios))]
