"""Pytree checkpoints: per-leaf ``.npy`` files and a JSON manifest (copy of
``repro/checkpoint/checkpoint.py:41-283``, with the same on-disk format).

* **atomic**: written to ``<dir>/tmp.<step>``, fsynced, then renamed to
  ``<dir>/step_<step:012d>``; a crash mid-write never corrupts the latest
  checkpoint.
* **self-validating**: the manifest holds ``step``, ``n_leaves``,
  ``leaves{key: {file, shape, dtype, crc32}}`` and ``host``;
  :func:`latest_step` skips incomplete directories and :func:`restore`
  raises :class:`CheckpointCorruption` on a shape, dtype or crc32 mismatch
  or an unreadable payload.  ``CheckpointManager.restore_latest``
  quarantines a corrupt directory (renamed ``corrupt.step_*``, payload
  kept) and falls back to the one before.
* **host state included**: the control plane's state rides in the
  manifest's ``host`` dict, so a restart resumes the SLW schedule exactly.

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), lists and tuples; a leaf is a numpy array, a torch tensor
or a :class:`repro_torch.bridge.LeafSpec`, and ``None`` is an empty
subtree, as in ``jax.tree_util`` (Shampoo's statistics of an ineligible
leaf).  A leaf's key is its
path joined by ``/``, the JAX package's key.  The trainer writes its state
in the JAX layout (``repro_torch.bridge.train_state_to_numpy``), so a
checkpoint written by either package restores in the other.  ``save``
calls ``distributed.fault_injection.checkpoint_crash_point`` at the
reference's two crash points: ``post_tmp`` (payload and manifest written,
before the rename) and ``post_rename`` (after it).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.fault_injection import checkpoint_crash_point


class CheckpointCorruption(ValueError):
    """A checkpoint directory failed validation (missing or unreadable
    payload, shape/dtype mismatch, or content-checksum mismatch)."""


def _is_node(x: Any) -> bool:
    return isinstance(x, dict) or (isinstance(x, (list, tuple))
                                   and not hasattr(x, "_fields"))


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if _is_node(tree):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten(t, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_node(t):
            return [build(x) for x in t]
        return next(it)
    return build(like)


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (``zlib.crc32(arr.tobytes())``
    without the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _host(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any,
         host_state: Optional[Dict] = None) -> str:
    """Atomically write checkpoint ``step``.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:012d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "leaves": {},
                "host": host_state or {}}
    for key, leaf in leaves:
        arr = _host(leaf)
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "crc32": _crc32(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    checkpoint_crash_point("post_tmp", step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    checkpoint_crash_point("post_rename", step)
    return final


def available_steps(directory: str) -> List[int]:
    """Steps with a complete-looking checkpoint directory, newest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out, reverse=True)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[0] if steps else None


def quarantine(directory: str, step: int) -> str:
    """Rename a corrupt ``step_*`` directory to ``corrupt.step_*`` so no
    future restart trusts it (payload kept on disk for postmortems).
    Returns the quarantine path."""
    src = os.path.join(directory, f"step_{step:012d}")
    dst = os.path.join(directory, f"corrupt.step_{step:012d}")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(src, dst)
    return dst


def _legacy_opt_alias(key: str) -> Optional[str]:
    """The legacy monolithic location of a chain-format optimizer leaf:
    pre-chain checkpoints stored the AdamW state flat under ``opt/``
    (``opt/m/...``, ``opt/v/...``, ``opt/count``); the chain nests it under
    the ``adam`` slot."""
    m = re.fullmatch(r"opt/(?:shampoo/)?adam/((?:m|v)(?:/.*)?|count)", key)
    return f"opt/{m.group(1)}" if m else None


def restore(directory: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore checkpoint ``step`` into the structure of ``like``: a tree of
    numpy arrays on the host, and the manifest's ``host`` dict.

    Every payload is validated against the manifest (shape, dtype, crc32
    when present: pre-hardening manifests lack it and still restore); a
    mismatch raises :class:`CheckpointCorruption`.  Legacy ``{"m", "v",
    "count"}`` optimizer payloads restore into the chain format through
    :func:`_legacy_opt_alias`.
    """
    path = os.path.join(directory, f"step_{step:012d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruption(f"unreadable manifest in {path}: {e}")
    keys = {}
    for k, _ in _flatten(like):
        alias = _legacy_opt_alias(k)
        if k not in manifest["leaves"] and alias in manifest["leaves"]:
            keys[k] = alias
        else:
            keys[k] = k  # reported missing below when absent
    missing = [k for k, src in keys.items() if src not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]} ...")
    arrays = []
    for key, src in keys.items():
        meta = manifest["leaves"][src]
        fpath = os.path.join(path, meta["file"])
        try:
            arr = np.load(fpath)
        except Exception as e:  # noqa: BLE001 — any load failure = corrupt
            raise CheckpointCorruption(f"unreadable payload {fpath}: {e}")
        if list(arr.shape) != list(meta["shape"]) \
                or str(arr.dtype) != meta["dtype"]:
            raise CheckpointCorruption(
                f"{fpath}: shape/dtype {arr.shape}/{arr.dtype} != manifest "
                f"{tuple(meta['shape'])}/{meta['dtype']}")
        if "crc32" in meta:
            crc = _crc32(arr)
            if crc != meta["crc32"]:
                raise CheckpointCorruption(
                    f"{fpath}: crc32 {crc:#010x} != manifest "
                    f"{meta['crc32']:#010x}")
        arrays.append(arr)
    return _unflatten(like, arrays), manifest["host"]


def migrate_host_state(host: Dict) -> Dict:
    """Upgrade a legacy host dict to the unified controller format.

    Pre-regulator checkpoints carried per-object payloads
    (``{"curriculum": ..., "tracker": ...}``); the control plane checkpoints
    one ``controller`` dict (``core.regulators.ControllerState``), and
    legacy curriculum state maps onto the ``seqlen`` regulator's slot.  A
    legacy monolithic ``{"m", "v", "count"}`` opt state in the host dict is
    upgraded into the chain format (on disk that happens leaf by leaf in
    :func:`restore`).
    """
    if isinstance(host.get("opt"), dict):
        from repro_torch.optim.transforms import migrate_opt_state
        new_opt = migrate_opt_state(host["opt"])
        if new_opt is not host["opt"]:
            host = dict(host)
            host["opt"] = new_opt
    if "controller" in host:  # already the new format: passed through
        return host
    out = dict(host)
    regs = {}
    if "curriculum" in host:
        regs["seqlen"] = host["curriculum"]
    out["controller"] = {
        "step": host.get("step", 0),
        "tokens_seen": host.get("tokens_seen", 0),
        "regulators": regs,
        "tracker": host.get("tracker", {}),
    }
    return out


class CheckpointManager:
    """Keep-N garbage collection and the restore fallback."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        # (step, quarantine path, reason) of every corrupt dir sidelined
        self.quarantined: List[Tuple[int, str, str]] = []

    def save(self, step: int, tree: Any, host_state: Optional[Dict] = None):
        path = save(self.directory, step, tree, host_state)
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, like: Any):
        """``(step, tree, host)`` of the newest checkpoint that passes
        validation.  A corrupt one is quarantined and the one before tried,
        until one validates or none is left: then ``(None, None, None)``,
        as for an empty directory (the caller cold-starts)."""
        for step in available_steps(self.directory):
            try:
                tree, host = restore(self.directory, step, like)
                return step, tree, host
            except CheckpointCorruption as e:
                self.quarantined.append(
                    (step, quarantine(self.directory, step), str(e)))
        return None, None, None

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n)
             for n in os.listdir(self.directory)) if m)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:012d}"),
                          ignore_errors=True)
