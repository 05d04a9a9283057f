"""Plain reference of the first training steps a cell's set-up runs: the
plan, the cut, the loss and its gradient, global-norm clipping and AdamW
with decoupled weight decay, in fp32 with TF32 off.

It returns what the comparison reads: each step's plan and cross-entropy,
the per-leaf norm of the first step's gradient as the optimizer gets it
(after clipping), and the per-leaf norm of the parameters' change after the
last step.  ``precision="tf32"`` runs the same steps with TF32 matmuls (the
control: the nearest precision below the configuration's); ``fault=
"half_batch"`` takes the loss over the first half of each batch's rows (a
planted fault).  Imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from bench.reference import plan as plan_lib
from bench.reference import transformer as tfm

Draw = Callable[[], Iterable[Tuple[tfm.Group, torch.Tensor]]]
Batch = Callable[[int], Dict[str, np.ndarray]]


def leaf_norms(stacked: Dict[str, torch.Tensor], layered: Dict[str, bool]
               ) -> Dict[str, float]:
    """Per program leaf: the norm of each layer's slice of a stacked
    group, or of the whole group."""
    out: Dict[str, float] = {}
    for name, t in stacked.items():
        if layered[name]:
            norms = t.reshape(t.shape[0], -1).norm(dim=1).tolist()
            rest = name[len("layers."):]
            out.update({f"layers.{i}.{rest}": v for i, v in enumerate(norms)})
        else:
            out[name] = float(t.norm())
    return out


class _Precision:
    """TF32 matmuls on or off for the block's duration."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def run(m: Dict, traffic: Dict, draw: Draw, batch_at: Batch, n_steps: int,
        device: torch.device, precision: str = "fp32",
        fault: Optional[str] = None) -> Dict:
    """``n_steps`` reference steps from the drawn weights on the batches
    ``batch_at(step)`` (full-length host arrays), cut by the reference's
    own plan.  Returns ``{"plans", "loss", "grad1", "change"}``."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    opt = traffic["optimizer"]
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    wd, clip = opt["weight_decay"], opt["grad_clip"]
    plans = plan_lib.plan(traffic, n_steps)
    layered: Dict[str, bool] = {}
    params: Dict[str, torch.Tensor] = {}
    for g, t in draw():
        layered[g.name] = g.layered
        params[g.name] = t.to(device).requires_grad_(True)
    names = list(params)
    leaves = [params[n] for n in names]
    mom = [torch.zeros_like(p) for p in leaves]
    var = [torch.zeros_like(p) for p in leaves]
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    with _Precision(precision == "tf32"):
        for step, pl in enumerate(plans):
            host = batch_at(step)
            rows = pl["batch"] // 2 if fault == "half_batch" else pl["batch"]
            s = pl["seq_len"]
            tokens = torch.as_tensor(host["tokens"][:rows, :s],
                                     dtype=torch.int64, device=device)
            labels = torch.as_tensor(host["labels"][:rows, :s],
                                     dtype=torch.int64, device=device)
            total, ce = tfm.loss(params, tokens, labels, m)
            grads = list(torch.autograd.grad(total, leaves))
            del total
            losses.append(float(ce))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.double().square().sum()
                                       for g in grads))
                scale = min(clip / max(float(gnorm), 1e-12), 1.0)
                for g in grads:
                    g.mul_(scale)
                if step == 0:
                    grad1 = leaf_norms(dict(zip(names, grads)), layered)
                # the bias corrections in fp32, as the configuration states
                count = np.float32(step + 1)
                bc1 = float(np.float32(1) - np.float32(b1) ** count)
                bc2 = float(np.float32(1) - np.float32(b2) ** count)
                lr = float(np.float32(pl["lr"]))
                for p, g, mo, va in zip(leaves, grads, mom, var):
                    mo.mul_(b1).add_(g, alpha=1.0 - b1)
                    va.mul_(b2).add_(g * g, alpha=1.0 - b2)
                    upd = (mo / bc1) / (torch.sqrt(va / bc2) + eps)
                    upd.add_(p, alpha=wd)
                    p.sub_(upd * lr)
            del grads
    del mom, var
    with torch.no_grad():
        diffs = {}
        for g, t0 in draw():
            diffs[g.name] = params[g.name].detach() - t0.to(device)
            params[g.name] = None  # the group's memory goes as it is read
        change = leaf_norms(diffs, layered)
    return {"plans": plans, "loss": losses, "grad1": grad1,
            "change": change}


def gaps(prog: Dict[str, float], ref: Dict[str, float],
         keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms: ``|prog - ref|`` over the larger of the
    reference's norm of that leaf and its median leaf's."""
    names = list(keep) if keep is not None else list(ref)
    med = float(np.median([ref[n] for n in ref]))
    out = {}
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        out[n] = g if math.isfinite(g) else math.inf
    return out
