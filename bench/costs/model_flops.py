"""Model FLOPs of a training step, the numerator of ``step_mfu``: 6 N D for
the matrix products plus three times the causal attention's forward,
recomputed work not counted.

The formula is a frozen copy of ``src/repro_torch/roofline/analysis.py:
180-236`` (``model_flops`` for ``kind == "train"``, ``_attn_fwd_flops`` for
the dense and MoE families) and of ``src/repro_torch/models/model_zoo.py:
65-73`` (``active_param_count``: a MoE's routed experts count ``top_k /
n_experts`` of theirs).  N departs from the program's count: it holds only
the parameters that enter a matrix product, as counted from the
reference's parameter groups (the vocabulary padded to a multiple of 128,
as the program's table is).  An untied input table is a gather, and the
positions, norms and biases are added or scaled, so none of them counts; a
tied table counts once, as the head's product.
"""
from __future__ import annotations

import math
from typing import Dict

from bench.reference import transformer as tfm


def matmul_param_count(m: Dict) -> int:
    """Parameters of every weight matrix a step multiplies by."""
    tied = m.get("tie_embeddings", False)
    total = 0
    for g in tfm.param_groups(m):
        gather = g.name == "pos_embed" or (g.name == "embed" and not tied)
        if len(g.shape) < 2 or gather:
            continue
        total += math.prod(g.shape) * (m["n_layers"] if g.layered else 1)
    return total


def active_param_count(m: Dict) -> int:
    total = matmul_param_count(m)
    if m["family"] != "moe":
        return total
    e, k = m["n_experts"], m["top_k"]
    routed = 3 * m["n_layers"] * m["d_model"] * m["d_ff"] * e
    return total - routed + routed * k // e


def attn_fwd_flops(m: Dict, rows: int, seq: int) -> float:
    """Causal S^2 / 2 pairs, QK^T and PV, 2 FLOPs a multiply-add."""
    per_layer = (2.0 * 2.0 * rows * seq * seq / 2.0 * m["n_heads"]
                 * tfm.head_dim(m))
    return m["n_layers"] * per_layer


def train_step_flops(m: Dict, rows: int, seq: int) -> float:
    return (6.0 * active_param_count(m) * rows * seq
            + 3.0 * attn_fwd_flops(m, rows, seq))
