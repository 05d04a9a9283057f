"""Reading ``--metrics-jsonl`` streams back (``repro/core/telemetry.py:103-142``).

Only the reader is ported: the serving CLI's per-step rows and summary row
need it.  The per-leaf telemetry it also parses (``per_leaf`` dicts and a
``leaf_labels`` header row) comes with the optimizer's per-leaf telemetry
(ROADMAP A12); the reader already turns such vectors into numpy arrays.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

import numpy as np


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
                row["per_leaf"] = {k: np.asarray(v, np.float32)
                                   for k, v in row["per_leaf"].items()}
            rows.append(row)
    return labels, rows
