"""Finds everything that belongs to a cell by name, from ``BENCHMARK.json``
at the root of the checkout: the cell's workload entry, its configuration
file, its traffic file (``bench/traffic/<traffic>.json``), its limits
(``bench/limits/<cell>.json``), the per-layer and end-to-end metric readers
(``bench/metrics/<metric>.py``) and the module that drives its kind of
traffic (``bench/kinds/<kind>.py``).  A new cell, mix or metric is new
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: Dict        # the configuration file's object
    traffic: Dict       # the traffic file's object
    limits: Dict        # the cell's limits file's object
    e2e: List[Dict]     # end-to-end metric entries the cell reports
    per_layer: List[Dict]  # per-layer metric entries the cell reports
    root: Path


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _checked(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError if the
    benchmark has no such cell."""
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    traffic = _checked(w["traffic"], "traffic")
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(root / entry["file"]),
        traffic=_json(root / "bench" / "traffic" / f"{traffic}.json"),
        limits=_json(root / "bench" / "limits" / f"{_checked(name, 'cell')}"
                     ".json"),
        e2e=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(cell: Cell, metric: str) -> ModuleType:
    """``bench/metrics/<metric>.py``: a module with ``read(ctx)`` returning
    the metric's value, or None where it finds nothing to read."""
    name = _checked(metric, "metric")
    path = cell.root / "bench" / "metrics" / f"{name}.py"
    return load_module(path, "bench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))


def kind_driver(cell: Cell) -> ModuleType:
    """``bench/kinds/<kind>.py`` of the cell's traffic."""
    kind = _checked(cell.traffic["kind"], "kind")
    return load_module(cell.root / "bench" / "kinds" / f"{kind}.py",
                       "bench_kind_" + kind)


def read_metrics(cell: Cell, entries: List[Dict], ctx) -> Dict[str, Dict]:
    """``{name: {"value", "unit"}}`` of every entry whose reader finds
    something to read."""
    out: Dict[str, Dict] = {}
    for m in entries:
        value: Optional[float] = metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
