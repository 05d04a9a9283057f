"""BENCHMARK.json against the contract, and cells, mixes and metrics found by
name in files of their own."""
import json
import re
import shutil

import pytest

from bench.harness import spec
from bench.tests.conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_WORDS = ("d_model", "d_ff", "head_dim", "hidden", "intermediate",
               "top_k", "n_heads", "n_kv_heads", "expand", "state")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"][1] == "bench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(cells)) == len(cells) and len(set(metrics)) == len(metrics)
    assert {(w["config"], w["traffic"]) for w in b["workloads"]} and len(
        {(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert not any(w in k for k in c["reduced"] for w in WIDTH_WORDS)
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) | set(cfg["model"])
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert w["config"] in names
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline_pct.train") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.traffic["kind"] == "train"
    compared = set(cell.limits["limits"])
    assert "plan_mismatch" in compared and cell.limits["limits"][
        "plan_mismatch"] == 0
    assert compared <= {"plan_mismatch", "loss_gap", "grad_gap",
                        "change_gap", "grad_gap_median", "change_gap_median"}
    assert not cell.limits.get("provisional", False)
    assert [m["name"] for m in cell.e2e] == ["train_tokens_per_s",
                                             "peak_mem_gb", "setup_s"]
    layer = {m["name"] for m in cell.per_layer}
    assert ("expert_bmm_roofline_pct.train" in layer) == name.startswith(
        "deepseek")
    # every metric that moves an end-to-end metric the cell reports
    assert {m["moves"] for m in cell.per_layer} <= {m["name"]
                                                    for m in cell.e2e}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")


def test_new_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway traffic file, limits file and metric reader, with their
    entries in BENCHMARK.json, are found without editing a file the
    benchmark has."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    traffic = json.loads((ROOT / "bench/traffic/train_full.json").read_text())
    traffic["batch"] = 2
    (tmp_path / "bench/traffic/tmp_mix.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/limits/gpt2-1.5b.tmp_mix.json").write_text(
        (ROOT / "bench/limits/gpt2-1.5b.train_full.json").read_text())
    (tmp_path / "bench/metrics/tmp_rows.py").write_text(
        "def read(ctx):\n    return float(ctx.window['rows'])\n")
    b["workloads"].append({"name": "gpt2-1.5b.tmp_mix", "config": "gpt2-1.5b",
                           "traffic": "tmp_mix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "tmp_rows", "unit": "rows",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "train_tokens_per_s",
                           "workloads": ["gpt2-1.5b.tmp_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("gpt2-1.5b.tmp_mix", tmp_path)
    assert cell.traffic["batch"] == 2
    assert cell.config["name"] == "gpt2-1.5b"
    assert "tmp_rows" in [m["name"] for m in cell.per_layer]
    assert "tmp_rows" not in [m["name"] for m in
                              spec.load_cell("gpt2-1.5b.train_full",
                                             tmp_path).per_layer]

    class Ctx:
        window = {"rows": 2}
    got = spec.read_metrics(cell, [m for m in cell.per_layer
                                   if m["name"] == "tmp_rows"], Ctx())
    assert got == {"tmp_rows": {"value": 2.0, "unit": "rows"}}
