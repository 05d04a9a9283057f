"""The import check and the refusals of a run."""
import json
import subprocess
import sys

from bench.harness import guard
from bench.tests.conftest import ROOT


def test_forbidden_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
             "repro.core.pacing", "repro_torch", "repro_torch.models",
             "reproduce", "jaxtyping", "torch", "numpy"]
    assert guard.forbidden(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "repro",
         "repro.core.pacing"])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU at the tiny size (program, window, reference)
    in a fresh process, then its loaded modules."""
    code = f"""
import sys, time, json, torch
torch.set_num_threads(1)
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from bench.tests.conftest import TINY_MODELS, tiny_traffic
from bench.harness import guard, spec
import bench.reference.train, bench.reference.plan, bench.reference.transformer
cell = spec.load_cell("deepseek-moe-16b.train_slw")
out = spec.kind_driver(cell).run(cell, 5, 0.2, True, time.perf_counter(),
    device="cpu", model_over=TINY_MODELS["deepseek-moe-16b"],
    traffic_over=tiny_traffic(cell.traffic))
print(json.dumps({{"correct": out["correct"],
                  "forbidden": guard.forbidden(sys.modules),
                  "port": "repro_torch" in sys.modules}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import sys, json
sys.path[:0] = [{str(ROOT)!r}]
import bench.reference.train, bench.reference.plan, bench.reference.transformer
import bench.costs.model_flops, bench.costs.flash, bench.costs.matmul
print(json.dumps(sorted(n for n in sys.modules
                        if n.split(".")[0] in ("repro_torch", "repro",
                                               "jax", "flax", "jaxlib"))))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_a_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gpt2-1.5b.train_full",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no result" in res.stderr
