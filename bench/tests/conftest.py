"""The benchmark's tests: the checkout's root and ``src/`` on the path, and
the tiny shapes the CPU runs use."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("gpt2-1.5b.train_full", "deepseek-moe-16b.train_full",
         "gpt2-1.5b.train_slw", "deepseek-moe-16b.train_slw")

# every width cut to a size the CPU runs in seconds
TINY_MODELS = {
    "gpt2-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=300, max_seq_len=64),
    "deepseek-moe-16b": dict(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=4, head_dim=16, d_ff=32,
                             vocab_size=256, n_experts=8, top_k=2,
                             max_seq_len=64),
}


def tiny_traffic(traffic: dict) -> dict:
    """The mix at 4 x 64: a full-length mix starts at 64, a ramp runs 8 ->
    64 over 6 steps."""
    over = {"seq_len": 64, "batch": 4}
    over["slw"] = ({"start_seq_len": 8, "duration_steps": 6}
                   if traffic["window"] == "ramp" else {"start_seq_len": 64})
    return over


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """One intra-op thread a test process: the suite runs several workers
    at once."""
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def tiny_run():
    """``tiny_run(cell_name, seed, hook=None)``: one run of the cell on the
    CPU at the tiny shapes, with a 0.3 s window."""
    import time
    from bench.harness import spec

    def go(name, seed=2 ** 31 + 77, hook=None, trace=False):
        cell = spec.load_cell(name)
        return cell, spec.kind_driver(cell).run(
            cell, seed, 0.3, trace, time.perf_counter(), device="cpu",
            model_over=TINY_MODELS[cell.config["name"]],
            traffic_over=tiny_traffic(cell.traffic), hook=hook)
    return go
