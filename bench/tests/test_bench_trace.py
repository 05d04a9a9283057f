"""The idle-share and roofline arithmetic on a synthetic trace, and the
reduction of a real (CPU) profile."""
from types import SimpleNamespace

import pytest
import torch

from bench.costs import flash, matmul
from bench.costs.peaks import bound_s
from bench.harness import spec
from bench.harness.profile import (MARKER, Kernel, Step, STEP_SPAN, Trace,
                                   reduce_profile, reduce_timeline)
from bench.tests.conftest import CELLS

MS = 1_000_000  # ns


def synthetic():
    """Two steps of 10 ms: kernels busy 0-3, 2-5 (overlapping), 6-9 ms in
    the first and 12-19 ms in the second; one kernel before the window."""
    tr = Trace()
    tr.steps = [Step(8, 1024, 0, 10 * MS), Step(8, 72, 10 * MS, 20 * MS)]
    tr.kernels = [
        Kernel("early", -5 * MS, -4 * MS, 1),
        Kernel("ampere_sgemm_128x64", 0, 3 * MS, 11),
        Kernel("void flash_fwd_kernel<float, 64>", 2 * MS, 5 * MS, 12),
        Kernel("ampere_sgemm_128x64", 6 * MS, 9 * MS, 13),
        Kernel("void bwd_dkv_kernel<float, 64>", 12 * MS, 19 * MS, 14),
    ]
    tr.op_names = {11: "aten::mm", 12: "bench.step", 13: "aten::bmm",
                   14: "aten::copy_"}
    tr.matmuls = {11: ("aten::mm", [[8192, 1600], [1600, 6400]],
                       ["float", "float"]),
                  13: ("aten::bmm", [[64, 960, 2048], [64, 2048, 1408]],
                       ["float", "float"])}
    return tr


def ctx(tr, m):
    return SimpleNamespace(trace=tr, timeline=tr, m=m, window=None)


def reader(name):
    return spec.metric_reader(spec.load_cell(CELLS[1]), name)


def test_busy_idle_and_breakdown():
    tr = synthetic()
    assert tr.window_s() == pytest.approx(0.020)
    assert tr.busy_s() == pytest.approx(0.005 + 0.003 + 0.007)
    idle = reader("device_idle_pct.train").read(ctx(tr, {}))
    assert idle == pytest.approx(100 * (1 - 0.015 / 0.020))
    ops = dict(tr.device_ops())
    assert ops["ampere_sgemm_128x64"] == pytest.approx(0.006)
    assert "early" not in ops
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::bmm"] == pytest.approx(0.001)       # 5 -> 6 ms
    assert gaps["aten::copy_"] == pytest.approx(0.003)     # 9 -> 12 ms
    assert gaps["(after the last kernel)"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.020 - tr.busy_s())


def test_matmul_and_expert_shares():
    tr = synthetic()
    mm = bound_s(*matmul.cost("aten::mm", *tr.matmuls[11][1:]))
    bmm = bound_s(*matmul.cost("aten::bmm", *tr.matmuls[13][1:]))
    got = reader("matmul_roofline_pct.train").read(ctx(tr, {}))
    assert got == pytest.approx(100 * (mm + bmm) / 0.006)
    experts = reader("expert_bmm_roofline_pct.train")
    assert experts.read(ctx(tr, {"n_experts": 64})) == pytest.approx(
        100 * bmm / 0.003)
    assert experts.read(ctx(tr, {"n_experts": 8})) is None
    assert experts.read(ctx(tr, {})) is None


def test_flash_share_takes_each_launch_from_its_step():
    tr = synthetic()
    m = {"n_heads": 25, "d_model": 1600, "head_dim": 64}
    want = (bound_s(*flash.cost("fwd", 8 * 25, 1024, 64))
            + bound_s(*flash.cost("dkv", 8 * 25, 72, 64)))
    got = reader("flash_roofline_pct.train").read(ctx(tr, m))
    assert got == pytest.approx(100 * want / 0.010)
    assert reader("flash_roofline_pct.train").read(ctx(None, m)) is None


def test_mfu_and_memory_readers():
    from bench.costs.model_flops import train_step_flops
    m = spec.load_cell(CELLS[0]).config["model"]
    w = {"shapes": [(8, 1024), (8, 72)], "seconds": 2.5, "tokens": 8768,
         "peak_bytes": 52e9, "base_bytes": 19e9}
    c = SimpleNamespace(m=m, window=w, trace=None, setup_s=21.0)
    mfu = reader("step_mfu.train").read(c)
    assert mfu == pytest.approx(100 * (train_step_flops(m, 8, 1024)
                                       + train_step_flops(m, 8, 72))
                                / 2.5 / 495e12)
    assert reader("transient_gb.train").read(c) == pytest.approx(33.0)
    assert reader("peak_mem_gb").read(c) == pytest.approx(52.0)
    assert reader("train_tokens_per_s").read(c) == pytest.approx(8768 / 2.5)
    assert reader("setup_s").read(c) == 21.0


def test_reduce_profile_of_a_cpu_window():
    """Steps come from the benchmark's spans in order; matmuls keep their
    shapes.  (A CPU profile has no device events.)"""
    from torch.profiler import ProfilerActivity, profile, record_function
    a, b = torch.randn(32, 16), torch.randn(16, 8)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for _ in range(3):
            with record_function(STEP_SPAN):
                a @ b
                torch.bmm(a[None], b[None])
    tr = reduce_profile(prof, [(4, 64), (4, 8), (4, 16)])
    assert [(s.rows, s.seq) for s in tr.steps] == [(4, 64), (4, 8), (4, 16)]
    assert all(s.start_ns < s.end_ns for s in tr.steps)
    kinds = sorted(op for op, _, _ in tr.matmuls.values())
    assert kinds == ["aten::bmm"] * 3 + ["aten::mm"] * 3
    assert [[32, 16], [16, 8]] in [shapes for op, shapes, _
                                   in tr.matmuls.values()]
    with pytest.raises(RuntimeError):
        reduce_profile(prof, [(4, 64)])


class _Event:
    """What ``reduce_timeline`` reads of a kineto event."""

    def __init__(self, name, start_ms, end_ms, device="cuda"):
        from torch.autograd import DeviceType
        self._name, self._s, self._e = name, start_ms * MS, end_ms * MS
        self._dev = DeviceType.CUDA if device == "cuda" else DeviceType.CPU

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._dev

    def linked_correlation_id(self):
        return 7


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_timeline_lies_between_the_markers():
    """The window runs from the first marker's end to the last one's start;
    device work outside it and host events are left out."""
    events = [_Event("ampere_sgemm", -3, -2),
              _Event(f"{MARKER}(long)", 0, 1),
              _Event("cudaLaunchKernel", 1, 2, device="cpu"),
              _Event("ampere_sgemm", 3, 6),
              _Event("void flash_fwd_kernel<float, 64>", 5, 8),
              _Event(f"{MARKER}(long)", 11, 12),
              _Event("ampere_sgemm", 13, 14)]
    tr = reduce_timeline(_prof(events))
    assert [k.name for k in tr.kernels] == [
        "ampere_sgemm", "void flash_fwd_kernel<float, 64>"]
    assert tr.window_s() == pytest.approx(0.010)
    assert tr.busy_s() == pytest.approx(0.005)
    idle = reader("device_idle_pct.train").read(ctx(tr, {}))
    assert idle == pytest.approx(50.0)
    assert dict(tr.device_ops())["ampere_sgemm"] == pytest.approx(0.003)


def test_timeline_without_markers_is_empty():
    tr = reduce_timeline(_prof([_Event("ampere_sgemm", 0, 3)]))
    assert not tr.kernels and not tr.steps
    assert reader("device_idle_pct.train").read(ctx(tr, {})) is None


@pytest.mark.parametrize("name", [CELLS[0], CELLS[2]])
def test_a_traced_run_traces_units_after_the_window(tiny_run, name):
    """The shapes trace holds the traffic's ``traced_units`` units, one span
    a step with that step's shape; the CPU has no timeline."""
    cell, out = tiny_run(name, trace=True)
    win = out["window"]
    assert win["timeline"] is None
    steps = [(s.rows, s.seq) for s in win["trace"].steps]
    if cell.traffic["window"] == "ramp":
        assert cell.traffic["traced_units"] == 1
        assert steps == win["shapes"][:len(steps)]
        assert steps[0][1] < steps[-1][1] <= 64
    else:
        assert steps == [(4, 64)] * cell.traffic["traced_units"]
    assert win["trace"].matmuls
