"""The readers of the program's own spans and counters
(``bench/harness/spans.py``) on synthetic spans and device intervals: the
window's steps picked out on the profiler's clock, the clock's two
anchors, each step placed on the device's clock by its own copy (or left
on the host's where the copy is not its own), the idle time split at
``train_step`` and charged to the innermost span, and nothing read where
the anchors disagree, the shapes differ or the program has no tracer."""
from types import SimpleNamespace

import pytest

from bench.harness import spans as spans_mod
from bench.harness import spec
from bench.harness.profile import Kernel, Step, Trace
from bench.tests.conftest import CELLS
from repro_torch.core.trace import Span

US = 1_000  # ns
CLOCK = 5_000_000_000  # the profiler's clock - perf_counter_ns

# one step of 1000 us on the host: (name, depth, start, end) in us
STEP = [("trainer.step", 0, 0, 1000), ("trainer.plan", 1, 10, 20),
        ("trainer.batch", 1, 20, 60), ("trainer.apply", 1, 60, 70),
        ("trainer.to_device", 1, 70, 100), ("train_step", 1, 100, 700),
        ("step.forward", 2, 100, 300), ("moe.route", 3, 150, 200),
        ("step.backward", 2, 300, 500), ("moe.route", 3, 350, 400),
        ("step.optimizer", 2, 500, 700), ("trainer.sync", 1, 700, 900),
        ("trainer.observe", 1, 900, 980)]
DEVICE_MS = {("moe.route", 3): 0.1, ("step.optimizer", 2): 0.25}
SHAPES = [(8, 72), (8, 168)]


def program_spans(n=2, t0_us=0, shapes=SHAPES, kept=30, out=None,
                  slew_us=(0, 0)):
    """``n`` steps of STEP, 1000 us apart; step ``s``'s clock pair reads
    ``slew_us[s]`` off."""
    out = [] if out is None else out
    for s in range(n):
        stack = []
        base = t0_us + 1000 * s
        for name, depth, a, b in STEP:
            stack = stack[:depth]
            sp = Span(name, stack[-1] if stack else None, s,
                      (base + a) * US, (base + b) * US)
            if depth == 0:
                sp.wall_ns = sp.start_ns + CLOCK + slew_us[s] * US
                sp.counts = {"rows": shapes[s][0], "seq": shapes[s][1],
                             "moe.assigned": 32, "moe.kept": kept,
                             "moe.slots": 40}
            if name == "moe.route" or name == "step.optimizer":
                sp.device_ms = DEVICE_MS[(name, depth)]
            stack.append(len(out))
            out.append(sp)
    return out


def timeline(copy_shift_us=(0, 0), end_us=2100, skew_us=(0, 0)):
    """Busy 120-690 us of each step; the step's device-to-host copy runs
    880-900 us (the host leaves ``trainer.sync`` at 900), later by
    ``copy_shift_us``; all of step ``s``'s device work stamped ``skew_us[s]``
    late."""
    tr = Trace()
    tr.steps = [Step(0, 0, CLOCK, CLOCK + end_us * US)]
    for s in range(2):
        b = CLOCK + (1000 * s + skew_us[s]) * US
        tr.kernels.append(Kernel("sm80_xmma_gemm", b + 120 * US,
                                 b + 690 * US, 1))
        e = b + (900 + copy_shift_us[s]) * US
        tr.kernels.append(Kernel("Memcpy DtoH (Device -> Pageable)",
                                 e - 20 * US, e, 2))
    return tr


def ctx(tl, taken, monkeypatch, shapes=SHAPES):
    monkeypatch.setattr(spans_mod, "_take", lambda: taken)
    return SimpleNamespace(timeline=tl, trace=None, m={},
                           window={"shapes": list(shapes)})


def reader(name):
    return spec.metric_reader(spec.load_cell(CELLS[1]), name)


def read(name, c):
    return reader(name).read(c)


def test_idle_splits_at_train_step_and_sums_to_device_idle(monkeypatch,
                                                           capsys):
    tl = timeline()
    # a third step, seconds later (the shapes trace), is not the window's
    taken = program_spans(1, t0_us=9_000_000, out=program_spans())
    c = ctx(tl, taken, monkeypatch)
    win = spans_mod.of(c)
    assert len(win.steps) == 2
    assert win.mapped and win.host_ns == CLOCK
    assert win.anchors_ns == (CLOCK, CLOCK) and win.shift_ns == [0, 0]
    # idle a step: 0-120, 690-880 (the copy runs 880-900), 900-1000 us;
    # then 2000-2100 after the steps.  Inside train_step (100-700): 30 us.
    launch = read("launch_idle_pct.train", c)
    boundary = read("boundary_idle_pct.train", c)
    assert launch == pytest.approx(100 * 60 / 2100)
    assert boundary == pytest.approx(100 * (820 - 60 + 100) / 2100)
    idle = read("device_idle_pct.train", c)
    assert launch + boundary == pytest.approx(idle, abs=1e-9)
    err = capsys.readouterr().err
    assert "idle by span" in err and "clock anchors" in err
    assert "kept 60 of 64 top-k assignments (93.75%)" in err


def test_idle_is_charged_to_the_innermost_span(monkeypatch):
    c = ctx(timeline(), program_spans(), monkeypatch)
    table = dict(spans_mod.idle_by_span(c))
    want_us = {"trainer.step": 30, "trainer.plan": 10, "trainer.batch": 40,
               "trainer.apply": 10, "trainer.to_device": 30,
               "step.forward": 20, "step.optimizer": 10,
               "trainer.sync": 180, "trainer.observe": 80}
    for name, us in want_us.items():
        assert table.pop(name) == pytest.approx(2 * us * 1e-6), name
    assert table.pop("(outside any span)") == pytest.approx(100e-6)
    assert all(v == 0 for v in table.values())
    names = {p[2] for p in spans_mod.innermost(spans_mod.of(c))}
    assert {"moe.route", "moe.route in step.backward"} <= names


def test_the_span_readers(monkeypatch):
    c = ctx(timeline(), program_spans(kept=30), monkeypatch)
    assert read("control_plane_ms.train", c) == pytest.approx(
        (10 + 40 + 10 + 30 + 80) / 1000)
    assert read("optimizer_ms.train", c) == pytest.approx(0.25)
    assert read("moe_routing_ms.train", c) == pytest.approx(0.2)
    assert read("expert_slot_fill_pct.train", c) == pytest.approx(75.0)


def test_anchors_that_disagree_map_nothing(monkeypatch):
    """The last step's clock pair reads 60 us off the first's: more than
    50 us."""
    c = ctx(timeline(), program_spans(slew_us=(0, 60)), monkeypatch)
    win = spans_mod.of(c)
    assert win.anchors_ns == (CLOCK, CLOCK + 60 * US) and not win.mapped
    assert read("launch_idle_pct.train", c) is None
    assert read("boundary_idle_pct.train", c) is None
    assert spans_mod.idle_by_span(c) is None
    # what needs no device interval still reads
    assert read("control_plane_ms.train", c) is not None
    # 40 us apart: mapped by the median
    c = ctx(timeline(), program_spans(slew_us=(0, 40)), monkeypatch)
    win = spans_mod.of(c)
    assert win.mapped and win.host_ns == CLOCK + 40 * US


def test_each_step_is_placed_by_its_own_copy(monkeypatch):
    """The device's stamps of the second step run 100 us late: placed by
    its copy, the step reads as if they did not (30 us idle inside
    ``train_step`` a step); placed by the host's clock alone it would read
    120 us there."""
    c = ctx(timeline(skew_us=(0, 100)), program_spans(), monkeypatch)
    win = spans_mod.of(c)
    assert win.mapped and win.shift_ns == [0, 100 * US]
    assert read("launch_idle_pct.train", c) == pytest.approx(
        100 * 60 / 2100)
    assert read("launch_idle_pct.train", c) + read(
        "boundary_idle_pct.train", c) == pytest.approx(
            read("device_idle_pct.train", c), abs=1e-9)
    table = spans_mod.idle_by_span(c)
    assert sum(v for _, v in table) == pytest.approx(920e-6)


def test_a_copy_not_its_own_leaves_the_step_on_the_hosts_clock(
        monkeypatch):
    """The last step's copy lies 30 ms off: both steps find the first
    step's copy nearest, so both stay on the host's clock; 400 us off, the
    copy places its step."""
    c = ctx(timeline(copy_shift_us=(0, 30_000), end_us=40_000),
            program_spans(), monkeypatch)
    win = spans_mod.of(c)
    assert win.mapped and win.shift_ns == [0, 0] and win.unplaced == 2
    c = ctx(timeline(copy_shift_us=(0, 400), end_us=2500),
            program_spans(), monkeypatch)
    win = spans_mod.of(c)
    assert win.shift_ns == [0, 400 * US] and win.unplaced == 0
    assert read("launch_idle_pct.train", c) + read(
        "boundary_idle_pct.train", c) == pytest.approx(
            read("device_idle_pct.train", c), abs=1e-9)


def test_nothing_is_read_without_a_matching_window(monkeypatch):
    names = ["launch_idle_pct.train", "boundary_idle_pct.train",
             "control_plane_ms.train", "optimizer_ms.train",
             "moe_routing_ms.train", "expert_slot_fill_pct.train"]
    cases = [(timeline(), None, SHAPES),               # no tracer
             (timeline(), [], SHAPES),                 # nothing traced
             (timeline(), program_spans(), [(8, 72)] * 2),  # other shapes
             (None, program_spans(), SHAPES)]          # no timeline
    for tl, taken, shapes in cases:
        c = ctx(tl, taken, monkeypatch, shapes)
        assert [read(n, c) for n in names] == [None] * len(names)


def test_overlaps():
    idle = [(0, 10), (20, 30), (40, 50)]
    assert spans_mod.overlaps(idle, [(5, 25), (25, 45), (60, 70)]) == [
        10, 10, 0]
    assert spans_mod.overlaps([], [(0, 1)]) == [0]


def test_a_cpu_traced_run_reads_no_span_metric(tiny_run):
    """On the CPU there is no timeline: the new readers read nothing and
    take the spans the shapes trace left in the program's tracer."""
    from repro_torch.core import trace
    name = CELLS[3]
    cell, out = tiny_run(name, trace=True)
    c = SimpleNamespace(m=out["m"], window=out["window"],
                        trace=out["window"]["trace"],
                        timeline=out["window"]["timeline"],
                        setup_s=out["setup_s"], cell=cell)
    new = [m for m in cell.per_layer if m["source"] in
           ("program_span", "program_counter")
           and m["name"] != "transient_gb.train"]
    assert len(new) == 6
    assert spec.read_metrics(cell, new, c) == {}
    assert trace.take() == []
    assert not trace.enabled()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _excursions(taken, host_events, host_ns):
    """For each host aten op that starts inside a program span (its start
    moved onto perf_counter_ns), how far past that span's end it ends, in
    ns (0 if inside)."""
    ivs = [(sp.start_ns, sp.end_ns) for sp in taken]
    worst = []
    for name, s, e in host_events:
        s, e = s - host_ns, e - host_ns
        for a, b in ivs:
            if a <= s < b:
                worst.append(max(0, e - b))
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_spans_on_the_cards_clock(card, name, capsys):
    """On the card, at the cell's widths with 2 layers: the timeline's two
    anchors agree within 50 us, each step's device-to-host copy places it,
    and launch + boundary idle is the device idle;
    in a pass traced with host ops, every aten op that starts inside a
    program span ends inside it on the profiler's clock, to within the
    clock's own reading (:data:`HOST_OPS_NS`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trace
    cell = spec.load_cell(name)
    drv = spec.kind_driver(cell)
    m = drv.model_dict(cell.config, {"n_layers": 2})
    prog = drv.Program(m, cell.traffic, cell.config["remat"], 2 ** 31 + 11,
                       card)
    prog.first_steps()
    trace.take()
    win = drv.run_window(prog, 3.0, timeline=True)
    if not win["timeline"].kernels:  # as the harness: CUPTI's odd miss
        win = drv.run_window(prog, 3.0, timeline=True)
    c = SimpleNamespace(timeline=win["timeline"], window=win, trace=None,
                        m=m)
    w = spans_mod.of(c)
    assert w is not None, (len(c.timeline.kernels), win["shapes"])
    a, b = w.anchors_ns
    launch, boundary = spans_mod.idle_split(c)
    idle = read("device_idle_pct.train", c)
    window_s = c.timeline.window_s()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(3):
            prog.trainer.run_step()
        torch.cuda.synchronize()
    taken = trace.take()
    host_ns = spans_mod._median([sp.wall_ns - sp.start_ns for sp in taken
                                 if sp.parent is None])
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith("aten::")]
    worst = _excursions(taken, ops, host_ns)
    with capsys.disabled():
        print(f"\n{name}: anchors differ {abs(a - b)} ns; steps' copies at most "
              f"{max(map(abs, w.shift_ns))} ns off; idle "
              f"{idle:.4f}% "
              f"= launch {100 * launch / window_s:.4f} + boundary "
              f"{100 * boundary / window_s:.4f}; {len(worst)} host ops "
              f"start in spans, {sum(x > 0 for x in worst)} end past "
              f"them, by at most {max(worst)} ns")
    assert abs(a - b) <= spans_mod.ANCHOR_NS
    assert w.mapped
    assert 100 * (launch + boundary) / window_s == pytest.approx(idle,
                                                                 abs=0.01)
    assert worst and max(worst) <= HOST_OPS_NS
    prog.free()


# the profiler stamps host ops from the CPU's cycle counter converted to
# time.time_ns()'s clock, which the tracer reads beside perf_counter_ns;
# the two readings agree to a few us (7.3 us at worst on the card)
HOST_OPS_NS = 10_000
