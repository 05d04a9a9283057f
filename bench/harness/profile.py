"""Traces of a run, reduced in memory to what the per-layer readers need.

A traced run records two traces; nothing is written to disk:

* the timeline: the measured window under ``torch.profiler`` with the
  device's activity alone (no host operations, no shapes), between two
  marker kernels the harness launches first and last, so that the host
  runs at nearly its untraced pace and the idle share is the program's
  (:func:`reduce_timeline`);
* the shapes trace: a few more units of the same traffic after the window,
  with the host's operations and their input shapes, which the roofline
  readers need and which slows the host (:func:`reduce_profile`).

The kineto events are read once (``key_averages()`` builds a Python event
tree that takes a minute for a window this size) into a :class:`Trace`:

* every device interval (kernels, copies, sets) with the correlation id of
  the host operation that launched it;
* the matmul operations (``aten::mm``, ``aten::addmm``, ``aten::bmm``) with
  their shapes and dtypes, by correlation id;
* the name of every host operation, by correlation id;
* the steps, from the benchmark's own ``bench.step`` spans, with the batch
  rows and sequence length the harness recorded for each, in order.

A device interval belongs to the host operation that launched it, the
innermost one open at the launch.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

STEP_SPAN = "bench.step"
MARKER = "spin_kernel"  # ``torch.cuda._sleep``'s kernel, the timeline's ends
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm")


@dataclass
class Kernel:
    name: str
    start_ns: int
    end_ns: int
    corr: int  # correlation id of the launching host operation


@dataclass
class Step:
    rows: int
    seq: int
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    kernels: List[Kernel] = field(default_factory=list)
    matmuls: Dict[int, Tuple[str, list, list]] = field(default_factory=dict)
    op_names: Dict[int, str] = field(default_factory=dict)
    steps: List[Step] = field(default_factory=list)

    @property
    def window(self) -> Tuple[int, int]:
        """(first step's start, last step's end) in ns."""
        return self.steps[0].start_ns, self.steps[-1].end_ns

    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e9

    def in_window(self) -> List[Kernel]:
        t0, t1 = self.window
        return [k for k in self.kernels if k.end_ns > t0 and k.start_ns < t1]

    def busy_s(self) -> float:
        """Seconds in which any device activity ran, inside the window."""
        t0, t1 = self.window
        busy, cur_s, cur_e = 0, None, None
        for k in sorted(self.in_window(), key=lambda k: k.start_ns):
            s, e = max(k.start_ns, t0), min(k.end_ns, t1)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def step_of(self, t_ns: int) -> Optional[Step]:
        """The step whose span holds ``t_ns`` (a kernel's start)."""
        i = bisect.bisect_right([st.start_ns for st in self.steps], t_ns) - 1
        if i >= 0 and t_ns <= self.steps[i].end_ns:
            return self.steps[i]
        return None

    def device_ops(self, top: int = 10) -> List[List]:
        """[name, seconds] of the device operations that took most time."""
        by: Dict[str, float] = {}
        for k in self.in_window():
            by[k.name] = by.get(k.name, 0.0) + (k.end_ns - k.start_ns) / 1e9
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[name, seconds]: the device's idle time inside the window, each
        gap charged to the host operation that launched the work ending
        it (what the host was doing while the device waited)."""
        t0, t1 = self.window
        by: Dict[str, float] = {}
        end = t0
        for k in sorted(self.in_window(), key=lambda k: k.start_ns):
            if k.start_ns > end:
                name = self.op_names.get(k.corr, "(unattributed)")
                by[name] = by.get(name, 0.0) + (k.start_ns - end) / 1e9
            end = max(end, k.end_ns)
        if t1 > end:
            by["(after the last kernel)"] = (by.get("(after the last "
                                                    "kernel)", 0.0)
                                             + (t1 - end) / 1e9)
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
            and e.name() != STEP_SPAN]


def reduce_timeline(prof) -> Trace:
    """A :class:`Trace` of a device-only profile whose window lies between
    the first and the last marker kernel: the device activity between
    them, and one span, with no shape, for the whole window."""
    events = sorted(_device_events(prof), key=lambda e: e.start_ns())
    marks = [i for i, e in enumerate(events) if MARKER in e.name()]
    tr = Trace()
    if len(marks) < 2:
        return tr
    first, last = events[marks[0]], events[marks[-1]]
    tr.kernels = [Kernel(e.name(), e.start_ns(), e.end_ns(),
                         e.linked_correlation_id())
                  for e in events[marks[0] + 1:marks[-1]]]
    tr.steps = [Step(0, 0, first.end_ns(), last.start_ns())]
    return tr


def reduce_profile(prof, shapes: List[Tuple[int, int]]) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile`` whose
    window ran one ``bench.step`` span per entry of ``shapes`` ((rows,
    seq) of each step, in order)."""
    from torch.autograd import DeviceType
    tr = Trace()
    spans = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the device-side copy of a span is no device activity
            if e.duration_ns() > 0 and name != STEP_SPAN:
                tr.kernels.append(Kernel(name, e.start_ns(), e.end_ns(),
                                         e.linked_correlation_id()))
            continue
        if name == STEP_SPAN:
            spans.append((e.start_ns(), e.end_ns()))
        # host operations; runtime calls (a launch) link to their operation
        if e.linked_correlation_id() == 0 and e.correlation_id():
            corr = e.correlation_id()
            tr.op_names[corr] = name
            if name in MATMUL_OPS:
                tr.matmuls[corr] = (name, list(e.shapes()),
                                    list(e.dtypes()))
    spans.sort()
    if len(spans) != len(shapes):
        raise RuntimeError(f"the trace holds {len(spans)} step spans for "
                           f"{len(shapes)} steps")
    tr.steps = [Step(r, s, a, b) for (r, s), (a, b) in zip(shapes, spans)]
    return tr
