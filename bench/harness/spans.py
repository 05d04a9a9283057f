"""The program's own spans and counters (``repro_torch.core.trace``), read
beside the timeline on the device's clock.

The program's tracer records whenever a ``torch.profiler`` session records,
so a traced run's two profiled passes (the timeline window and the shapes
trace) leave their spans in it, and the untraced run that gives the
end-to-end metrics leaves none.  :func:`of` takes them once a run, as
``ctx.spans``, and keeps the timeline window's steps:

1. The host's clock.  The profiler stamps host events on
   ``time.time_ns()``'s clock; the tracer reads ``time.time_ns()`` beside
   ``time.perf_counter_ns()`` at each step's start.  Their difference at the
   window's first step and at its last are the pass's two anchors, which
   must agree within :data:`ANCHOR_NS`; the host offset is the window's
   median difference.
2. The steps: the outermost spans (``trainer.step``) whose host interval,
   so mapped, lies in the timeline's window.  There must be as many as the
   window ran steps, of the same shapes, or nothing is read.
3. The device's clock.  The profiler maps the device's timestamps onto the
   host's clock, but for stretches of a few steps that mapping wanders (on
   the H100: a step's device-to-host copy ended up to 1.6 ms before, or
   0.3 ms after, the host's call that waited for it, and one step's 9.2 ms
   off).  So each step is placed by its own copy: ``trainer.sync`` holds
   the step's one device-to-host copy, and the host leaves it a steady time
   after the copy ends (the median over the window's steps).  A step whose
   nearest copy another step shares, or lies further than
   :data:`WANDER_NS` from its place, is not its own: that step stays on the
   host's clock.

Where the anchors disagree, the readers that map spans onto the device's
intervals read nothing.

A parent commit's program has no tracer: then ``ctx.spans`` is None and
every reader of it reads nothing.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

ROOT_SPAN = "trainer.step"
STEP_SPAN = "train_step"
SYNC_SPAN = "trainer.sync"
CONTROL_SPANS = ("trainer.plan", "trainer.batch", "trainer.apply",
                 "trainer.to_device", "trainer.observe")
D2H = "DtoH"  # in the name of a device-to-host copy's trace event
ANCHOR_NS = 50_000  # the most the two anchors of a pass may differ by
WANDER_NS = 25_000_000  # the most a step's copy may lie from its place
# (a step lasts 100 ms or more)
SELECT_NS = 50_000_000  # how far the host's and the profiler's clocks may
# differ when the window's steps are picked out (passes lie seconds apart)

Interval = Tuple[int, int]


@dataclass
class Window:
    """The timeline window's steps among the program's spans."""

    spans: list          # every span the tracer handed over
    steps: List[int]     # indices of the window's outermost spans
    kids: Dict[int, List[int]]  # children of each span, in start order
    host_ns: int         # profiler clock - perf_counter_ns (the median)
    anchors_ns: Tuple[int, int]  # at the first and the last step
    # per step: how far its copy lies from where the host puts it (the
    # device's clock against the host's; 0 for a step left on the host's
    # clock), those steps, and whether the anchors agree
    shift_ns: Optional[List[int]] = None
    unplaced: int = 0
    mapped: bool = False

    def in_step(self, step: int) -> List[int]:
        """The spans of one step, the outermost first."""
        out, todo = [], [step]
        while todo:
            i = todo.pop()
            out.append(i)
            todo.extend(reversed(self.kids.get(i, [])))
        return out

    def named(self, names: Sequence[str]) -> List[List[int]]:
        """Per step, its spans named in ``names``."""
        return [[i for i in self.in_step(s) if self.spans[i].name in names]
                for s in self.steps]

    def interval(self, i: int, offset: int) -> Interval:
        sp = self.spans[i]
        return sp.start_ns + offset, sp.end_ns + offset

    def device_interval(self, i: int, k: int) -> Interval:
        """Span ``i`` of step ``k`` on the device's clock."""
        return self.interval(i, self.host_ns + self.shift_ns[k])


def of(ctx) -> Optional[Window]:
    """``ctx.spans``: the window's steps among the spans the program's
    tracer took, or None (no tracer, no timeline, or no match)."""
    if not hasattr(ctx, "spans"):
        ctx.spans = None
        taken = _take()
        tl = ctx.timeline
        if taken and tl is not None and tl.kernels:
            ctx.spans = window(taken, tl, ctx.window["shapes"])
        if ctx.spans is not None:
            _print_idle_table(ctx)
    return ctx.spans


def _take():
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace.take()


def window(spans: list, timeline, shapes: Sequence[Tuple[int, int]]
           ) -> Optional[Window]:
    """The :class:`Window` of ``spans`` in a timeline ``Trace`` whose window
    ran steps of ``shapes`` ((rows, seq) each), or None."""
    roots = [i for i, sp in enumerate(spans)
             if sp.parent is None and sp.name == ROOT_SPAN and sp.end_ns >= 0]
    if not roots:
        return None
    coarse = _median([spans[i].wall_ns - spans[i].start_ns for i in roots])
    w0, w1 = timeline.window
    steps = [i for i in roots
             if spans[i].start_ns + coarse >= w0 - SELECT_NS
             and spans[i].end_ns + coarse <= w1 + SELECT_NS]
    got = [(spans[i].counts.get("rows"), spans[i].counts.get("seq"))
           for i in steps]
    if got != [tuple(s) for s in shapes]:
        return None
    kids: Dict[int, List[int]] = {}
    for i, sp in enumerate(spans):
        if sp.parent is not None:
            kids.setdefault(sp.parent, []).append(i)
    host = [spans[i].wall_ns - spans[i].start_ns for i in steps]
    win = Window(spans, steps, kids, _median(host), (host[0], host[-1]))
    syncs = [ids[-1] for ids in win.named((SYNC_SPAN,)) if ids]
    if len(syncs) != len(steps):
        return win
    ends = [k.end_ns for k in timeline.in_window() if D2H in k.name]
    # each step's copy (the one ending nearest to where the host leaves
    # trainer.sync), and how long before the host leaves it the copy ends
    left = [win.interval(i, win.host_ns)[1] for i in syncs]
    own = [min(ends, key=lambda e: abs(e - t)) if ends else None
           for t in left]
    gap = [t - e if e is not None and own.count(e) == 1 else None
           for t, e in zip(left, own)]
    known = [g for g in gap if g is not None]
    tail = _median(known) if known else 0
    placed = [g is not None and abs(tail - g) <= WANDER_NS for g in gap]
    win.shift_ns = [tail - g if ok else 0 for g, ok in zip(gap, placed)]
    win.unplaced = placed.count(False)
    win.mapped = abs(host[0] - host[-1]) <= ANCHOR_NS
    return win


def _median(xs: List[int]) -> int:
    return sorted(xs)[len(xs) // 2]


# ---------------------------------------------------------------------------
# interval arithmetic on the device's clock
# ---------------------------------------------------------------------------

def idle_intervals(timeline) -> List[Interval]:
    """The timeline window's stretches with no device activity, in order
    (the complement of ``Trace.busy_s``'s union)."""
    t0, t1 = timeline.window
    out, end = [], t0
    for k in sorted(timeline.in_window(), key=lambda k: k.start_ns):
        s, e = max(k.start_ns, t0), min(k.end_ns, t1)
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if t1 > end:
        out.append((end, t1))
    return out


def overlaps(idle: List[Interval], pieces: List[Interval]) -> List[int]:
    """The overlap of each of ``pieces`` with ``idle``, both sorted lists of
    disjoint intervals."""
    out, i = [], 0
    for s, e in pieces:
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        got, j = 0, i
        while j < len(idle) and idle[j][0] < e:
            got += max(0, min(e, idle[j][1]) - max(s, idle[j][0]))
            j += 1
        out.append(got)
    return out


def idle_split(ctx) -> Optional[Tuple[float, float]]:
    """(launch, boundary): the timeline window's idle seconds while the
    host was inside ``train_step``, and outside it, or None."""
    win = of(ctx)
    if win is None or not win.mapped:
        return None
    idle = idle_intervals(ctx.timeline)
    inside: List[Interval] = []
    for s, e in sorted(win.device_interval(i, k)
                       for k, ids in enumerate(win.named((STEP_SPAN,)))
                       for i in ids):
        if inside and s < inside[-1][1]:  # steps placed by other copies
            inside[-1] = (inside[-1][0], max(e, inside[-1][1]))
        else:
            inside.append((s, e))
    launch = sum(overlaps(idle, inside))
    total = sum(e - s for s, e in idle)
    return launch / 1e9, (total - launch) / 1e9


def innermost(win: Window) -> List[Tuple[int, int, str]]:
    """The window's steps cut into (start, end, name) pieces on the
    device's clock, each named after the innermost span open on the host
    then; a span inside the backward pass's recompute is named ``<name> in
    step.backward``."""
    out: List[Tuple[int, int, str]] = []

    def walk(i: int, step: int, label_under: bool) -> None:
        sp = win.spans[i]
        label = (f"{sp.name} in step.backward" if label_under
                 else sp.name)
        under = label_under or sp.name == "step.backward"
        s, e = win.device_interval(i, step)
        cur = s
        for c in win.kids.get(i, []):
            cs, ce = win.device_interval(c, step)
            if cs > cur:
                out.append((cur, cs, label))
            walk(c, step, under)
            cur = max(cur, ce)
        if e > cur:
            out.append((cur, e, label))

    for k, root in enumerate(win.steps):
        walk(root, k, False)
    # two steps placed by different copies may touch: the later one starts
    # where the earlier one ended
    pieces, end = [], None
    for s, e, name in sorted(out):
        s = s if end is None else max(s, end)
        if e > s:
            pieces.append((s, e, name))
            end = e
    return pieces


def idle_by_span(ctx) -> Optional[List[List]]:
    """[name, seconds]: the window's idle time charged to the innermost
    program span open on the host during it, or to "(outside any span)";
    most first."""
    win = of(ctx)
    if win is None or not win.mapped:
        return None
    idle = idle_intervals(ctx.timeline)
    pieces = innermost(win)
    got = overlaps(idle, [(s, e) for s, e, _ in pieces])
    by: Dict[str, float] = {}
    for (_, _, name), ns in zip(pieces, got):
        by[name] = by.get(name, 0.0) + ns / 1e9
    by["(outside any span)"] = (sum(e - s for s, e in idle)
                                - sum(got)) / 1e9
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])]


def _print_idle_table(ctx) -> None:
    win = ctx.spans
    a, b = win.anchors_ns
    shift = win.shift_ns or [0]
    print(f"spans: {len(win.steps)} steps; clock anchors {a} / {b} ns "
          f"(profiler - perf_counter), differ {abs(a - b)} ns; the device's "
          f"clock against the host's, by each step's copy: median 0, "
          f"{min(shift)} to {max(shift)} ns, "
          f"{sum(abs(x) > 100_000 for x in shift)} steps beyond 100 us, "
          f"{win.unplaced} left on the host's clock; mapped: {win.mapped}",
          file=sys.stderr)
    counts = [win.spans[i].counts for i in win.steps]
    assigned = sum(c.get("moe.assigned", 0) for c in counts)
    if assigned:
        kept = sum(c.get("moe.kept", 0) for c in counts)
        print(f"moe: the window kept {kept:.0f} of {assigned:.0f} top-k "
              f"assignments ({100 * kept / assigned:.2f}%)", file=sys.stderr)
    rows = idle_by_span(ctx)
    if rows is not None:
        print("idle by span (timeline window, s): "
              + ", ".join(f"{n} {v:.6f}" for n, v in rows), file=sys.stderr)


def per_step(win: Window, names: Sequence[str], what) -> Optional[float]:
    """The mean over the window's steps of ``what(span)`` summed over each
    step's spans named in ``names``; None where a step has none or a value
    is None."""
    totals = []
    for ids in win.named(names):
        vals = [what(win.spans[i]) for i in ids]
        if not vals or any(v is None for v in vals):
            return None
        totals.append(sum(vals))
    return sum(totals) / len(totals) if totals else None
