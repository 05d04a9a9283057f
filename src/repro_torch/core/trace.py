"""The port's tracer: named spans and per-step counters, kept in memory on
the host's clock.

* ``span(name)`` times a block: its name, the span it opened in, the step
  index, and host start and end from ``time.perf_counter_ns()``.  With
  ``device=True`` (and CUDA in use) the span also records a CUDA event at
  each end on the current stream: their elapsed time is the device time of
  the work the block issued, from the moment the stream reached it.
* ``count(name, value)`` adds ``value`` to a counter of the current step,
  held by the outermost open span.
* ``take()`` hands the spans over, counters included, and empties the
  tracer.

The tracer records inside the :func:`tracing` context and while a
``torch.profiler`` session records in the process, as ``record_function``
does: profiling the program brings its spans along, so a profiled window
reads the host's phases beside the device's work.  Otherwise ``span()``
returns one shared no-op context: no allocation, no torch op, no device
work.

Spans read clocks and record events; they issue no torch op, so they are
safe inside ``remat_call``'s recompute, whose ``fn`` must issue the same
ops each time it runs.  A span that fires again in the backward pass's
recompute is a child of ``step.backward``: one stack serves every thread,
as the autograd engine's thread runs the recompute while the thread that
opened ``step.backward`` waits for it.

Step metrics named with :data:`METRIC_PREFIX` are counters that ride the
step's one host transfer (the MoE layer's slot counts): the step builds
them only while the tracer records, sums them over layers and shards, and
the trainer hands them to :func:`count`.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

METRIC_PREFIX = "trace/"


@dataclass
class Span:
    name: str
    parent: Optional[int]  # index of the enclosing span in the same list
    step: Optional[int]    # the step index of the outermost span
    start_ns: int          # time.perf_counter_ns()
    end_ns: int = -1
    # outermost spans: time.time_ns() read beside start_ns, and the step's
    # counters
    wall_ns: int = 0
    counts: Dict[str, float] = field(default_factory=dict)
    # spans opened with device=True on CUDA: device ms of the block's work
    device_ms: Optional[float] = None


class _Tracer:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.events: List[Tuple[int, torch.cuda.Event, torch.cuda.Event]] = []
        self.free: List[torch.cuda.Event] = []  # events read, for reuse

    def event(self) -> torch.cuda.Event:
        """A timing event recorded on the current stream now (creating one
        costs tens of us, so a read one is reused)."""
        ev = self.free.pop() if self.free else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        return ev

    def harvest(self) -> None:
        """Read the device times of the spans whose end event the device has
        reached."""
        pending = []
        for i, start, end in self.events:
            if end.query():
                self.spans[i].device_ms = start.elapsed_time(end)
                self.free += (start, end)
            else:
                pending.append((i, start, end))
        self.events = pending


_T = _Tracer()


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _T.on or _profiler._is_profiler_enabled


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record inside the block."""
    was, _T.on = _T.on, True
    try:
        yield
    finally:
        _T.on = was


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("name", "step", "device", "index", "start_event")

    def __init__(self, name: str, step: Optional[int], device: bool):
        self.name, self.step, self.device = name, step, device
        self.start_event = None

    def __enter__(self):
        t = _T
        parent = t.stack[-1] if t.stack else None
        step = self.step
        if step is None and parent is not None:
            step = t.spans[parent].step
        sp = Span(self.name, parent, step, time.perf_counter_ns())
        if parent is None:
            sp.wall_ns = time.time_ns()
        self.index = len(t.spans)
        t.spans.append(sp)
        t.stack.append(self.index)
        if self.device and torch.cuda.is_initialized():
            self.start_event = t.event()
        return None

    def __exit__(self, *exc):
        t = _T
        if self.start_event is not None:
            t.events.append((self.index, self.start_event, t.event()))
        t.spans[self.index].end_ns = time.perf_counter_ns()
        t.stack.pop()
        if not t.stack and t.events:
            t.harvest()  # a step's end: its host transfer drained the stream
        return False


def span(name: str, step: Optional[int] = None, device: bool = False):
    """A context that records the block as a span while the tracer records;
    ``step`` sets the step index of it and its children (else inherited)."""
    if not (_T.on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, step, device)


def count(name: str, value: float) -> None:
    """Add ``value`` to the current step's counter ``name`` (nothing
    outside a span, or while the tracer is off)."""
    t = _T
    if t.stack and (t.on or _profiler._is_profiler_enabled):
        counts = t.spans[t.stack[0]].counts
        counts[name] = counts.get(name, 0) + value


def take() -> List[Span]:
    """Every span recorded since the last ``take()``, in start order, with
    the device times read (a device synchronise when there are any); the
    tracer starts empty again."""
    t = _T
    if t.stack:
        raise RuntimeError(f"take() inside the open span "
                           f"{t.spans[t.stack[-1]].name!r}")
    if t.events:
        torch.cuda.synchronize()
        t.harvest()
    spans, t.spans = t.spans, []
    return spans
