"""The reader of the optimizer's fused share (``optimizer_fused_pct.train``)
on the synthetic spans of ``test_bench_spans``: the program's
``optim.fused`` and ``optim.params`` counters summed over the window's
steps, and nothing where the program counts neither."""
import pytest

from bench.tests.test_bench_spans import (SHAPES, ctx, program_spans, read,
                                          timeline)

NAME = "optimizer_fused_pct.train"


def counted(per_step):
    """Two steps of program spans, step ``s``'s root counting
    ``per_step[s]`` (a dict of the optimizer's counters)."""
    taken = program_spans()
    roots = [sp for sp in taken if sp.parent is None]
    for sp, extra in zip(roots, per_step):
        sp.counts.update(extra)
    return taken


@pytest.mark.parametrize("per_step,want", [
    ([{"optim.params": 100, "optim.fused": 100}] * 2, 100.0),
    ([{"optim.params": 100, "optim.fused": 100},
      {"optim.params": 300}], 25.0),
    ([{"optim.params": 50}] * 2, 0.0),
    ([{}, {}], None),  # a program that counts neither: the parent's
])
def test_the_fused_share_reader(monkeypatch, per_step, want):
    c = ctx(timeline(), counted(per_step), monkeypatch)
    got = read(NAME, c)
    assert got == (None if want is None else pytest.approx(want))


def test_the_fused_share_needs_the_window(monkeypatch):
    taken = counted([{"optim.params": 10, "optim.fused": 10}] * 2)
    assert read(NAME, ctx(timeline(), taken, monkeypatch,
                          [(8, 72)] * 2)) is None
    assert read(NAME, ctx(None, taken, monkeypatch, SHAPES)) is None
