"""The port's tracer (``repro_torch.core.trace``) and its spans and counters
in the trainer, the train step and the MoE layer, on reduced gpt2-1.5b and
deepseek-moe-16b, on the CPU.

* With tracing on, each step is the span tree ``trainer.step`` > plan,
  batch, apply, to_device, ``train_step`` (> forward, backward,
  optimizer), sync, observe, properly nested, with non-negative self
  times; the MoE layer's four spans sit under ``step.forward`` once a
  layer, and again under ``step.backward`` where remat "full" recomputes
  the layer.
* With tracing off nothing is recorded, the step issues the same aten op
  sequence as with tracing on less the MoE counters' ops, and returns the
  same metrics keys; the losses and parameters are bit-identical.
* ``moe.assigned`` = rows x seq x top_k x layers, ``moe.kept`` <=
  ``moe.slots``, the same under remat "none" and "full", and summed over
  the shards of the GNS step.
* A ``torch.profiler`` session switches the tracer on while it records.
"""
import contextlib
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import trace
from repro_torch.launch.train import Trainer
from repro_torch.models.moe import capacity

TRAINER_KIDS = ["trainer.plan", "trainer.batch", "trainer.apply",
                "trainer.to_device", "train_step", "trainer.sync",
                "trainer.observe"]
STEP_KIDS = ["step.forward", "step.backward", "step.optimizer"]
MOE = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
COUNTER_OPS = {"aten.sum", "aten.add", "aten.detach", "aten.view",
               "aten._to_copy"}


@pytest.fixture(autouse=True)
def _empty_tracer():
    trace.take()
    yield
    trace.take()


def _tracing(on):
    return trace.tracing() if on else contextlib.nullcontext()


def _config(arch, remat="none", gns=False):
    steps, seq, batch = 8, 64, 4
    return tbase.TrainConfig(
        model=tconfigs.reduced(tconfigs.get_arch(arch)),
        optimizer=tbase.OptimizerConfig(
            lr=3e-3, min_lr=1e-4, warmup_steps=3,
            warmup_tokens=3 * batch * seq, total_steps=steps,
            total_tokens=steps * batch * seq),
        slw=tbase.SLWConfig(enabled=True, start_seq_len=8, duration_steps=4,
                            round_multiple=8, max_buckets=4),
        gns=tbase.GNSConfig(enabled=gns, shards=2, precursor_window=0),
        seq_len=seq, global_batch=batch, eval_interval=0, remat=remat)


def _steps(tc, n, on):
    """``n`` steps of a fresh trainer (tracing ``on`` or not) -> (the
    trainer, each step's metrics, the spans taken)."""
    tr = Trainer(tc, device="cpu")
    with _tracing(on):
        metrics = [tr.run_step()[2] for _ in range(n)]
    return tr, metrics, trace.take()


def _kids(spans, i):
    return [j for j, sp in enumerate(spans) if sp.parent == i]


@pytest.mark.parametrize("arch,remat", [("gpt2-1.5b", "dots"),
                                        ("deepseek-moe-16b", "full"),
                                        ("deepseek-moe-16b", "none")])
def test_each_step_is_the_span_tree(arch, remat):
    tc = _config(arch, remat)
    _, _, spans = _steps(tc, 3, on=True)
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    assert [spans[i].name for i in roots] == ["trainer.step"] * 3
    assert [spans[i].step for i in roots] == [0, 1, 2]
    layers = tc.model.n_layers if tc.model.family == "moe" else 0
    for r in roots:
        kids = _kids(spans, r)
        assert [spans[i].name for i in kids] == TRAINER_KIDS
        step = kids[TRAINER_KIDS.index("train_step")]
        parts = _kids(spans, step)
        assert [spans[i].name for i in parts] == STEP_KIDS
        fwd, bwd, opt = parts
        assert [spans[i].name for i in _kids(spans, fwd)] == MOE * layers
        again = layers if remat == "full" else 0
        assert [spans[i].name for i in _kids(spans, bwd)] == MOE * again
        assert _kids(spans, opt) == []
        assert spans[r].counts["rows"] == 4
        assert spans[r].counts["seq"] in (8, 16, 24, 32, 40, 48, 56, 64)
    for i, sp in enumerate(spans):
        assert sp.step == spans[_root(spans, i)].step
        kids = _kids(spans, i)
        assert sp.start_ns <= sp.end_ns
        cur = sp.start_ns
        for k in kids:
            assert spans[k].start_ns >= cur
            cur = spans[k].end_ns
        assert cur <= sp.end_ns
        self_ns = (sp.end_ns - sp.start_ns) - sum(
            spans[k].end_ns - spans[k].start_ns for k in kids)
        assert self_ns >= 0
        assert sp.device_ms is None  # no CUDA here


def _root(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
    return i


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _subsequence_rest(short, long):
    """What ``long`` holds beyond ``short`` if ``short`` is a subsequence of
    it, else None."""
    rest, i = [], 0
    for op in long:
        if i < len(short) and short[i] == op:
            i += 1
        else:
            rest.append(op)
    return rest if i == len(short) else None


@pytest.mark.parametrize("arch", ["gpt2-1.5b", "deepseek-moe-16b"])
def test_tracing_off_issues_the_same_ops(arch):
    tc = _config(arch)
    # a process's first step fills caches (the leaf groups' index tensors)
    Trainer(tc, device="cpu").run_step()
    got = {}
    for on in (False, True):
        tr = Trainer(tc, device="cpu")
        with _tracing(on), _Ops() as rec:
            metrics = tr.run_step()[2]
        got[on] = (rec.ops, sorted(metrics), trace.take())
    off, on = got[False], got[True]
    assert off[2] == [] and on[2]
    assert off[1] == on[1]
    extra = _subsequence_rest(off[0], on[0])
    assert extra is not None
    if tc.model.family == "moe":
        # a sum of `keep` a layer, their sum, and one more tensor through
        # the step's one transfer
        assert set(extra) <= COUNTER_OPS
        assert extra.count("aten.sum") == tc.model.n_layers
        assert len(extra) <= 2 * tc.model.n_layers + 4
    else:
        assert extra == []


@pytest.mark.parametrize("arch,remat", [("gpt2-1.5b", "dots"),
                                        ("deepseek-moe-16b", "full")])
def test_loss_and_params_bit_identical_on_and_off(arch, remat):
    tc = _config(arch, remat)
    runs = [_steps(tc, 3, on) for on in (False, True)]
    (tr0, m0, spans0), (tr1, m1, _) = runs
    assert spans0 == []
    assert [m["loss"] for m in m0] == [m["loss"] for m in m1]
    assert all(math.isfinite(m["loss"]) for m in m0)
    for a, b in zip(tr0.state["params"]["layers"],
                    tr1.state["params"]["layers"]):
        for k in a:
            for x, y in zip(_leaves(a[k]), _leaves(b[k])):
                assert torch.equal(x, y)


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    return [t]


def _moe_counts(tc, n=3):
    _, _, spans = _steps(tc, n, on=True)
    return [sp.counts for sp in spans if sp.parent is None]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_counters(remat):
    tc = _config("deepseek-moe-16b", remat)
    m = tc.model
    counts = _moe_counts(tc)
    for c in counts:
        rows, seq = c["rows"], c["seq"]
        assert c["moe.assigned"] == rows * seq * m.top_k * m.n_layers
        assert c["moe.slots"] == (rows * m.n_experts * capacity(seq, m)
                                  * m.n_layers)
        assert 0 < c["moe.kept"] <= min(c["moe.slots"], c["moe.assigned"])
    assert counts == _moe_counts(_config("deepseek-moe-16b", "none"))


def test_moe_counters_sum_over_gns_shards():
    tc = _config("deepseek-moe-16b", gns=True)
    m = tc.model
    _, _, spans = _steps(tc, 2, on=True)
    roots = [i for i, sp in enumerate(spans) if sp.parent is None]
    for r in roots:
        c = spans[r].counts
        assert c["moe.assigned"] == (c["rows"] * c["seq"] * m.top_k
                                     * m.n_layers)
        step = [i for i in _kids(spans, r)
                if spans[i].name == "train_step"][0]
        names = [spans[i].name for i in _kids(spans, step)]
        # the batch's 4 rows as 2 shards, each its own forward and backward
        assert names == ["step.forward", "step.backward"] * 2 \
            + ["step.optimizer"]


def test_off_path_is_one_shared_noop():
    assert not trace.enabled()
    a, b = trace.span("x"), trace.span("y", device=True)
    assert a is b
    with a:
        trace.count("n", 1)
    assert trace.take() == []


def test_tracing_context_nesting_and_take():
    with trace.tracing():
        assert trace.enabled()
        with trace.span("outer", step=7):
            trace.count("n", 2)
            with pytest.raises(RuntimeError):
                trace.take()
            with pytest.raises(ValueError):
                with trace.span("inner"):
                    raise ValueError
            trace.count("n", 3)
        trace.count("outside", 1)
    assert not trace.enabled()
    spans = trace.take()
    assert [(sp.name, sp.parent, sp.step) for sp in spans] == [
        ("outer", None, 7), ("inner", 0, 7)]
    assert spans[0].counts == {"n": 5}
    assert spans[0].wall_ns > 0 and spans[1].wall_ns == 0
    assert trace.take() == []


def test_a_profiler_session_switches_the_tracer_on():
    tc = _config("gpt2-1.5b")
    tr = Trainer(tc, device="cpu")
    tr.run_step()
    assert trace.take() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        tr.run_step()
    assert not trace.enabled()
    spans = trace.take()
    assert [sp.name for sp in spans if sp.parent is None] == ["trainer.step"]
