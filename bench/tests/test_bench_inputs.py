"""The inputs a run draws from its seed, and the mixes' lengths."""
import numpy as np
import pytest
import torch

from bench.harness import inputs, spec
from bench.reference import plan as plan_lib
from bench.reference import transformer as tfm
from bench.tests.conftest import CELLS, TINY_MODELS

BIG = 2 ** 31 + 1234567


def test_corpus_is_a_function_of_the_seed():
    a = inputs.Corpus(50257, 1024, BIG, 1.1)
    b = inputs.Corpus(50257, 1024, BIG, 1.1)
    c = inputs.Corpus(50257, 1024, BIG + 1, 1.1)
    x, y = a.batch(16, 8), b.batch(16, 8)
    assert np.array_equal(x["tokens"], y["tokens"])
    assert not np.array_equal(x["tokens"], c.batch(16, 8)["tokens"])
    assert x["tokens"].shape == (8, 1024) and x["tokens"].dtype == np.int32
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert x["tokens"].min() >= 0 and x["tokens"].max() < 50257
    # every row of the first steps differs
    rows = np.concatenate([a.batch(8 * s, 8)["tokens"] for s in range(3)])
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_weights_are_a_function_of_the_seed():
    m = dict(spec.load_cell(CELLS[1]).config["model"],
             **TINY_MODELS["deepseek-moe-16b"])
    groups = tfm.param_groups(m)
    cpu = torch.device("cpu")
    one = list(inputs.draw(groups, m["n_layers"], BIG, cpu))
    two = list(inputs.draw(groups, m["n_layers"], BIG, cpu))
    other = list(inputs.draw(groups, m["n_layers"], BIG + 1, cpu))
    assert [g.name for g, _ in one] == [g.name for g in groups]
    for (g, a), (_, b), (_, c) in zip(one, two, other):
        assert a.shape == ((m["n_layers"],) if g.layered else ()) + g.shape
        assert torch.equal(a, b)
        if g.init == "normal":
            assert not torch.equal(a, c)
            assert abs(float(a.std()) - g.scale) < 0.2 * g.scale


@pytest.mark.parametrize("name", CELLS)
def test_mix_lengths_do_not_depend_on_the_seed(name):
    traffic = spec.load_cell(name).traffic
    plans = plan_lib.plan(traffic, 13)
    lengths = [p["seq_len"] for p in plans]
    assert all(p["batch"] == traffic["batch"] for p in plans)
    if traffic["window"] == "ramp":
        assert lengths == [8, 72, 168, 232, 328, 424, 488, 584, 680, 744,
                           840, 936, 1024]
    else:
        assert lengths == [1024] * 13


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith("slw")])
def test_the_window_replays_the_ramp(tiny_run, name):
    cell, out = tiny_run(name)
    shapes = out["window"]["shapes"]
    ramp = [(4, s) for s in (8, 16, 24, 32, 40, 48)]
    assert len(shapes) % len(ramp) == 0 and len(shapes) >= len(ramp)
    assert shapes == ramp * (len(shapes) // len(ramp))
    assert out["window"]["tokens"] == sum(r * s for r, s in shapes)
