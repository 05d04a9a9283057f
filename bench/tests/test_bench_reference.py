"""The plain reference against the port at a tiny size on the CPU, and runs
with the timed path broken underneath: ``correct`` comes out false."""
import copy

import pytest
import torch

from bench.tests.conftest import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference(tiny_run, name):
    cell, out = tiny_run(name)
    assert out["correct"], out["checks"]
    numbers = out["where"]["numbers"]
    assert numbers["plan_mismatch"] == 0.0
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5
    assert numbers["change_gap_median"] < 1e-5
    assert out["attempted"] == len(out["window"]["shapes"]) > 0
    assert out["failed"] == 0


def unchanged(trainer):
    """The step computes its metrics and returns the state it was given."""
    step = trainer.step_fn

    def broken(state, batch, lr, clip_scale=1.0, **kw):
        _, metrics = step(copy.deepcopy(state), batch, lr, clip_scale, **kw)
        return state, metrics
    trainer.step_fn = broken


def half_batch(trainer):
    """Half of the batch's rows left out, the mean taken over the rest."""
    step = trainer.step_fn

    def broken(state, batch, lr, clip_scale=1.0, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()}, lr,
                    clip_scale, **kw)
    trainer.step_fn = broken


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(tiny_run, name, fault):
    cell, out = tiny_run(name, hook=fault)
    assert not out["correct"], out["checks"]
    limits = {k: lim for k, (_, lim) in out["checks"].items()}
    failing = [k for k, (v, lim) in out["checks"].items() if not v <= lim]
    assert failing, limits
