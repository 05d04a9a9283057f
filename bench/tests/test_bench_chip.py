"""On the card: the control (the reference in TF32, the nearest precision
below the configurations' fp32) and a planted fault (the loss over half of
each batch) each fail a cell's limits, while the program passes them, at
the cells' widths and timed batch with 2 layers.  The limits come from
readings at the cells' full sizes (``bench/calibrate.py``; PERF.md).

Run on the card: ``python -m pytest -q -m gpu bench/tests``."""
import pytest
import torch

from bench.harness import spec
from bench.tests.conftest import CELLS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def failing(numbers, limits):
    """The numbers a cell compares that exceed their limits."""
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_and_fault_fail_the_limits(card, name):
    cell = spec.load_cell(name)
    drv = spec.kind_driver(cell)
    limits = cell.limits["limits"]
    m = drv.model_dict(cell.config, {"n_layers": 2})
    prog = drv.Program(m, cell.traffic, cell.config["remat"], 2 ** 31 + 5,
                       card)
    readings = prog.first_steps(warm=False)
    prog.free()
    ref = drv.reference(prog)
    assert not failing(drv.compare(readings, ref)[0], limits)
    control = drv.compare(drv.reference(prog, precision="tf32"), ref)[0]
    assert failing(control, limits), control
    half = drv.compare(drv.reference(prog, fault="half_batch"), ref)[0]
    assert failing(half, limits), half
