"""Model FLOPs of the traced window's steps (``bench/costs/model_flops.py``,
recompute not counted) over the window's seconds, as a share of the
card's dense TF32 rate, in %."""
from bench.costs.model_flops import train_step_flops
from bench.costs.peaks import PEAK_FLOPS_TF32


def read(ctx):
    w = ctx.window
    if not w["shapes"] or w["seconds"] <= 0:
        return None
    flops = sum(train_step_flops(ctx.m, rows, seq)
                for rows, seq in w["shapes"])
    return 100.0 * flops / w["seconds"] / PEAK_FLOPS_TF32
