"""The paper's experiments on the port: the bench harness (copy of
``benchmarks/common.py:1-110``) and the arms of Table 1
(``benchmarks/bench_table1_stability.py``), Fig. 1 / Table 3
(``bench_fig1_variance.py``) and Fig. 3 with the low-cost tuner
(``bench_fig3_pacing.py``), each a function that returns its rows.

Every function takes ``device`` (CUDA by default; ``"cpu"`` runs the
same arms on the host) and ``model``, which replaces the small GPT-2
replica ``BENCH_MODEL`` (3 layers, d 96, sized to show the training
dynamics in seconds on a CPU), e.g. with the full-width ``gpt2-117m``
on the card.  A row is ``(name, us_per_step, derived)``, as the
benchmarks print them.

    PYTHONPATH=src python -m repro_torch.launch.paper --device cpu --quick
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (BatchWarmupConfig, ModelConfig,
                                      OptimizerConfig, RegulatorSpec,
                                      SLWConfig, TrainConfig)
from repro_torch.core.regulators import auto_specs, predict_trajectory
from repro_torch.core.stability import pearson
from repro_torch.core.tuning import (ProbeFn, significant_fluctuation,
                                     tune_slw)
from repro_torch.launch.train import TrainResult, train

Row = Tuple[str, float, str]  # (name, us_per_call, derived)

BENCH_MODEL = ModelConfig(
    name="gpt2-bench", family="dense", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=4, d_ff=384, vocab_size=512, pos_emb="learned",
    norm="layernorm", mlp="gelu", tie_embeddings=True, max_seq_len=512)

SEQ = 192
BATCH = 8

# Table 1's learning rates (``bench_table1_stability.py:18-22``): 0.5 is
# where the bench model spikes often and SLW suppresses the spikes
MODERATE_LR = 6e-3
AGGRESSIVE_LR = 0.5
# a non-finite loss ratio enters the correlation as this value
# (``bench_fig1_variance.py:18``)
RATIO_CAP = 10.0


def bench_config(slw: bool = False, lr: float = 1e-3, steps: int = 150,
                 pacing: str = "linear", duration: Optional[int] = None,
                 start_seq: int = 8, batch_warmup: bool = False,
                 schedule: str = "token_cosine", warmup_steps: int = 15,
                 seq: int = SEQ, batch: int = BATCH, grad_clip: float = 1.0,
                 mode: str = "truncate", seed: int = 1234,
                 total_tokens: int = 0,
                 regulators: Tuple[RegulatorSpec, ...] = (),
                 model: Optional[ModelConfig] = None) -> TrainConfig:
    """One bench arm.  ``slw`` and ``batch_warmup`` compose through the
    regulator stack (the paper's joint recipe is both at once);
    ``regulators`` overrides the auto-derived stack."""
    return TrainConfig(
        model=model or BENCH_MODEL,
        optimizer=OptimizerConfig(
            lr=lr, min_lr=lr / 30, schedule=schedule,
            warmup_steps=warmup_steps,
            warmup_tokens=warmup_steps * batch * seq,
            total_steps=steps,
            total_tokens=total_tokens or steps * batch * seq,
            grad_clip=grad_clip),
        slw=SLWConfig(enabled=slw, pacing=pacing, start_seq_len=start_seq,
                      duration_steps=duration or steps // 3,
                      round_multiple=8, max_buckets=12, mode=mode),
        batch_warmup=BatchWarmupConfig(
            enabled=batch_warmup, start_batch=max(batch // 4, 1),
            warmup_tokens=(duration or steps // 3) * batch * seq // 2),
        regulators=regulators,
        seq_len=seq, global_batch=batch, seed=seed, remat="none",
        eval_interval=10)


def with_throttle(tc: TrainConfig, **spec) -> TrainConfig:
    """``tc`` with the variance-gated LR throttle after its schedules."""
    return dataclasses.replace(tc, regulators=auto_specs(tc) + (
        RegulatorSpec(kind="var_lr_throttle", **spec),))


def run_arm(name: str, tc: TrainConfig, device: str = "cuda",
            **kw) -> Tuple[str, TrainResult, float]:
    t0 = time.time()
    res = train(tc, quiet=True, stop_on_nan=False, device=device, **kw)
    return name, res, time.time() - t0


def stability_row(name: str, res: TrainResult, wall: float) -> Row:
    s = res.tracker_summary
    derived = (f"spikes={s['spikes']}({100 * s['spike_frac']:.2f}%) "
               f"max_ratio={s['max_loss_ratio']:.2f} "
               f"diverged={res.diverged} "
               f"final_loss={res.loss_history[-1]:.3f}")
    return (name, wall / max(res.steps, 1) * 1e6, derived)


def final_ppl(res: TrainResult) -> float:
    if res.val_ppl_history:
        return res.val_ppl_history[-1][1]
    return float("nan")


def arm_stats(res: TrainResult, wall: float) -> Dict[str, float]:
    """One arm's Table 1 numbers: spikes, max loss ratio, final loss, val
    ppl, the var_max peak, tokens, wall seconds and tokens/s."""
    s = res.tracker_summary
    return {"spikes": s["spikes"], "max_loss_ratio": s["max_loss_ratio"],
            "final_loss": res.loss_history[-1], "val_ppl": final_ppl(res),
            "var_max_peak": float(np.nanmax(res.var_max_history)),
            "tokens": res.tokens, "wall_s": wall,
            "tokens_per_s": res.tokens / wall}


def loss_ratios(res: TrainResult) -> np.ndarray:
    """The loss-ratio series, a non-finite ratio capped at RATIO_CAP."""
    return np.asarray([r if np.isfinite(r) else RATIO_CAP
                       for r in res.loss_ratios])


def correlation(res: TrainResult) -> Dict[str, Tuple[float, float]]:
    """Table 3: Pearson (r, p) of the loss ratio against var_max and
    against var_l1."""
    ratios = loss_ratios(res)
    n = len(ratios)
    return {key: pearson(ratios, np.asarray(getattr(res, f"{key}_history"))
                         [:n]) for key in ("var_max", "var_l1")}


def tuner_probe(base: TrainConfig, eval_interval: int, device: str = "cuda",
                runs: Optional[List[TrainResult]] = None) -> ProbeFn:
    """The tuner's probe: ``base`` (sized to the probe window) with the
    candidate's SLW config, returning its validation perplexities; each
    run's result is appended to ``runs`` when given."""
    def probe(slw_cfg: SLWConfig) -> List[float]:
        tc = dataclasses.replace(base, slw=slw_cfg,
                                 eval_interval=eval_interval)
        res = train(tc, quiet=True, stop_on_nan=False, device=device)
        if runs is not None:
            runs.append(res)
        return [p for _, p in res.val_ppl_history]
    return probe


# ---------------------------------------------------------------------------
# the experiments
# ---------------------------------------------------------------------------

def table1_arms(steps: int, model: Optional[ModelConfig] = None
                ) -> List[Tuple[str, TrainConfig]]:
    """Table 1's arms (``bench_table1_stability.py:33-63``): baselines at a
    moderate and an aggressive LR (and with a tighter clip), SLW,
    Shortformer's two stages, batch warmup and variance-gated pacing at the
    aggressive LR, and the baseline with the LR throttle."""
    dur = steps // 3
    cfg = lambda **kw: bench_config(steps=steps, model=model, **kw)
    return [
        ("table1/baseline_moderate", cfg(lr=MODERATE_LR)),
        ("table1/baseline_aggressive", cfg(lr=AGGRESSIVE_LR)),
        ("table1/baseline_aggressive_clip0.25",
         cfg(lr=AGGRESSIVE_LR, grad_clip=0.25)),
        ("table1/slw_aggressive",
         cfg(slw=True, lr=AGGRESSIVE_LR, duration=steps // 2)),
        ("table1/shortformer_aggressive",
         cfg(slw=True, lr=AGGRESSIVE_LR, duration=dur, pacing="two_stage")),
        ("table1/bszwarmup_aggressive",
         cfg(lr=AGGRESSIVE_LR, batch_warmup=True)),
        ("table1/slw_variance_gated",
         cfg(slw=True, lr=AGGRESSIVE_LR, duration=dur,
             pacing="variance_gated")),
        ("table1/baseline_var_lr_throttle",
         with_throttle(cfg(lr=AGGRESSIVE_LR))),
    ]


def run_table1(quick: bool = False, device: str = "cuda",
               model: Optional[ModelConfig] = None) -> List[Row]:
    steps = 80 if quick else 160
    return [stability_row(*run_arm(name, tc, device))
            for name, tc in table1_arms(steps, model)]


def run_fig1(quick: bool = False, device: str = "cuda",
             model: Optional[ModelConfig] = None) -> List[Row]:
    """Fig. 1 and Table 3: the variance telemetry of the aggressive
    baseline, its correlation with the loss ratio, and the SLW arm's."""
    steps = 80 if quick else 200
    _, res, wall = run_arm(
        "fig1/baseline_aggressive",
        bench_config(lr=AGGRESSIVE_LR, steps=steps, model=model), device)
    corr = correlation(res)
    (r_max, p_max), (r_l1, p_l1) = corr["var_max"], corr["var_l1"]
    _, res2, wall2 = run_arm(
        "fig1/slw_aggressive",
        bench_config(slw=True, lr=AGGRESSIVE_LR, steps=steps,
                     duration=steps // 2, model=model), device)
    us = wall / max(res.steps, 1) * 1e6
    return [
        ("fig1/pearson_lossratio_vs_varmax", us,
         f"r={r_max:.3f} p={p_max:.2e} (paper: 0.26, p~0)"),
        ("fig1/pearson_lossratio_vs_varnorm", us,
         f"r={r_l1:.3f} p={p_l1:.2e} (paper: 0.23, p~0)"),
        ("fig1/varmax_peak_baseline", us,
         f"peak={np.nanmax(res.var_max_history):.3e}"),
        ("fig1/varmax_peak_slw", wall2 / max(res2.steps, 1) * 1e6,
         f"peak={np.nanmax(res2.var_max_history):.3e} "
         f"spikes={res2.tracker_summary['spikes']} vs baseline "
         f"{res.tracker_summary['spikes']}"),
    ]


def run_fig3(quick: bool = False, device: str = "cuda",
             model: Optional[ModelConfig] = None) -> List[Row]:
    """Fig. 3 / Table 6: the pacing-duration sweep with early-fluctuation
    detection, then the low-cost tuner on short probes only."""
    steps = 80 if quick else 200
    warmup = 15
    lr = 6e-2
    sweep = ([warmup, 3 * warmup, 6 * warmup] if quick else
             [warmup, 2 * warmup, 4 * warmup, 8 * warmup])
    rows: List[Row] = []
    for t_dur in sweep:
        name, res, wall = run_arm(
            f"fig3/slw_T{t_dur}",
            bench_config(slw=True, lr=lr, steps=steps, duration=t_dur,
                         warmup_steps=warmup, model=model), device)
        probe_window = [p for st, p in res.val_ppl_history
                        if st <= 3 * warmup + 10]
        rows.append((name, wall / max(res.steps, 1) * 1e6,
                     f"final_ppl={final_ppl(res):.1f} "
                     f"early_fluctuation="
                     f"{significant_fluctuation(probe_window)} "
                     f"spikes={res.tracker_summary['spikes']}"))

    probe = tuner_probe(bench_config(slw=True, lr=lr, steps=3 * warmup,
                                     warmup_steps=warmup, model=model),
                        eval_interval=5, device=device)
    tuned = tune_slw(probe, SLWConfig(round_multiple=8, max_buckets=12),
                     warmup_steps=warmup, seqlen_s_grid=(8, 16, 32),
                     t_multiple_range=(1, 8))
    # the tuned schedule's exact warmup token cost, replayed open loop
    tc_tuned = dataclasses.replace(
        bench_config(slw=True, lr=lr, steps=steps, warmup_steps=warmup,
                     model=model),
        slw=SLWConfig(enabled=True, start_seq_len=tuned.seqlen_s,
                      duration_steps=tuned.duration, round_multiple=8,
                      max_buckets=12))
    plans = predict_trajectory(tc_tuned, tuned.duration)
    warmup_tokens = sum(p.batch_size * p.seq_len for p in plans)
    rows.append(("fig3/low_cost_tuner", 0.0,
                 f"chose seqlen_s={tuned.seqlen_s} T={tuned.duration} "
                 f"after {tuned.probe_runs} short probes "
                 f"(no full trainings); predicted warmup cost "
                 f"{warmup_tokens} tokens"))
    return rows


EXPERIMENTS: Dict[str, Callable[..., List[Row]]] = {
    "table1": run_table1, "fig1": run_fig1, "fig3": run_fig3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--only", default="", help="comma-separated subset of "
                   + ", ".join(EXPERIMENTS))
    p.add_argument("--quick", action="store_true",
                   help="80-step arms instead of 160-200")
    args = p.parse_args(argv)
    names = args.only.split(",") if args.only else list(EXPERIMENTS)
    for name in names:
        for row_name, us, derived in EXPERIMENTS[name](args.quick,
                                                       args.device):
            print(f"{row_name:40s} {us:12.1f} us/step  {derived}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
