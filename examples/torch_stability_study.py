"""The stability-efficiency dilemma on the PyTorch port (paper §3 + §5 in
miniature), on the card by default.

Runs the same model under (a) a moderate recipe, (b) an aggressive recipe
(large LR, the 8x-batch/4x-LR analogue), (c) the aggressive recipe with
SLW, (d) with SLW and batch warmup (the joint recipe) and (e) with the
variance-gated LR throttle instead, and prints the Table-1-style
loss-ratio comparison, the Adam variance-max peak and the Table 3
correlation of the loss ratio with var_max.

    PYTHONPATH=src python examples/torch_stability_study.py
    PYTHONPATH=src python examples/torch_stability_study.py --device cpu
    PYTHONPATH=src python examples/torch_stability_study.py --preset 100m

``--preset 100m`` runs the full-width gpt2-117m at 16 x 1024 instead of
the bench replica.  Without a CUDA card it raises unless ``--device cpu``.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_arch
from repro_torch.launch import paper


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--preset", default="tiny", choices=["tiny", "100m"],
                   help="'100m': the full-width gpt2-117m at 16 x 1024")
    args = p.parse_args(argv)
    steps = args.steps
    shape = (dict(model=get_arch("gpt2-117m"), seq=1024, batch=16)
             if args.preset == "100m" else {})
    cfg = lambda **kw: paper.bench_config(steps=steps, **shape, **kw)
    arms = [
        ("moderate baseline", cfg(lr=6e-3)),
        ("aggressive baseline", cfg(lr=6e-2)),
        ("aggressive + SLW", cfg(slw=True, lr=6e-2, duration=steps // 3)),
        ("aggressive + SLW + bsz", cfg(slw=True, batch_warmup=True, lr=6e-2,
                                       duration=steps // 3)),
        ("aggressive + throttle", paper.with_throttle(cfg(lr=6e-2))),
    ]
    print(f"{'case':24s} {'spikes':>7s} {'max_ratio':>10s} "
          f"{'var_max_peak':>13s} {'final_loss':>11s} {'r(var_max)':>11s} "
          f"{'p':>9s}")
    for name, tc in arms:
        _, res, wall = paper.run_arm(name, tc, args.device)
        s = paper.arm_stats(res, wall)
        r, pval = paper.correlation(res)["var_max"]
        print(f"{name:24s} {s['spikes']:7d} {s['max_loss_ratio']:10.2f} "
              f"{s['var_max_peak']:13.3e} {s['final_loss']:11.3f} "
              f"{r:11.3f} {pval:9.2e}")
    print("\npaper: aggressive recipes spike; SLW removes the spikes while "
          "keeping the aggressive recipe's efficiency.")


if __name__ == "__main__":
    main()
