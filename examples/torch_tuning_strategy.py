"""The paper's low-cost tuning strategy (§4) on the PyTorch port, on the
card by default.

Finds (seqlen_s, T) with short probe runs only, no full trainings:
  1. start at seqlen_s=8, T = 1x LR-warmup;
  2. raise seqlen_s until early validation perplexity stops fluctuating;
  3. binary-search the largest calm T.

    PYTHONPATH=src python examples/torch_tuning_strategy.py
    PYTHONPATH=src python examples/torch_tuning_strategy.py --device cpu
    PYTHONPATH=src python examples/torch_tuning_strategy.py --preset 100m

``--preset 100m`` probes the full-width gpt2-117m at 16 x 1024 instead of
the bench replica.  Without a CUDA card it raises unless ``--device cpu``.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_arch
from repro_torch.configs.base import SLWConfig
from repro_torch.core.tuning import tune_slw
from repro_torch.launch import paper

WARMUP = 15
LR = 6e-2


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--preset", default="tiny", choices=["tiny", "100m"],
                   help="'100m': the full-width gpt2-117m at 16 x 1024")
    args = p.parse_args(argv)
    shape = (dict(model=get_arch("gpt2-117m"), seq=1024, batch=16)
             if args.preset == "100m" else {})
    # the probe trains only the early window and returns its val ppls
    probe = paper.tuner_probe(
        paper.bench_config(slw=True, lr=LR, steps=3 * WARMUP,
                           warmup_steps=WARMUP, **shape),
        eval_interval=5, device=args.device)
    result = tune_slw(probe, SLWConfig(round_multiple=8, max_buckets=12),
                      warmup_steps=WARMUP, seqlen_s_grid=(8, 16, 32),
                      t_multiple_range=(1, 8))
    print("probe trials (seqlen_s, T, fluctuated):")
    for t in result.trials:
        print("  ", t)
    print(f"\nchosen: seqlen_s={result.seqlen_s} T={result.duration} "
          f"({result.probe_runs} probes of {3 * WARMUP} steps each: "
          f"a small fraction of any full training)")


if __name__ == "__main__":
    main()
