"""Quickstart on the PyTorch port: train a small GPT-2-style model with the
paper's joint recipe (Sequence Length Warmup composed with batch-size and
LR warmup through the regulator control plane), on the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 120]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --preset 100m

What you should see: the per-step sequence length ramping 8 -> 256 (1024
at ``--preset 100m``, the full-width gpt2-117m) on the paper's linear
pacing while the batch ramps up alongside it, the loss-ratio tracker
staying spike-free, and validation perplexity (always full-length)
dropping.  Without a CUDA card it raises unless ``--device cpu``.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import (BatchWarmupConfig, OptimizerConfig,
                                      SLWConfig, TrainConfig)
from repro_torch.launch.train import train


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--preset", default="tiny", choices=["tiny", "100m"],
                   help="'100m' trains the full-width gpt2-117m config")
    args = p.parse_args(argv)

    if args.preset == "100m":
        model = get_arch("gpt2-117m")
        seq, batch = 1024, 16
    else:
        model = reduced(get_arch("gpt2-117m")).replace(
            n_layers=3, d_model=96, d_ff=384, vocab_size=512)
        seq, batch = 256, 8

    steps = args.steps
    tc = TrainConfig(
        model=model,
        optimizer=OptimizerConfig(
            lr=6e-3, min_lr=2e-4, schedule="token_cosine",
            warmup_steps=15, warmup_tokens=15 * batch * seq,
            total_steps=steps, total_tokens=steps * batch * seq),
        slw=SLWConfig(enabled=True, pacing="linear", start_seq_len=8,
                      duration_steps=steps // 3, round_multiple=8,
                      max_buckets=12),
        # composes with SLW through the regulator stack (the paper's
        # joint recipe: short sequences make the warming batch/LR safe)
        batch_warmup=BatchWarmupConfig(enabled=True, start_batch=batch // 2,
                                       warmup_tokens=steps * batch * seq // 8),
        seq_len=seq, global_batch=batch, remat="none", eval_interval=20)

    res = train(tc, quiet=False, device=args.device)
    print("\n== quickstart summary ==")
    print(f"steps={res.steps} tokens={res.tokens}")
    print(f"seqlen schedule: {res.seqlen_history[0]} -> "
          f"{res.seqlen_history[-1]}")
    print(f"batch schedule:  {res.batch_history[0]} -> "
          f"{res.batch_history[-1]}")
    print(f"stability: {res.tracker_summary}")
    print(f"val ppl: {[f'{p:.1f}' for _, p in res.val_ppl_history]}")


if __name__ == "__main__":
    main()
