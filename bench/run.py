#!/usr/bin/env python3
"""One run of one benchmark cell of ``repro_torch``, the PyTorch/CUDA port:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Builds the port's kernels (once per checkout,
into ``build/repro_torch_kernels/``), sets the cell up from its files and
the seed, measures for about ``--seconds``, checks the timed path against
the plain reference, and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from ``torch.profiler`` traces kept in
memory: the window's device activity alone, then a few more units with
the host's operations and shapes.  The numbers compared and their limits are the last lines of
standard error and the last key of the JSON line.

Exits non-zero and prints no result when there is no CUDA device (or fewer
than the cell asks for), when the program is absent, or when JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(why: str, code: int) -> int:
    print(f"bench: no result: {why}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import guard, spec
    cell = spec.load_cell(args.workload, ROOT)
    why = guard.devices_missing(cell.chips)
    if why:
        return fail(why, 2)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not in this checkout",
                    3)
    import torch
    torch.set_num_threads(4)
    out = spec.kind_driver(cell).run(cell, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    found = guard.forbidden(sys.modules)
    if found:
        return fail(f"forbidden modules loaded: {found}", 4)
    win, trace, timeline = out["window"], out["window"]["trace"], \
        out["window"]["timeline"]
    if args.trace and not (timeline and timeline.kernels):
        return fail("the traced window holds no device activity", 5)
    ctx = SimpleNamespace(m=out["m"], window=win, trace=trace,
                          timeline=timeline, setup_s=out["setup_s"],
                          cell=cell)
    metrics = spec.read_metrics(cell, cell.per_layer if args.trace
                                else cell.e2e, ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = timeline.busy_s()
        device["window_s"] = timeline.window_s()
        line["breakdown"] = {"device_ops": timeline.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    print(f"bench: setup_s {out['setup_s']:.3f} window_s "
          f"{win['seconds']:.3f} steps {len(win['shapes'])} units "
          f"{[round(u, 3) for u in win['unit_seconds']]} "
          f"where {json.dumps(out['where'])}", file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
