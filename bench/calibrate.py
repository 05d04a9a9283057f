#!/usr/bin/env python3
"""The readings the limits of a training cell are set from, on the card at
the cell's own sizes, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--out calib.jsonl]

For each seed the program runs the cell's compared steps (through the same
set-up a run uses, without the window) and the plain reference follows
them; the numbers compared are printed.  For each control seed the
reference also runs in the program's place in TF32 (the control: the
nearest precision below the configuration's fp32) and with the loss over
half of each batch (a planted fault), each compared with the fp32
reference.  A step that returns its state unchanged reads 1 on the
gradient and change numbers by their definition and needs no run.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import guard, spec
    from bench.reference.train import gaps
    cell = spec.load_cell(args.workload, ROOT)
    why = guard.devices_missing(cell.chips)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 2
    drv = spec.kind_driver(cell)
    from repro_torch.kernels._build import build_all
    build_all()
    dev = torch.device("cuda")
    m = drv.model_dict(cell.config)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        t0 = time.perf_counter()
        prog = drv.Program(m, cell.traffic, cell.config["remat"], seed, dev)
        readings = prog.first_steps(warm=False)
        prog.free()
        ref = drv.reference(prog)
        runs = {"program": readings}
        if seed in controls:
            runs["control_tf32"] = drv.reference(prog, precision="tf32")
            runs["fault_half_batch"] = drv.reference(prog, fault="half_batch")
        for what, got in runs.items():
            numbers, where = drv.compare(got, ref)
            # every leaf's gaps, for a look at which leaves move
            leaves = {"grad": gaps(got["grad1"], ref["grad1"]),
                      "change": gaps(got["change"], ref["change"])}
            rec = {"cell": cell.name, "seed": seed, "what": what,
                   "numbers": numbers, "where": where, "leaves": leaves,
                   "losses": ref["loss"],
                   "seconds": time.perf_counter() - t0,
                   "card": torch.cuda.get_device_name(0)}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
        del prog, ref, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
