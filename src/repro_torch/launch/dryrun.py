"""Production-mesh dry run: one step of each (arch x shape x mesh) cell,
traced in one process with no card and no allocation
(the counterpart of ``repro/launch/dryrun.py``).

For each cell this:
  1. starts a fake process group of 256 or 512 ranks (collectives return
     at once and move nothing) and builds the production mesh, (16, 16)
     ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``;
  2. resolves the sharding contract (state, batch and cache placements)
     from the logical-axis rules;
  3. places fake params, optimizer state, batch and cache (``FakeTensor``:
     shapes and dtypes, no storage) as rank 0's shards and runs the step
     on them: DTensor's sharding propagation, the redistributions and
     every rank-local op run for real, only the data is fake;
  4. records rank 0's per-device param and optimizer bytes, ``MemTracker``'s
     peak (of a second run of the step), the FLOPs and bytes per device
     (``roofline.op_cost``), the
     collectives by kind, bytes and group (``roofline.analysis``), the
     analytic model FLOPs and the H100 roofline terms, as JSON.

A failure here (a placement DTensor cannot propagate, a shape no rule
divides) is a fault of the sharded step.  The step runs fp32, as the
trainer does; on the CPU the kernels run as their plain versions, so
attention counts the whole (S, S) square (``useful_flops_ratio`` shows
it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt2-117m \
      qwen3-32b --shape all --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, List, Optional

import numpy as np


def _fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import init_fake_group
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    init_fake_group(world, 0)


def _fake(shape, kind: str = "float"):
    """An uninitialized tensor of ``shape`` (created under FakeTensorMode
    it is fake: no storage)."""
    import torch
    dtype = {"float": torch.float32, "fp32": torch.float32,
             "int": torch.int64, "bool": torch.bool}[kind]
    return torch.empty(tuple(shape), dtype=dtype)


def _local_bytes(tree) -> int:
    from repro_torch.distributed.compat import is_dtensor
    from repro_torch.optim.transforms import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if hasattr(t, "numel"):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _cell_setup(arch_name: str, shape_name: str, mesh_kind: str,
                rule_set: str, seq_shard: str, moe_dispatch: str):
    from repro_torch.configs import get_arch_spec
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_production_mesh

    spec = get_arch_spec(arch_name)
    shape = spec.shape(shape_name)
    cfg = spec.model
    if moe_dispatch:
        cfg = cfg.replace(moe_dispatch=moe_dispatch)
    chips = 512 if mesh_kind == "multi" else 256
    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    if seq_shard == "auto":
        seq_sharded, seq_axis = shape.name == "long_500k", "data"
    else:
        seq_sharded = seq_shard != "none"
        seq_axis = seq_shard if seq_sharded else "data"
    rules = ShardingRules.make(mesh, rule_set, seq_sharded_cache=seq_sharded,
                               seq_shard_axis=seq_axis)
    return spec, shape, cfg, mesh, chips, rules


def _run_step(cfg, shape, rules, remat: str, block_kv: int):
    """Place the cell's fake inputs and return (thunk running the step,
    {"params": bytes, "opt": bytes} on rank 0)."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx

    model = model_zoo.build_model(cfg, remat=remat, block_kv=block_kv)
    params = optim_tx.tree_map(lambda m: _fake(m.shape),
                               model_zoo.abstract_params(cfg))
    if shape.kind == "train":
        opt = OptimizerConfig()
        state = {"params": params,
                 "opt": optim_tx.build_optimizer(opt).init(params),
                 "step": _fake((), "int")}
        state = steps_lib.shard_train_state(state, rules, cfg, opt)
        specs = model_zoo.train_batch_specs(cfg, shape.global_batch,
                                            shape.seq_len)
        batch = {k: _fake(*v) for k, v in specs.items()}
        batch = steps_lib.shard_tree(
            batch, steps_lib.batch_shardings(rules, cfg, batch))
        step = steps_lib.make_train_step(model, opt, rules)
        held = {"params": _local_bytes(state["params"]),
                "opt": _local_bytes(state["opt"])}
        return (lambda: step(state, batch, 1e-4)), held
    p_sh = steps_lib.train_state_shardings(rules, cfg)["params"]
    params = steps_lib.shard_tree(params, p_sh)
    held = {"params": _local_bytes(params), "opt": 0}
    if shape.kind == "prefill":
        specs = model_zoo.prefill_batch_specs(cfg, shape.global_batch,
                                              shape.seq_len)
        batch = {k: _fake(*v) for k, v in specs.items()}
        batch = steps_lib.shard_tree(
            batch, steps_lib.batch_shardings(rules, cfg, batch))
        step = steps_lib.make_prefill_step(model, rules)
        return (lambda: step(params, batch)), held
    cache = {k: _fake(*v) for k, v in
             model.cache_shapes(shape.global_batch, shape.seq_len).items()}
    cache = steps_lib.shard_tree(cache, steps_lib.cache_shardings(
        rules, model, shape.global_batch, shape.seq_len))
    tokens = {"tokens": _fake(*model_zoo.decode_token_specs(
        shape.global_batch))}
    tokens = steps_lib.shard_tree(
        tokens, steps_lib.batch_shardings(rules, cfg, tokens))["tokens"]
    held["cache"] = _local_bytes(cache)
    step = steps_lib.make_serve_step(model, rules)
    return (lambda: step(params, cache, tokens)), held


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             rule_set: str = "fsdp", remat: str = "full",
             block_kv: int = 512, seq_shard: str = "auto",
             moe_dispatch: str = "") -> Dict:
    """Trace one cell's step at production mesh size; returns the record."""
    spec, shape, cfg, mesh, chips, rules = _cell_setup(
        arch_name, shape_name, mesh_kind, rule_set, seq_shard, moe_dispatch)
    record: Dict = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "chips": chips, "rule_set": rule_set,
        "remat": remat, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "seq_shard": seq_shard,
        "moe_dispatch": moe_dispatch or cfg.moe_dispatch, "dtype": "fp32",
    }
    record.update(trace_step(cfg, shape, rules, remat, block_kv))
    from repro_torch.roofline import analysis as roofline
    record["roofline"] = roofline.build_report(record).summary()
    return record


def trace_step(cfg, shape, rules, remat: str = "full",
               block_kv: int = 512, memory: bool = True) -> Dict:
    """Place fake inputs by ``rules`` on the mesh of the started process
    group and run ``shape``'s step of ``cfg`` on them: this rank's held
    bytes, FLOPs and bytes, collectives, memory peak (``memory``: a second
    run of the step), the model FLOPs and the roofline terms
    (``record["arch"]`` etc. left to the caller)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.compat import mem_tracker
    from repro_torch.distributed.sharding import mesh_axes
    from repro_torch.models import model_zoo
    from repro_torch.roofline import analysis as roofline
    from repro_torch.roofline.op_cost import analyze_fn

    record: Dict = {"kind": shape.kind,
                    "chips": int(np.prod(list(mesh_axes(rules.mesh)
                                              .values())))}
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        run, held = _run_step(cfg, shape, rules, remat, block_kv)
        record["place_s"] = time.time() - t0
        record["held_bytes_per_device"] = held
        t1 = time.time()
        with roofline.record_collectives() as colls:
            cost, _ = analyze_fn(run)
        record["step_s"] = time.time() - t1
        # a second run for the memory peak: DTensor caches each op's
        # shape inference (global-shape fake tensors, allocated by no
        # device) at its first run, so the tracker sees the step alone
        record["memory"] = {}
        if memory:
            with mem_tracker() as mt:
                run()
            peak = max(mt.get_tracker_snapshot("peak").values(),
                       key=lambda d: d.get("Total", 0))
            record["memory"] = {"peak_bytes": float(peak.get("Total", 0)),
                                "peak_by_kind": {str(k): float(v)
                                                 for k, v in peak.items()}}
    record["cost"] = {"flops": cost.flops, "bytes": cost.bytes,
                      "flops_by_op": cost.top()}
    record["collectives"] = colls
    record["collective_wire_bytes"] = roofline.wire_bytes_by_kind(colls)
    record["params_total"] = model_zoo.param_count(cfg)
    record["params_active"] = model_zoo.active_param_count(cfg)
    record["model_flops"] = roofline.model_flops(
        cfg, shape.kind, shape.global_batch, shape.seq_len,
        record["params_active"])
    record["roofline"] = roofline.build_report(
        {"arch": cfg.name, "shape": shape.name, "mesh": "", **record}
    ).summary()
    record["sharding_fallbacks"] = rules.fallbacks
    return record


def measure_cell(arch_name: str, shape_name: str, mesh_kind: str = "single",
                 rule_set: str = "fsdp", remat: str = "full",
                 block_kv: int = 512, seq_shard: str = "auto",
                 moe_dispatch: str = "") -> Dict:
    """Global FLOPs and bytes of the cell's unsharded step (the
    reference's scan-aware jaxpr count; an eager step has no loop that a
    counter sees once), beside the sharded cell's per-device collectives
    and the analytic model FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as optim_tx
    from repro_torch.roofline import analysis as roofline
    from repro_torch.roofline.op_cost import analyze_fn

    rec = run_cell(arch_name, shape_name, mesh_kind, rule_set, remat,
                   block_kv, seq_shard, moe_dispatch)
    spec, shape, cfg = _cell_setup(arch_name, shape_name, mesh_kind,
                                   rule_set, seq_shard, moe_dispatch)[:3]
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = model_zoo.build_model(cfg, remat=remat, block_kv=block_kv)
        params = optim_tx.tree_map(lambda m: _fake(m.shape),
                                   model_zoo.abstract_params(cfg))
        if shape.kind == "train":
            from repro_torch.configs.base import OptimizerConfig
            opt = OptimizerConfig()
            state = {"params": params,
                     "opt": optim_tx.build_optimizer(opt).init(params),
                     "step": _fake((), "int")}
            batch = {k: _fake(*v) for k, v in model_zoo.train_batch_specs(
                cfg, shape.global_batch, shape.seq_len).items()}
            cost, _ = analyze_fn(steps_lib.make_train_step(model, opt),
                                 state, batch, 1e-4)
        elif shape.kind == "prefill":
            batch = {k: _fake(*v) for k, v in model_zoo.prefill_batch_specs(
                cfg, shape.global_batch, shape.seq_len).items()}
            cost, _ = analyze_fn(steps_lib.make_prefill_step(model),
                                 params, batch)
        else:
            cache = {k: _fake(*v) for k, v in model.cache_shapes(
                shape.global_batch, shape.seq_len).items()}
            tokens = _fake(*model_zoo.decode_token_specs(shape.global_batch))
            cost, _ = analyze_fn(steps_lib.make_serve_step(model), params,
                                 cache, tokens)
    return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind,
            "kind": shape.kind, "chips": rec["chips"], "rule_set": rule_set,
            "flops_global": cost.flops, "bytes_global": cost.bytes,
            "flops_by_op": cost.top(), "trace_s": time.time() - t0,
            "flops_per_device": rec["cost"]["flops"],
            "collective_wire_bytes_per_device":
                rec["collective_wire_bytes"],
            "collective_wire_total": sum(
                rec["collective_wire_bytes"].values()),
            "model_flops": roofline.model_flops(
                cfg, shape.kind, shape.global_batch, shape.seq_len,
                rec["params_active"])}


def cell_path(out_dir: str, arch: str, shape: str, mesh_kind: str,
              tag: str = "") -> str:
    suffix = f".{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def _summary(rec: Dict) -> str:
    colls: Dict[str, int] = {}
    for c in rec["collectives"]:
        colls[c["kind"]] = colls.get(c["kind"], 0) + 1
    held = rec["held_bytes_per_device"]
    return (f"params/dev={held['params']:.3e}B opt/dev={held['opt']:.3e}B "
            f"flops/dev={rec['cost']['flops']:.3e} "
            f"peak={rec['memory'].get('peak_bytes', float('nan')):.3e}B "
            f"collectives={colls} step={rec['step_s']:.1f}s")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", nargs="+", default=["all"])
    parser.add_argument("--shape", nargs="+", default=["all"])
    parser.add_argument("--mesh", nargs="+", default=["single", "multi"],
                        choices=["single", "multi"])
    parser.add_argument("--rules", default="fsdp",
                        choices=["fsdp", "baseline", "fsdp_pure", "serve_tp"])
    parser.add_argument("--remat", default="full",
                        choices=["full", "dots", "none"])
    parser.add_argument("--block-kv", type=int, default=512)
    parser.add_argument("--out", default="experiments/dryrun_torch")
    parser.add_argument("--tag", default="",
                        help="suffix for variants of a cell")
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--moe-dispatch", default="",
                        choices=["", "global", "row_local"])
    parser.add_argument("--seq-shard", default="auto",
                        choices=["auto", "none", "data", "model"],
                        help="KV-cache sequence-axis sharding (auto: data "
                        "for long_500k only)")
    parser.add_argument("--measure", action="store_true",
                        help="also count the unsharded step's global FLOPs "
                        "and bytes; writes <cell>.measure[.tag].json")
    args = parser.parse_args(argv)

    from repro_torch.configs import ASSIGNED, get_arch_spec

    archs = list(ASSIGNED) if args.arch == ["all"] else args.arch
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch_name in archs:
        spec = get_arch_spec(arch_name)
        runnable = [s.name for s in spec.runnable_shapes()]
        shapes = runnable if args.shape == ["all"] else args.shape
        for shape_name in shapes:
            if shape_name not in runnable:
                print(f"SKIP {arch_name} x {shape_name} (documented skip)")
                continue
            for mesh_kind in args.mesh:
                tag = (("measure." if args.measure else "") + args.tag
                       ).rstrip(".")
                path = cell_path(args.out, arch_name, shape_name, mesh_kind,
                                 tag)
                if args.skip_existing and os.path.exists(path):
                    print(f"CACHED {path}")
                    continue
                label = f"{arch_name} x {shape_name} x {mesh_kind}"
                print(f"RUN {label} ...", flush=True)
                kw = dict(rule_set=args.rules, remat=args.remat,
                          block_kv=args.block_kv, seq_shard=args.seq_shard,
                          moe_dispatch=args.moe_dispatch)
                try:
                    if args.measure:
                        rec = measure_cell(arch_name, shape_name, mesh_kind,
                                           **kw)
                        msg = (f"flops_global={rec['flops_global']:.3e} "
                               f"coll/dev={rec['collective_wire_total']:.3e}B")
                    else:
                        rec = run_cell(arch_name, shape_name, mesh_kind, **kw)
                        msg = _summary(rec)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"OK  {label}: {msg}", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((label, str(e)))
                    traceback.print_exc()
                    print(f"FAIL {label}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        return 1
    print("\nall cells ran OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
