"""The port's analysis tooling against the JAX package: the presets' shape
cells, the analytic model FLOPs, and a mini dry run on a fake process
group.

* Every preset x runnable shape: the same cells (kind, seq_len, batch),
  source and notes as the reference's ``ArchSpec``, the same active
  parameter count, and ``model_flops`` equal to the reference's.
* In a subprocess with ``jax`` blocked, a mini dry run of gpt2-117m's
  train step (8 x 512) on 8 fake ranks, a (4, 2) ``("data", "model")``
  mesh, ``fsdp`` rules (the reference's slow mini dry run,
  ``tests/test_distributed.py:127-166``): FLOPs per device > 0; all-gathers
  and reduce-scatters or all-reduces among the collectives; each device's
  param and optimizer bytes equal to what the param specs give.  The same
  for its prefill step (8 x 512) and one serve step against a 512-long
  cache, with the decode cache's bytes per device from the cache specs.
* The H100 constants and the roofline report's terms.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_arch as jget_arch
from repro.models import model_zoo as jzoo
from repro.roofline import analysis as janalysis
from repro_torch.configs import SPECS, get_arch_spec
from repro_torch.models import model_zoo as tzoo
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import hw

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CELLS = [(a, s.name) for a in sorted(SPECS)
         for s in get_arch_spec(a).runnable_shapes()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    jspec, tspec = jget_arch(arch), get_arch_spec(arch)
    assert [s.name for s in jspec.runnable_shapes()] == \
        [s.name for s in tspec.runnable_shapes()]
    assert (jspec.source, jspec.notes) == (tspec.source, tspec.notes)
    js, ts = jspec.shape(shape), tspec.shape(shape)
    assert (js.kind, js.seq_len, js.global_batch) == \
        (ts.kind, ts.seq_len, ts.global_batch)
    ja = jzoo.active_param_count(jspec.model)
    ta = tzoo.active_param_count(tspec.model)
    assert ja == ta
    want = janalysis.model_flops(jspec.model, js.kind, js.global_batch,
                                 js.seq_len, ja)
    got = tanalysis.model_flops(tspec.model, ts.kind, ts.global_batch,
                                ts.seq_len, ta)
    assert got == want > 0


_MINI = r"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {src!r})
from repro_torch.distributed.compat import init_fake_group
init_fake_group(8, 0)
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import ShardingRules, mesh_axes
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import dp_size, make_host_mesh
from repro_torch.models import model_zoo

cfg = get_arch("gpt2-117m")
model = model_zoo.build_model(cfg)
mesh = make_host_mesh((4, 2), ("data", "model"))
rules = ShardingRules.make(mesh, "fsdp")
sizes = mesh_axes(mesh)
def local_numel(spec, shape):
    n = 1
    for dim, entry in zip(shape, spec):
        parts = 1
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            parts *= sizes[a]
        n *= dim // parts
    return n
def walk(axes, p):
    if isinstance(axes, tuple):
        return local_numel(rules.param_spec(axes, tuple(p.shape)),
                           tuple(p.shape))
    if isinstance(axes, dict):
        return sum(walk(axes[k], p[k]) for k in axes)
    return sum(walk(a, q) for a, q in zip(axes, p))
want = 4 * walk(model_zoo.param_axes(cfg), model_zoo.abstract_params(cfg))
out = {{}}
for kind in ("train", "prefill", "decode"):
    shape = ShapeConfig("mini_" + kind, kind, 512, 8)
    rec = trace_step(cfg, shape, rules, memory=False)
    cache = 0
    if kind == "decode":
        shapes = model.cache_shapes(8, 512)
        cache = sum((4 if shapes[k][1] == "float" else 8) * local_numel(
            rules.act_spec(axes, shapes[k][0]), shapes[k][0])
            for k, axes in model.cache_axes().items())
    out[kind] = {{"flops": rec["cost"]["flops"],
                 "kinds": sorted({{c["kind"] for c in rec["collectives"]}}),
                 "held": rec["held_bytes_per_device"], "want": want,
                 "want_cache": cache, "dp": dp_size(mesh),
                 "chips": rec["chips"],
                 "total": 4 * model_zoo.param_count(cfg)}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mini():
    r = subprocess.run([sys.executable, "-c", _MINI.format(src=SRC)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_mini_dryrun_on_eight_fake_ranks(mini):
    out = mini["train"]
    assert out["flops"] > 0 and out["chips"] == 8 and out["dp"] == 4
    # FSDP gathers the weights and reduces their gradients
    assert "all-gather" in out["kinds"], out["kinds"]
    assert {"all-reduce", "reduce-scatter"} & set(out["kinds"]), out["kinds"]
    assert out["held"]["params"] == out["want"]
    assert out["held"]["opt"] == 2 * out["want"] + 4  # m, v and the count
    assert out["want"] < out["total"] / 2  # the params are sharded


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mini_dryrun_serving_cells(mini, kind):
    """The prefill step and one serve step of the same mini cell: FSDP
    gathers the weights, each device holds its param shards (and, for
    decode, its shards of the KV cache: slots over "data", KV heads over
    "model") and no optimizer state."""
    out = mini[kind]
    assert out["flops"] > 0 and out["chips"] == 8
    assert "all-gather" in out["kinds"], out["kinds"]
    assert out["held"]["params"] == out["want"]
    assert out["held"]["opt"] == 0
    if kind == "decode":
        assert out["held"]["cache"] == out["want_cache"] > 0
    # a forward of the batch, or of one token each, costs less than a
    # train step's forward and backward
    assert out["flops"] < mini["train"]["flops"]


def test_h100_constants_and_roofline_terms():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_TF32, hw.PEAK_FLOPS_FP32) == (
        989e12, 495e12, 67e12)
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (3.35e12, 80e9, 450e9)
    assert hw.wire_bytes("all-reduce", 100, 4) == 150.0
    assert hw.wire_bytes("all-gather", 100, 4) == 75.0
    assert hw.wire_bytes("collective-permute", 100, 2) == 100.0
    assert hw.wire_bytes("all-gather", 100, 1) == 0.0
    rep = tanalysis.build_report({
        "arch": "a", "shape": "s", "mesh": "single", "kind": "train",
        "chips": 2, "cost": {"flops": 67e12, "bytes": 3.35e12},
        "model_flops": 67e12, "dtype": "fp32",
        "collectives": [{"kind": "all-reduce", "result_bytes": 450e9,
                         "group": 2}]})
    assert (rep.t_compute, rep.t_memory, rep.t_collective) == (1.0, 1.0,
                                                               1.0)
    assert rep.useful_flops_ratio == 0.5 and rep.mfu_upper_bound == 0.5
