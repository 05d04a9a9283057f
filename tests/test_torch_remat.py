"""remat "dots" and the paper's GPT-2 1.5B against the JAX package on the CPU.

``layers.remat_call(fn, "dots", ...)`` is the port's counterpart of
``maybe_checkpoint(fn, "dots")``: selective activation checkpointing that
keeps the outputs of ``aten.mm`` / ``aten.addmm`` (a ``dot_general`` with
no batch dimensions) and recomputes everything else.

* Every family at reduced size (gpt2, deepseek-moe under both dispatches,
  rwkv6, zamba2), fp32, JAX weights moved through ``repro_torch.bridge``:
  the port's "dots" loss against the reference's "dots" loss (rtol 1e-5),
  every gradient leaf within 1e-4 of the JAX leaf's largest entry, and the
  port's "dots" gradients bit-equal to its own "none" gradients.
* The saved residuals of one checkpointed block of each family: the
  element counts of the port's saved matmul outputs against those of the
  reference's ``saved_residuals``.  The two differ in one documented way:
  torch keeps every selected op's output, XLA only the residuals the
  backward reads, so the port also holds the block's last projection
  (the one that only feeds the residual add).
* The kernels' forward functions (their plain versions here) run again
  in the backward under "dots", as under "full": a kernel's output is
  never saved.
* gpt2-1.5b on a 2-layer slice that keeps its odd head count (5 heads of
  16, d 80) under "dots" and "none".
* The dry run traces a step under each policy.

The reference's ``maybe_checkpoint`` names
``jax.checkpoint_policies.checkpoint_dots_no_batch_dims``, which the
installed JAX calls ``checkpoint_dots_with_no_batch_dims``; a fixture
gives the policy its old name for the reference, so its "dots" runs.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models import zamba2 as jzamba2
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import zamba2 as tzamba2

CPU = torch.device("cpu")
TOL = 1e-4
SRC = Path(__file__).resolve().parents[1] / "src"
# (preset, overrides of the reduced config)
FAMILIES = {
    "gpt2": ("gpt2-117m", {}),
    "moe_row_local": ("deepseek-moe-16b", dict(moe_dispatch="row_local",
                                                capacity_factor=0.75)),
    "moe_global": ("deepseek-moe-16b", dict(moe_dispatch="global",
                                            capacity_factor=0.75)),
    "rwkv6": ("rwkv6-7b", {}),
    "zamba2": ("zamba2-2.7b", {}),
    # gpt2-1.5b cut to 2 layers, keeping 25 heads' oddness: 5 heads of 16
    "gpt2_1p5b": ("gpt2-1.5b", dict(n_layers=2, d_model=80, n_heads=5,
                                    n_kv_heads=5, head_dim=16, d_ff=320)),
}


@pytest.fixture(scope="module", autouse=True)
def setup():
    """One intra-op thread (many small ops, shared cores), and the
    reference's name for XLA's dots policy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    pol = jax.checkpoint_policies
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pol, "checkpoint_dots_no_batch_dims"):
            mp.setattr(pol, "checkpoint_dots_no_batch_dims",
                       pol.checkpoint_dots_with_no_batch_dims, raising=False)
        yield
    torch.set_num_threads(n)


def _cfgs(family):
    preset, kw = FAMILIES[family]
    if family == "gpt2_1p5b":
        # the slice's widths replace reduced()'s
        kw = dict(kw, vocab_size=512, max_seq_len=256)
        return (jget_arch(preset).model.replace(**kw),
                tconfigs.get_arch(preset).replace(**kw))
    return (jreduced(jget_arch(preset).model).replace(**kw),
            tconfigs.reduced(tconfigs.get_arch(preset)).replace(**kw))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _grads_close(got, ref):
    got, ref = _leaves(got), _leaves(ref)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, g), (_, r) in zip(got, ref):
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= TOL * scale, f"{name}: {err} > {TOL} x {scale}"


def _weights(family):
    jcfg, tcfg = _cfgs(family)
    params = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, tcfg, bridge.params_from_numpy(host, tcfg, CPU)


def _port_loss_grads(tcfg, tparams, batch, remat):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in jax.tree_util.tree_leaves(tparams)]
    tree = jax.tree_util.tree_structure(tparams)
    total, _ = tzoo.build_model(tcfg, remat=remat).loss(
        jax.tree_util.tree_unflatten(tree, leaves),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    total.backward()
    return total, jax.tree_util.tree_unflatten(tree,
                                               [p.grad for p in leaves])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dots_matches_reference_and_none(family):
    jcfg, params, tcfg, tparams = _weights(family)
    batch = tzoo.make_train_batch(5, tcfg, 3, 24)
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat="dots")
    (jtotal, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    total, grads = _port_loss_grads(tcfg, tparams, batch, "dots")
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    _grads_close(bridge.params_to_numpy(grads, tcfg),
                 jax.tree_util.tree_map(np.asarray, jg))
    # the recompute replays the same ops on the same inputs: the same bits
    none_total, none_grads = _port_loss_grads(tcfg, tparams, batch, "none")
    assert torch.equal(total, none_total)
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(none_grads)):
        assert torch.equal(a, b)


# -- saved residuals ----------------------------------------------------------
B, S = 2, 16


def _port_saved(fn, *args):
    """Element counts of the outputs ``dots_policy`` saves while ``fn``
    runs forward under remat "dots"."""
    saved = []
    policy = tlayers.dots_policy

    def record(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        if not ctx.is_recompute and out == CheckpointPolicy.MUST_SAVE:
            m, n = ((a[0].shape[0], a[1].shape[1])
                    if op == torch.ops.aten.mm.default
                    else (a[1].shape[0], a[2].shape[1]))
            saved.append(m * n)
        elif not ctx.is_recompute:
            assert op not in tlayers.DOT_OPS
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "dots_policy", record)
        tlayers.remat_call(fn, "dots", *args)
    return sorted(saved)


def _blocks(name):
    """(JAX block fn, its args, port block fn, its args) of one layer."""
    family = {"gpt2": "gpt2", "moe": "moe_row_local", "rwkv6": "rwkv6",
              "mamba": "zamba2", "shared": "zamba2"}[name]
    jcfg, params, tcfg, tparams = _weights(family)
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x).requires_grad_(True)
    pos = jnp.arange(S)
    jmodel = jbuild_model(jcfg, dtype=jnp.float32, remat="dots")
    tmodel = tzoo.build_model(tcfg, remat="dots")
    first = lambda tree: jax.tree_util.tree_map(lambda a: a[0], tree)
    if name == "gpt2":
        return (jmodel._block_nokv(), (jx, first(params["layers"]), pos),
                tmodel._block, (tparams["layers"][0], tx))
    if name == "moe":
        return (jmodel._moe_block(False), (jx, first(params["layers"]), pos),
                tmodel._block, (tparams["layers"][0], tx))
    if name == "rwkv6":
        return (lambda h, lp: jrwkv6.rwkv6_block(lp, h, jcfg),
                (jx, first(params["layers"])),
                trwkv6.rwkv6_block, (tparams["layers"][0], tx, tcfg))
    if name == "mamba":
        return (lambda h, lp: jmamba2.mamba2_block(lp, h, jcfg),
                (jx, first(params["mamba_layers"])),
                tmamba2.mamba2_block, (tparams["mamba_layers"][0], tx, tcfg))
    return (lambda h, sh: jzamba2._shared_block(sh, h, jcfg, pos, 512)[0],
            (jx, params["shared"]),
            tzamba2._shared_block, (tparams["shared"], tx, tcfg, 512))


# the port's one extra residual per block: the last projection's output
# (B * S * d), read by no backward (it only feeds the residual add), which
# XLA drops and torch's selective checkpoint keeps; RWKV-6's channel mix
# multiplies its last projection by the receptance gate, so XLA keeps it
EXTRA = {"gpt2": 1, "moe": 1, "rwkv6": 0, "mamba": 1, "shared": 1}


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_saved_residuals_match_reference(name):
    jfn, jargs, tfn, targs = _blocks(name)
    res = saved_residuals(jlayers.maybe_checkpoint(jfn, "dots"), *jargs)
    computed = [(int(np.prod(a.shape)), what) for a, what in res
                if "from the argument" not in what
                and "from a constant" not in what]
    # XLA keeps the dots' outputs (each stamped by a reduce_precision) and
    # the outputs of jitted activations right after a dot (silu): each is
    # the size of the dot it follows, which the port keeps instead
    for _, what in computed:
        assert ("reduce_precision" in what
                or "jitted function 'silu'" in what), what
    want = sorted([n for n, _ in computed]
                  + [B * S * targs[1].shape[-1]] * EXTRA[name])
    assert _port_saved(tfn, *targs) == want


@pytest.mark.parametrize("family,module,name", [
    ("gpt2", fa_kernel, "flash_attention_fwd_plain"),
    ("rwkv6", wkv6_kernel, "wkv6_fwd_plain"),
    ("zamba2", ssd_kernel, "ssd_fwd_plain")])
def test_kernel_forwards_run_again_in_the_backward(family, module, name):
    """Under "dots" and "full" each layer's kernel forward runs twice a
    step (forward, then the backward's recompute), once under "none": the
    policy never saves what a kernel writes."""
    _, _, tcfg, tparams = _weights(family)
    batch = tzoo.make_train_batch(5, tcfg, 2, 16)
    plain = getattr(module, name)
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, counting)
        for remat in ("none", "full", "dots"):
            calls.clear()
            _port_loss_grads(tcfg, tparams, batch, remat)
            got[remat] = len(calls)
    n = tcfg.n_layers  # one kernel call a layer
    assert got == {"none": n, "full": 2 * n, "dots": 2 * n}


_DRYRUN = r"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {src!r})
from repro_torch.distributed.compat import init_fake_group
init_fake_group(8, 0)
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import make_host_mesh

cfg = reduced(get_arch("gpt2-117m"))
rules = ShardingRules.make(make_host_mesh((4, 2), ("data", "model")), "fsdp")
shape = ShapeConfig("mini_train", "train", 64, 8)
print(json.dumps({{r: trace_step(cfg, shape, rules, r, memory=False)
                   ["cost"]["flops"] for r in ("none", "dots", "full")}}))
"""


def test_dryrun_traces_each_remat_policy():
    """A sharded step on 8 fake ranks traces under each policy; "dots"
    recomputes less than "full" and more than "none"."""
    r = subprocess.run([sys.executable, "-c", _DRYRUN.format(src=str(SRC))],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    flops = json.loads(r.stdout.strip().splitlines()[-1])
    assert 0 < flops["none"] < flops["dots"] < flops["full"], flops
