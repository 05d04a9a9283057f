"""The port's logical-axis sharding rules against the JAX package's, in
process, with no devices.

The reference's ``ShardingRules._resolve`` reads only ``mesh.axis_names``
and ``mesh.shape``, so both packages resolve on a stand-in mesh of names
and sizes (``MeshShape``); the reference's ``NamedSharding`` is replaced
by its spec where a tree of shardings is built (the main test process has
one CPU device).

* Every preset x the four rule sets x the (4, 2) and (2, 16, 16) meshes:
  each param's spec and the fallbacks its resolution records equal the
  reference's, after mapping the port's per-layer leaves onto the
  reference's stacked ones (the stacked leaf has a leading "layers" dim,
  which no rule shards, so its spec is the port's behind a ``None`` and
  its fallback messages count dims one further); the Adam moments'
  placements follow the params and everything else of the chain state is
  replicated.
* The same for the batch, the model's cache and the dense and paged serve
  states (fallbacks as sets: the port records a repeated resolution once,
  the reference at every call).
* The reference's fallback cases (``tests/test_distributed.py:30-47``),
  ``constrain`` as the identity without rules or on a plain tensor, and
  the DTensor placements a spec gives.
"""
from typing import Dict, NamedTuple, Tuple

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.distributed import sharding as jsharding
from repro.models import model_zoo as jzoo
from repro.serve import SlotDecodeState as JSlot
from repro.serve.paging import PagedDecodeState as JPaged
from repro_torch.configs import SPECS, get_arch
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.compat import Replicate, Shard
from repro_torch.launch import steps as tsteps
from repro_torch.models import model_zoo as tzoo
from repro_torch.serve.paging import PagedDecodeState as TPaged
from repro_torch.serve.state import SlotDecodeState as TSlot

class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices: what both packages'
    resolution reads."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


RULE_SETS = ("baseline", "fsdp", "fsdp_pure", "serve_tp")
MESHES = {"4x2": MeshShape(("data", "model"), (4, 2)),
          "2x16x16": MeshShape(("pod", "data", "model"), (2, 16, 16))}
STACKED = ("layers", "mamba_layers")
CASES = [(a, r, m) for a in sorted(SPECS) for r in RULE_SETS for m in MESHES]


def _rules(pkg, mesh, rule_set):
    return pkg.ShardingRules.make(mesh, rule_set)


def _spec(s):
    return tuple(s)


def _leaf_fallbacks(pkg, mesh, rule_set, kind, axes, shape):
    """(spec, fallbacks) of one leaf resolved by a fresh rule object."""
    rules = _rules(pkg, mesh, rule_set)
    fn = rules.param_spec if kind == "param" else rules.act_spec
    return _spec(fn(axes, shape)), list(rules.fallbacks)


def _shift(msgs):
    """A per-layer leaf's fallback messages as its stacked leaf's: each dim
    one further."""
    out = []
    for m in msgs:
        head, rest = m.split(": dim ", 1)
        i, tail = rest.split(" ", 1)
        out.append(f"{head}: dim {int(i) + 1} {tail}")
    return out


def _pairs(jaxes, jshapes, taxes, tshapes, stacked=False):
    """(ref axes, ref shape, port axes, port shape, stacked) per leaf, the
    port's layer lists mapped onto the reference's stacked leaves."""
    if jsharding.is_axes_leaf(jaxes):
        yield jaxes, tuple(jshapes.shape), taxes, tuple(tshapes.shape), stacked
        return
    for k in jaxes:
        if k in STACKED:
            n = len(taxes[k])
            assert jshapes[k] is not None and n >= 1
            for layer in range(n):
                yield from _pairs(jaxes[k], jshapes[k], taxes[k][layer],
                                  tshapes[k][layer], True)
        else:
            yield from _pairs(jaxes[k], jshapes[k], taxes[k], tshapes[k],
                              stacked)


@pytest.mark.parametrize("arch,rule_set,mesh_name", CASES)
def test_param_specs_and_fallbacks_match_reference(arch, rule_set, mesh_name):
    mesh = MESHES[mesh_name]
    jcfg = jget_arch(arch).model
    tcfg = get_arch(arch)
    pairs = list(_pairs(jzoo.param_axes(jcfg), jzoo.abstract_params(jcfg),
                        tzoo.param_axes(tcfg), tzoo.abstract_params(tcfg)))
    assert len(pairs) >= 10
    for jax_axes, jshape, taxes, tshape, stacked in pairs:
        if stacked:
            assert jax_axes == ("layers",) + taxes and jshape[1:] == tshape
        else:
            assert jax_axes == taxes and jshape == tshape
        jspec, jfall = _leaf_fallbacks(jsharding, mesh, rule_set, "param",
                                       jax_axes, jshape)
        tspec, tfall = _leaf_fallbacks(tsharding, mesh, rule_set, "param",
                                       taxes, tshape)
        if stacked:
            assert jspec == (None,) + tspec, (jax_axes, jspec, tspec)
            assert jfall == _shift(tfall), (jax_axes, jfall, tfall)
        else:
            assert jspec == tspec and jfall == tfall, (jax_axes, jspec, tspec)


class _Named:
    """Stands in for ``jax.sharding.NamedSharding`` on a mesh of names: a
    tree leaf holding the spec."""

    def __init__(self, mesh, spec):
        self.spec = _spec(spec)


def _named_specs(monkeypatch, *modules):
    for m in (jsharding,) + modules:
        monkeypatch.setattr(m, "NamedSharding", _Named)


def _specs(tree):
    return {k: v.spec for k, v in _flat(tree).items()}


def _flat(tree, prefix=""):
    """{leaf name: value} of a dict tree (a nested dict's leaves by their
    own key: the reference nests Zamba-2's Mamba cache, the port does
    not)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("arch,rule_set,mesh_name", CASES)
def test_batch_cache_and_serve_specs_match_reference(arch, rule_set,
                                                     mesh_name, monkeypatch):
    _named_specs(monkeypatch)
    mesh = MESHES[mesh_name]
    jcfg = jget_arch(arch).model
    tcfg = get_arch(arch)
    jr, tr = _rules(jsharding, mesh, rule_set), _rules(tsharding, mesh,
                                                        rule_set)
    # batches: train, prefill and one decode token per row
    for b, s in ((32, 4096), (4, 1024), (1, 64)):
        jb = jzoo.train_batch_specs(jcfg, b, s)
        tb = tzoo.train_batch_specs(tcfg, b, s)
        assert set(jb) == set(tb)
        for name in jb:
            want = _spec(jr.act_spec(jzoo.batch_logical_axes(jcfg)[name],
                                     jb[name].shape))
            got = tr.act_spec(
                tzoo.batch_logical_axes(tcfg)[name], tb[name][0])
            assert got == want, (name, got, want)
    tokens = tsteps.batch_shardings(tr, tcfg, {
        "tokens": tzoo.decode_token_specs(32)})["tokens"].spec
    assert tokens == _spec(jr.act_spec(("batch", "seq"), (32, 1)))
    # the model's cache, the dense slot state and the paged state
    jmodel = jzoo.build_model(jcfg, remat="none")
    tmodel = tzoo.build_model(tcfg, remat="none")
    for b, s in ((32, 4096), (2, 64)):
        want = _specs(jsharding.tree_act_shardings(
            jr, jmodel.cache_axes(), jmodel.cache_shapes(b, s)))
        got = {k: v.spec for k, v in
               tsteps.cache_shardings(tr, tmodel, b, s).items()}
        assert got == want, (got, want)
    want = _specs(JSlot(jmodel).shardings(jr, n_slots=8, cache_len=64))
    got = {k: v.spec for k, v in
           TSlot(tmodel).shardings(tr, n_slots=8, cache_len=64).items()}
    assert got == want
    want = _specs(JPaged(jmodel, 16, 24).shardings(jr, n_slots=8,
                                                   cache_len=64))
    got = {k: v.spec for k, v in
           TPaged(tmodel, 16, 24).shardings(tr, n_slots=8,
                                            cache_len=64).items()}
    assert got == want
    # the port records a repeated resolution once, the reference at every
    # call
    assert set(tr.fallbacks) == set(jr.fallbacks)


@pytest.mark.parametrize("arch", ["gpt2-117m", "qwen3-32b",
                                  "deepseek-moe-16b", "zamba2-2.7b"])
def test_train_state_shardings_match_reference(arch, monkeypatch):
    """The whole train state under fsdp on (2, 16, 16): params as above,
    Adam's m and v on the params' specs, count and step replicated."""
    from repro.launch import steps as jsteps
    _named_specs(monkeypatch, jsteps)
    mesh = MESHES["2x16x16"]
    jcfg, tcfg = jget_arch(arch).model, get_arch(arch)
    jsh = jsteps.train_state_shardings(_rules(jsharding, mesh, "fsdp"), jcfg)
    tsh = tsteps.train_state_shardings(_rules(tsharding, mesh, "fsdp"), tcfg)
    assert set(tsh["opt"]) == set(jsh["opt"])
    for part in ("m", "v"):
        for name in tsh["opt"]["adam"][part]:
            tleaf = tsh["opt"]["adam"][part][name]
            jleaf = jsh["opt"]["adam"][part][name]
            if name in STACKED:
                for layer in tleaf:
                    for key, spec in _specs(layer).items():
                        assert (None,) + spec == _specs(jleaf)[key]
            elif isinstance(tleaf, dict):
                assert _specs(tleaf) == _specs(jleaf)
            else:
                assert tleaf.spec == jleaf.spec
    for sh in (tsh["opt"]["adam"]["count"], tsh["step"]):
        assert sh.spec == () and all(
            isinstance(p, Replicate) for p in sh.placements)
    assert jsh["opt"]["adam"]["count"].spec == () and jsh["step"].spec == ()


def test_rules_conflict_and_divisibility_fallback():
    """``tests/test_distributed.py:30-47`` on the port."""
    rules = tsharding.ShardingRules.make(MESHES["4x2"], "fsdp")
    # moe weight: experts takes model; embed takes data; mlp must back off
    spec = rules.param_spec(("experts", "embed", "mlp"), (8, 16, 64))
    assert spec == ("model", "data", None), spec
    # non-divisible head count falls back to replication
    spec2 = rules.param_spec(("embed", "heads", "head_dim"), (16, 5, 64))
    assert spec2[1] is None, spec2
    assert any("heads=5" in f for f in rules.fallbacks)
    # a resolution recorded once, however often a step repeats it
    n = len(rules.fallbacks)
    rules.param_spec(("embed", "heads", "head_dim"), (16, 5, 64))
    assert len(rules.fallbacks) == n
    # fsdp_pure puts the batch over every axis, the pod first
    pure = tsharding.ShardingRules.make(MESHES["2x16x16"], "fsdp_pure")
    assert pure.act_spec(("batch", "seq"), (1024, 8)) == (
        ("pod", "data", "model"), None)
    assert pure.act_spec(("batch", "seq"), (64, 8)) == (("pod", "data"),
                                                        None)


def test_spec_placements():
    mesh = MESHES["2x16x16"]
    assert tsharding.spec_placements((("pod", "data"), None, "model"),
                                     mesh) == (Shard(0), Shard(0), Shard(2))
    assert tsharding.spec_placements((None, None), mesh) == (
        Replicate(), Replicate(), Replicate())
    with pytest.raises(ValueError):
        tsharding.spec_placements((("data", "pod"),), mesh)


def test_constrain_is_identity_without_rules():
    x = torch.randn(2, 3, 4)
    assert tsharding.constrain(x, ("batch", "seq", "embed")) is x
    rules = tsharding.ShardingRules.make(MESHES["4x2"], "fsdp")
    with tsharding.use_rules(rules):
        assert tsharding.active_rules() is rules
        # a plain tensor is not constrained, even under rules
        assert tsharding.constrain(x, ("batch", "seq", "embed")) is x
        assert tsharding.gather_params({"w": x}, {"w": ("embed",)})["w"] \
            is x
    assert tsharding.active_rules() is None
    got = tsharding.local_call(lambda a: a * 2, (x,), (("batch",),),
                               (("batch",),))
    np.testing.assert_array_equal(got.numpy(), (x * 2).numpy())
