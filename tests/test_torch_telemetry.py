"""Per-leaf telemetry of the port against the JAX package, on the CPU.

* The leaf-group map: the port's labels equal ``repro``'s
  ``param_labels`` for reduced gpt2, rwkv6, zamba2 and deepseek-moe-16b
  and at full size (16, 26, 29 and 16 leaves), and each group holds its
  layers in order.
* ``leaf_norms`` and ``leaf_var_max`` on a transferred tree against the
  reference's, within 1e-6 relative: fp32 sums of squares reduced per
  layer and then per group instead of over the stacked leaf.
  ``leaf_var_max`` is a max of square roots, so it is exact.
* ``split_metrics`` (one transfer, the ``leaf_`` prefix dropped,
  ``grad_to_weight`` added), ``blame`` and the per-leaf host round trip
  give the reference's results on the same inputs.
* The ``--metrics-jsonl`` stream of a GNS run: the labels once, every
  row's per-leaf vectors as the trainer saw them, and the streamed pair
  replayed into an estimator.  This is the port's counterpart of
  ``tests/test_gns.py::test_metrics_jsonl_per_leaf_roundtrip``; it holds
  the round trip and not that ``b_noise`` is finite, which depends on the
  run (an EMA of |G|^2 that goes negative makes it inf by definition).
"""
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import (GNSConfig, OptimizerConfig, SLWConfig,
                                 TrainConfig, get_arch, reduced)
from repro_torch.core import telemetry as ttel
from repro_torch.gns import GNSEstimator
from repro_torch.launch.train import MetricsJsonlHook, TrainerHook, train
from repro_torch.models import model_zoo
from repro_torch.optim.transforms import tree_leaves

CPU = torch.device("cpu")
ARCHS = ("gpt2-117m", "rwkv6-7b", "zamba2-2.7b", "deepseek-moe-16b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small tensor ops: one intra-op thread keeps them cheap where
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's telemetry, configs and model init (skips where
    JAX is absent)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_arch as jget_arch, reduced as jreduced
    from repro.core import telemetry
    from repro.models import model_zoo as jzoo
    return types.SimpleNamespace(jax=jax, get_arch=jget_arch,
                                 reduced=jreduced, telemetry=telemetry,
                                 zoo=jzoo)


def _jax_params(jx, arch, small=True):
    cfg = jx.get_arch(arch).model
    cfg = jx.reduced(cfg) if small else cfg
    init = lambda: jx.zoo.init_params(jx.jax.random.PRNGKey(0), cfg)
    return init() if small else jx.jax.eval_shape(init)


def _port_cfg(arch, small=True):
    return reduced(get_arch(arch)) if small else get_arch(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_labels_equal_the_reference(jx, arch):
    jparams = _jax_params(jx, arch)
    tparams = bridge.params_from_numpy(
        jx.jax.tree_util.tree_map(np.asarray, jparams), _port_cfg(arch), CPU)
    groups = ttel.leaf_groups(tparams)
    assert groups.labels == jx.telemetry.param_labels(jparams)
    # each group is its reference leaf: stacked layers in order
    leaves = tree_leaves(tparams)
    for ref, members, stacked in zip(jx.jax.tree_util.tree_leaves(jparams),
                                     groups.gather(leaves), groups.stacked):
        got = torch.stack(members) if stacked else members[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch,n", [("gpt2-117m", 16), ("rwkv6-7b", 26),
                                    ("zamba2-2.7b", 29),
                                    ("deepseek-moe-16b", 16)])
def test_full_size_labels(jx, arch, n):
    ref = jx.telemetry.param_labels(_jax_params(jx, arch, small=False))
    meta = bridge._meta_params(model_zoo.model_defs(_port_cfg(arch, False)))
    got = ttel.param_labels(meta)
    assert got == ref and len(got) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_norms_and_var_max_match_reference(jx, arch):
    jparams = _jax_params(jx, arch)
    host = jx.jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(3)
    v_host = jx.jax.tree_util.tree_map(
        lambda p: (rng.random(np.shape(p)) ** 4).astype(np.float32), host)
    cfg = _port_cfg(arch)
    params = bridge.params_from_numpy(host, cfg, CPU)
    v = bridge.params_from_numpy(v_host, cfg, CPU)
    np.testing.assert_allclose(
        ttel.leaf_norms(params).numpy(),
        np.asarray(jx.telemetry.leaf_norms(jparams)), rtol=1e-6)
    np.testing.assert_array_equal(
        ttel.leaf_var_max(v).numpy(),
        np.asarray(jx.telemetry.leaf_var_max(v_host)))


def test_split_metrics_blame_and_host_round_trip(jx):
    rng = np.random.default_rng(0)
    n = 5
    host = {"loss": np.float32(2.5), "grad_norm": np.float32(1.25),
            "leaf_var_max": rng.random(n).astype(np.float32),
            "leaf_grad_norm": rng.random(n).astype(np.float32),
            "leaf_param_norm": np.array([1.0, 0.0, 2.0, 3.0, 0.5],
                                        np.float32),
            "leaf_gns_sketch": rng.standard_normal((n, 4)).astype(np.float32)}
    got_s, got_v = ttel.split_metrics(
        {**{k: torch.from_numpy(np.asarray(v)) for k, v in host.items()},
         "lr": 1e-3})
    ref_s, ref_v = jx.telemetry.split_metrics(
        {**{k: jx.jax.numpy.asarray(v) for k, v in host.items()},
         "lr": 1e-3})
    assert got_s == {k: float(v) for k, v in ref_s.items()}
    assert sorted(got_v) == sorted(ref_v)
    for k in ref_v:
        assert got_v[k].dtype == np.float32
        np.testing.assert_array_equal(got_v[k], ref_v[k])
    assert ttel.split_metrics({"loss": torch.tensor(1.0)}) == (
        {"loss": 1.0}, None)
    # the JSON form and back
    back = ttel.per_leaf_from_host(json.loads(json.dumps(
        ttel.per_leaf_to_host(got_v))))
    ref_back = jx.telemetry.per_leaf_from_host(
        jx.telemetry.per_leaf_to_host(ref_v))
    for k in ref_back:
        np.testing.assert_array_equal(back[k], ref_back[k])
    assert ttel.per_leaf_to_host(None) is None
    labels = tuple(f"leaf{i}" for i in range(n))
    for ratios in (got_v["var_max"], np.zeros(3)):
        assert ttel.blame(labels, ratios) == jx.telemetry.blame(labels,
                                                                ratios)
    assert ttel.blame((), got_v["var_max"]) == ""


def test_metrics_jsonl_per_leaf_roundtrip(tmp_path):
    """The stream holds the one-time labels and, in every row, the GNS
    scalars and the per-leaf vectors the trainer's regulators saw."""
    path = str(tmp_path / "metrics.jsonl")
    gns = GNSConfig(enabled=True, shards=4, precursor_window=6)

    class Seen(TrainerHook):
        rows = []

        def on_step_end(self, tr, tele, plan, metrics):
            self.rows.append((tele, tr.leaf_labels))

    cfg = reduced(get_arch("gpt2-117m")).replace(vocab_size=128)
    tc = TrainConfig(
        model=cfg, optimizer=OptimizerConfig(
            lr=1e-3, schedule="token_cosine", warmup_steps=4,
            warmup_tokens=4 * 8 * 64, total_steps=8, total_tokens=8 * 8 * 64,
            telemetry_level="per_leaf"),
        slw=SLWConfig(enabled=False), gns=gns, seq_len=64, global_batch=8,
        remat="none", eval_interval=0)
    res = train(tc, hooks=[MetricsJsonlHook(path), Seen()], device="cpu")
    assert res.steps == 8 and res.precursor_events == []
    labels, rows = ttel.read_metrics_jsonl(path)
    assert len(rows) == 8 and labels == Seen.rows[0][1]
    with open(path) as f:
        assert sum("leaf_labels" in json.loads(line) for line in f) == 1
    est = GNSEstimator(ema_window=8, warmup_obs=2)
    for r, (tele, _) in zip(rows, Seen.rows):
        for k in ("gns_small_sq", "gns_big_sq", "gns_b_small", "gns_b_big",
                  "grad_norm", "var_max"):
            assert r[k] == getattr(tele, k), k
        assert (r["gns_b_small"], r["gns_b_big"]) == (2.0, 8.0)
        assert sorted(r["per_leaf"]) == sorted(tele.per_leaf)
        for k, v in tele.per_leaf.items():
            assert r["per_leaf"][k].dtype == np.float32
            np.testing.assert_array_equal(r["per_leaf"][k], v)
        assert r["per_leaf"]["gns_sketch"].shape == (len(labels),
                                                     gns.precursor_dim)
        np.testing.assert_allclose(r["per_leaf"]["gns_small_sq"].sum(),
                                   r["gns_small_sq"], rtol=1e-5)
        est.update(r["gns_small_sq"], r["gns_big_sq"], r["gns_b_small"],
                   r["gns_b_big"])
    assert est.ready and est.n_obs == 8
