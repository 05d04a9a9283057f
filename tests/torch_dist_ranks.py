"""Rank entry points of ``tests/test_torch_distributed.py`` and
``tests/test_torch_distributed_models.py``: gloo ranks on the CPU, started
with ``torch.multiprocessing``.

Importing this module pulls in no JAX and nothing of ``repro``: spawn
re-imports it in every rank.  The JAX side runs in the pytest process; the
two sides exchange ``.npz`` files in the test's temporary directory, and
the ranks meet through a ``FileStore`` there (no port is opened).  The
numpy check that both test files use, :func:`step_params_close`, lives
here too.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")


def flat(tree, prefix=""):
    """{"a/b/c": array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflat(arrays, prefix):
    """The nested dict under ``prefix/`` of a flat {path: array} mapping."""
    out = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(arrays[key])
    return out


def step_params_close(got, want, grads, p0, grad_norm, opt, lr):
    """Hold one AdamW step's params against the reference's where the
    step is determined by the gradients' tolerance.

    At the first step Adam moves each entry by ``lr * g / (|g| + eps)``
    plus the decay, with ``g`` the clipped gradient: an error ``dg`` moves
    it by at most ``lr * eps * dg / g**2``.  Where ``|g|`` is at least
    1e-3 of the leaf's largest clipped entry ``gmax`` and ``dg`` within
    1e-5 of ``gmax``, that is ``lr * 10 * eps / gmax``: the params must
    agree within it plus 1e-6 of the leaf's largest entry (fp32 rounding
    of the param).  Elsewhere a gradient within its tolerance of zero
    leaves the direction open, and the step is held to its size, at most
    ``lr`` from the reference's start plus the decay (the embedding rows
    of tokens a batch lacks have no gradient at all).  Returns the number
    of entries held to the tight bound.  Trees are flat {path: array}."""
    scale = min(1.0, opt.grad_clip / grad_norm) if opt.grad_clip else 1.0
    tight = 0
    for key, r in want.items():
        g = np.abs(grads[key]) * scale
        gmax = float(g.max())
        pmax = float(np.abs(r).max())
        err = np.abs(got[key] - r)
        sure = g >= 1e-3 * gmax
        bound = lr * 10 * opt.eps / max(gmax, 1e-30) + 1e-6 * pmax
        assert float(err[sure].max(initial=0)) <= bound, key
        moved = np.abs(got[key] - p0[key])
        assert float(moved.max()) <= lr * (1 + opt.weight_decay * pmax) \
            + 1e-6 * pmax, key
        tight += int(sure.sum())
    return tight


def _init(rank, world, tmp, name):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"store_{name}"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _plain(x):
    from repro_torch.distributed.compat import is_dtensor
    x = x.full_tensor() if is_dtensor(x) else x
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# eight ranks: the (4, 2) mesh and the (8,) sequence mesh
# ---------------------------------------------------------------------------

def _adamw_update(inp, rules, cfg, out):
    """(a) the sharded AdamW chain fed the reference's gradients."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch import steps
    from repro_torch.optim import transforms as tx_lib

    opt = OptimizerConfig()
    tx = tx_lib.build_optimizer(opt)
    params = params_from_numpy(unflat(inp, "a_params"), cfg, CPU)
    state = steps.shard_train_state(
        {"params": params, "opt": tx.init(params),
         "step": torch.zeros((), dtype=torch.int32)}, rules, cfg, opt)
    p_sh = steps.train_state_shardings(rules, cfg, opt)["params"]
    for i in range(int(inp["a_steps"])):
        grads = steps.shard_tree(params_from_numpy(
            unflat(inp, f"a_grads{i}"), cfg, CPU), p_sh)
        hyper = {"lr": float(inp["a_lr"][i]), "clip_scale": 1.0}
        with torch.no_grad(), use_rules(rules):
            updates, state["opt"], tel = tx.update(
                grads, state["opt"], state["params"], hyper)
            tx_lib.apply_updates(state["params"], updates)
        for key in ("grad_norm", "grad_norm_clipped", "var_max", "var_l1",
                    "mom_l1"):
            out[f"a_{key}{i}"] = _plain(tel[key])
        whole = steps.unshard_tree(state["params"])
        out.update(flat(params_to_numpy(whole, cfg), f"a_params{i}"))
    out["a_placements"] = np.array([str(tuple(p.placements)) for p in
                                    tx_lib.tree_leaves(state["params"])])


def _model_step(inp, rules, cfg, out, tag, src="b", remat="full"):
    """Loss and gradients of one sharded step under ``remat``, and the
    whole step's metrics and updated params, from the params and batch
    under ``src`` in ``inp``."""
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.distributed.sharding import gather_params, use_rules
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    from repro_torch.optim import transforms as tx_lib

    model = model_zoo.build_model(cfg, remat=remat)
    params = params_from_numpy(unflat(inp, f"{src}_params"), cfg, CPU)
    batch = {k: torch.from_numpy(inp[f"{src}_{k}"]).long()
             for k in ("tokens", "labels")}
    sbatch = steps.shard_tree(batch, steps.batch_shardings(rules, cfg, batch))
    p_sh = steps.train_state_shardings(rules, cfg)["params"]
    sparams = steps.shard_tree(params, p_sh)
    leaves = tx_lib.tree_leaves(sparams)
    for p in leaves:
        p.requires_grad_(True)
    with use_rules(rules):
        loss, _ = model.loss(gather_params(sparams, model_zoo.param_axes(cfg)),
                             sbatch)
        grads = steps.loss_grads(loss, leaves)
    out[f"{tag}_loss"] = _plain(loss)
    out[f"{tag}_grads_on_param_placements"] = np.array(all(
        tuple(g.placements) == tuple(p.placements)
        for g, p in zip(grads, leaves)))
    grads = steps.unshard_tree(tx_lib.tree_unflatten(sparams, grads))
    out.update(flat(params_to_numpy(grads, cfg), f"{tag}_grads"))
    # the whole step: its metrics come back whole on every rank
    opt = OptimizerConfig()
    state = steps.shard_train_state(
        {"params": params_from_numpy(unflat(inp, f"{src}_params"), cfg,
                                     CPU),
         "opt": tx_lib.build_optimizer(opt).init(params),
         "step": torch.zeros((), dtype=torch.int32)}, rules, cfg, opt)
    state, metrics = steps.make_train_step(model, opt, rules)(state, sbatch,
                                                              1e-3)
    for key in ("loss", "grad_norm", "var_max"):
        out[f"{tag}_step_{key}"] = _plain(metrics[key])
    out.update(flat(params_to_numpy(steps.unshard_tree(state["params"]),
                                    cfg), f"{tag}_step_params"))


def _flash_decode(inp, out):
    """(d) flash_decode_sharded on an (8,) sequence mesh."""
    from repro_torch.distributed.collectives import flash_decode_sharded
    from repro_torch.distributed.compat import Shard, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((8,), ("data",))
    q = torch.from_numpy(inp["d_q"])
    k, v = (distribute_tensor(torch.from_numpy(inp[n]), mesh, [Shard(1)])
            for n in ("d_k", "d_v"))
    for backend in ("reference", "kernel"):
        fn = flash_decode_sharded(mesh, "data", backend=backend)
        for pos in inp["d_pos"]:
            out[f"d_{backend}_{int(pos)}"] = fn(q, k, v, int(pos)).numpy()


def run8(rank, world, tmp):
    _init(rank, world, tmp, "8")
    try:
        from repro_torch.configs import get_arch, reduced
        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch.mesh import make_host_mesh

        inp = np.load(os.path.join(tmp, "in8.npz"))
        mesh = make_host_mesh((4, 2), ("data", "model"))
        cfg = reduced(get_arch("gpt2-117m"))
        out = {}
        _adamw_update(inp, ShardingRules.make(mesh, "fsdp"), cfg, out)
        for rule_set in ("fsdp", "baseline"):
            _model_step(inp, ShardingRules.make(mesh, rule_set), cfg, out,
                        f"b_{rule_set}")
        _flash_decode(inp, out)
        np.savez(os.path.join(tmp, f"out8_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# four ranks: the compressed all-reduce and migration onto a mesh
# ---------------------------------------------------------------------------

def _compressed(inp, rank, out):
    """(e) one error-feedback sync of this rank's gradients, and 40 syncs
    of a replicated gradient."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compression import (compressed_allreduce,
                                               init_error_state)

    mesh = make_host_mesh((4,), ("pod",))
    sync = compressed_allreduce(mesh, "pod")
    grads = {k: torch.from_numpy(v)
             for k, v in unflat(inp, f"e_grads{rank}").items()}
    # a transposed leaf, as autograd hands some gradients
    grads["b"] = grads["b"].t().contiguous().t()
    assert not grads["b"].is_contiguous()
    err = {k: torch.from_numpy(v)
           for k, v in unflat(inp, f"e_err{rank}").items()}
    mean, new_err = sync(grads, err)
    out.update(flat({k: v.numpy() for k, v in mean.items()}, "e_mean"))
    out.update(flat({k: v.numpy() for k, v in new_err.items()}, "e_newerr"))
    g = {"w": torch.tensor([0.5, -0.02, 0.3, -0.7])}
    err = init_error_state(g)
    acc = np.zeros(4)
    for _ in range(40):
        m, err = sync(g, err)
        acc += m["w"].numpy()
    out["e_running_mean"] = acc / 40


def _migrate(out):
    """(f) a slot's row migrated onto a mesh of the ranks."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.distributed.collectives import migrate_row
    from repro_torch.distributed.compat import is_dtensor
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo
    from repro_torch.serve.state import SlotDecodeState

    cfg = reduced(get_arch("gpt2-117m"))
    model = model_zoo.build_model(cfg, remat="none")
    params = model_zoo.init_params(cfg, torch.Generator().manual_seed(1), CPU)
    src, dst = SlotDecodeState(model), SlotDecodeState(model)
    src_cache = src.init_slots(2, 32, torch.float32, CPU)
    dst_cache = dst.init_slots(3, 32, torch.float32, CPU)
    tokens = torch.arange(5, 17)[None, :] % cfg.vocab_size
    _, row = model.prefill(params, {"tokens": tokens}, cache_len=32)
    src_cache = src.insert(src_cache, 1, row)
    want = {k: v.clone() for k, v in src.gather(src_cache, 1).items()}
    mesh = make_host_mesh((4,), ("data",))
    seen = {}
    insert = dst.insert

    def spy(cache, slot, r):
        seen.update({k: is_dtensor(v) for k, v in r.items()})
        return insert(cache, slot, r)

    dst.insert = spy
    placed = {}
    from repro_torch.distributed import collectives

    orig_place = collectives._place

    def place(r, placement):
        got = orig_place(r, placement)
        placed.update({k: str(tuple(v.placements)) for k, v in got.items()})
        return got

    collectives._place = place
    try:
        src_cache, dst_cache = migrate_row(
            src, src_cache, 1, dst, dst_cache, 2,
            placement=NamedSharding(mesh, ()))
    finally:
        collectives._place = orig_place
    got = dst.gather(dst_cache, 2)
    out["f_equal"] = np.array(all(torch.equal(got[k], want[k])
                                  for k in want))
    out["f_placed"] = np.array(sorted(f"{k}={v}" for k, v in placed.items()))
    out["f_plain_insert"] = np.array(not any(seen.values()))
    out["f_src_active"] = src_cache["active"].numpy()
    out["f_dst_active"] = dst_cache["active"].numpy()


def run4(rank, world, tmp):
    _init(rank, world, tmp, "4")
    try:
        inp = np.load(os.path.join(tmp, "in4.npz"))
        out = {}
        _compressed(inp, rank, out)
        _migrate(out)
        np.savez(os.path.join(tmp, f"out4_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# four ranks on a (2, 2) mesh: the model families' sharded steps, and
# gpt2's sharded prefill and serve steps
# ---------------------------------------------------------------------------

def _serve(inp, rules, out, tag):
    """One sharded prefill step, and two serve steps from a prefilled
    cache, of reduced gpt2."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo

    cfg = reduced(get_arch("gpt2-117m"))
    model = model_zoo.build_model(cfg, remat="none")
    params = params_from_numpy(unflat(inp, "s_params"), cfg, CPU)
    sparams = steps.shard_tree(
        params, steps.train_state_shardings(rules, cfg)["params"])
    batch = {"tokens": torch.from_numpy(inp["s_tokens"]).long()}
    logits, cache = steps.make_prefill_step(model, rules)(
        sparams, steps.shard_tree(batch, steps.batch_shardings(rules, cfg,
                                                               batch)))
    out[f"{tag}_prefill_logits"] = _plain(logits)
    for k in ("k", "v"):
        out[f"{tag}_prefill_{k}"] = _plain(cache[k])
        out[f"{tag}_prefill_{k}_sharded"] = np.array(any(
            not p.is_replicate() for p in cache[k].placements))
    b, n = inp["s_cache_k"].shape[1:3]
    cache = {k: torch.from_numpy(inp[f"s_cache_{k}"]) for k in ("k", "v")}
    cache["pos"] = torch.tensor(int(inp["s_cache_pos"]))
    cache = steps.shard_tree(cache, steps.cache_shardings(rules, model, b, n))
    serve = steps.make_serve_step(model, rules)
    for i, toks in enumerate(inp["s_next"]):
        tokens = torch.from_numpy(toks).long()
        tokens = steps.shard_tree({"tokens": tokens}, steps.batch_shardings(
            rules, cfg, {"tokens": tokens}))["tokens"]
        logits, cache = serve(sparams, cache, tokens)
        out[f"{tag}_decode_logits{i}"] = _plain(logits)
    for k in ("k", "v", "pos"):
        out[f"{tag}_decode_{k}"] = _plain(cache[k])


def run_models(rank, world, tmp):
    _init(rank, world, tmp, "models")
    try:
        from repro_torch.configs import get_arch, reduced
        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch.mesh import make_host_mesh

        inp = np.load(os.path.join(tmp, "in_models.npz"))
        mesh = make_host_mesh((2, 2), ("data", "model"))
        out = {}
        for arch in inp["m_archs"]:
            _model_step(inp, ShardingRules.make(mesh, "fsdp"),
                        reduced(get_arch(str(arch))), out, f"{arch}_fsdp",
                        src=str(arch))
        for arch in inp["m_dots_archs"]:  # selective checkpointing
            _model_step(inp, ShardingRules.make(mesh, "fsdp"),
                        reduced(get_arch(str(arch))), out, f"{arch}_dots",
                        src=str(arch), remat="dots")
        for rule_set in ("fsdp", "serve_tp"):
            _serve(inp, ShardingRules.make(mesh, rule_set), out,
                   f"s_{rule_set}")
        np.savez(os.path.join(tmp, f"out_models_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
