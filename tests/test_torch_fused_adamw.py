"""The fused AdamW kernel (``kernels/fused_adamw``, ``csrc/fused_adamw.cu``)
against its plain version, the default AdamW chain, on the card.

Leaves: gpt2-1.5b's 580 parameter shapes, and ragged ones (one element,
lengths not a multiple of 4, a chunk's 16,384 and one past it, a leaf that
starts 4 bytes past a 16-byte boundary, per-layer lists).  Variations: the
clip on and off, decay mask ``all`` and ``std``, with a runtime
``leaf_lr_scale`` and without.  Two steps from a state at count 7 (m
random, v at least m^2, so each step is at most ~0.2 of the LR), each
through ``optimizer_step`` (the fused route) and through the chain's
``update`` and ``apply_updates`` on a twin.  Tolerances, fixed before the
first run:

* ``count``: exact.
* m and v: 2e-6 of the entry plus 2e-6 of the leaf's largest entry.  The
  clip scale comes from the chain's fp32 norm of each leaf and the
  kernel's double sum of squares, ~1e-6 apart relative at 1.5 B
  elements; the rest is the chain's separate roundings against fused
  multiply-adds (~6e-8); the absolute part covers m cancelling to ~0.
* params: 2 float32 ulps of the entry (the update's last subtraction)
  plus 1e-5 of the largest LR factor (|u| <= ~0.2 with the same relative
  error as m and v).
* the five telemetry scalars: 1e-5 relative (sums of up to 1.6 B terms,
  the chain's in fp32, the kernel's in double).

From the chain's initial state (count 0, m = v = 0, bias corrections 0.1
and 0.001 at the first step) three steps whose gradients, on the first
half of each leaf, have magnitudes log-uniform in [1e-10, 1e-6] (below
and around eps = 1e-8 after the clip), at the same tolerances: where
|g| ~ eps the step is g / (|g| + eps), so a fault in the bias correction
or in where eps enters moves those entries by a good part of the LR.
The test prints the worst readings (``-s``).

Also: two kernel runs from one state give the same bits, the fused route
allocates nothing the size of the parameters (the chain makes two such
temporaries), and the launch count rises by one a step.  Card tests run
on the card (``-m gpu``); here they skip.
"""
import pytest
import torch

from repro_torch.configs import OptimizerConfig, get_arch
from repro_torch.core.telemetry import leaf_groups
from repro_torch.kernels.fused_adamw import TELEMETRY, fused_adamw
from repro_torch.models import model_zoo
from repro_torch.optim import transforms as ttx

LR = 1e-3
START_COUNT = 7


@pytest.fixture
def cuda():
    """The CUDA device; skips where there is none (decided at run time, so
    every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _ragged(dev):
    tree = {name: torch.empty(shape, device=dev) for name, shape in {
        "a": (1,), "b": (3,), "c": (5, 7), "d": (16383,), "e": (128, 128),
        "f": (16385,), "g": (2, 20001), "h": (4097, 9)}.items()}
    tree["odd"] = torch.empty(1 + 37 * 27, device=dev)[1:].view(37, 27)
    tree["layers"] = [{"w": torch.empty(6, 10, device=dev),
                       "bias": torch.empty(10, device=dev)}
                      for _ in range(3)]
    return tree


def _gpt2(dev):
    shapes = model_zoo.abstract_params(get_arch("gpt2-1.5b"))
    return ttx.tree_map(lambda m: torch.empty(m.shape, device=dev), shapes)


SHAPES = {"ragged": _ragged, "gpt2-1.5b": _gpt2}


def _state(tx, make, dev, seed):
    """Params, their chain state at ``START_COUNT`` and a gradient maker,
    all drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = make(dev)
    for p in ttx.tree_leaves(params):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
    state = tx.init(params)
    for m, v in zip(ttx.tree_leaves(state["adam"]["m"]),
                    ttx.tree_leaves(state["adam"]["v"])):
        m.copy_(torch.randn(m.shape, generator=gen, device=dev) * 1e-3)
        v.copy_(m * m * (1 + 3 * torch.rand(m.shape, generator=gen,
                                            device=dev)) + 1e-12)
    state["adam"]["count"].fill_(START_COUNT)

    def grads(step):
        g = torch.Generator(device=dev).manual_seed(seed * 100 + step)
        return ttx.tree_map(lambda p: torch.randn(
            p.shape, generator=g, device=dev) * 1e-2, params)
    return params, state, grads


def _hyper(params, step, leaf_lr, dev):
    hyper = {"lr": LR * (1 + step), "clip_scale": 1.0}
    if leaf_lr:
        n = len(leaf_groups(params).labels)
        hyper["leaf_lr_scale"] = torch.linspace(0.25, 1.5, n, device=dev)
    return hyper


def _close(got, ref, rtol, atol_of_max, what):
    for i, (a, b) in enumerate(zip(ttx.tree_leaves(got),
                                   ttx.tree_leaves(ref))):
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol_of_max * float(b.abs().max()),
            msg=lambda m: f"{what} leaf {i}: {m}")


def _fused_steps(tx, params, state, grads, leaf_lr, dev, steps=2):
    tel = None
    for step in range(steps):
        g = grads(step)
        launches = fused_adamw.launches
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, state, tel = ttx.optimizer_step(
            tx, g, state, params, _hyper(params, step, leaf_lr, dev))
        torch.cuda.synchronize()
        assert fused_adamw.launches == launches + 1
        extra = torch.cuda.max_memory_allocated() - base
        assert extra < 2 ** 26, f"the fused step allocated {extra} bytes"
        del g
    return state, tel


@pytest.mark.gpu
@pytest.mark.parametrize("leaf_lr", [False, True], ids=["lr", "leaf_lr"])
@pytest.mark.parametrize("mask", ["all", "std"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("shapes", sorted(SHAPES))
def test_fused_adamw_matches_the_chain(cuda, shapes, clip, mask, leaf_lr):
    tx = ttx.build_optimizer(OptimizerConfig(grad_clip=clip,
                                             decay_mask=mask))
    seed = 1 + 2 * (clip > 0) + 4 * (mask == "std") + 8 * leaf_lr
    params, state, grads = _state(tx, SHAPES[shapes], cuda, seed)
    state, tel = _fused_steps(tx, params, state, grads, leaf_lr, cuda)
    twin, twin_state, _ = _state(tx, SHAPES[shapes], cuda, seed)
    for step in range(2):
        with torch.no_grad():
            u, twin_state, twin_tel = tx.update(
                grads(step), twin_state, twin,
                _hyper(twin, step, leaf_lr, cuda))
            ttx.apply_updates(twin, u)
        del u
    assert int(state["adam"]["count"]) == int(
        twin_state["adam"]["count"]) == START_COUNT + 2
    for key in ("m", "v"):
        _close(state["adam"][key], twin_state["adam"][key], 2e-6, 2e-6, key)
    top = LR * 2 * (1.5 if leaf_lr else 1.0)
    for i, (a, b) in enumerate(zip(ttx.tree_leaves(params),
                                   ttx.tree_leaves(twin))):
        torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-5 * top,
                                   msg=lambda m: f"params leaf {i}: {m}")
    assert list(tel) == list(twin_tel) == list(TELEMETRY)
    for key in TELEMETRY:
        torch.testing.assert_close(tel[key], twin_tel[key], rtol=1e-5,
                                   atol=0.0, msg=key)


def _near_eps_grads(like, seed, dev):
    """A gradient maker for leaves shaped like ``like``: N(0, 1e-2), but
    the first half of each leaf (at least one entry) log-uniform in
    [1e-10, 1e-6] with random signs."""
    def grads(step):
        gen = torch.Generator(device=dev).manual_seed(seed * 100 + step)

        def one(p):
            g = torch.randn(p.shape, generator=gen, device=dev) * 1e-2
            k = (g.numel() + 1) // 2
            sign = torch.randint(0, 2, (k,), generator=gen, device=dev) * 2 - 1
            g.view(-1)[:k] = sign * 10.0 ** (-10 + 4 * torch.rand(
                k, generator=gen, device=dev))
            return g
        return ttx.tree_map(one, like)
    return grads


def _worst(got, ref):
    """max over leaves of max |got - ref| / max |ref|."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(ttx.tree_leaves(got), ttx.tree_leaves(ref)))


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "no_clip"])
@pytest.mark.parametrize("shapes", sorted(SHAPES))
def test_fused_adamw_from_init_near_eps(cuda, shapes, clip):
    """Three steps from ``tx.init`` with gradients near eps, kernel against
    the chain (see the module's docstring)."""
    tx = ttx.build_optimizer(OptimizerConfig(grad_clip=clip))
    seed = 31 + (clip > 0)
    runs = []
    for fused in (True, False):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        params = SHAPES[shapes](cuda)
        for p in ttx.tree_leaves(params):
            p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * 0.02)
        grads = _near_eps_grads(params, seed, cuda)
        state, tel = tx.init(params), None
        for step in range(3):
            hyper = _hyper(params, step, False, cuda)
            if fused:
                launches = fused_adamw.launches
                _, state, tel = ttx.optimizer_step(tx, grads(step), state,
                                                   params, hyper)
                assert fused_adamw.launches == launches + 1
            else:
                with torch.no_grad():
                    u, state, tel = tx.update(grads(step), state, params,
                                              hyper)
                    ttx.apply_updates(params, u)
                del u
        runs.append((params, state, tel))
    (params, state, tel), (twin, twin_state, twin_tel) = runs
    assert int(state["adam"]["count"]) == int(twin_state["adam"]["count"]) == 3
    for key in ("m", "v"):
        _close(state["adam"][key], twin_state["adam"][key], 2e-6, 2e-6, key)
    top = LR * 3
    for i, (a, b) in enumerate(zip(ttx.tree_leaves(params),
                                   ttx.tree_leaves(twin))):
        torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-5 * top,
                                   msg=lambda m: f"params leaf {i}: {m}")
    for key in TELEMETRY:
        torch.testing.assert_close(tel[key], twin_tel[key], rtol=1e-5,
                                   atol=0.0, msg=key)
    dp = max(float((a - b).abs().max()) for a, b in zip(
        ttx.tree_leaves(params), ttx.tree_leaves(twin))) / top
    rel = {k: float((tel[k] - twin_tel[k]).abs() / twin_tel[k].abs())
           for k in TELEMETRY}
    print(f"\nnear_eps {shapes} clip={clip}: params {dp:.3e} of the LR, "
          f"m {_worst(state['adam']['m'], twin_state['adam']['m']):.3e}, "
          f"v {_worst(state['adam']['v'], twin_state['adam']['v']):.3e} of "
          f"a leaf's largest entry; telemetry {rel}")


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", sorted(SHAPES))
def test_fused_adamw_reruns_bit_for_bit(cuda, shapes):
    """Two runs of two steps from one state: the same params, moments,
    count and telemetry, bit for bit (no float atomics)."""
    tx = ttx.build_optimizer(OptimizerConfig(decay_mask="std"))
    runs = []
    for _ in range(2):
        params, state, grads = _state(tx, SHAPES[shapes], cuda, 21)
        state, tel = _fused_steps(tx, params, state, grads, True, cuda)
        runs.append((params, state, tel))
        del params, state
    (p1, s1, t1), (p2, s2, t2) = runs
    for a, b in zip(ttx.tree_leaves((p1, s1, t1)),
                    ttx.tree_leaves((p2, s2, t2))):
        assert torch.equal(a, b)
