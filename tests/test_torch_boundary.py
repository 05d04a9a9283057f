"""The port's boundary: no JAX, no ``repro``, CUDA by default, no silent
fallback, and no ported-looking option that quietly does nothing.

* With ``jax`` blocked, every ``repro_torch`` module, ``chip_smoke`` and
  the port's examples (``examples/torch_*.py``) import, and none of them
  pulls in ``repro`` or a ``repro.*`` module.
* An option not wired into the port raises: ``grad_compression`` and an
  unknown remat policy; ``--remat dots`` trains.
* The entry points (the examples too) default to CUDA and raise where
  there is none.
* On CPU tensors the kernel wrappers (flash attention, flash decode,
  WKV-6, SSD) run their plain versions and count no launch; a DTensor
  never reaches one (a sharded step hands the kernels local tensors).
* ``chip_smoke.py`` fails, printing no result, without a card and in a
  directory that holds nothing else of the repo.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
for path in {examples!r}:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in ("repro_torch.core.telemetry", "repro_torch.optim.adam",
             "repro_torch.gns.estimator", "repro_torch.gns.precursor",
             "repro_torch.gns.regulator", "repro_torch.distributed.compat",
             "repro_torch.distributed.sharding",
             "repro_torch.distributed.collectives", "repro_torch.launch.mesh",
             "repro_torch.launch.dryrun", "repro_torch.optim.compression",
             "repro_torch.roofline.hw", "repro_torch.roofline.analysis",
             "repro_torch.roofline.op_cost"):
    assert name in names, name
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
assert "torch" in sys.modules
"""


def test_port_imports_without_jax_or_repro():
    assert [p.name for p in EXAMPLES] == [
        "torch_quickstart.py", "torch_stability_study.py",
        "torch_tuning_strategy.py"]
    code = _IMPORT_ALL.format(src=str(SRC), root=str(ROOT),
                              examples=[str(p) for p in EXAMPLES])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 25  # every module of the package was imported


_IMPORT_ZAMBA = r"""
import importlib, sys
sys.modules["jax"] = None
sys.path.insert(0, {src!r})
for name in ("repro_torch.configs.zamba2_2p7b", "repro_torch.kernels.ssd",
             "repro_torch.kernels.ssd.kernel", "repro_torch.kernels.ssd.ops",
             "repro_torch.models.mamba2", "repro_torch.models.zamba2"):
    importlib.import_module(name)
from repro_torch.configs import get_arch
from repro_torch.models import model_zoo
assert model_zoo.param_count(get_arch("zamba2-2.7b")) == 2422670240
assert not [k for k in sys.modules if k == "repro" or k.startswith("repro.")]
"""


def test_zamba_modules_import_without_jax():
    r = subprocess.run([sys.executable, "-c",
                        _IMPORT_ZAMBA.format(src=str(SRC))],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr


def test_no_jax_or_repro_import_in_sources():
    files = (list((SRC / "repro_torch").rglob("*.py"))
             + [ROOT / "chip_smoke.py"] + EXAMPLES)
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "jaxlib", "repro"), f"{f}: {line}"


def _small_train_config():
    from repro_torch.configs import TrainConfig, get_arch, reduced
    return TrainConfig(model=reduced(get_arch("gpt2-117m")), seq_len=16,
                       global_batch=2)


@pytest.mark.parametrize("entry", ["serve_engine", "from_arch", "train",
                                   "Trainer"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    from repro_torch.launch.serve import serve_engine
    from repro_torch.launch.train import Trainer, train
    from repro_torch.serve import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "serve_engine":
            serve_engine("gpt2-117m", True, n_slots=1, prompt_len=8,
                         gen_tokens=2, quiet=True)
        elif entry == "from_arch":
            InferenceEngine.from_arch("gpt2-117m")
        elif entry == "train":
            train(_small_train_config(), max_steps=1)
        else:
            Trainer(_small_train_config())


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_defaults_to_cuda(monkeypatch, cli):
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if cli == "serve":
            serve.main(["--reduced", "--batch", "1", "--prompt-len", "8",
                        "--gen", "2"])
        else:
            train.main(["--reduced", "--steps", "1", "--batch", "2",
                        "--seq", "16"])


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_rwkv_clis_default_to_cuda(monkeypatch, cli):
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if cli == "serve":
            serve.main(["--arch", "rwkv6-7b", "--reduced", "--batch", "1",
                        "--prompt-len", "8", "--gen", "2"])
        else:
            train.main(["--arch", "rwkv6-7b", "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "16"])


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_zamba_clis_default_to_cuda(monkeypatch, cli):
    from repro_torch.launch import serve, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if cli == "serve":
            serve.main(["--arch", "zamba2-2.7b", "--reduced", "--batch", "1",
                        "--prompt-len", "8", "--gen", "2"])
        else:
            train.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "1",
                        "--batch", "2", "--seq", "16"])


def _example(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_examples_default_to_cuda(monkeypatch, path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(path).main([])


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_stability_study"])
def test_examples_run_on_the_cpu_when_asked(capsys, name):
    _example(ROOT / "examples" / f"{name}.py").main(
        ["--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out
    assert ("stability:" in out if name == "torch_quickstart"
            else "aggressive + throttle" in out)


def test_train_cli_refuses_what_is_not_ported(capsys):
    """``--remat dots`` trains a reduced model on the CPU; a policy the
    reference does not have is refused."""
    from repro_torch.launch import train
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--eval-interval", "0", "--remat"]
    assert train.main(argv + ["dots"]) == 0
    assert "done: steps=3" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train.main(argv + ["offload"])


def test_train_step_refuses_grad_compression():
    """The reference's ``grad_compression`` fields ride in the config, but
    no train step syncs through the compressed all-reduce: setting one
    raises rather than run the exact sync under its name."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    model = model_zoo.build_model(reduced(get_arch("gpt2-117m")))
    steps.make_train_step(model, OptimizerConfig())
    with pytest.raises(NotImplementedError, match="grad_compression"):
        steps.make_train_step(model, OptimizerConfig(grad_compression=True))


def test_train_cli_recovers_from_an_injected_fault(capsys):
    from repro_torch.launch import train
    assert train.main(["--reduced", "--device", "cpu", "--steps", "8",
                       "--batch", "2", "--seq", "16", "--recover",
                       "--max-rollbacks", "2", "--inject-faults",
                       "nan_grad@4", "--inject-seed", "3"]) == 0
    out = capsys.readouterr().out
    assert "done: steps=8" in out and "diverged=False" in out
    assert ("recovery: rollbacks=1 events=['nan_loss@4(loss=nan)', "
            "'restored@0'] faults=['nan_grad@4']") in out


def test_train_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import train
    assert train.main(["--reduced", "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--slw",
                       "--duration", "2", "--eval-interval", "3"]) == 0
    assert "done: steps=3" in capsys.readouterr().out


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from repro_torch.kernels.flash_decode import (flash_decode_fwd,
                                                  flash_decode_fwd_plain)
    before = (flash_attention_fwd.launches, flash_decode_fwd.launches)
    g = torch.Generator().manual_seed(0)
    # head dim 16 and float64: shapes and types the CUDA kernels refuse
    q, k, v = (torch.randn(2, 9, 16, generator=g, dtype=torch.float64)
               for _ in range(3))
    for a, b in zip(flash_attention_fwd(q, k, v),
                    flash_attention_fwd_plain(q, k, v)):
        assert torch.equal(a, b)
    qd = torch.randn(2, 3, 1, 16, generator=g)
    kc = torch.randn(2, 7, 3, 16, generator=g)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    for a, b in zip(flash_decode_fwd(qd, kc, kc, lengths),
                    flash_decode_fwd_plain(qd, kc, kc, lengths)):
        assert torch.equal(a, b)
    assert (flash_attention_fwd.launches, flash_decode_fwd.launches) == before


def test_cpu_tensors_through_the_backward_count_no_launch():
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_plain,
        flash_attention_bwd_preprocess, flash_attention_fwd)
    kernels = (flash_attention_fwd, flash_attention_bwd_preprocess,
               flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [f.launches for f in kernels]
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 9, 16, generator=g, dtype=torch.float64)
                   for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v)
    for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do),
                    flash_attention_bwd_plain(q, k, v, o, lse, do)):
        assert torch.equal(a, b)
    x = torch.randn(1, 5, 2, 16, generator=g, requires_grad=True)
    flash_attention(x, x, x).sum().backward()
    assert x.grad is not None
    assert [f.launches for f in kernels] == before


def test_cpu_tensors_through_wkv6_count_no_launch():
    from repro_torch.kernels.rwkv6 import (wkv6, wkv6_bwd, wkv6_bwd_plain,
                                           wkv6_fwd, wkv6_fwd_plain)
    before = (wkv6_fwd.launches, wkv6_bwd.launches)
    g = torch.Generator().manual_seed(2)
    # head dim 16 and float64: shapes and types the CUDA kernels refuse
    r, k, v, dy = (torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
                   for _ in range(4))
    lw = -torch.rand(1, 2, 12, 16, generator=g, dtype=torch.float64)
    u = torch.randn(2, 16, generator=g, dtype=torch.float64)
    got = wkv6_fwd(r, k, v, lw, u, chunk=4, return_carries=True)
    for a, b in zip(got, wkv6_fwd_plain(r, k, v, lw, u, chunk=4,
                                        return_carries=True)):
        assert torch.equal(a, b)
    ds = torch.randn(1, 2, 16, 16, generator=g)
    for a, b in zip(wkv6_bwd(r, k, v, lw, u, got[2], dy, ds, chunk=4),
                    wkv6_bwd_plain(r, k, v, lw, u, got[2], dy, ds, chunk=4)):
        assert torch.equal(a, b)
    x = r.clone().requires_grad_()
    y, state = wkv6(x, k, v, lw, u, chunk=5)  # ragged: padded to 15
    (y.sum() + state.sum()).backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert (wkv6_fwd.launches, wkv6_bwd.launches) == before


def test_cpu_tensors_through_ssd_count_no_launch():
    from repro_torch.kernels.ssd import (ssd, ssd_bwd, ssd_bwd_plain,
                                         ssd_fwd, ssd_fwd_plain)
    before = (ssd_fwd.launches, ssd_bwd.launches)
    g = torch.Generator().manual_seed(3)
    # head dim 16, state 8 and float64: shapes and types the kernels refuse
    x, dy = (torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
             for _ in range(2))
    dt = torch.rand(1, 2, 12, generator=g, dtype=torch.float64)
    a = -torch.rand(2, generator=g, dtype=torch.float64)
    b_in, c_in = (torch.randn(1, 12, 8, generator=g, dtype=torch.float64)
                  for _ in range(2))
    got = ssd_fwd(x, dt, a, b_in, c_in, chunk=4, return_carries=True)
    for p, q in zip(got, ssd_fwd_plain(x, dt, a, b_in, c_in, chunk=4,
                                       return_carries=True)):
        assert torch.equal(p, q)
    ds = torch.randn(1, 2, 8, 16, generator=g)
    for p, q in zip(ssd_bwd(x, dt, a, b_in, c_in, got[2], dy, ds, chunk=4),
                    ssd_bwd_plain(x, dt, a, b_in, c_in, got[2], dy, ds,
                                  chunk=4)):
        assert torch.equal(p, q)
    xg = x.clone().requires_grad_()
    y, state = ssd(xg, dt, a, b_in, c_in, chunk=5)  # ragged: padded to 15
    (y.sum() + state.sum()).backward()
    assert xg.grad is not None and xg.grad.shape == x.shape
    assert (ssd_fwd.launches, ssd_bwd.launches) == before


def test_other_devices_are_refused():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    meta = torch.empty(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention_fwd(meta, meta, meta)


def _run_chip_smoke(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _no_result(r):
    return r.returncode != 0 and '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert _no_result(_run_chip_smoke(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert _no_result(_run_chip_smoke(tmp_path))


def test_kernel_wrappers_refuse_dtensors(tmp_path):
    """A DTensor reaching a kernel wrapper raises, on any device: the
    sharded step calls kernels through ``sharding.local_call``."""
    import torch.distributed as dist
    from repro_torch.distributed.compat import (Replicate, distribute_tensor,
                                                init_device_mesh)
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode_fwd
    before = flash_attention_fwd.launches
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        q = distribute_tensor(torch.randn(2, 8, 16), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention_fwd(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            flash_decode_fwd(q.reshape(2, 1, 8, 16)[:, :, :1], q, q,
                             torch.ones(2, dtype=torch.int32))
        assert flash_attention_fwd.launches == before
    finally:
        dist.destroy_process_group()
