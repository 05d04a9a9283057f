"""The port's boundary: no JAX, no ``repro``, CUDA by default, no silent
fallback.

* With ``jax`` blocked, every ``repro_torch`` module and ``chip_smoke``
  import, and none of them pulls in ``repro`` or a ``repro.*`` module.
* The entry points default to CUDA and raise where there is none.
* On CPU tensors the kernel wrappers run their plain versions and count
  no launch.
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
leaked = sorted(k for k in sys.modules if k == "repro" or k.startswith("repro."))
print(len(names), leaked)
assert not leaked, leaked
assert "torch" in sys.modules
"""


def test_port_imports_without_jax_or_repro():
    code = _IMPORT_ALL.format(src=str(SRC), root=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 25  # every module of the package was imported


def test_no_jax_or_repro_import_in_sources():
    files = list((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "jaxlib", "repro"), f"{f}: {line}"


@pytest.mark.parametrize("entry", ["serve_engine", "from_arch"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    from repro_torch.launch.serve import serve_engine
    from repro_torch.serve import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "serve_engine":
            serve_engine("gpt2-117m", True, n_slots=1, prompt_len=8,
                         gen_tokens=2, quiet=True)
        else:
            InferenceEngine.from_arch("gpt2-117m")


def test_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--reduced", "--batch", "1", "--prompt-len", "8",
                  "--gen", "2"])


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
