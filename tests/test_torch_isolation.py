"""The port stands alone: no module of ``tpu_aggcomm_torch``, and not
``chip_smoke.py``, imports ``jax`` or the reference package.

Each check runs in a subprocess whose ``jax`` AND ``tpu_aggcomm`` are
poisoned packages that raise on import (the manner of
``tests/_jaxfree.py``), started outside the repository so the real
reference package is not on the path ahead of the poison. The card is
hidden (``CUDA_VISIBLE_DEVICES=""``), so the entry points' refusals
without a card are checked the same way on every host.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_aggcomm_torch")


def _port_modules():
    mods = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


@pytest.fixture
def poisoned(tmp_path):
    """(env, cwd) for a subprocess in which importing jax or tpu_aggcomm
    raises, the repository root is importable, and no card is visible."""
    for name in ("jax", "tpu_aggcomm"):
        pkg = tmp_path / "poison" / name
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(
            f"raise ImportError('poisoned {name}: the port must not "
            f"import it')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path / "poison"), REPO])
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("JAX_PLATFORMS", None)
    work = tmp_path / "work"
    work.mkdir()
    return env, str(work)


def _run(args, env, cwd, timeout=240):
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_and_runs_m1_on_cpu(poisoned):
    env, cwd = poisoned
    mods = _port_modules()
    assert "tpu_aggcomm_torch.backends.cuda_fused" in mods
    assert "tpu_aggcomm_torch.backends.cuda_dma" in mods
    for m in ("tune.space", "tune.race", "tune.cache", "tune.measure",
              "synth.primitives", "synth.search", "synth.register",
              "synth.artifact", "analysis.check", "obs.regress",
              "model.artifact", "pilot", "pilot.plan", "pilot.promote",
              "pilot.campaign", "pilot.artifact", "obs.export",
              "obs.watch", "obs.slo"):
        assert f"tpu_aggcomm_torch.{m}" in mods
    code = f"""
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
sys.path.insert(0, {REPO!r})
import chip_smoke
bad = [m for m in sys.modules
       if m == 'jax' or m.startswith('jax.') or m == 'tpu_aggcomm'
       or m.startswith('tpu_aggcomm.')]
assert not bad, bad

from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
from tpu_aggcomm_torch.backends.cuda_fused import (CudaFusedBackend,
                                                   FusedBackendError)
from tpu_aggcomm_torch.backends.cuda_dma import CudaDmaBackend
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.device import NoCudaDeviceError

s = compile_method(1, AggregatorPattern(8, 3, data_size=256, comm_size=2))
for backend in (TorchSimBackend("cpu"), CudaFusedBackend("cpu"),
                CudaDmaBackend("cpu"), CudaDmaBackend("cpu", True)):
    recv, timers = backend.run(s, verify=True)
    assert sum(r is not None for r in recv) == 3
for ctor, err in ((TorchSimBackend, NoCudaDeviceError),
                  (CudaFusedBackend, FusedBackendError),
                  (CudaDmaBackend, NoCudaDeviceError)):
    try:
        ctor()
    except err as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError(f"{{ctor.__name__}}() ran without a card")
print("ISOLATED-OK", len({mods!r}))
"""
    r = _run(["-c", code], env, cwd)
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"ISOLATED-OK {len(mods)}" in r.stdout


def test_bench_refuses_without_a_card(poisoned):
    env, cwd = poisoned
    r = _run(["-m", "tpu_aggcomm_torch.bench"], env, cwd)
    assert r.returncode != 0
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["metric"].startswith("all_to_many max total time per rep")
    assert rec["error"].startswith("NoCudaDeviceError: ")
    assert "value" not in rec or rec["value"] is None


def test_cli_refuses_without_a_card_and_runs_on_request(poisoned):
    env, cwd = poisoned
    base = ["-m", "tpu_aggcomm_torch.cli", "-m", "1", "-a", "14", "-d",
            "2048", "-c", "3", "--backend", "torch_sim"]
    r = _run(base, env, cwd)
    assert r.returncode != 0
    assert "NoCudaDeviceError: " in r.stderr
    assert "max total time" not in r.stdout
    r = _run(["-m", "tpu_aggcomm_torch.cli", "-n", "8", "-m", "1", "-a",
              "3", "-d", "64", "-c", "2", "--device", "cpu", "--verify"],
             env, cwd)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "| All to many max total time = " in r.stdout


def test_chip_smoke_fails_without_a_card_and_outside_the_repo(poisoned,
                                                               tmp_path):
    env, cwd = poisoned
    r = _run([os.path.join(REPO, "chip_smoke.py")], env, cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in a directory, with a card pretended: it must still fail,
    # since nothing of the port is there to drive
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = dict(env, PYTHONPATH=str(tmp_path / "poison"))
    code = ("import runpy, torch; torch.cuda.is_available = lambda: True; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    r = _run(["-c", code], env, str(alone))
    assert r.returncode != 0
    assert "No module named 'tpu_aggcomm_torch'" in r.stderr
    assert '"ok"' not in r.stdout
