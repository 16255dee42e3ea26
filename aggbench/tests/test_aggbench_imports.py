"""A run imports no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``tpu_aggcomm`` (compared whole: ``tpu_aggcomm_torch`` is the
port), and opens no file of the JAX package or its ``bench.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from aggbench import harness
from aggbench.tests.conftest import REPO

SCRIPT = textwrap.dedent('''
    import json, sys
    opened = []
    sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                     if ev == "open" and args and isinstance(args[0], str)
                     else None)
    from aggbench import harness
    bench = harness.Bench()
    for cell in ("tiny.a2m_c3_torch_sim", "tiny.a2m_unthrottled_torch_shard",
                 "tiny.a2m_c3_cuda_fused"):
        s = harness.Session(bench, cell, "cpu")
        rec, checks, failed = s.measure(2**40 + 1, 0.1, True)
        assert harness.passed(checks), checks
    print(json.dumps({"top": sorted({m.split(".")[0] for m in sys.modules}),
                      "forbidden": harness.loaded_forbidden(),
                      "opened": opened}))
    ''')


def test_a_run_loads_no_jax_and_reads_no_jax_package(tiny_root):
    env = dict(os.environ, PYTHONPATH=f"{tiny_root}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tiny_root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.splitlines()[-1])
    assert "tpu_aggcomm_torch" in got["top"] and "torch" in got["top"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "tpu_aggcomm"}
    assert got["forbidden"] == []
    jax_pkg = str(REPO / "tpu_aggcomm") + os.sep
    assert not [p for p in got["opened"]
                if os.path.abspath(p).startswith(jax_pkg)
                or os.path.basename(p) == "bench.py"]


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("tpu_aggcomm_torch", "tpu_aggcomm_torch.core",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "tpu_aggcomm.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.loaded_forbidden() == ["jaxlib", "tpu_aggcomm"]


def test_the_sources_name_no_jax_module():
    for path in (REPO / "aggbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                top = words[1].split(".")[0]
                assert top not in harness.FORBIDDEN, (path, line)
