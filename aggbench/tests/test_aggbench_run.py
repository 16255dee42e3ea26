"""The command's refusals: no result without the CUDA devices a cell
asks for, and none in a directory holding only the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from aggbench.tests.conftest import REPO


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run(REPO, "-m", "aggbench.run", "--workload", "readme_a2m_fused",
                "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0")
    assert proc.returncode == 2
    assert "needs 1 CUDA device" in proc.stderr
    _no_result(proc)


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(REPO / "aggbench", tmp_path / "aggbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(tmp_path, "-m", "aggbench.run", "--workload",
                "readme_a2m_fused", "--seed", "1", "--seconds", "1",
                "--trace", "0", env=env)
    assert proc.returncode != 0
    _no_result(proc)
    script = ("from aggbench import harness\n"
              "harness.Session(harness.Bench(), 'readme_a2m_fused', 'cpu')\n")
    proc = _run(tmp_path, "-c", script, env=env)
    assert proc.returncode != 0 and "tpu_aggcomm_torch" in proc.stderr
    _no_result(proc)
