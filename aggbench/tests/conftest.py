"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary root whose ``BENCHMARK.json`` holds small cells of the same
traffic mixes, so a whole run fits the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
TINY = {"name": "tiny", "source": "a small cell for the CPU tests",
        "nprocs": 8, "cb_nodes": 3, "data_size": 64, "proc_node": 1,
        "placement": 1, "reduced": []}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


def make_root(tmp: Path, config: dict = TINY) -> Path:
    """A root holding a copy of ``aggbench/`` and a ``BENCHMARK.json`` with
    the repository's entries plus a cell of ``config`` for each traffic
    mix under ``aggbench/traffic/``, named ``<config>.<traffic>``."""
    shutil.copytree(REPO / "aggbench", tmp / "aggbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "aggbench" / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    spec["configs"].append({"name": config["name"], "source": "tests",
                            "file": f"aggbench/configs/{config['name']}.json",
                            "reduced": [], "why": "tests"})
    for traffic in sorted(p.stem for p in
                          (REPO / "aggbench" / "traffic").glob("*.json")):
        spec["workloads"].append({"name": f"{config['name']}.{traffic}",
                                  "config": config["name"],
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
