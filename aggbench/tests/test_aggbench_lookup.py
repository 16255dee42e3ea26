"""Everything a cell needs is found by name, and a new configuration,
traffic mix, metric or backend is a file of its own: adding one edits no
file that is there."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from aggbench.harness import Bench
from aggbench.tests.conftest import REPO, make_root


def test_every_cell_resolves():
    bench = Bench(REPO)
    spec = bench.spec
    for w in spec["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert (REPO / "aggbench" / "backends"
                / f"{cell.traffic['backend']}.py").is_file()
        assert cell.config["name"] == w["config"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.plugin("metrics", m["name"]).read)
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("aggbench/")


def test_a_split_metric_reads_its_quantity_unless_it_has_a_file(tmp_path):
    root = make_root(tmp_path)
    bench = Bench(root)
    assert bench.plugin("metrics", "exchange_us.theta") is bench.plugin(
        "metrics", "exchange_us")
    (root / "aggbench" / "metrics" / "idle_share.own.py").write_text(
        "def read(record):\n    return 1.5\n")
    assert bench.plugin("metrics", "idle_share.own").read(None) == 1.5
    with pytest.raises(LookupError):
        bench.plugin("metrics", "no_such_quantity.theta")
    with pytest.raises(LookupError):
        bench.plugin("backends", "torch_sim.theta")


def test_unknown_names_are_named_errors():
    bench = Bench(REPO)
    for call in (lambda: bench.cell("no_such_cell"),
                 lambda: bench.traffic("no_such_traffic"),
                 lambda: bench.plugin("metrics", "no_such_metric"),
                 lambda: bench.plugin("backends", "no_such_backend")):
        with pytest.raises(LookupError):
            call()


def _digests(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root / "aggbench"):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_adding_a_cell_metric_and_backend_edits_no_file(tmp_path):
    root = make_root(tmp_path)
    before = _digests(root)
    pkg = root / "aggbench"
    (pkg / "configs" / "tiny2.json").write_text(json.dumps(
        {"name": "tiny2", "nprocs": 6, "cb_nodes": 2, "data_size": 8,
         "proc_node": 1, "placement": 0, "reduced": []}))
    (pkg / "traffic" / "m2a_c1_echo.json").write_text(json.dumps(
        {"name": "m2a_c1_echo", "method": 2, "direction": "many_to_all",
         "comm_size": 1, "backend": "echo_sim",
         "loop": {"kind": "closed", "callers": 1},
         "send": {"fill": "uniform_bytes", "arenas": 3},
         "warmup_exchanges": 1, "sample_outputs": 2, "profile_skip": 1,
         "profile_exchanges": 3}))
    (pkg / "metrics" / "exchanges_seen.py").write_text(
        "def read(record):\n    return float(record.exchanges)\n")
    (pkg / "backends" / "echo_sim.py").write_text(textwrap.dedent('''
        from aggbench.backends.torch_sim import Adapter as Base

        class Adapter(Base):
            backend = "echo_sim"
        '''))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny2", "source": "tests",
                            "file": "aggbench/configs/tiny2.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny2.echo", "config": "tiny2",
                              "traffic": "m2a_c1_echo", "chips": 1,
                              "why": "tests"})
    spec["end_to_end"].append({"name": "exchanges_seen", "unit": "count",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny2.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    script = textwrap.dedent('''
        import json
        from aggbench import harness
        bench = harness.Bench()
        cell = bench.cell("tiny2.echo")
        s = harness.Session(bench, "tiny2.echo", "cpu")
        rec, checks, failed = s.measure(5, 0.2, False)
        print(json.dumps(harness.result(bench, cell, rec, checks, failed,
                                        False)))
        ''')
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s", "exchanges_seen"}
    assert out["metrics"]["exchanges_seen"]["value"] == out["attempted"]
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
