"""Live telemetry of the port (``tpu_aggcomm_torch/obs/export``, the
``/metrics`` endpoints of ``serve`` and ``sweep``) against the
reference's, on the CPU.

- The same sequence of ``counter``/``gauge``/``observe`` calls, the same
  ``LiveSlo`` records and the same trace events render byte-identical
  OpenMetrics text in both packages (the ``tpu_aggcomm_`` names are a
  wire contract, kept by the port).
- ``validate_openmetrics`` accepts and rejects what the reference's does.
- ``serve_from_env`` is off by default; the endpoint binds loopback and
  answers 404 off ``/metrics``.
- ``cli serve --metrics-port 0 --device cpu`` announces its URL; scraped
  after a burst, the text validates and its request counter and
  batch-fill gauge equal the server's ``stats()``.
- A ``cli sweep --device cpu --metrics-port 0`` subprocess is scraped
  mid-run; a sweep without the flag, and a server without a port, never
  import ``obs/export``.

No test reads a time.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

pytest.importorskip("jax")

from tpu_aggcomm.obs import export as ref_export  # noqa: E402
from tpu_aggcomm.obs import watch as ref_watch  # noqa: E402
from tpu_aggcomm.obs.regress import \
    validate_openmetrics as ref_validate  # noqa: E402

from tpu_aggcomm_torch.obs import export, watch  # noqa: E402
from tpu_aggcomm_torch.obs.regress import (parse_openmetrics,  # noqa: E402
                                           validate_openmetrics)
from tpu_aggcomm_torch.serve.protocol import ServeClient  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHAPE = {"method": 1, "nprocs": 8, "cb_nodes": 3, "comm_size": 2,
          "data_size": 64}


def _env(**over):
    env = dict(os.environ, PYTHONPATH=REPO, **over)
    env.pop(export.METRICS_PORT_ENV, None)
    return env


def _scrape(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith(
            "application/openmetrics-text")
        return resp.read().decode()


def _samples(text):
    return {(s["name"], tuple(sorted(s["labels"].items()))): s["value"]
            for s in parse_openmetrics(text)["samples"]}


def _calls(mod):
    """One fixed sequence of registry calls, rendered by ``mod``'s
    registry: labelled counters (one escaped), gauges, and histograms of
    walls from nanoseconds to seconds."""
    reg = mod.MetricsRegistry()
    reg.counter(f"{mod.PREFIX}_serve_requests", backend="torch_sim",
                outcome="ok")
    reg.counter(f"{mod.PREFIX}_serve_requests", 3.0, backend="torch_sim",
                outcome="ok")
    reg.counter(f"{mod.PREFIX}_serve_shed", reason='queue "full"\\n')
    reg.gauge(f"{mod.PREFIX}_serve_queue_depth", 5)
    reg.gauge(f"{mod.PREFIX}_serve_batch_fill_ratio", 0.75)
    reg.gauge(f"{mod.PREFIX}_serve_state",
              float(mod.SERVE_STATE_VALUES["degraded"]))
    for i, w in enumerate([3e-9, 1.25e-4, 0.5, 2.0, 7.5e-3, 0.1]):
        reg.observe(f"{mod.PREFIX}_serve_request_seconds", w,
                    backend="cuda_fused" if i % 2 else "torch_sim",
                    cache="hit")
        reg.observe(f"{mod.PREFIX}_sweep_cell_wall_seconds", w * 3)
    return reg.render()


def test_registry_calls_render_byte_identical_text():
    text = _calls(export)
    assert text == _calls(ref_export)
    assert validate_openmetrics(text) == [] and text.endswith("# EOF\n")
    assert export.PREFIX == ref_export.PREFIX == "tpu_aggcomm"
    assert export.SERVE_STATE_VALUES == ref_export.SERVE_STATE_VALUES
    assert export.METRICS_PORT_ENV == ref_export.METRICS_PORT_ENV

    # the live burn-rate gauges: the same records, the same text
    regs = []
    for mod, watch_mod in ((export, watch), (ref_export, ref_watch)):
        reg = mod.MetricsRegistry()
        live = watch_mod.LiveSlo(reg)
        for i in range(40):
            if i % 11 == 5:
                live.record(status="shed", shed_reason="deadline",
                            deadline_ms=50.0)
            else:
                live.record(status="done" if i % 13 else "fail",
                            wall_s=0.01 if i < 25 else 4.0,
                            cache="hit" if i % 3 else "miss",
                            deadline_ms=100.0 if i % 4 == 0 else None,
                            batch={"seq": i // 4, "n": 3, "padded": 4})
        regs.append(reg.render())
    assert regs[0] == regs[1]
    assert "tpu_aggcomm_slo_burn_rate" in regs[0]

    # trace-derived metrics from the same recorder events
    events = [{"ev": "run", "id": 0, "name": "m1", "backend": "torch_sim"}]
    for rnd in range(3):
        for rank in range(4):
            events.append({"ev": "span", "run": 0, "rep": 0, "rank": rank,
                           "round": rnd, "bucket": "sendrecv",
                           "dur_s": 1e-4 * (rnd + 1) * (rank + 1)})
    events += [{"ev": "hbm", "peak_bytes": 123456},
               {"ev": "counter", "name": "traffic_max_incast", "value": 7,
                "run": 0},
               {"ev": "instant", "name": "ledger.resilience",
                "args": {"site": "serve:dispatch", "kind": "attempt",
                         "outcome": "retry"}}]
    got = export.trace_registry(events).render()
    assert got == ref_export.trace_registry(events).render()
    assert "tpu_aggcomm_round_wall_seconds" in got


def test_validate_openmetrics_equals_the_reference():
    good = _calls(export)
    texts = [
        good,
        good.replace("# EOF\n", ""),
        "orphan_total 1\n# EOF\n",
        "!!!\n# EOF\n",
        ("# TYPE h histogram\n"
         'h_bucket{le="0.1"} 5\nh_bucket{le="0.2"} 3\n'
         'h_bucket{le="+Inf"} 5\nh_count 5\nh_sum 1.0\n# EOF\n'),
        ("# TYPE h histogram\n"
         'h_bucket{le="0.1"} 5\nh_count 6\n# EOF\n'),
        ("# TYPE s summary\n"
         's{quantile="1.5"} 1.0\n# EOF\n'),
        good + "after_eof 1\n",
    ]
    for i, text in enumerate(texts):
        got = validate_openmetrics(text)
        assert (got == []) == (i == 0), (i, got)
        assert got == ref_validate(text)


def test_endpoint_is_off_by_default_and_loopback_only():
    assert export.serve_from_env(lambda: "", env={}) is None
    assert export.serve_from_env(
        lambda: "", env={export.METRICS_PORT_ENV: ""}) is None
    assert export.serve_from_env(
        lambda: "", env={export.METRICS_PORT_ENV: "not-a-port"}) is None
    srv = export.serve_from_env(lambda: _calls(export),
                                env={export.METRICS_PORT_ENV: "0"})
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        assert validate_openmetrics(_scrape(srv.url)) == []
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url.replace("/metrics", "/other"),
                                   timeout=10)
    finally:
        srv.close()


def test_cli_serve_metrics_endpoint_after_a_burst(tmp_path):
    """``cli serve --metrics-port 0 --device cpu``: the ready line names
    the loopback URL; after a burst of verified requests the scraped
    text validates and its request counter and batch-fill gauge equal
    ``stats()``."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_aggcomm_torch.cli", "serve", "--device",
         "cpu", "--metrics-port", "0", "--journal",
         str(tmp_path / "s.journal.jsonl")],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        url = ready["metrics_url"]
        assert url.startswith("http://127.0.0.1:") and url.endswith(
            "/metrics")
        with ServeClient(ready["port"], timeout=120.0) as c:
            for i in range(6):
                r = c.run(**dict(_SHAPE, iter=i, verify=True))
                assert r["ok"] and r["verified"] is True
            st = c.stats()
            text = _scrape(url)
            assert c.shutdown()["stopping"] is True
        _out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "# telemetry: /metrics bound on ephemeral port" in err
    assert validate_openmetrics(text) == []
    s = _samples(text)
    ok = s[("tpu_aggcomm_serve_requests_total",
            (("backend", "torch_sim"), ("outcome", "ok")))]
    assert ok == st["completed"] == 6
    assert s[("tpu_aggcomm_serve_batch_fill_ratio", ())] == \
        st["batch"]["fill_ratio"]
    assert s[("tpu_aggcomm_serve_padding_waste_bytes", ())] == \
        st["batch"]["padding_waste_bytes"]
    assert s[("tpu_aggcomm_serve_state", ())] == 0.0
    assert ("tpu_aggcomm_slo_compliant", (("objective", "goodput"),)) in s


def test_sweep_endpoint_serves_openmetrics_midrun(tmp_path):
    """The reference's mid-run scrape on the port: the sweep announces
    its endpoint before its first cell and serves the sweep counters
    while it runs, then exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_aggcomm_torch.cli", "sweep", "-n", "16",
         "-a", "4", "-d", "512", "-m", "1", "-i", "5", "--device", "cpu",
         "--comm-sizes", "1,2,4,8", "--results-csv", "r.csv",
         "--metrics-port", "0"],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    url = None
    try:
        for line in proc.stderr:
            if line.startswith("# metrics endpoint:"):
                url = line.split(":", 1)[1].strip()
                break
        assert url and url.startswith("http://127.0.0.1:"), \
            "sweep never announced its metrics endpoint"
        body = _scrape(url)
        assert validate_openmetrics(body) == []
        names = {s["name"] for s in parse_openmetrics(body)["samples"]}
        assert "tpu_aggcomm_sweep_cells_total" in names
    finally:
        proc.stderr.close()
        rc = proc.wait(timeout=600)
    assert rc == 0


def test_unarmed_sweep_and_server_never_import_export(tmp_path):
    code = (
        "import sys\n"
        "from tpu_aggcomm_torch.cli import main\n"
        "rc = main(['sweep', '-n', '8', '-a', '2', '-d', '64', '-m', '1',\n"
        "           '--backend', 'local', '--comm-sizes', '2',\n"
        "           '--results-csv', 'r.csv'])\n"
        "assert rc == 0, rc\n"
        "from tpu_aggcomm_torch.serve.server import ScheduleServer\n"
        "srv = ScheduleServer(port=0, device='cpu')\n"
        "assert srv._slo is None and srv._registry is None\n"
        "assert 'metrics_url' not in srv.ready_info()\n"
        "srv.close()\n"
        "bad = [m for m in ('tpu_aggcomm_torch.obs.export',\n"
        "                   'tpu_aggcomm_torch.obs.watch') if m in sys.modules]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
