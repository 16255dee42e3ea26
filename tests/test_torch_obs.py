"""The port's flight recorder, run ledger and profiler cross-check.

The copied ``obs`` modules must equal the reference's on the same
inputs: ``to_chrome_trace``, ``round_stats`` and ``critical_path`` on
one event list holding every method at n=8 a=3, ``round_traffic`` and
``audit_schedule`` on every method's schedule, and the ledger's loaders
and renderers. The wiring is held as the reference's tests hold theirs
(``tests/test_obs.py:127`` and ``:246``): ``--trace`` on ``run`` (local
and torch_sim, on the CPU) and ``sweep`` writes the pair, and the events
re-aggregate to the timer columns float-exactly; the chain harness
records its warm-up, trials and samples and every graph capture; the
runner records schedule builds, repairs and first dispatches; ``--xprof``
on the CPU reports the labelled host wall, and a Chrome trace with device
events gives the device span. Sizes are n=8 a=3.
"""

import io
import json
import os

import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.obs import ledger as ref_ledger  # noqa: E402
from tpu_aggcomm.obs import metrics as ref_metrics  # noqa: E402
from tpu_aggcomm.obs import perfetto as ref_perfetto  # noqa: E402
from tpu_aggcomm.obs import traffic as ref_traffic  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import NotPortedError  # noqa: E402
from tpu_aggcomm_torch.core.methods import METHODS, compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness import chained  # noqa: E402
from tpu_aggcomm_torch.harness.report import PHASE_SOURCES  # noqa: E402
from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,  # noqa: E402
                                              run_experiment)
from tpu_aggcomm_torch.obs import (ledger, metrics, perfetto, trace,  # noqa: E402
                                   traffic)
from tpu_aggcomm_torch.obs.trace import aggregate_run, load_events  # noqa: E402

TIMER_COLS = ("post", "send_wait", "recv_wait", "barrier", "total")


def _cols(t):
    return {"post": t.post_request_time, "send_wait": t.send_wait_all_time,
            "recv_wait": t.recv_wait_all_time, "barrier": t.barrier_time,
            "total": t.total_time}


def _traced(prefix, **kw):
    """(records, (jsonl, json)) of one traced run on the CPU."""
    cfg = dict(nprocs=8, cb_nodes=3, data_size=64, comm_size=2, method=1,
               ntimes=3, backend="torch_sim", device="cpu", verify=True,
               results_csv=None)
    cfg.update(kw)
    trace.enable()
    try:
        recs = run_experiment(ExperimentConfig(**cfg), out=io.StringIO())
    finally:
        paths = trace.flush(prefix)
        trace.disable()
    return recs, paths


@pytest.fixture(scope="module")
def every_method(tmp_path_factory):
    """One event list holding every dispatched method at n=8 a=3 c=2 on
    torch_sim (-m 0, the CPU), and the records of that run."""
    prefix = str(tmp_path_factory.mktemp("all") / "all")
    recs, paths = _traced(prefix, method=0, ntimes=2)
    return recs, load_events(paths[0])


# ---------------------------------------------------------------------------
# the copied modules against the reference's, on the same inputs

def test_exporters_match_the_reference_on_the_same_events(every_method):
    recs, events = every_method
    runs = [e["id"] for e in events if e["ev"] == "run"]
    assert len(runs) == len(recs) == 20
    # json round trip: tuples become lists in both, as in a file
    got = json.loads(json.dumps(perfetto.to_chrome_trace(events)))
    want = json.loads(json.dumps(ref_perfetto.to_chrome_trace(events)))
    assert got == want
    for rid in runs:
        assert metrics.round_stats(events, rid) == \
            ref_metrics.round_stats(events, rid)
        assert metrics.critical_path(events, rid) == \
            ref_metrics.critical_path(events, rid)
        assert metrics.summarize_run(events, rid) == \
            ref_metrics.summarize_run(events, rid)
        assert metrics.render_run_analytics(events, rid) == \
            ref_metrics.render_run_analytics(events, rid)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_traffic_audit_matches_the_reference(method):
    kw = dict(data_size=64, comm_size=2)
    got_s = compile_method(method, AggregatorPattern(8, 3, **kw))
    want_s = ref_compile(method, RefPattern(8, 3, **kw))
    assert traffic.round_traffic(got_s) == ref_traffic.round_traffic(want_s)
    got = traffic.audit_schedule(got_s)
    want = ref_traffic.audit_schedule(want_s)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert traffic.render_audit(got) == ref_traffic.render_audit(want)


def test_measured_overlay_is_refused_by_name():
    s = compile_method(1, AggregatorPattern(8, 3, data_size=64, comm_size=2))
    with pytest.raises(NotPortedError, match="inspect slice"):
        traffic.measured_overlay(traffic.audit_schedule(s), [])


def test_ledger_loaders_and_renderers_match_the_reference(tmp_path):
    _, (jsonl, _) = _traced(str(tmp_path / "l"))
    got, want = ledger.load_ledger(jsonl), ref_ledger.load_ledger(jsonl)
    assert got == want and got["manifest"]["versions"]["torch"]
    recs = [
        {"site": "dispatch:m1:i0", "kind": "attempt", "attempt": 1,
         "outcome": "retry", "error_class": "transient-tunnel"},
        {"site": "dispatch:m1:i0", "kind": "attempt", "attempt": 2,
         "outcome": "ok"},
        {"site": "xprof", "kind": "suppressed", "error_class": "program",
         "error": "RuntimeError: boom"},
        {"site": "sweep:c4", "kind": "cancel", "signal": "SIGINT"}]
    assert ledger.render_resilience(recs) == \
        ref_ledger.render_resilience(recs)
    assert ledger.diff_resilience(recs, recs[:1]) == \
        ref_ledger.diff_resilience(recs, recs[:1])
    report = dict(label="m1 x [torch_sim]", logdir="d", profiled_wall_s=2e-3,
                  device_span_s=None, device_plane=None,
                  reconstructed_s=1e-3, total_s=2e-3,
                  source="host-wall(profiled)", divergence_pct=100.0,
                  error=None, error_class=None)
    assert ledger.render_xprof(report) == ref_ledger.render_xprof(report)
    bad = dict(report, error="RuntimeError: x")
    assert ledger.render_xprof(bad) == ref_ledger.render_xprof(bad)
    text = ledger.render_ledgers([jsonl, jsonl])
    assert "torch " in text and "no environment drift" in text


# ---------------------------------------------------------------------------
# --trace on run and sweep

@pytest.mark.parametrize("backend", ["local", "torch_sim"])
def test_run_trace_reaggregates_float_exactly(tmp_path, backend):
    recs, paths = _traced(str(tmp_path / backend), backend=backend)
    assert os.path.exists(paths[0]) and os.path.exists(paths[1])
    events = load_events(paths[0])
    agg = aggregate_run(events, 0)
    assert set(agg) == set(range(8))
    assert agg[0] == _cols(recs[0]["timer0"])
    assert max(a["total"] for a in agg.values()) == \
        recs[0]["max_timer"].total_time
    spans = [e for e in events if e["ev"] == "host_span"]
    assert [s["name"] for s in spans].count("backend.run") == 1
    with open(paths[1]) as fh:
        chrome = json.load(fh)
    slices = [e for e in chrome["traceEvents"]
              if e.get("ph") == "X" and e["pid"] == perfetto.RANKS_PID]
    assert slices and all(e["args"]["phase_source"] in PHASE_SOURCES
                          for e in slices)
    if backend == "torch_sim":
        s = compile_method(1, AggregatorPattern(8, 3, data_size=64,
                                                comm_size=2))
        assert {int(e[4]) for e in s.data_edges()} <= \
            {e["args"]["round"] for e in slices}


def test_measured_phases_trace_reaggregates_float_exactly(tmp_path):
    recs, paths = _traced(str(tmp_path / "mp"), measured_phases=True,
                          method=2)
    agg = aggregate_run(load_events(paths[0]), 0)
    assert agg[0] == _cols(recs[0]["timer0"])
    assert recs[0]["phase_source"] in PHASE_SOURCES


def test_cli_trace_flag_writes_the_pair(tmp_path, capsys):
    prefix = str(tmp_path / "cli")
    assert cli.main(["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
                     "--device", "cpu", "--verify", "--results-csv",
                     str(tmp_path / "r.csv"), "--trace", prefix]) == 0
    out = capsys.readouterr().out
    assert f"trace written: {prefix}.trace.jsonl (events)" in out
    assert os.path.exists(prefix + ".trace.json")
    assert trace.current() is None      # the CLI turns tracing off again
    events = load_events(prefix + ".trace.jsonl")
    timers = {e["rank"]: {k: e[k] for k in TIMER_COLS}
              for e in events if e["ev"] == "timer"}
    assert aggregate_run(events, 0) == timers
    assert "run 0:" in trace.summarize_trace(prefix + ".trace.jsonl")


def test_sweep_trace_covers_every_cell(tmp_path, capsys):
    prefix = str(tmp_path / "sw")
    assert cli.main(["sweep", "-n", "8", "-a", "3", "-d", "64", "-i", "1",
                     "--comm-sizes", "1,2,999999999", "--device", "cpu",
                     "--verify", "--results-csv", str(tmp_path / "r.csv"),
                     "--trace", prefix]) == 0
    assert "trace written" in capsys.readouterr().out
    events = load_events(prefix + ".trace.jsonl")
    runs = [e for e in events if e["ev"] == "run"]
    assert [r["comm_size"] for r in runs] == [1, 2, 999999999]
    for r in runs:
        timers = {e["rank"]: {k: e[k] for k in TIMER_COLS}
                  for e in events if e["ev"] == "timer"
                  and e["run"] == r["id"]}
        assert aggregate_run(events, r["id"]) == timers
    assert os.path.exists(prefix + ".trace.json")


def test_chained_trace_records_warmup_trials_and_samples(tmp_path):
    _, (jsonl, _) = _traced(str(tmp_path / "ch"), chained=True)
    events = load_events(jsonl)
    inst = [e for e in events if e["ev"] == "instant"]
    trials = [e["args"] for e in inst if e["name"] == "chained.trial"]
    samples = [e["args"] for e in inst if e["name"] == "chained.samples"]
    assert len(trials) >= 3 and len(samples) == 1
    assert samples[0]["samples"] == [t["per_rep"] for t in trials
                                     if t["accepted"]]
    comp = [e["args"] for e in inst if e["name"] == "ledger.compile"]
    assert any(c["kind"] == "compile+warmup" for c in comp)
    assert "chained.warmup" in {e["name"] for e in events
                                if e["ev"] == "host_span"}


def test_graph_capture_is_a_ledger_record(monkeypatch):
    """A graph chain records each capture (block and remainder) once per
    family, with its length; the capture itself replaced by a direct
    call, as the CPU has no graphs."""
    monkeypatch.setattr(chained, "_capture", lambda fn, state: fn)
    send0 = torch.arange(64, dtype=torch.uint8)
    perm = torch.flip(torch.arange(64, dtype=torch.int32), [0])

    def step(x, r):
        tok = r % 251
        if isinstance(tok, torch.Tensor):
            tok = tok.to(torch.uint8)
        torch.bitwise_xor(x.index_select(0, perm), tok, out=x)

    before = len(ledger.compile_records())
    make = chained.graph_chain(None, step=step)
    trace.enable()
    try:
        got = make(53)(send0)
        events = list(trace.current().events)
    finally:
        trace.disable()
    assert torch.equal(got, chained.eager_chain(None, step=step)(53)(send0))
    caps = [r for r in ledger.compile_records()[before:]
            if r["kind"] == "graph-capture"]
    assert sorted(r["reps"] for r in caps) == [3, 50]
    assert sum(e["ev"] == "instant" and e["name"] == "ledger.compile"
               for e in events) == 2
    make(53)(send0)                       # captured once per family
    assert len([r for r in ledger.compile_records()[before:]
                if r["kind"] == "graph-capture"]) == 2


# ---------------------------------------------------------------------------
# the ledger's compile records and --xprof

def test_ledger_records_builds_repairs_and_first_dispatch():
    ledger.reset()
    run_experiment(ExperimentConfig(
        nprocs=8, cb_nodes=3, data_size=64, comm_size=2, method=1,
        iters=2, backend="torch_sim", device="cpu", results_csv=None,
        fault="slow:r2*2"), out=io.StringIO())
    kinds = [(r["kind"], r["label"]) for r in ledger.compile_records()]
    assert kinds == [("schedule-build", "m1:All to many"),
                     ("schedule-repair", "m1:All to many[slow:r2*2]"),
                     ("first-dispatch", "m1:All to many")]
    assert all(r["backend"] == "torch_sim" and r["seconds"] >= 0
               for r in ledger.compile_records())
    assert ledger.total_compile_seconds() == pytest.approx(
        sum(r["seconds"] for r in ledger.compile_records()), abs=0)
    assert ledger.hbm_peak() is None       # nothing sampled on the CPU
    ledger.reset()
    assert ledger.compile_records() == [] and ledger.xprof_reports() == []


@pytest.mark.parametrize("backend", ["torch_sim", "local"])
def test_xprof_on_the_cpu_reports_the_host_wall(tmp_path, capsys, backend):
    logdir = tmp_path / "xp"
    argv = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
            "--backend", backend, "--verify", "--results-csv",
            str(tmp_path / "r.csv"), "--xprof", str(logdir)]
    if backend == "torch_sim":
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"| xprof m1 All to many [{backend}]: profiled " in out
    assert "[host-wall(profiled)]" in out
    rep = ledger.xprof_reports()[-1]
    assert rep["source"] == "host-wall(profiled)"
    assert rep["device_span_s"] is None and rep["device_plane"] is None
    assert rep["total_s"] == rep["profiled_wall_s"] > 0
    path = logdir / "m1_All to many" / "rep.pt.trace.json"
    assert path.exists()
    assert ledger.chrome_trace_device_events(str(path)) is None


def test_xprof_failure_is_suppressed_not_raised(tmp_path, capsys,
                                                monkeypatch):
    from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
    real = TorchSimBackend.run

    def run(self, schedule, **kw):
        if kw.get("ntimes") == 1 and not kw.get("verify"):
            raise RuntimeError("profiled rep failed")
        return real(self, schedule, **kw)

    monkeypatch.setattr(TorchSimBackend, "run", run)
    ledger.reset()
    assert cli.main(["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
                     "-k", "2", "--device", "cpu", "--verify",
                     "--results-csv", str(tmp_path / "r.csv"), "--xprof",
                     str(tmp_path / "xp")]) == 0
    assert "unavailable (RuntimeError: profiled rep failed)" in \
        capsys.readouterr().out
    assert ledger.resilience_records()[-1]["kind"] == "suppressed"
    assert ledger.xprof_reports()[-1]["source"] is None


def test_xprof_report_reads_the_device_span(tmp_path):
    """A torch.profiler Chrome trace with device events: the span is the
    first device event's start to the last one's end on the widest card,
    the busy time the union of its intervals; host events are ignored."""
    logdir = tmp_path / "m1_x"
    logdir.mkdir()
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 900.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0, "dur": 10.0,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 105.0,
         "dur": 10.0, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memset", "name": "s", "ts": 150.0,
         "dur": 5.0, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 300.0, "dur": 1.0,
         "args": {"device": 1}},
        {"ph": "i", "cat": "kernel", "name": "not a slice", "ts": 999.0,
         "args": {"device": 0}},
    ]
    blob = {"deviceProperties": [{"id": 0, "name": "Card Zero"}],
            "traceEvents": events}
    (logdir / "rep.pt.trace.json").write_text(json.dumps(blob))
    dev = ledger.chrome_trace_device_events(
        str(logdir / "rep.pt.trace.json"))
    assert dev["plane"] == "cuda:0 (Card Zero)" and dev["events"] == 3
    assert dev["span_s"] == pytest.approx(55e-6)
    assert dev["busy_s"] == pytest.approx(20e-6)
    rep = ledger.xprof_report(label="m1 x [cuda_fused]", logdir=str(logdir),
                              profiled_wall_s=1e-3, reconstructed_s=50e-6)
    assert rep["source"] == "cupti-device-span"
    assert rep["total_s"] == rep["device_span_s"] == dev["span_s"]
    assert rep["device_plane"] == "cuda:0 (Card Zero)"
    assert rep["divergence_pct"] == pytest.approx(10.0)
    assert set(rep) == set(ref_ledger.xprof_report(
        label="x", logdir=str(tmp_path / "none"), profiled_wall_s=1.0,
        reconstructed_s=1.0))
    assert "[cupti-device-span]" in ledger.render_xprof(rep)
    (logdir / "rep.pt.trace.json").write_text("{not json")
    assert ledger.chrome_trace_device_events(
        str(logdir / "rep.pt.trace.json")) is None


def test_sample_device_skips_the_cpu_and_records_the_card(monkeypatch):
    """On the card the runner records the card's name (which the
    manifest already holds, so the journal's fingerprint stays) and
    max_memory_allocated as the HBM peak; on the CPU nothing."""
    from tpu_aggcomm_torch.harness import runner

    class Fake:
        device = torch.device("cuda", 0)

    ledger.reset()
    runner._sample_device(None, type("C", (), {"device":
                                               torch.device("cpu")})())
    assert ledger.hbm_peak() is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 5)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 7)
    man = ledger.manifest()
    runner._sample_device(None, Fake())
    assert ledger.hbm_peak() == 7
    assert ledger.manifest()["device_kind"] == "Card"
    assert set(ledger.manifest()) == set(man)
    ledger.reset()


def test_trace_is_off_by_default_and_costs_nothing():
    assert trace.current() is None and not trace.enabled()
    with trace.span("x"):
        pass
    trace.instant("y")
    assert trace.current() is None
