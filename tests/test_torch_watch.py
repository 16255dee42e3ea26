"""The watchtower of the port (``tpu_aggcomm_torch/obs/{watch,slo}`` and
``obs.regress.validate_watch``) against the reference's, on the CPU.

- ``burn_rate``, ``measure_window``, ``evaluate_slo``,
  ``detect_changepoint`` and ``attribute_anomaly`` equal the reference's
  on the same seeded inputs (no tolerance: identical arithmetic);
- ``watch_streams`` over the committed ``serve_exemplar.journal.jsonl``
  (and over a journal with an engineered step plus a trace) gives the
  reference's body;
- ``replay_watch`` on a copy of the committed ``WATCH_r01.json``
  reproduces, and a doctored copy is a named mismatch;
- a ``predict_path`` (the explain join, ``model/explain`` not ported) is
  refused by name, before any artifact is written;
- ``validate_watch`` and ``validate_slo`` accept and reject what the
  reference's do, with the same errors.

No test reads a time.
"""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from tpu_aggcomm.obs import regress as ref_regress  # noqa: E402
from tpu_aggcomm.obs import slo as ref_slo  # noqa: E402
from tpu_aggcomm.obs import watch as ref_watch  # noqa: E402

from tpu_aggcomm_torch.obs import regress, slo, watch  # noqa: E402
from tpu_aggcomm_torch.resilience.journal import RunJournal  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXEMPLAR = os.path.join(REPO, "serve_exemplar.journal.jsonl")

_SHAPE = {"method": 3, "nprocs": 8, "cb_nodes": 2, "comm_size": 2,
          "data_size": 64}


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def _rows(seed, n=24):
    """Seeded per-request rows of every status, cache disposition,
    deadline and batch fill the evaluator reads."""
    rng = np.random.default_rng(seed)
    rows = []
    for rid in range(n):
        status = str(rng.choice(["done", "done", "done", "fail", "shed"]))
        padded = int(rng.choice([1, 2, 4]))
        rows.append({
            "rid": rid, "status": status,
            "cache": str(rng.choice(["hit", "miss", "evict"])),
            "wall_s": None if status == "shed"
            else float(rng.uniform(0.001, 3.0)),
            "phases": {}, "shed_reason": "deadline"
            if status == "shed" else None,
            "deadline_ms": None if rng.random() < 0.5
            else float(rng.uniform(1.0, 2000.0)),
            "batch": {"seq": rid // 2, "n": max(1, padded - 1),
                      "padded": padded}})
    return rows


def _walls(kind, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.9, 1.1, 16)
    if kind == "up":
        base[8:] *= 2.0
    elif kind == "down":
        base[8:] *= 0.4
    elif kind == "noisy":
        base = rng.lognormal(0.0, 0.8, 20)
    return [float(x) for x in base]


def _write_journal(path, scales, *, backend="torch_sim"):
    """A serve journal of ``len(scales)`` done requests whose phase stamps
    scale by the given factors (the reference tests' recipe)."""
    j = RunJournal(str(path))
    fp = j.begin_session({"torch": "0.0-test"})
    t0 = 1_700_000_000.0
    for i, s in enumerate(scales):
        stamps = {"admit": 0.0, "queue": 0.001 * s, "batch": 0.002 * s,
                  "cache": 0.0021 * s, "dispatch": 0.004 * s,
                  "respond": 0.0042 * s}
        j.record({"request": i}, fingerprint=fp, status="admitted",
                 shape=dict(_SHAPE), backend=backend, iter=i,
                 t_unix=t0 + 0.05 * i, queue_depth=i % 3, deadline_ms=None)
        j.record({"request": i}, fingerprint=fp, status="done",
                 latency_s=stamps["respond"], batch_n=1,
                 cache="miss" if i >= 6 else "hit", phases=stamps,
                 batch_seq=i, batch_padded=1, queue_depth=None)
    return str(path)


def _write_trace(path, walls):
    events = [{"ev": "run", "id": 0, "method": 3, "name": "theta",
               "backend": "torch_sim", "nprocs": 8, "data_size": 64}]
    for rnd, wall in enumerate(walls):
        for rank in (0, 1):
            events.append({"ev": "span", "run": 0, "rep": 0, "rank": rank,
                           "round": rnd, "bucket": "sendrecv",
                           "dur_s": wall if rank == 0 else wall * 0.5})
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
    return str(path)


# ---------------------------------------------------------------------------
# The arithmetic


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_and_burn_rates_equal_the_reference(seed):
    rows = _rows(seed)
    for spec in (slo.DEFAULT_SLO,
                 {**slo.DEFAULT_SLO,
                  "windows": [{"name": "w5", "requests": 5}],
                  "objectives": [
                      {"name": "dl", "kind": "deadline-miss",
                       "target": 0.8},
                      {"name": "pad", "kind": "padding-waste",
                       "target": 0.5},
                      {"name": "warm", "kind": "warm-latency",
                       "target": 0.9, "threshold_s": 1.0}]}):
        assert slo.validate_slo(spec) == ref_slo.validate_slo(spec) == []
        for obj in spec["objectives"]:
            _same(watch.measure_window(rows, obj),
                  ref_watch.measure_window(rows, obj))
        _same(watch.evaluate_slo(rows, spec),
              ref_watch.evaluate_slo(rows, spec))
    for bad, total, budget in ((0, 10, 0.1), (1, 10, 0.1), (3, 7, 0.05),
                               (0, 0, 0.1)):
        assert slo.burn_rate(bad, total, budget) == \
            ref_slo.burn_rate(bad, total, budget)
    for obj in slo.DEFAULT_SLO["objectives"]:
        assert slo.objective_budget(obj) == ref_slo.objective_budget(obj)


@pytest.mark.parametrize("kind", ["flat", "up", "down", "noisy"])
@pytest.mark.parametrize("seed", [0, 7])
def test_detect_changepoint_equals_the_reference(kind, seed):
    walls = _walls(kind, seed)
    got = watch.detect_changepoint(walls, seed=seed)
    _same(got, ref_watch.detect_changepoint(walls, seed=seed))
    if kind in ("up", "down"):
        assert got is not None and got["direction"] == kind
        assert got["index"] == 8
    if kind == "flat":
        assert got is None


def test_attribution_equals_the_reference():
    det = {"index": 6, "delta_rel": 0.5, "direction": "up"}

    def rows_for(**after):
        rows = []
        for i in range(12):
            r = {"rid": i, "status": "done", "cache": "hit",
                 "wall_s": 0.01, "phases": {"cache": 0.001},
                 "shed_reason": None, "deadline_ms": None, "batch": None}
            if i >= 6:
                r.update(after)
            rows.append(r)
        return rows

    none = {"sessions": [], "states": [],
            "resilience_retries": {"count": 0, "sites": []},
            "explain": {}}
    cases = [
        (rows_for(), dict(none, sessions=[
            {"fingerprint": "a", "drift": []},
            {"fingerprint": "b", "drift": ["versions.torch: 1 -> 2"]}]),
         None, "ledger"),
        (rows_for(cache="evict"), none, None, "ledger"),
        (rows_for(cache="miss"), none, None, "ledger"),
        (rows_for(), dict(none, states=[{"state": "degraded",
                                          "prev": "ready",
                                          "reason": "retries_exhausted"}]),
         None, "resilience"),
        (rows_for(), dict(none, resilience_retries={
            "count": 3, "sites": ["dispatch"]}), None, "resilience"),
        (rows_for(status="shed", wall_s=None, shed_reason="queue-full"),
         none, None, "shed"),
        (rows_for(), none, [{"round": 7, "verdict": "incast-bound",
                             "deviation_rel": 0.0}], "explain"),
        (rows_for(), none, None, "none"),
    ]
    for rows, ev, expl, stream in cases:
        got = watch.attribute_anomaly(det, rows=rows, evidence=ev,
                                      split_rid=6, explain_rounds=expl)
        assert got["evidence"] == stream
        _same(got, ref_watch.attribute_anomaly(
            det, rows=rows, evidence=ev, split_rid=6, explain_rounds=expl))


# ---------------------------------------------------------------------------
# The pipeline and its artifact


def test_watch_streams_equals_the_reference(tmp_path):
    _same(watch.watch_streams([EXEMPLAR]),
          ref_watch.watch_streams([EXEMPLAR]))
    journal = _write_journal(tmp_path / "serve.journal.jsonl",
                             [1.0] * 6 + [2.5] * 6)
    trace = _write_trace(tmp_path / "run.trace.jsonl",
                         [1e-3] * 6 + [3e-3] * 6)
    got = watch.watch_streams([journal], [trace], seed=3)
    _same(got, ref_watch.watch_streams([journal], [trace], seed=3))
    assert {a["stream"] for a in got["anomalies"]} == {
        "request-walls", "round-walls:run.trace.jsonl#run0"}


def test_committed_watch_artifact_replays_from_a_copy(tmp_path):
    for name in ("WATCH_r01.json", "serve_exemplar.journal.jsonl"):
        shutil.copy(os.path.join(REPO, name), tmp_path)
    path = str(tmp_path / "WATCH_r01.json")
    blob = json.load(open(path))
    assert regress.validate_watch(blob, "WATCH_r01.json") == []
    rep = watch.replay_watch(path)
    assert rep["verdict"] == "REPRODUCED", rep["problems"]
    _same(rep, ref_watch.replay_watch(path))
    blob["requests"]["completed"] += 1
    with open(tmp_path / "WATCH_r02.json", "w") as fh:
        json.dump(blob, fh)
    rep = watch.replay_watch(str(tmp_path / "WATCH_r02.json"))
    assert rep["verdict"] == "MISMATCH"
    assert any("'requests'" in p for p in rep["problems"])
    _same(rep, ref_watch.replay_watch(str(tmp_path / "WATCH_r02.json")))


def test_port_written_artifact_validates_and_replays_under_both(tmp_path):
    journal = _write_journal(tmp_path / "serve.journal.jsonl",
                             [1.0] * 6 + [2.5] * 6)
    body = watch.watch_streams([journal])
    blob = watch.write_watch(str(tmp_path / "WATCH_r01.json"), body)
    assert regress.validate_watch(blob) == []
    assert ref_regress.validate_watch(blob) == []
    for replay in (watch.replay_watch, ref_watch.replay_watch):
        rep = replay(str(tmp_path / "WATCH_r01.json"))
        assert rep["verdict"] == "REPRODUCED", rep["problems"]


def test_predict_path_is_refused_by_name(tmp_path):
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    with pytest.raises(NotPortedError, match="model/explain.*inspect"):
        watch.watch_streams([EXEMPLAR],
                            predict_path=os.path.join(REPO,
                                                      "PREDICT_r11.json"))
    assert os.listdir(tmp_path) == []


def test_validators_accept_and_reject_as_the_reference(tmp_path):
    journal = _write_journal(tmp_path / "serve.journal.jsonl",
                             [1.0] * 6 + [2.5] * 6)
    blob = watch.write_watch(str(tmp_path / "WATCH_r01.json"),
                             watch.watch_streams([journal]))

    def mutate(fn):
        bad = json.loads(json.dumps(blob))
        fn(bad)
        return bad

    variants = [
        blob,
        mutate(lambda b: b["per_request"][0].__setitem__("wall_s", 1.0)),
        mutate(lambda b: b["evaluation"].__setitem__("compliant", False)),
        mutate(lambda b: b["anomalies"][0].__setitem__("cause", "ANOMALY")),
        mutate(lambda b: b["anomalies"][0].__setitem__("evidence", "vibes")),
        mutate(lambda b: b.__setitem__("anomalies", [])),
        mutate(lambda b: b["requests"].__setitem__("completed", 99)),
        mutate(lambda b: b.__setitem__("problems", ["oops"])),
        mutate(lambda b: b.__setitem__("schema", "watch-v0")),
        "not an object",
    ]
    for i, v in enumerate(variants):
        got = regress.validate_watch(v)
        assert (got == []) == (i == 0), (i, got)
        assert got == ref_regress.validate_watch(v)

    bad = json.loads(json.dumps(slo.DEFAULT_SLO))
    bad["objectives"][0]["target"] = 1.0
    bad2 = json.loads(json.dumps(slo.DEFAULT_SLO))
    bad2["objectives"][0]["kind"] = "vibes"
    for spec in (bad, bad2, {"schema": "slo-v0"}, []):
        got = slo.validate_slo(spec)
        assert got and got == ref_slo.validate_slo(spec)
    p = tmp_path / "slo.json"
    p.write_text("{not json")
    with pytest.raises(slo.SloError, match="slo.json"):
        slo.load_slo(str(p))
