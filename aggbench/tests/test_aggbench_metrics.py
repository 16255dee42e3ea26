"""The metric readers, the trace reduction, the reservoir and the result
line, on synthetic records."""

from __future__ import annotations

import random

import pytest

from aggbench import harness, tracing
from aggbench.tests.conftest import REPO

KIND = "NVIDIA H100 80GB HBM3"
CFG = {"nprocs": 32, "cb_nodes": 14, "data_size": 2048}


def read(name, rec):
    return harness.Bench(REPO).plugin("metrics", name).read(rec)


def _rec(**kw):
    rec = harness.Record(CFG, KIND)
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_end_to_end_readers():
    walls = [i * 1e-6 for i in range(1, 101)]
    rec = _rec(window_s=0.5, exchanges=1000, walls_s=walls, setup_s=3.5)
    assert read("exchange_us", rec) == pytest.approx(500.0)
    assert read("exchange_p95_us", rec) == pytest.approx(95.0)
    assert read("setup_s", rec) == 3.5
    empty = _rec()
    assert read("exchange_us", empty) is None
    assert read("exchange_p95_us", empty) is None


def test_per_layer_readers():
    prof = {"exchanges": 10, "window_s": 0.01, "busy_s": 0.0002,
            "device_events": 230, "device_ops": [], "idle_gaps": []}
    rec = _rec(window_s=1.0, exchanges=1000, profile=prof,
               dispatch_s=[2e-6, 4e-6], split={"tables_s": 1.25})
    assert read("host_dispatch_us", rec) == pytest.approx(3.0)
    assert read("kernels_per_exchange", rec) == 23.0
    assert read("device_busy_us", rec) == pytest.approx(20.0)
    floor_us = 2 * 32 * 14 * 2048 / 3.35e12 * 1e6
    assert read("exchange_roofline", rec) == pytest.approx(
        floor_us / 20.0 * 100)
    assert read("idle_share", rec) == pytest.approx(1 - (0.0002 / 10) / (1.0 / 1000))
    assert read("tables_s", rec) == 1.25


def test_per_layer_readers_return_nothing_without_a_trace():
    rec = _rec(window_s=1.0, exchanges=10)
    for name in ("host_dispatch_us", "kernels_per_exchange",
                 "device_busy_us", "exchange_roofline", "idle_share",
                 "tables_s"):
        assert read(name, rec) is None
    quiet = {"exchanges": 5, "window_s": 0.1, "busy_s": 0.0,
             "device_events": 0, "device_ops": [], "idle_gaps": []}
    rec.profile = quiet
    for name in ("kernels_per_exchange", "device_busy_us",
                 "exchange_roofline", "idle_share"):
        assert read(name, rec) is None
    other = _rec(profile=dict(quiet, busy_s=0.001, device_events=5))
    other.device_kind = "a card with no peak in the table"
    assert read("exchange_roofline", other) is None


def _slice(n, gap=False):
    D, S = tracing.DISPATCH, tracing.SYNC
    host, dev, t = [], [], 0
    for _ in range(n):
        host += [(t, t + 100, D, 1), (t + 10, t + 40, "aten::index", 1),
                 (t + 50, t + 90, "aten::index_put_", 1),
                 (t + 100, t + 150, S, 1), (t, t + 150, D, 2)]
        dev += [(t + 30, t + 60, "kern_a" * 40), (t + 95, t + 130, "kern_b"),
                (t + 20, t + 130, D)]
        t += 160
    return dev, host


def test_trace_reduction():
    dev, host = _slice(4)
    dev = [d for d in dev if d[2] != tracing.DISPATCH]
    r = tracing.reduce(dev, [h for h in host if h[3] == 1], 1, 3)
    assert r["exchanges"] == 3 and r["device_events"] == 6
    assert r["window_s"] == pytest.approx(470e-9)
    assert r["busy_s"] == pytest.approx(195e-9)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"synchronize": 140e-9, "dispatch:aten::index_put_": 105e-9,
         "dispatch": 30e-9})
    assert r["device_ops"][0] == ["kern_b", pytest.approx(105e-9)]
    assert len(r["device_ops"][1][0]) == tracing.NAME_CHARS
    with pytest.raises(ValueError):
        tracing.reduce(dev, host, 3, 3)


def test_reservoir_keeps_a_seeded_uniform_sample():
    counts = [0] * 20
    for seed in range(3000):
        r = harness.Reservoir(4, random.Random(seed))
        for i in range(20):
            r.offer(i, i)
        assert len(r.kept) == 4 and len(set(r.kept)) == 4
        for i in r.kept:
            counts[i] += 1
    assert min(counts) > 450 and max(counts) < 750     # 600 expected
    a, b = harness.Reservoir(3, random.Random(9)), harness.Reservoir(
        3, random.Random(9))
    for i in range(1000):
        a.offer(i, i)
        b.offer(i, i)
    assert a.kept == b.kept


def test_result_line_puts_checks_last():
    bench = harness.Bench(REPO)
    cell = bench.cell("readme_a2m_fused")
    prof = {"exchanges": 10, "window_s": 0.01, "busy_s": 0.0002,
            "device_events": 230, "device_ops": [["k", 0.0002]],
            "idle_gaps": [["between", 0.0098]]}
    rec = _rec(window_s=1.0, exchanges=1000, walls_s=[1e-3] * 1000,
               setup_s=2.0, profile=prof, dispatch_s=[1e-6],
               split={"tables_s": 0.5}, memory_peak_bytes=123)
    checks = {"judged": {"value": 8, "min": 1},
              "wrong_slabs": {"value": 0, "limit": 0}}
    plain = harness.result(bench, cell, rec, checks, 0, False)
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert set(plain["metrics"]) == {"exchange_us.readme",
                                     "exchange_p95_us.readme", "setup_s"}
    traced = harness.result(bench, cell, rec, checks, 0, True)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert traced["device"]["busy_s"] == 0.0002
    assert set(traced["metrics"]) == {m["name"] for m in
                                      bench.spec["per_layer"]
                                      if "theta" not in m["name"]}
    assert harness.check_lines(checks) == ["check judged 8 min 1",
                                           "check wrong_slabs 0 limit 0"]
    assert not harness.passed({"judged": {"value": 0, "min": 1}})
