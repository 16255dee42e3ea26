"""The serve slice of the port (``tpu_aggcomm_torch/serve``) against the
reference (``tpu_aggcomm/serve``), on the CPU at n=8 a=2 d=64.

- **Batched equals sequential equals the reference equals the oracle**:
  for m=1, 3, 11 (one per structural family), m=5 (dense), m=15 (TAM),
  and ``slow:r2*2`` and ``deadlink:5>1`` on m=1, the port's
  ``batched_recv_bytes`` (iters 0, 1, 2 padded to 4), its ``recv_bytes``
  per iter, the reference's sequential single rep and the port's
  ``local`` oracle agree byte for byte (no tolerance: integer data
  movement). **Substitution:** the reference's ``build_chain(...,
  "jax_sim")`` fails on this tree's jax (``executor.py:81`` asks ``prim
  in batching.primitive_batchers``, which raises ``TypeError``), so its
  sequential rep is built by hand as ``CompiledChain(s, b, "jax_sim",
  jax.jit(b.one_rep(s)), None)`` with ``b = JaxSimBackend()``, and the
  reference's own ``executor.recv_bytes`` reads it.
- **Per-request barrier tokens**: a batch whose requests differ in
  ``iter`` gives each its own trash row, equal to the reference's single
  rep's whole arena, in the unrolled and the padded lowerings, healthy
  and faulted.
- The executor's refusals (``cuda_fused`` never batches, no card without
  ``device="cpu"``), the copies of ``obs/workload`` (``padded_slots``
  names ``torch_sim``), ``resilience/policy``, ``model`` and
  ``tune/measure`` against the reference's, the cache's drift eviction,
  the floor reading only its own platform's entry, the server end to end
  (batching, caching, drift, the journal replayed), every overload shed
  and named refusal, ``--recover``, the control plane under a poisoned
  torch, and the reference's unchanged load generator driving ``cli
  serve --device cpu`` over the wire.

No test here reads a time.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.serve import executor as ref_executor  # noqa: E402
from tpu_aggcomm.serve.protocol import parse_request as ref_parse  # noqa: E402
from tpu_aggcomm.serve.protocol import \
    request_schedule as ref_request_schedule  # noqa: E402

from tpu_aggcomm_torch.backends.lanes import to_reference  # noqa: E402
from tpu_aggcomm_torch.backends.local import LocalBackend  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import dense_send_batch  # noqa: E402
from tpu_aggcomm_torch.serve import executor  # noqa: E402
from tpu_aggcomm_torch.serve.cache import CompiledChainCache  # noqa: E402
from tpu_aggcomm_torch.serve.protocol import (ProtocolError,  # noqa: E402
                                              ServeClient, parse_request,
                                              request_schedule)
from tpu_aggcomm_torch.serve.recover import (prewarm_plan,  # noqa: E402
                                             replay_journal)
from tpu_aggcomm_torch.serve.server import (SERVE_BACKENDS,  # noqa: E402
                                            ScheduleServer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHAPE = {"method": 3, "nprocs": 8, "cb_nodes": 2, "comm_size": 2,
          "data_size": 64}

#: (id, request fields): one per structural family, dense, TAM, faults
PARITY = [
    ("m1", dict(_SHAPE, method=1)),
    ("m3", dict(_SHAPE, method=3)),
    ("m11", dict(_SHAPE, method=11)),
    ("m5-dense", dict(_SHAPE, method=5)),
    ("m15-tam", dict(_SHAPE, method=15)),
    ("m1-slow", dict(_SHAPE, method=1, fault="slow:r2*2")),
    ("m1-deadlink", dict(_SHAPE, method=1, fault="deadlink:5>1")),
]


def _assert_same_bufs(a, b, ctx=""):
    assert len(a) == len(b), ctx
    for r, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            assert x is None and y is None, f"{ctx} rank {r}"
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), \
                f"{ctx} rank {r} differs"


def _ref_chain(fields):
    """The reference's sequential single rep, built by hand (see the
    module docstring's substitution)."""
    s = ref_request_schedule(ref_parse(dict(fields)))
    b = JaxSimBackend()
    return ref_executor.CompiledChain(s, b, "jax_sim", jax.jit(b.one_rep(s)),
                                      None)


# ---------------------------------------------------------------------------
# The batched data plane


@pytest.mark.parametrize("fields", [f for _i, f in PARITY],
                         ids=[i for i, _f in PARITY])
def test_batched_equals_sequential_reference_and_oracle(fields):
    s = request_schedule(parse_request(dict(fields)))
    chain, compile_s = executor.build_chain(s, "torch_sim", device="cpu")
    assert compile_s > 0 and chain.batched is not None
    iters = [0, 1, 2]
    batched = executor.batched_recv_bytes(chain, iters)
    ref = _ref_chain(fields)
    for k, it in enumerate(iters):
        seq = executor.recv_bytes(chain, it)
        _assert_same_bufs(batched[k], seq, f"{fields} iter={it} batched-seq")
        _assert_same_bufs(batched[k], ref_executor.recv_bytes(ref, it),
                          f"{fields} iter={it} batched-reference")
        oracle, _ = LocalBackend().run(s, ntimes=1, iter_=it, verify=True)
        _assert_same_bufs(batched[k], oracle,
                          f"{fields} iter={it} batched-oracle")


@pytest.mark.parametrize("nprocs,comm_size", [(8, 2), (40, 1)],
                         ids=["unrolled", "padded"])
@pytest.mark.parametrize("fault", [None, "slow:r2*2"])
def test_batch_barrier_tokens_are_per_request(nprocs, comm_size, fault):
    """m=17 carries a barrier a round: every request of a batch gets its
    own token in its own trash row, and its whole arena equals the
    reference's single rep's (the per-element vmap semantics)."""
    fields = dict(_SHAPE, method=17, nprocs=nprocs, comm_size=comm_size,
                  fault=fault)
    s = request_schedule(parse_request(dict(fields)))
    chain, _ = executor.build_chain(s, "torch_sim", device="cpu")
    out = chain.batched(dense_send_batch(s.pattern, [0, 1, 2], 4, "cpu"))
    ref = _ref_chain(fields)
    for k in range(3):
        want = np.asarray(ref.single(ref.backend._global_send(
            ref.schedule.pattern, k)))
        assert np.array_equal(to_reference(out[k]), want), k
    trash = out[:, :, -1, 0]
    assert len({int(t) for t in trash[:3, 0]}) == 3, trash
    assert torch.equal(out[3], out[2])             # the padded lane


def test_pad_to_powers_of_two():
    assert [executor._pad_to(n) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 16]


def test_execute_batch_pads_verifies_and_names_a_bad_byte(monkeypatch):
    s = request_schedule(parse_request(dict(_SHAPE)))
    chain, _ = executor.build_chain(s, "torch_sim", device="cpu")
    reqs = [parse_request(dict(_SHAPE, iter=i, verify=i != 1))
            for i in range(3)]
    res = executor.execute_batch(chain, reqs)
    assert [r["verified"] for r in res] == [True, None, True]
    assert all(r["error"] is None and r["dispatch_s"] > 0 for r in res)
    assert res[1]["verify_s"] is None and res[0]["verify_s"] > 0
    # a corrupted delivery is the request's named verdict, not a crash
    real = chain.batched
    agg = int(s.pattern.rank_list[-1])

    def corrupt(sends):
        out = real(sends)
        out[0, agg, 0, 0] ^= 1
        return out

    monkeypatch.setattr(chain, "batched", corrupt)
    res = executor.execute_batch(chain, [parse_request(dict(
        _SHAPE, iter=i, verify=True)) for i in range(2)])
    assert res[0]["verified"] is False
    assert res[0]["error"].startswith(f"verify failed: rank {agg}:")
    assert res[1]["verified"] is True


def test_cuda_fused_never_batches_and_needs_a_card():
    from tpu_aggcomm_torch.backends.cuda_fused import FusedBackendError

    s = request_schedule(parse_request(dict(_SHAPE, method=1)))
    chain, _ = executor.build_chain(s, "cuda_fused", device="cpu")
    assert chain.batched is None
    with pytest.raises(ValueError, match="does not batch"):
        executor.batched_recv_bytes(chain, [0, 1])
    with pytest.raises(ValueError, match="cuda_fused does not batch"):
        chain.backend.batched_rep(s)
    reqs = [parse_request(dict(_SHAPE, method=1, iter=i, verify=True))
            for i in range(3)]
    res = executor.execute_batch(chain, reqs)
    assert all(r["verified"] is True for r in res)
    if not torch.cuda.is_available():
        with pytest.raises(FusedBackendError, match="device='cpu'"):
            executor.build_chain(s, "cuda_fused")
    with pytest.raises(ValueError, match="unknown chain backend"):
        executor.build_chain(s, "jax_sim", device="cpu")


# ---------------------------------------------------------------------------
# The copies against the reference


@pytest.mark.parametrize("n,backend,want", [
    (1, "torch_sim", 1), (3, "torch_sim", 4), (5, "torch_sim", 8),
    (8, "torch_sim", 8), (3, "cuda_fused", 3), (3, "jax_sim", 3)])
def test_padded_slots_pads_torch_sim_only(n, backend, want):
    from tpu_aggcomm.obs.workload import padded_slots as ref_padded
    from tpu_aggcomm_torch.obs.workload import padded_slots

    assert padded_slots(n, backend) == want
    # torch_sim pads as the reference's jax_sim, cuda_fused as pallas_fused
    ref_name = {"torch_sim": "jax_sim", "cuda_fused": "pallas_fused"}
    if backend in ref_name:
        assert ref_padded(n, ref_name[backend]) == want


def _journal_lines(path, fp, rows):
    from tpu_aggcomm_torch.resilience.journal import RunJournal
    j = RunJournal(str(path))
    j.begin_session({"versions": {"torch": "x"}})
    for key, extra in rows:
        j.record(key, fingerprint=fp, **extra)
    return str(path)


def test_workload_profile_equals_the_reference(tmp_path):
    from tpu_aggcomm.obs.workload import profile_journal as ref_profile
    from tpu_aggcomm_torch.obs.workload import profile_journal

    shape = dict(_SHAPE, proc_node=1, agg_type=0, barrier_type=0,
                 fault=None)
    rows = []
    for rid in range(1, 10):
        rows.append(({"request": rid}, dict(
            status="admitted", shape=shape, backend="torch_sim", iter=rid,
            t_unix=100.0 + 0.01 * rid, queue_depth=rid % 3)))
    for rid in range(1, 10):
        seq, n = (1, 8) if rid < 9 else (2, 1)
        rows.append(({"request": rid}, dict(
            status="done", cache="miss" if seq == 1 else "hit",
            latency_s=0.01 * rid, batch_seq=seq, batch_n=n,
            batch_padded=n, phases={"admit": 0.0, "queue": 0.001 * rid,
                                    "batch": 0.002 * rid,
                                    "cache": 0.003 * rid,
                                    "dispatch": 0.004 * rid,
                                    "respond": 0.005 * rid})))
    path = _journal_lines(tmp_path / "w.jsonl", "fp", rows)
    got, want = profile_journal([path], seed=3), ref_profile([path], seed=3)
    assert got["problems"] == [] and got["proposals"]
    for key in ("requests", "per_request", "phase_totals", "arrivals",
                "queue_depth", "shape_mix", "batching"):
        assert got[key] == want[key], key
    assert [p["kind"] for p in got["proposals"]] == \
        [p["kind"] for p in want["proposals"]]


@pytest.mark.parametrize("attempts", [1, 3, 5])
def test_retry_policy_equals_the_reference(attempts):
    from tpu_aggcomm.resilience import policy as ref_policy
    from tpu_aggcomm_torch.resilience import policy

    fields = dict(max_attempts=attempts, backoff_base_s=0.01, seed=7)
    assert policy.RetryPolicy(**fields).backoff_schedule() == \
        ref_policy.RetryPolicy(**fields).backoff_schedule()
    errors = [ConnectionRefusedError("x"), ValueError("mosaic lowering"),
              RuntimeError("UNAVAILABLE: rpc"), KeyError("k"),
              policy.ChaosError("injected transient")]
    assert [policy.classify_error(e) for e in errors] == \
        [ref_policy.classify_error(e) for e in errors]
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < attempts:
            raise ConnectionResetError("connection reset")
        return "ok"

    pol = policy.RetryPolicy(**fields)
    assert policy.retry_call(flaky, site="t", policy=pol,
                             sleep=lambda s: None) == "ok"
    with pytest.raises(ConnectionResetError) as e:
        policy.retry_call(lambda: (_ for _ in ()).throw(
            ConnectionResetError("reset")), site="t2", policy=pol,
            sleep=lambda s: None)
    assert policy.retries_exhausted(e.value) is True


@pytest.mark.parametrize("method,fault", [(1, None), (3, None), (11, None),
                                          (1, "deadlink:5>1")])
def test_floor_features_equal_the_reference(method, fault):
    from tpu_aggcomm.model.features import \
        schedule_features as ref_features
    from tpu_aggcomm.model.predict import \
        floor_from_features as ref_floor
    from tpu_aggcomm_torch.model import (PARAM_NAMES, floor_from_features,
                                         schedule_features)

    fields = dict(_SHAPE, method=method, fault=fault)
    params = {k: 1e-3 * (i + 1) for i, k in enumerate(PARAM_NAMES)}
    got = schedule_features(request_schedule(parse_request(dict(fields))))
    want = ref_features(ref_request_schedule(ref_parse(dict(fields))))
    assert got == want
    assert floor_from_features(got, params) == ref_floor(want, params)


def test_dispatch_inflight_refuses_contention():
    from tpu_aggcomm_torch.tune.measure import (PilotContentionError,
                                                _check_contention,
                                                serve_dispatch_inflight)
    _check_contention("torch_sim")
    with serve_dispatch_inflight("torch_sim"):
        with pytest.raises(PilotContentionError, match="torch_sim"):
            _check_contention("torch_sim")
        _check_contention("cuda_fused")
    _check_contention("torch_sim")


@pytest.mark.parametrize("obj", [
    {"method": 3, "nprocs": 8, "cb_nodes": 2, "comm_size": 4},
    {"method": 3, "nprocs": 8, "cb_nodes": 2, "comm_size": 4, "iter": 7,
     "verify": True, "deadline_ms": 50, "fault": "slow:r2*2"},
    {"method": 3, "nprocs": 8, "cb_nodes": 2},
    {"method": True, "nprocs": 8, "cb_nodes": 2, "comm_size": 4},
    {"method": 3, "nprocs": 8, "cb_nodes": 2, "comm_size": 4,
     "deadline_ms": 0},
])
def test_parse_request_equals_the_reference(obj):
    try:
        want = ref_parse(dict(obj))
    except ValueError as e:
        with pytest.raises(ProtocolError) as got:
            parse_request(dict(obj))
        assert str(got.value) == str(e)
        return
    got = parse_request(dict(obj))
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}


# ---------------------------------------------------------------------------
# Cache drift


def _man(torch_ver):
    return {"versions": {"torch": torch_ver, "cuda": "12.8"},
            "device_kind": None}


def test_cache_drift_evicts_with_divergent_key_named():
    from tpu_aggcomm_torch.obs.ledger import diff_manifests
    from tpu_aggcomm_torch.tune.cache import manifest_fingerprint

    m1, m2 = _man("2.11.0"), _man("2.12.0")
    fp1, fp2 = manifest_fingerprint(m1), manifest_fingerprint(m2)
    cache = CompiledChainCache()
    key = ("pat", 3, False, (), "", None)
    entry, reason = cache.lookup(key, "torch_sim", fingerprint=fp1,
                                 manifest=m1)
    assert entry is None and "compiling" in reason
    cache.put(key, "torch_sim", fingerprint=fp1, manifest=m1,
              chain=object(), compile_s=0.1)
    assert cache.lookup(key, "torch_sim", fingerprint=fp1,
                        manifest=m1)[1] is None
    assert "versions.torch" in [d["key"] for d in diff_manifests(m1, m2)]
    entry, reason = cache.lookup(key, "torch_sim", fingerprint=fp2,
                                 manifest=m2)
    assert entry is None and reason.startswith("manifest drift")
    assert "versions.torch" in reason and "evicted" in reason
    assert cache.stats()["evictions"] == 1 and len(cache) == 0


# ---------------------------------------------------------------------------
# The server end to end (in-process, CPU torch_sim)


def _run_many(port, payloads):
    out = [None] * len(payloads)

    def fire(i):
        with ServeClient(port, timeout=300.0) as c:
            out[i] = c.run(**payloads[i])

    ts = [threading.Thread(target=fire, args=(i,))
          for i in range(len(payloads))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def _records(journal):
    return [json.loads(line) for line in journal.read_text().splitlines()
            if line.strip()]


def test_server_roundtrip_batches_caches_and_evicts(tmp_path):
    """The reference's roundtrip pin on torch_sim (its warm-beats-cold
    latency assertion left out: no port test reads a time on the CPU)."""
    from tpu_aggcomm_torch.tune.cache import manifest_fingerprint

    journal = tmp_path / "serve.journal.jsonl"
    srv = ScheduleServer(port=0, max_batch=4, batch_window_s=0.25,
                         journal_path=str(journal), device="cpu")
    srv.start()
    try:
        assert srv.ready_info()["backend"] == "torch_sim"
        assert srv.ready_info()["device"] == "cpu"
        shape = dict(_SHAPE, verify=True)
        resps = _run_many(srv.port, [dict(shape, iter=i)
                                     for i in range(4)])
        assert all(r["ok"] and r["verified"] for r in resps)
        assert {r["batch_n"] for r in resps} == {4}
        assert sum(1 for r in resps if r["cache"] == "miss") == 4
        warm = _run_many(srv.port, [dict(shape, iter=9)])[0]
        assert warm["ok"] and warm["cache"] == "hit"
        assert warm["compile_s"] is None and warm["verified"] is True
        drifted = json.loads(json.dumps(srv._man))
        drifted.setdefault("versions", {})["torch"] = "drifted-for-test"
        srv._man, srv._fp = drifted, manifest_fingerprint(drifted)
        evicted = _run_many(srv.port, [dict(shape, iter=10)])[0]
        assert evicted["ok"] and evicted["cache"] == "evict"
        assert evicted["compile_s"] is not None
        with ServeClient(srv.port, timeout=60.0) as c:
            bad = c.run(method=999, nprocs=8, cb_nodes=2, comm_size=2)
        assert not bad["ok"] and "999" in bad["error"]
        st = srv.stats()
        assert st["completed"] == 6 and st["errors"] == 1
        assert st["cache"]["compiles"] == 2
        assert st["cache"]["evictions"] == 1
        assert st["batch"]["max_batch"] == 4
        assert st["warm"]["n"] == 1 and st["cold"]["n"] == 5
        with ServeClient(srv.port, timeout=60.0) as c:
            assert c.shutdown()["stopping"] is True
        srv.join(timeout=60.0)
    finally:
        srv.stop()
        srv.close()
    recs = _records(journal)
    reqs = [r for r in recs
            if isinstance(r.get("key"), dict) and "request" in r["key"]]
    admitted = [r for r in reqs if r.get("status") == "admitted"]
    done = [r for r in reqs if r.get("status") == "done"]
    assert len(admitted) == 6 and len(done) == 6
    assert {r["backend"] for r in admitted} == {"torch_sim"}
    caches = [r.get("cache") for r in done]
    assert caches.count("hit") == 1 and caches.count("evict") == 1
    drains = [r for r in recs
              if isinstance(r.get("key"), dict) and "drain" in r["key"]]
    assert len(drains) == 1 and drains[0]["completed"] == 6
    rep = replay_journal(str(journal))
    assert rep["verdict"] == "REPRODUCED", rep["problems"]
    assert rep["completed"] == [1, 2, 3, 4, 5, 6] and rep["lost"] == []


def test_server_refusals_by_name(monkeypatch):
    from tpu_aggcomm_torch.device import NoCudaDeviceError

    assert SERVE_BACKENDS == ("torch_sim", "cuda_fused")
    with pytest.raises(ValueError, match="127.0.0.1 only"):
        ScheduleServer(host="0.0.0.0", device="cpu")
    with pytest.raises(ValueError, match="127.0.0.1 only"):
        ScheduleServer(host="0.0.0.0", metrics_port=0, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        ScheduleServer(backend="jax_sim", device="cpu")
    # --metrics-port (or the env var) arms a loopback /metrics endpoint
    # whose URL the ready line announces
    monkeypatch.delenv("TPU_AGGCOMM_METRICS_PORT", raising=False)
    for port, env in ((0, None), (None, "0")):
        if env is not None:
            monkeypatch.setenv("TPU_AGGCOMM_METRICS_PORT", env)
        srv = ScheduleServer(metrics_port=port, device="cpu")
        try:
            url = srv.ready_info()["metrics_url"]
            assert url.startswith("http://127.0.0.1:")
            assert url == srv.stats()["metrics_url"]
        finally:
            srv.close()
    monkeypatch.delenv("TPU_AGGCOMM_METRICS_PORT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        ScheduleServer()


@pytest.mark.parametrize("op", ["swap", "demote"])
def test_swap_and_demote_refused_by_name(op):
    """A malformed promotion record is refused by the named problems of
    ``pilot/promote.validate_promotion_record``; nothing is installed.
    (The working ops are ``tests/test_torch_pilot.py``'s.)"""
    srv = ScheduleServer(port=0, device="cpu")
    srv.start()
    try:
        with ServeClient(srv.port, timeout=60.0) as c:
            resp = (c.swap({"old_method": 1}) if op == "swap"
                    else c.demote({"old_method": 1}, "regressed"))
            assert resp["ok"] is False and resp["op"] == op
            assert resp["error"].startswith(
                f"{op} refused: record field 'shape' must be dict")
            assert "record field 'new_method' must be int" in resp["error"]
            assert c.stats()["promotions"] == []
    finally:
        srv.stop()
        srv.close()


# ---------------------------------------------------------------------------
# Overload protection (the executor faked, as the reference's tests do)


@pytest.fixture
def fake_executor(monkeypatch):
    calls = {"build": 0, "exec": 0}
    gate = threading.Event()
    gate.set()
    entered = threading.Event()

    def fake_build(schedule, backend_name, **kw):
        calls["build"] += 1
        entered.set()
        assert gate.wait(120.0), "test gate never released"
        return object(), 1e-3

    def fake_exec(chain, reqs):
        calls["exec"] += 1
        return [{"verified": True if r.verify else None, "error": None}
                for r in reqs]

    monkeypatch.setattr(executor, "build_chain", fake_build)
    monkeypatch.setattr(executor, "execute_batch", fake_exec)
    return SimpleNamespace(calls=calls, gate=gate, entered=entered)


def _wait_queue_depth(port, depth, timeout=60.0):
    with ServeClient(port, timeout=30.0) as c:
        deadline = time.monotonic() + timeout
        while c.health()["queue_depth"] < depth:
            assert time.monotonic() < deadline, "queue never filled"
            time.sleep(0.01)


def test_admission_queue_full_sheds_by_name(fake_executor):
    fake_executor.gate.clear()
    srv = ScheduleServer(port=0, max_queue=2, max_batch=1,
                         batch_window_s=0.0, device="cpu")
    srv.start()
    results = []
    try:
        def fire(i):
            with ServeClient(srv.port, timeout=120.0) as c:
                results.append(c.run(**dict(_SHAPE, iter=i)))

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(3)]
        threads[0].start()
        assert fake_executor.entered.wait(60.0)
        for t in threads[1:]:
            t.start()
        _wait_queue_depth(srv.port, 2)
        with ServeClient(srv.port, timeout=60.0) as probe:
            shed = probe.run(**dict(_SHAPE, iter=99))
        assert shed["ok"] is False and shed["shed"] == "queue-full"
        assert shed["error"].startswith("SHED[queue-full]")
        assert "queue depth 2" in shed["error"]
        assert "--max-queue 2" in shed["error"]
        fake_executor.gate.set()
        for t in threads:
            t.join(timeout=120.0)
        assert len(results) == 3 and all(r["ok"] for r in results)
    finally:
        fake_executor.gate.set()
        srv.stop()
        srv.close()


def test_deadline_expired_sheds_at_fenced_boundary(fake_executor,
                                                   tmp_path):
    fake_executor.gate.clear()
    journal = tmp_path / "serve.journal.jsonl"
    srv = ScheduleServer(port=0, max_batch=1, batch_window_s=0.0,
                         journal_path=str(journal), device="cpu")
    srv.start()
    out = {}
    try:
        def fire(name, **extra):
            with ServeClient(srv.port, timeout=120.0) as c:
                out[name] = c.run(**dict(_SHAPE, **extra))

        t1 = threading.Thread(target=fire, args=("head",),
                              kwargs={"iter": 0})
        t1.start()
        assert fake_executor.entered.wait(60.0)
        t2 = threading.Thread(target=fire, args=("late",),
                              kwargs={"iter": 1, "deadline_ms": 50.0})
        t2.start()
        _wait_queue_depth(srv.port, 1)
        time.sleep(0.2)              # the soft budget lapses in-queue
        fake_executor.gate.set()
        t1.join(timeout=120.0)
        t2.join(timeout=120.0)
        assert out["head"]["ok"] is True
        late = out["late"]
        assert late["ok"] is False and late["shed"] == "deadline-expired"
        assert "never mid-kernel" in late["error"]
        assert fake_executor.calls["build"] == 1
    finally:
        fake_executor.gate.set()
        srv.stop()
        srv.close()
    rep = replay_journal(str(journal))
    assert rep["verdict"] == "REPRODUCED", rep["problems"]
    assert rep["completed"] == [1] and rep["shed"] == [2]


def _predict(root, platforms):
    from tpu_aggcomm_torch.model import PARAM_NAMES
    (root / "PREDICT_r99.json").write_text(json.dumps(
        {"platforms": {p: {"params": {k: v for k in PARAM_NAMES}}
                       for p, v in platforms.items()}}))


def test_deadline_floor_presheds_on_its_own_platform(fake_executor,
                                                     tmp_path):
    _predict(tmp_path, {"cpu": 1000.0})
    srv = ScheduleServer(port=0, max_batch=1, batch_window_s=0.0,
                         predict_root=str(tmp_path), device="cpu")
    srv.start()
    try:
        with ServeClient(srv.port, timeout=60.0) as c:
            shed = c.run(**dict(_SHAPE, deadline_ms=1.0))
            assert shed["ok"] is False and shed["shed"] == "deadline_floor"
            assert "provably cannot meet its deadline" in shed["error"]
            assert fake_executor.calls["build"] == 0
            assert c.run(**dict(_SHAPE, iter=1))["ok"] is True
    finally:
        srv.stop()
        srv.close()


@pytest.mark.parametrize("platforms,want", [
    ({"cpu": 1000.0, "tpu": 5.0}, None),        # no gpu entry: off
    ({"cpu": 1000.0, "gpu": 2.0}, 2.0),         # only its own entry
    (None, None),                               # the committed artifact
])
def test_floor_on_the_card_reads_only_the_gpu_entry(tmp_path, capsys,
                                                    platforms, want):
    """A server on the card takes the ``gpu`` entry and never falls back
    to the ``cpu`` one; without it the floor is off, said once."""
    root = REPO if platforms is None else str(tmp_path)
    if platforms is not None:
        _predict(tmp_path, platforms)
    srv = ScheduleServer(port=0, predict_root=root, device="cpu")
    try:
        srv._platform = "gpu"          # what device="cuda" sets
        got = srv._load_floor_params()
        err = capsys.readouterr().err
        if want is None:
            assert got is None
            assert "no 'gpu' platform entry" in err
            assert "deadline_floor pre-shed disabled" in err
        else:
            assert set(got["params"].values()) == {want}
    finally:
        srv.close()


def test_exhausted_admit_flips_degraded_and_sheds_by_name(monkeypatch,
                                                          fake_executor):
    from tpu_aggcomm_torch.resilience import policy as rpolicy
    monkeypatch.setenv("TPU_AGGCOMM_CHAOS", "serve:admit:5")
    rpolicy._reset_chaos()
    try:
        srv = ScheduleServer(
            port=0, max_batch=1, batch_window_s=0.0, device="cpu",
            retry_policy=rpolicy.RetryPolicy(max_attempts=2,
                                             backoff_base_s=0.001,
                                             jitter_frac=0.0))
        srv.start()
        try:
            with ServeClient(srv.port, timeout=60.0) as c:
                first = c.run(**_SHAPE)
                assert first["ok"] is False
                assert "admit failed" in first["error"]
                second = c.run(**dict(_SHAPE, iter=1))
                assert second["shed"] == "degraded"
                assert "DEGRADED" in second["error"]
                h = c.health()
                assert h["state"] == "degraded"
                assert "retry budget exhausted" in h["degraded_reason"]
        finally:
            srv.stop()
            srv.close()
    finally:
        rpolicy._reset_chaos()


def test_connection_limit_sheds_framed_line(fake_executor):
    srv = ScheduleServer(port=0, max_conns=1, device="cpu")
    srv.start()
    a = ServeClient(srv.port, timeout=60.0)
    try:
        assert a.stats()["ok"]       # holds the single handler slot
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=30.0) as s:
            line = s.makefile("r", encoding="utf-8").readline()
        rec = json.loads(line)
        assert rec["ok"] is False and rec["shed"] == "connection-limit"
        assert "--max-conns" in rec["error"]
    finally:
        a.close()
        srv.stop()
        srv.close()


# ---------------------------------------------------------------------------
# Crash recovery


def _port_journal(tmp_path, backend, *, drifted=False):
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.resilience.journal import RunJournal

    man = ledger.manifest()
    if drifted:
        man.setdefault("versions", {})["torch"] = "drifted-for-test"
    shape = dict(_SHAPE, proc_node=1, agg_type=0, barrier_type=0,
                 fault=None)
    path = str(tmp_path / "crashed.journal.jsonl")
    j = RunJournal(path)
    fp = j.begin_session(man)
    j.record({"request": 1}, fingerprint=fp, status="admitted",
             shape=shape, backend=backend, iter=0)
    j.record({"request": 1}, fingerprint=fp, status="done", cache="miss")
    j.record({"request": 2}, fingerprint=fp, status="admitted",
             shape=shape, backend=backend, iter=1)   # lost in flight
    return path


def test_recover_prewarms_and_the_first_request_hits(tmp_path):
    journal = _port_journal(tmp_path, "torch_sim")
    srv = ScheduleServer(port=0, recover=journal, max_batch=1,
                         batch_window_s=0.0, device="cpu")
    try:
        rec = srv.ready_info()["recover"]
        assert rec["verdict"] == "REPRODUCED"
        assert rec["completed"] == [1] and rec["lost"] == [2]
        assert rec["prewarmed"] == 1 and rec["skipped"] == []
        srv.start()
        with ServeClient(srv.port, timeout=60.0) as c:
            r = c.run(**dict(_SHAPE, iter=7, verify=True))
            assert r["ok"] and r["cache"] == "hit" and r["verified"]
            assert r["compile_s"] is None
            assert c.stats()["cache"]["prewarmed"] == 1
    finally:
        srv.stop()
        srv.close()


@pytest.mark.parametrize("backend", ["jax_sim", "pallas_fused"])
def test_reference_journal_shapes_are_skipped_by_name(tmp_path, backend):
    """A reference journal's shapes name the reference's backends: each is
    skipped by name, never aliased to torch_sim or cuda_fused, even under
    this process's own fingerprint."""
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.tune.cache import manifest_fingerprint

    journal = _port_journal(tmp_path, backend)
    man = ledger.manifest()
    warm, skips = prewarm_plan(replay_journal(journal),
                               fingerprint=manifest_fingerprint(man),
                               manifest=man)
    assert warm == [] and len(skips) == 1
    assert f"backend {backend!r} is not a chain backend" in skips[0]
    assert "never aliased" in skips[0]
    srv = ScheduleServer(port=0, recover=journal, device="cpu")
    try:
        rec = srv.ready_info()["recover"]
        assert rec["prewarmed"] == 0 and rec["skipped"] == skips
    finally:
        srv.close()


def test_prewarm_plan_drift_skips_by_name(tmp_path):
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.tune.cache import manifest_fingerprint

    journal = _port_journal(tmp_path, "torch_sim", drifted=True)
    man = ledger.manifest()
    warm, skips = prewarm_plan(replay_journal(journal),
                               fingerprint=manifest_fingerprint(man),
                               manifest=man)
    assert warm == [] and len(skips) == 1
    assert "manifest drift" in skips[0] and "versions.torch" in skips[0]


# ---------------------------------------------------------------------------
# The control plane without torch, and the wire


def test_control_plane_imports_without_torch(tmp_path):
    poison = tmp_path / "poison" / "torch"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('poisoned torch: the serve control plane must "
        "not import it')\n")
    mods = ["tpu_aggcomm_torch.serve", "tpu_aggcomm_torch.serve.protocol",
            "tpu_aggcomm_torch.serve.cache", "tpu_aggcomm_torch.serve.recover",
            "tpu_aggcomm_torch.serve.server", "tpu_aggcomm_torch.model",
            "tpu_aggcomm_torch.resilience.policy",
            "tpu_aggcomm_torch.obs.workload",
            "tpu_aggcomm_torch.tune.measure"]
    code = ("import " + ", ".join(mods) + ", sys\n"
            "from tpu_aggcomm_torch.serve import parse_request, "
            "request_schedule\n"
            "s = request_schedule(parse_request({'method': 1, 'nprocs': 8, "
            "'cb_nodes': 2, 'comm_size': 2}))\n"
            "assert 'torch' not in sys.modules\n"
            "try:\n    import tpu_aggcomm_torch.serve.executor\n"
            "except ImportError as e:\n    print('DOOR', e)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "poison"), REPO]))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DOOR poisoned torch" in r.stdout


def test_reference_loadgen_drives_cli_serve_over_the_wire(tmp_path):
    """``cli serve --device cpu`` prints one ready line; the reference's
    unchanged ``scripts/serve_loadgen.py --attach`` completes and
    verifies 8 requests on it; the journal replays REPRODUCED."""
    journal = tmp_path / "serve.journal.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_aggcomm_torch.cli", "serve",
         "--device", "cpu", "--journal", str(journal)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["serve"] == "ready" and ready["device"] == "cpu"
        assert ready["backend"] == "torch_sim"
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "serve_loadgen.py"),
             "--attach", str(ready["port"]), "--requests", "8",
             "--verify"],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        summary = json.loads(r.stdout.strip().splitlines()[-1])
        assert summary["completed"] == 8 and summary["verified"] == 8
        assert summary["errors"] == 0 and summary["shed"] == 0
        with ServeClient(ready["port"], timeout=60.0) as c:
            assert c.shutdown()["stopping"] is True
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert rest.strip() == ""            # exactly ONE ready line
    rep = replay_journal(str(journal))
    assert rep["verdict"] == "REPRODUCED", rep["problems"]
    assert len(rep["completed"]) == 8 and len(rep["drains"]) == 1


def test_cli_serve_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "tpu_aggcomm_torch.cli", "serve"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "NoCudaDeviceError: " in r.stderr
    assert '"serve": "ready"' not in r.stdout
