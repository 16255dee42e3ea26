"""The flight recorder's host spans inside the port.

The recorder (``obs/trace``) is free when off: ``span`` hands back the
shared no-op and a rep reads ``current()`` once. On, host spans nest
(``id``/``parent`` on one thread), their self and child times add up,
and their ends, moved by the recorded offset, lie on ``torch.profiler``'s
clock: a span around ``torch.zeros`` holds the profiler's ``aten::zeros``.
The benched layers carry spans: the build (``schedule.compile``,
``tables.edges``, ``tables.rounds``) and the rep (``rep`` holding
``rep.arena`` and ``rep.issue``, one ``rep.issue`` a round on
``torch_shard``), on ``torch_shard`` and ``cuda_fused`` (its plain
version on the CPU), with the same bytes traced or not. Sizes are n=8.
"""

import threading

import numpy as np
import pytest
import torch

from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
from tpu_aggcomm_torch.backends.lanes import lane_layout
from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.harness.verify import slot_shapes
from tpu_aggcomm_torch.native import fuse
from tpu_aggcomm_torch.obs import ledger, perfetto, trace

#: (method, cb_nodes, comm_size) at n=8: all-to-many and many-to-all,
#: throttled to one edge a round, to two, and not at all
SHAPES = [(1, 3, 1), (1, 3, 2), (1, 3, 999), (2, 3, 2), (3, 4, 2)]


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


def _schedule(method=1, cb_nodes=3, comm_size=2, data_size=64):
    return compile_method(method, AggregatorPattern(
        nprocs=8, cb_nodes=cb_nodes, data_size=data_size,
        comm_size=comm_size))


def _spans(events, name=None):
    return [e for e in events if e["ev"] == "host_span"
            and (name is None or e["name"] == name)]


def _shard_send(rep, data_size, seed):
    _, dt, w = lane_layout(data_size)
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (rep.Fs, w * dt.itemsize), generator=g,
                         dtype=torch.uint8).view(dt)


def _dense_send(schedule, seed):
    n_send, _ = slot_shapes(schedule.pattern)
    _, dt, w = lane_layout(schedule.pattern.data_size)
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (schedule.pattern.nprocs, n_send,
                                  w * dt.itemsize), generator=g,
                         dtype=torch.uint8).view(dt)


# -- the recorder ------------------------------------------------------------

def test_span_off_is_the_shared_noop_and_records_nothing():
    assert trace.current() is None
    assert trace.span("rep") is trace._NOOP
    assert trace.span("rep.issue", round=3, edges=7) is trace._NOOP
    idle = trace.TraceRecorder(manifest=False)
    s = _schedule()
    rep = TorchShardBackend(device="cpu").one_rep(s)
    rep(_shard_send(rep, 64, 0))
    frep = CudaFusedBackend(device="cpu").one_rep(s)
    frep(_dense_send(s, 0))
    assert [e["ev"] for e in idle.events] == ["meta"]
    assert trace.current() is None


def test_spans_nest_on_their_thread():
    rec = trace.enable(manifest=False)
    with trace.span("outer", k=1):
        with trace.span("a"):
            with trace.span("a.inner"):
                pass
        with trace.span("b"):
            pass
    with trace.span("after"):
        pass
    by = {e["name"]: e for e in _spans(rec.events)}
    assert by["outer"]["parent"] is None and by["after"]["parent"] is None
    assert by["a"]["parent"] == by["b"]["parent"] == by["outer"]["id"]
    assert by["a.inner"]["parent"] == by["a"]["id"]
    assert by["outer"]["args"] == {"k": 1}
    # children end before their parent is recorded, inside its window
    names = [e["name"] for e in _spans(rec.events)]
    assert names == ["a.inner", "a", "b", "outer", "after"]
    for child, parent in (("a", "outer"), ("b", "outer"), ("a.inner", "a")):
        c, p = by[child], by[parent]
        assert p["start_ns"] <= c["start_ns"] <= c["end_ns"] <= p["end_ns"]
    for e in by.values():
        assert e["dur"] == pytest.approx((e["end_ns"] - e["start_ns"]) / 1e3)
        assert e["ts"] == pytest.approx((e["start_ns"] - rec._t0_ns) / 1e3)
    assert len({e["id"] for e in by.values()}) == 5


def test_spans_of_another_thread_have_their_own_parents():
    rec = trace.enable(manifest=False)
    entered, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("worker"):
            entered.set()
            release.wait(10)

    with trace.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        entered.wait(10)
        with trace.span("main.child"):
            pass
        release.set()
        t.join(10)
    by = {e["name"]: e for e in _spans(rec.events)}
    assert by["worker"]["parent"] is None
    assert by["main.child"]["parent"] == by["main"]["id"]


def test_self_and_child_time_arithmetic():
    def ev(i, name, parent, ts, dur):
        return {"ev": "host_span", "name": name, "id": i, "parent": parent,
                "ts": ts, "dur": dur, "args": {}}

    events = [{"ev": "meta"},
              ev(1, "rep.arena", 0, 1.0, 2.5), ev(2, "rep.issue", 0, 4.0, 3.0),
              ev(3, "rep.issue", 0, 8.0, 1.5), ev(0, "rep", None, 0.0, 10.0),
              ev(5, "rep.arena", 4, 21.0, 1.0), ev(6, "inner", 5, 21.5, 0.25),
              ev(4, "rep", None, 20.0, 4.0),
              ev(7, "rep.issue", None, 30.0, 9.0)]
    assert trace.span_self_us(events, "rep") == [3.0, 3.0]
    assert trace.span_child_us(events, "rep", "rep.issue") == [4.5, 0.0]
    assert trace.span_child_us(events, "rep", "rep.arena") == [2.5, 1.0]
    assert trace.span_self_us(events, "rep.arena") == [2.5, 0.75]
    assert trace.span_total_s(events, "rep.issue") == pytest.approx(13.5e-6)
    assert trace.span_total_s(events, "missing") == 0.0
    # self + children = the span, rep by rep
    for self_us, arena, issue, rep in zip(
            trace.span_self_us(events, "rep"),
            trace.span_child_us(events, "rep", "rep.arena"),
            trace.span_child_us(events, "rep", "rep.issue"),
            _spans(events, "rep")):
        assert self_us + arena + issue == rep["dur"]


def test_lean_recorder_collects_no_manifest(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("manifest collected")

    monkeypatch.setattr(ledger, "manifest", boom)
    rec = trace.enable(manifest=False)
    assert [e["ev"] for e in rec.events] == ["meta"]
    assert isinstance(rec.profiler_offset_ns, int)


def test_full_recorder_keeps_the_ledger_preamble_and_exports():
    rec = trace.enable()
    assert [e["ev"] for e in rec.events][:2] == ["meta", "ledger"]
    with trace.span("outer", k=2):
        with trace.span("inner"):
            pass
    chrome = perfetto.to_chrome_trace(rec.events)
    got = {e["name"]: e for e in chrome["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "host"}
    assert set(got) == {"outer", "inner"}
    assert got["outer"]["args"] == {"k": 2}
    assert got["outer"]["ts"] <= got["inner"]["ts"]
    assert "host-measured events: 2 spans" in trace.summarize_events(
        rec.events)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_one_clock_a_port_span_holds_the_aten_op_it_wraps():
    rec = trace.enable(manifest=False)

    def body():
        with trace.span("port.zeros"):
            torch.zeros(1 << 16)

    events = _profiled(body)
    (span,) = _spans(rec.events, "port.zeros")
    off = rec.profiler_offset_ns
    s0, s1 = span["start_ns"] + off, span["end_ns"] + off
    zeros = [(a, b) for name, a, b in events if name == "aten::zeros"]
    assert len(zeros) == 1
    z0, z1 = zeros[0]
    assert s0 <= z0 <= z1 <= s1
    # the profiler's own range of the span, on its clock, inside it too
    ranges = [(a, b) for name, a, b in events if name == "port.zeros"]
    assert len(ranges) == 1
    r0, r1 = ranges[0]
    assert s0 <= r0 <= z0 <= z1 <= r1 <= s1


def test_no_profiler_range_while_off_or_unprofiled():
    def body():
        with trace.span("port.zeros"):
            torch.zeros(8)

    assert "port.zeros" not in {name for name, *_ in _profiled(body)}
    rec = trace.enable(manifest=False)
    body()          # no profiler: the span alone
    assert len(_spans(rec.events, "port.zeros")) == 1


# -- the build ---------------------------------------------------------------

def test_compile_method_records_schedule_compile():
    rec = trace.enable(manifest=False)
    _schedule(3, 4, 2)
    (span,) = _spans(rec.events)
    assert span["name"] == "schedule.compile" and span["parent"] is None


def test_torch_shard_build_records_edges_then_rounds():
    s = _schedule(2, 3, 2)
    rec = trace.enable(manifest=False)
    b = TorchShardBackend(device="cpu")
    b.one_rep(s)
    names = [e["name"] for e in _spans(rec.events)]
    assert names == ["tables.edges", "tables.rounds", "tables.rounds"]
    assert all(e["parent"] is None for e in _spans(rec.events))
    b.one_rep(s)    # cached: no second build
    assert len(_spans(rec.events)) == 3


def test_cuda_fused_build_records_edges_then_rounds():
    s = _schedule()
    rec = trace.enable(manifest=False)
    CudaFusedBackend(device="cpu").one_rep(s)
    assert [e["name"] for e in _spans(rec.events)] == ["tables.edges",
                                                       "tables.rounds"]


# -- the rep -----------------------------------------------------------------

@pytest.mark.parametrize("method,cb_nodes,comm_size", SHAPES)
def test_torch_shard_rep_spans_and_bytes(method, cb_nodes, comm_size):
    s = _schedule(method, cb_nodes, comm_size)
    b = TorchShardBackend(device="cpu")
    rep = b.one_rep(s)
    built = b._compiled(s)
    sends = [_shard_send(rep, 64, k) for k in range(3)]
    plain = [rep(x) for x in sends]
    rec = trace.enable(manifest=False)
    traced = [rep(x) for x in sends]
    trace.disable()
    again = [rep(x) for x in sends]
    for a, t, c in zip(plain, traced, again):
        assert torch.equal(a, t) and torch.equal(a, c)
    reps = _spans(rec.events, "rep")
    assert len(reps) == 3 and all(e["parent"] is None for e in reps)
    edges = s.data_edges()
    rounds = sorted({int(r) for r in edges[:, 4]})
    assert [r for (r, _t, _nb) in built.rounds] == rounds
    for r in reps:
        kids = [e for e in _spans(rec.events) if e["parent"] == r["id"]]
        assert [e["name"] for e in kids] == (
            ["rep.arena"] + ["rep.issue"] * len(rounds))
        issues = kids[1:]
        assert [e["args"]["round"] for e in issues] == rounds
        assert [e["args"]["edges"] for e in issues] == [
            int((edges[:, 4] == rnd).sum()) for rnd in rounds]
    assert len(_spans(rec.events)) == 3 * (2 + len(rounds))


def test_torch_shard_scanned_rep_counts_each_rounds_own_edges():
    """At 32 rounds or more the tables are padded to the widest round;
    a ``rep.issue`` still names the round's real edges."""
    s = compile_method(1, AggregatorPattern(nprocs=64, cb_nodes=8,
                                            data_size=16, comm_size=1))
    b = TorchShardBackend(device="cpu")
    rep = b.one_rep(s)
    edges = s.data_edges()
    rounds = sorted({int(r) for r in edges[:, 4]})
    assert len(rounds) >= 32
    send = _shard_send(rep, 16, 5)
    want = rep(send)
    rec = trace.enable(manifest=False)
    assert torch.equal(rep(send), want)
    issues = _spans(rec.events, "rep.issue")
    assert [e["args"]["edges"] for e in issues] == [
        int((edges[:, 4] == rnd).sum()) for rnd in rounds]
    assert sum(e["args"]["edges"] for e in issues) == len(edges)


def test_torch_shard_one_rep_is_the_run_rep_and_carries_its_layout():
    s = _schedule(1, 3, 2)
    b = TorchShardBackend(device="cpu")
    rep = b.one_rep(s)
    built = b._compiled(s)
    assert rep is built.rep and b.one_rep(s) is rep
    assert (rep.F, rep.Fs) == (built.F, built.Fs)
    for key in ("counts", "send_base", "recv_base"):
        assert np.array_equal(getattr(rep, key), getattr(built, key))
    # the layout places every receiver's slots: the row map reads back
    send = _shard_send(rep, 64, 9)
    out = rep(send)
    assert out.shape[0] == rep.F and send.shape[0] == rep.Fs
    p = s.pattern
    for rank in range(p.nprocs):
        assert (rep.recv_base[rank] >= 0) == bool(rep.counts[rank])


def test_torch_shard_run_nests_the_rep_in_its_dispatch_span():
    s = _schedule(1, 3, 2)
    rec = trace.enable(manifest=False)
    TorchShardBackend(device="cpu").run(s, ntimes=2, verify=True)
    dispatch = _spans(rec.events, "torch_shard.dispatch")
    reps = _spans(rec.events, "rep")
    # the warm-up rep, then one inside each timed dispatch
    assert len(dispatch) == 2 and len(reps) == 3
    assert reps[0]["parent"] is None
    assert [r["parent"] for r in reps[1:]] == [d["id"] for d in dispatch]


def test_torch_shard_chain_steps_are_traced_reps():
    s = _schedule(1, 3, 2)
    b = TorchShardBackend(device="cpu")
    built = b._compiled(s)
    rounds = len(built.rounds)
    send = _shard_send(built.rep, 64, 2)
    off = built.make_chain()(3)(send)
    rec = trace.enable(manifest=False)
    on = built.make_chain()(3)(send)
    assert torch.equal(off, on) and not torch.equal(off, send)
    assert len(_spans(rec.events, "rep")) == 3
    assert len(_spans(rec.events, "rep.issue")) == 3 * rounds


@pytest.mark.parametrize("method,cb_nodes,comm_size",
                         [(1, 3, 1), (1, 3, 2), (2, 3, 2), (3, 4, 2)])
def test_cuda_fused_cpu_rep_spans_and_bytes(method, cb_nodes, comm_size):
    s = _schedule(method, cb_nodes, comm_size)
    rep = CudaFusedBackend(device="cpu").one_rep(s)
    sends = [_dense_send(s, k) for k in range(2)]
    launches = fuse.fused_rep.launches
    plain = [rep(x) for x in sends]
    rec = trace.enable(manifest=False)
    traced = [rep(x) for x in sends]
    into = [fuse.fused_rep(x, rep.tables, torch.full_like(plain[0], 7))
            for x in sends]
    trace.disable()
    for a, t, i in zip(plain, traced, into):
        assert torch.equal(a, t) and torch.equal(a, i)
    assert fuse.fused_rep.launches == launches
    reps = _spans(rec.events, "rep")
    assert len(reps) == 4
    trees = [[e["name"] for e in _spans(rec.events)
              if e["parent"] == r["id"]] for r in reps]
    # a fresh arena is allocated inside the rep; a caller's ``out`` is not
    assert trees == [["rep.arena", "rep.issue"]] * 2 + [["rep.issue"]] * 2
    for self_us, r in zip(trace.span_self_us(rec.events, "rep"), reps):
        assert 0.0 <= self_us <= r["dur"]


def test_cuda_fused_rep_refusals_are_the_same_traced():
    s = _schedule()
    rep = CudaFusedBackend(device="cpu").one_rep(s)
    bad = torch.zeros((3, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError) as off:
        rep(bad)
    rec = trace.enable(manifest=False)
    with pytest.raises(ValueError) as on:
        rep(bad)
    assert str(on.value) == str(off.value)
    (span,) = _spans(rec.events)
    assert span["name"] == "rep"
