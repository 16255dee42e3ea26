"""TAM (m=15/16) on ``torch_shard``'s one-device path: the relay.

The relay's orders (``tam/relay.relay_orders``) equal the loop build
they replaced and the JAX package's ``_tam_tables``, on contiguous and
round-robin node maps. With no process group ``TorchShardBackend`` runs
TAM as three row deliveries over m=1/m=2's compacted layouts; on seeded
random bytes each hop's arena equals the plain relay
(``aggbench/reference/tam.py``) and the delivered arena equals it and the
JAX package's TAM. The benchmark's adapter builds it unedited, its new
cells run and fail on faults on the CPU, and the Theta p64 orders build
in numpy. Under a group the blocked engine is unchanged
(``tests/test_torch_shard.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends import jax_sim as ref_sim  # noqa: E402
from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.core import topology as ref_topology  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.tam import engine as ref_engine  # noqa: E402

from aggbench import harness  # noqa: E402
from aggbench.reference.exchange import exchange  # noqa: E402
from aggbench.reference.roles import roles  # noqa: E402
from aggbench.reference.tam import relay  # noqa: E402
from tpu_aggcomm_torch.backends import deliver_rows as dr  # noqa: E402
from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import lane_layout  # noqa: E402
from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend  # noqa: E402
from tpu_aggcomm_torch.core import topology  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction  # noqa: E402
from tpu_aggcomm_torch.harness.verify import slot_shapes  # noqa: E402
from tpu_aggcomm_torch.obs import trace  # noqa: E402
from tpu_aggcomm_torch.tam import engine  # noqa: E402
from tpu_aggcomm_torch.tam.relay import relay_orders  # noqa: E402
from torch_fill import filled_empty  # noqa: E402,F401

# (nprocs, cb_nodes, proc_node, placement, data_size): n in {8, 64, 256},
# -p in {1, 4, 64} with ragged last nodes (n=70 -p 64, n=10 -p 4), every
# placement, int32 lanes (d=2048) and byte lanes (d=6)
SHAPES = [(8, 3, 1, 0, 2048), (8, 3, 4, 1, 6), (64, 16, 4, 2, 2048),
          (64, 16, 64, 3, 6), (256, 16, 64, 1, 2048), (256, 16, 4, 0, 6),
          (70, 8, 64, 3, 2048), (10, 3, 4, 2, 6)]
TAM = [15, 16]
DIRECTION = {15: "all_to_many", 16: "many_to_all"}


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


def _config(shape):
    n, a, pn, t, d = shape
    return {"nprocs": n, "cb_nodes": a, "data_size": d, "proc_node": pn,
            "placement": t}


def _tam(method, shape, kind=0):
    """The port's and the JAX package's TAM schedules of ``shape``, on
    node map ``kind`` (0 contiguous, as ``compile_method``; 1
    round-robin)."""
    n, a, pn, t, d = shape
    s = compile_method(method, AggregatorPattern(n, a, data_size=d,
                                                 proc_node=pn, placement=t))
    rs = ref_compile(method, RefPattern(n, a, data_size=d, proc_node=pn,
                                        placement=t))
    if kind:
        s = engine.TamMethod(s.pattern, s.method_id, s.name,
                             topology.static_node_assignment(n, pn, kind))
        rs = ref_engine.TamMethod(
            rs.pattern, rs.method_id, rs.name,
            ref_topology.static_node_assignment(n, pn, kind))
    return s, rs


def _loop_tables(tam):
    """The walk ``_tam_tables`` was before the relay's orders: per node,
    each resident sender's slabs; per destination node, arrivals in that
    order."""
    p, na = tam.pattern, tam.assignment
    if p.direction is Direction.ALL_TO_MANY:
        senders, nslots = list(range(p.nprocs)), p.cb_nodes
        dest_of = lambda s, i: int(p.rank_list[i])           # noqa: E731
        slot_of = lambda s, i: s                             # noqa: E731
    else:
        senders, nslots = [int(r) for r in p.rank_list], p.nprocs
        dest_of = lambda s, i: i                             # noqa: E731
        slot_of = lambda s, i: int(p.agg_index[s])           # noqa: E731
    stage, pos = [], {}
    for node in range(na.nnodes):
        for s in senders:
            if int(na.node_of[s]) == node:
                for i in range(nslots):
                    pos[(s, i)] = len(stage)
                    stage.append((s, i))
    exch, dst, slot = [], [], []
    for node in range(na.nnodes):
        for (s, i) in stage:
            if int(na.node_of[dest_of(s, i)]) == node:
                exch.append(pos[(s, i)])
                dst.append(dest_of(s, i))
                slot.append(slot_of(s, i))
    return tuple(np.array(x, dtype=np.int32) for x in (
        [s * nslots + i for (s, i) in stage], exch, dst, slot))


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("shape", SHAPES[:4] + SHAPES[6:])
@pytest.mark.parametrize("method", TAM)
def test_relay_orders_equal_the_loop_build_and_the_reference(method, shape,
                                                             kind):
    s, rs = _tam(method, shape, kind)
    got = torch_sim._tam_tables(s)
    for want in (_loop_tables(s), ref_sim._tam_tables(rs)):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_theta_p64_orders_build_in_numpy():
    """The Theta job's 4,194,304 slabs at 64 ranks a node: node 0's
    proxy holds rank 0's slabs first; P3's first run goes to node 0
    (aggregator 0, rank 0), its last to node 255 (aggregator 255, rank
    16320), rank 16383's slab last."""
    s = compile_method(15, AggregatorPattern(16384, 256, data_size=2048,
                                             proc_node=64))
    o = relay_orders(s.pattern, s.assignment)
    assert o.n_slabs == 16384 * 256 and o.nslots == 256
    for a in (o.stage_src, o.stage_slot, o.exch, o.dst, o.dst_slot):
        assert a.shape == (16384 * 256,) and a.dtype == np.int32
    assert (o.stage_src[[0, -1]].tolist(), o.stage_slot[[0, -1]].tolist()) \
        == ([0, 16383], [0, 255])
    assert o.exch[[0, 1, -1]].tolist() == [0, 256, 16384 * 256 - 1]
    assert o.dst[[0, -1]].tolist() == [0, 16320]
    assert o.dst_slot[[0, -1]].tolist() == [0, 16383]


def _dense_bytes(tam, seed):
    """Seeded random bytes in the dense ``(n, send slots, d)`` layout."""
    n_send, _ = slot_shapes(tam.pattern)
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (tam.pattern.nprocs, n_send,
                                  tam.pattern.data_size), generator=g,
                         dtype=torch.uint8)


def _lanes(b: torch.Tensor) -> torch.Tensor:
    _, dt, _w = lane_layout(b.shape[-1])
    return b.contiguous().view(dt)


def _compact_send(built, dense, senders):
    """torch_shard's (Fs, w) send arena of ``dense``'s senders."""
    nslots = dense.shape[1]
    send = torch.zeros((built.Fs, dense.shape[-1]), dtype=torch.uint8)
    for s in senders:
        b = int(built.send_base[s])
        send[b:b + nslots] = dense[s]
    return _lanes(send)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_relay_hop_by_hop_equals_the_plain_relay_and_the_reference(
        method, shape, filled_empty):
    """Each hop's arena, over ``torch.empty`` memory torch fills, equals
    the plain relay's buffer; the delivered slabs equal it, the plain
    exchange and the JAX package's TAM on the same bytes; the trash row
    is zero."""
    s, rs = _tam(method, shape)
    cfg, direction = _config(shape), DIRECTION[method]
    r = roles(cfg, direction)
    assert list(r.senders) == (list(range(s.nprocs)) if method == 15
                               else s.pattern.rank_list.tolist())
    dense = _dense_bytes(s, seed=sum(shape) + method)
    built = TorchShardBackend("cpu")._compiled(s)
    stages = []
    recv = built.rep(_compact_send(built, dense, r.senders), stages=stages)
    assert len(stages) == 3 and stages[-1] is recv
    d, E = cfg["data_size"], len(r.senders) * len(r.receivers)

    def slabs(t):
        return t.view(torch.uint8).reshape(t.shape[0], -1)[:, :d]

    ours = torch.stack([dense[x, :len(r.receivers)] for x in r.senders])
    p2, p3, delivered = relay(ours, cfg, direction)
    assert stages[0].shape[0] == stages[1].shape[0] == E
    assert torch.equal(slabs(stages[0]), p2)
    assert torch.equal(slabs(stages[1]), p3)
    assert torch.equal(delivered, exchange(ours))

    got = slabs(recv)
    rb, counts = built.recv_base, built.counts
    want = np.asarray(jax.jit(JaxSimBackend()._tam_rep(rs))(
        np.ascontiguousarray(_lanes(dense).numpy()).view(
            np.uint32 if d % 4 == 0 else np.uint8)))
    want = want.view(np.uint8).reshape(*want.shape[:2], -1)
    for k, x in enumerate(r.receivers):
        mine = got[int(rb[x]):int(rb[x]) + int(counts[x])]
        assert torch.equal(mine, delivered[k])
        np.testing.assert_array_equal(mine.numpy(), want[x, :int(counts[x])])
    assert int(got[built.F - 1].count_nonzero()) == 0


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[6]])
@pytest.mark.parametrize("method", TAM)
def test_layout_and_bytes_are_m1s_and_m2s(method, shape):
    """The relay keeps m=1's (m=15) and m=2's (m=16) compacted layouts on
    the same pattern, and delivers their flat arena, trash row
    included."""
    b = TorchShardBackend("cpu")
    s, _rs = _tam(method, shape)
    direct = compile_method(method - 14, s.pattern)
    x, y = b._compiled(s), b._compiled(direct)
    assert (x.F, x.Fs) == (y.F, y.Fs)
    for f in ("send_base", "recv_base", "counts"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert x.rounds == [] and len(x.relay) == 3
    np.testing.assert_array_equal(b.run_flat(s, 2), b.run_flat(direct, 2))


@pytest.mark.parametrize("method", TAM)
def test_run_takes_the_relay_with_no_group(method):
    """``run`` of m=15/16 with no group: the relay, verified, plain and
    chained, through the shared serial-chain scaffold; each rep three
    hops, each its own pass (even P2's identity order at ``-p 4``)."""
    b = TorchShardBackend("cpu")
    s = compile_method(method, AggregatorPattern(16, 5, data_size=32,
                                                 proc_node=4))
    calls = []
    plain = dr.deliver_rows_plain

    def counted(send, recv, tabs, zero=None):
        calls.append(None if tabs is None else tabs.n_rows)
        return plain(send, recv, tabs, zero)

    dr.deliver_rows_plain = counted
    try:
        recv, timers = b.run(s, verify=True, ntimes=2)
    finally:
        dr.deliver_rows_plain = plain
    assert b.last_route == "relay"
    assert b.last_provenance == ("torch_shard", "attributed")
    assert calls == [16 * 5] * 9                 # warm-up + 2 reps, 3 hops
    assert timers[0].total_time > 0
    assert sum(x is not None for x in recv) == (5 if method == 15 else 16)
    _recv, timers = b.run(s, verify=True, chained=True)
    assert (b.last_route, b.last_provenance) == (
        "relay", ("torch_shard", "attributed-chained"))
    assert timers[0].total_time > 0 and b.measure_per_rep(s) > 0
    with pytest.raises(ValueError, match="measured phases"):
        b.run(s, measured_phases=True)
    with pytest.raises(ValueError, match="round-structured"):
        b.measure_round_times(s)
    with pytest.raises(ValueError, match="no round prefixes"):
        b._compiled(s).rep(b._send(s.pattern, 0, b._compiled(s)), 1)


def test_a_group_keeps_the_blocked_engine():
    """With a process group (or a split asking for more devices) TAM is
    not the relay: ``_compiled`` refuses it and ``run`` keeps the blocked
    engine's route."""
    s = compile_method(15, AggregatorPattern(16, 5, data_size=32,
                                             proc_node=4))
    b = TorchShardBackend("cpu")
    b._coll = object()
    assert not b._relay_applies(s)
    with pytest.raises(TypeError, match="blocked engine"):
        b._compiled(s)
    split = TorchShardBackend("cpu", ranks_per_device=8)
    assert not split._relay_applies(s)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        split.run(s)
    assert split.last_route == "blocked"
    assert TorchShardBackend("cpu", ranks_per_device=16)._relay_applies(s)


def test_spans_and_counter_of_the_relay():
    """``tables.relay`` around the build; in each ``rep`` three
    ``rep.hop`` (``hop`` 1-3, ``rows`` the slabs), each after its
    arena's ``rep.arena``; ``deliver_rows.relay_hops`` counts the hops;
    the bytes are the same traced or not."""
    s = compile_method(16, AggregatorPattern(12, 3, data_size=64,
                                             proc_node=4, placement=3))
    rec = trace.enable(manifest=False)
    b = TorchShardBackend("cpu")
    built = b._compiled(s)
    send = b._send(s.pattern, 1, built)
    before = dr.deliver_rows.relay_hops
    traced = built.rep(send)
    trace.disable()
    assert dr.deliver_rows.relay_hops == before + 3
    assert torch.equal(traced, built.rep(send))
    assert dr.deliver_rows.relay_hops == before + 6
    spans = [e for e in rec.events if e["ev"] == "host_span"]
    names = [e["name"] for e in spans]
    assert names.count("tables.relay") == 1 and names.count("rep") == 1
    hops = [e for e in spans if e["name"] == "rep.hop"]
    assert [e["args"] for e in hops] == [{"hop": k, "rows": 36}
                                         for k in (1, 2, 3)]
    (outer,) = [e for e in spans if e["name"] == "rep"]
    inside = [e["name"] for e in spans if e.get("parent") == outer["id"]]
    assert inside == ["rep.arena", "rep.hop"] * 3


def test_the_adapter_builds_the_relay_at_n256_p64():
    """``aggbench/backends/torch_shard.py``, unedited, builds TAM's rep at
    n=256 ``-p 64`` (its layout check passes) and the judgement finds
    every slab in place; the control misses each self slab."""
    from aggbench.payload import blocks
    from aggbench.reference.exchange import wrong_slabs
    cfg = {"nprocs": 256, "cb_nodes": 16, "data_size": 256, "proc_node": 64,
           "placement": 1}
    traffic = {"method": 15, "direction": "all_to_many",
               "comm_size": 999_999_999}
    r = roles(cfg, "all_to_many")
    bench = harness.Bench()
    for name, bad in (("torch_shard", 0), ("control", 16)):
        ad = bench.plugin("backends", name).Adapter(cfg, traffic, r, "cpu")
        ad.library()
        ad.build()
        send = ad.new_send()
        for i0, i1, block in blocks(5, 0, 256, 16, 256, "cpu"):
            ad.put_send(send, i0, i1, block)
        out = ad.rep(send)
        assert wrong_slabs(ad.recv_view(out), 5, 0, 256, 16, 256) == bad
        assert ad.stray_bytes(out) == 0


@pytest.mark.parametrize("traffic", ["a2m_tam_torch_shard",
                                     "m2a_unthrottled_torch_shard"])
def test_new_cells_run_and_fail_on_faults_on_the_cpu(traffic, tmp_path):
    """The two new traffic mixes as whole runs of a small cell (n=16,
    ``-p 4``): sound runs are ``correct``; a rep that alters one byte is
    not."""
    import sys
    import types

    from aggbench.tests.conftest import TINY, make_root
    root = make_root(tmp_path, dict(TINY, name="tiny4", nprocs=16,
                                    proc_node=4))
    bench = harness.Bench(root)
    cell = f"tiny4.{traffic}"
    s = harness.Session(bench, cell, "cpu")
    rec, checks, failed = s.measure(2**31 + 977, 0.2, False)
    assert harness.passed(checks) and failed == 0 and rec.exchanges > 0

    base = bench.plugin("backends", "torch_shard").Adapter

    class Altered(base):
        def build(self):
            super().build()
            real = self.rep

            def rep(send):
                out = real(send)
                out.view(torch.uint8)[0, 0] ^= 1
                return out
            self.rep = rep

    mod = types.ModuleType("aggbench.backends.altered_relay")
    mod.Adapter = Altered
    sys.modules[mod.__name__] = mod
    try:
        bad = harness.Session(bench, cell, "cpu", backend="altered_relay")
        _rec, checks, failed = bad.measure(3, 0.2, False)
    finally:
        del sys.modules[mod.__name__]
    assert not harness.passed(checks)
    assert checks["wrong_slabs"]["value"] == failed == 1


def test_relay_roofline_reads_three_hops_of_the_essential_bytes():
    bench = harness.Bench()
    cfg = {"nprocs": 16384, "cb_nodes": 256, "data_size": 2048}
    prof = {"exchanges": 20, "window_s": 0.4, "busy_s": 0.36,
            "device_events": 60, "device_ops": [], "idle_gaps": []}
    rec = harness.Record(cfg, "NVIDIA H100 80GB HBM3", profile=prof)
    mod = bench.plugin("metrics", "relay_roofline.theta")
    assert mod.relay_bytes(cfg) == 3 * 2 * 16384 * 256 * 2048
    floor = 3 * 2 * 16384 * 256 * 2048 / 3.35e12
    assert mod.read(rec) == pytest.approx(floor / 0.018 * 100)
    assert mod.read(harness.Record(cfg, "cpu", profile=prof)) is None
    assert mod.read(harness.Record(cfg, "NVIDIA H100 80GB HBM3")) is None
    spec = bench.spec
    (m,) = [m for m in spec["per_layer"]
           if m["name"] == "relay_roofline.theta"]
    assert m["workloads"] == ["theta_tam_a2m_shard"]
    cell = bench.cell("theta_tam_a2m_shard")
    assert cell.config["proc_node"] == 64 and cell.traffic["method"] == 15
    assert {x["name"] for x in cell.per_layer} >= {
        "relay_roofline.theta", "kernels_per_exchange.theta", "tables_s"}
