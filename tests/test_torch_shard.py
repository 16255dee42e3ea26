"""The sharded rank-axis tier (``tpu_aggcomm_torch/backends/torch_shard.py``
and the blocked TAM route of ``tam/engine.py``) held against the
reference's ``jax_shard`` (``tests/test_jax_shard.py``'s cases).

The reference runs on the first W devices of conftest's 8-device CPU
mesh; the port runs on a gloo group of W processes (W = 1 in this
process; W = 2, 4 and 8 in a pool of 8 worker processes started once for
the module, ``tests/torch_dist_pool.py``). Integer data, so everything is
compared exactly: each rank's recv slabs, each device's flat recv buffer
with its trash row, and chained end states after k reps. Times are only
checked for the contracts they obey (positive, additive), never
compared between the packages.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpu_aggcomm.backends import jax_shard as ref_shard  # noqa: E402
from tpu_aggcomm.backends.jax_shard import JaxShardBackend  # noqa: E402
from tpu_aggcomm.core.methods import METHODS, method_ids  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.faults import repair_schedule as ref_repair  # noqa: E402
from tpu_aggcomm.tam import engine as ref_engine  # noqa: E402

from tpu_aggcomm_torch.backends import torch_shard  # noqa: E402
from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.tam import engine  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_pool import REPO, pool_factory  # noqa: E402
from torch_fill import filled_empty  # noqa: E402,F401

NON_TAM = [m for m in method_ids(include_dead=True) if not METHODS[m].tam]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    get = pool_factory(8, str(tmp_path_factory.mktemp("shard_pool")))
    yield get
    get.close()


def _sched(sp: dict):
    """The reference's schedule of a worker's ``sched`` dict."""
    kw = dict(sp)
    s = ref_compile(kw.pop("method"), RefPattern(
        kw.pop("n"), kw.pop("a"), data_size=kw.pop("d"),
        comm_size=kw.pop("c", 200_000_000), proc_node=kw.pop("p", 1),
        placement=kw.pop("t", 1)), barrier_type=kw.get("b", 0))
    kw.pop("b", None)
    if kw.get("fault"):
        s = ref_repair(s, kw["fault"], barrier_type=sp.get("b", 0))
    if kw.get("unrepaired"):
        s = dataclasses.replace(s, fault=kw["unrepaired"])
    return s


def _port_sched(sp: dict):
    kw = dict(sp)
    s = compile_method(kw.pop("method"), AggregatorPattern(
        kw.pop("n"), kw.pop("a"), data_size=kw.pop("d"),
        comm_size=kw.pop("c", 200_000_000), proc_node=kw.pop("p", 1),
        placement=kw.pop("t", 1)), barrier_type=kw.get("b", 0))
    if kw.get("fault"):
        from tpu_aggcomm_torch.faults import repair_schedule
        s = repair_schedule(s, kw["fault"], barrier_type=sp.get("b", 0))
    if kw.get("unrepaired"):
        s = dataclasses.replace(s, fault=kw["unrepaired"])
    return s


def _ref(W, sp, rpd=None, verify=True):
    """The reference on the first W mesh devices: per-rank recv, each
    device's flat buffer (ndev, F, w), and the backend."""
    b = JaxShardBackend(devices=jax.devices()[:W], ranks_per_device=rpd)
    s = _sched(sp)
    recv, _ = b.run(s, verify=verify)
    fn, mesh, ndev, bsz, extra = b._compiled(s)
    send = jax.device_put(
        b._global_send_flat(s.pattern, 0, ndev, bsz, extra[1], extra[0]),
        NamedSharding(mesh, P("dev")))
    return recv, np.asarray(fn(send)), b


def _assert_parity(results, ref_recv, ref_flat):
    """Every process's recv slabs and flat buffer against the
    reference's; every receiving rank delivered by exactly one process."""
    got = {}
    for res in results:
        for r, x in res["recv"].items():
            assert r not in got
            got[r] = x
        if res.get("idx") is not None:
            np.testing.assert_array_equal(res["flat"], ref_flat[res["idx"]])
    want = {r: x for r, x in enumerate(ref_recv) if x is not None}
    assert sorted(got) == sorted(want)
    for r in want:
        np.testing.assert_array_equal(got[r], want[r])


def _cycle_w(i: int) -> int:
    return (2, 4, 8)[i % 3]


@pytest.mark.parametrize("method,W", [(m, _cycle_w(i))
                                      for i, m in enumerate(NON_TAM)])
def test_shard_matches_reference(method, W, pool):
    """Every method, 16 ranks over W processes: per-rank recv slabs and
    every device's flat buffer (trash row included) equal jax_shard's on
    W devices."""
    sp = dict(method=method, n=16, a=5, d=32, c=3)
    res = pool().call(W, "shard_run", sched=sp, run=dict(verify=True))
    ref_recv, ref_flat, _ = _ref(W, sp)
    _assert_parity(res, ref_recv, ref_flat)
    assert all(r["total"] > 0 for r in res)
    assert all(r["foreign"] == [] for r in res)


@pytest.mark.parametrize("method", [1, 8, 13, 17])
def test_single_process_is_the_single_device_mesh(method, filled_empty):
    """W=1, in this process: the reference's single-device path (no
    collective, no mask, pads into the trash row) byte for byte, with the
    receive arena ``torch.empty`` hands back filled."""
    sp = dict(method=method, n=12, a=5, d=32, c=4, p=2,
              b=2 if method == 13 else 0)
    b = TorchShardBackend("cpu")
    s = _port_sched(sp)
    recv, timers = b.run(s, verify=True)
    ref_recv, ref_flat, _ = _ref(1, sp)
    _assert_parity([{"recv": {r: x for r, x in enumerate(recv)
                              if x is not None},
                     "idx": 0, "flat": b.run_flat(s)}], ref_recv, ref_flat)
    assert timers[0].total_time > 0


@pytest.mark.parametrize("tam_id,p_node,n,ragged", [
    (15, 4, 16, False), (16, 4, 16, False), (15, 4, 14, True),
    (16, 3, 14, True)])
def test_tam_blocked_route_matches_reference(tam_id, p_node, n, ragged,
                                             pool):
    """m=15/16 on the blocked two-level engine over 4 processes: each
    device's recv rows, every rank's slabs and the chained end state
    after 3 reps equal the reference's ``tam_two_level_sharded`` on the
    same (Dn, Dl) grid, for uniform and ragged node maps."""
    sp = dict(method=tam_id, n=n, a=5, d=32, c=3, p=p_node)
    rs = _sched(sp)
    assert ragged == (len(set(rs.assignment.node_sizes.tolist())) > 1)
    res = pool().call(4, "tam", sched=sp, chain_iters=3)
    grid = ref_engine.sharded_grid(
        rs.assignment.nnodes, int(rs.assignment.node_sizes.max()), 4)
    assert grid == engine.sharded_grid(
        rs.assignment.nnodes, int(rs.assignment.node_sizes.max()), 4)
    ref_recv, _t, st = ref_engine.tam_two_level_sharded(
        rs, jax.devices()[:4], mesh_shape=grid, cache={}, return_state=True)
    ref_out = np.asarray(st["fn"](st["last_send_dev"], *st["tab_devs"]))
    ref_chain = np.asarray(st["make_chain"](3)(st["last_send_dev"]))
    got = {}
    for r in res:
        i, j = r["idx"]
        np.testing.assert_array_equal(r["rows"], ref_out[i, j])
        np.testing.assert_array_equal(r["chain"], ref_chain[i, j])
        got.update(r["recv"])
    want = {k: x for k, x in enumerate(ref_recv) if x is not None}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the backend's route verifies the same delivery
    run = pool().call(4, "shard_run", sched=sp, run=dict(verify=True))
    assert {k for r in run for k in r["recv"]} == set(want)


@pytest.mark.parametrize("method,cs,bt", [(1, 1, 0), (13, 2, 2), (17, 3, 0)])
def test_shard_throttle_and_barriers(method, cs, bt, pool):
    """Throttled rounds and in-round barriers (all-reduced tokens into
    the trash row) survive the block lowering over 4 processes."""
    sp = dict(method=method, n=16, a=5, d=16, c=cs, p=2, b=bt)
    res = pool().call(4, "shard_run", sched=sp, run=dict(verify=True))
    ref_recv, ref_flat, _ = _ref(4, sp)
    _assert_parity(res, ref_recv, ref_flat)


def test_shard_uneven_device_split(pool):
    """12 ranks over 8 processes: the mesh shrinks to the largest
    divisor (6 devices, B=2); the two processes past it hold no ranks and
    run the same program over empty blocks."""
    sp = dict(method=1, n=12, a=4, d=32, c=4)
    res = pool().call(8, "shard_run", sched=sp, run=dict(verify=True))
    assert [r["ndev"] for r in res] == [6] * 8
    assert [r["bsz"] for r in res] == [2] * 8
    assert [r["idx"] for r in res] == [0, 1, 2, 3, 4, 5, None, None]
    assert res[6]["recv"] == {} and res[7]["recv"] == {}
    ref_recv, ref_flat, b = _ref(8, sp)
    assert b._compiled(_sched(sp))[2] == 6
    _assert_parity(res, ref_recv, ref_flat)


def test_shard_explicit_ranks_per_device(pool):
    sp = dict(method=2, n=16, a=3, d=32, c=8)
    res = pool().call(4, "shard_run", sched=sp, run=dict(verify=True),
                      rpd=4)
    assert [(r["ndev"], r["bsz"]) for r in res] == [(4, 4)] * 4
    ref_recv, ref_flat, _ = _ref(4, sp, rpd=4)
    _assert_parity(res, ref_recv, ref_flat)
    err = pool().call(2, "shard_refusal", sched=sp, rpd=5)
    assert err[0][0] == "ValueError" and "must divide" in err[0][1]


@pytest.mark.parametrize("method,n,a,c,bt,issues", [
    (1, 32, 14, 999_999_999, 0, "one round"),
    (13, 32, 14, 2, 2, "a launch a round"),     # barrier tokens
    (1, 32, 14, 3, 0, "one launch"),
    (1, 100, 7, 3, 0, "one launch"),            # scan pads
    (2, 32, 14, 4, 0, "one launch"),            # many-to-all
])
def test_one_device_rep_issues_by_rounds_and_tokens(method, n, a, c, bt,
                                                    issues):
    """On one device: one round takes the one-round issue; rounds with
    barrier tokens take one issue a round; more than one round and no
    token take ONE many-round issue, whose span names the rounds, their
    edges and the zeroed rows. Read from the rep's ``rep.issue`` spans."""
    from tpu_aggcomm_torch.obs import trace
    s = compile_method(method, AggregatorPattern(n, a, data_size=8,
                                                 comm_size=c),
                       barrier_type=bt)
    b = TorchShardBackend("cpu")
    built = b._compiled(s)
    R = len(built.rounds)
    tokens = any(nb for (_r, _t, nb) in built.rounds)
    send = b._send(s.pattern, 1, built)
    want = built.rep(send)
    rec = trace.enable(manifest=False)
    try:
        assert torch.equal(built.rep(send), want)
    finally:
        trace.disable()
    spans = [e for e in rec.events if e.get("name") == "rep.issue"]
    if issues == "one round":
        assert R == 1 and built.fused is None
        assert [e["args"].get("round") for e in spans] == [
            built.rounds[0][0]]
    elif issues == "a launch a round":
        assert R > 1 and tokens and built.fused is None
        assert [e["args"]["round"] for e in spans] == [
            r for (r, _t, _nb) in built.rounds]
    else:
        assert R > 1 and not tokens and built.fused is not None
        assert [e["args"] for e in spans] == [{
            "rounds": R, "edges": sum(t.edges for (_r, t, _nb)
                                      in built.rounds),
            "zero_rows": built.zero.rows}]


def test_block_tables_pad_and_order():
    """Hand-checked block tables: 4 ranks over 2 devices, one round with
    an uneven pair load pads to M and lands b-major."""
    edges = np.array([[0, 2, 0, 0, 0], [1, 2, 0, 1, 0], [2, 1, 0, 2, 0]],
                     dtype=np.int64)
    send_base = np.array([0, 1, 0, 1])
    recv_base = np.array([0, 4, 0, 4])
    tabs = torch_shard.block_round_tables(edges, ndev=2, bsz=2,
                                          send_base=send_base,
                                          recv_base=recv_base, F=9)
    (r, pack, scat, M) = tabs[0]
    assert r == 0 and M == 2 and pack.shape == (2, 2, 2)
    assert list(pack[0, 1]) == [0, 1] and list(pack[0, 0]) == [-1, -1]
    assert list(scat[1, 0]) == [0, 1] and list(scat[0, 0]) == [8, 8]


@pytest.mark.parametrize("seed", range(4))
def test_block_tables_and_layouts_equal_the_reference_on_random_edges(seed):
    """Property: ``block_round_tables`` and ``recv_layout`` equal the
    reference's on random edge sets (unique (src, dst) pairs, several
    rounds, uneven pair loads), array for array."""
    rng = np.random.default_rng(seed)
    ndev, bsz = int(rng.integers(1, 5)), int(rng.integers(1, 4))
    n = ndev * bsz
    counts = rng.integers(0, 4, n)
    recv_base, F = torch_shard.recv_layout(counts, ndev, bsz)
    ref_base, ref_F = ref_shard.recv_layout(counts, ndev, bsz)
    np.testing.assert_array_equal(recv_base, ref_base)
    assert F == ref_F
    pairs = {(int(s), int(d)) for s, d in rng.integers(0, n, (40, 2))}
    rows = [(s, d, int(rng.integers(0, 3)), k, int(rng.integers(0, 3)))
            for k, (s, d) in enumerate(sorted(pairs))]
    edges = np.array(rows, dtype=np.int64)
    send_base = np.arange(n) % bsz * 3
    kw = dict(ndev=ndev, bsz=bsz, send_base=send_base,
              recv_base=np.arange(n) % bsz * len(rows), F=bsz * len(rows) + 1)
    got = torch_shard.block_round_tables(edges, **kw)
    want = ref_shard.block_round_tables(edges, **kw)
    assert len(got) == len(want)
    for (r, pk, sc, M), (rr, rpk, rsc, rM) in zip(got, want):
        assert (r, M) == (rr, rM)
        np.testing.assert_array_equal(pk, rpk)
        np.testing.assert_array_equal(sc, rsc)


@pytest.mark.parametrize("method", NON_TAM)
def test_schedule_edges_equal_the_reference(method):
    """The payload edge table (receive slots resolved; m=5/8 one
    synthesized round of pattern volume, not n^2)."""
    sp = dict(method=method, n=16, a=5, d=32, c=3)
    got = torch_shard._schedule_edges(_port_sched(sp))
    want = ref_shard._schedule_edges(_sched(sp))
    np.testing.assert_array_equal(got, want)
    if method in (5, 8):
        assert len(got) == 16 * 5 and set(got[:, 4]) == {0}


def test_flagship_rank_count_m1_m8(pool):
    """16,384 logical ranks, 2,048 a process over 8 — the reference's
    flagship rank count (script_theta_all_to_many_256.sh:3) — verified
    for the throttled m=1 and the dense m=8; the aggregators' slabs equal
    the reference's on 8 devices (a=16, d=8 keep the suite fast)."""
    for m in (1, 8):
        sp = dict(method=m, n=16384, a=16, d=8, c=8192)
        res = pool().call(8, "shard_run", sched=sp, run=dict(verify=True),
                          flat=False)
        assert [(r["ndev"], r["bsz"]) for r in res] == [(8, 2048)] * 8
        ref_recv, _, _ = _ref(8, sp, verify=False)
        got = {k: x for r in res for k, x in r["recv"].items()}
        want = {k: x for k, x in enumerate(ref_recv) if x is not None}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("W,method", [(1, 1), (1, 2), (2, 1), (4, 13),
                                      (2, 8), (4, 2)])
def test_chained_end_states_equal_the_reference(W, method, pool):
    """The chain's end state after k reps on every device: the token
    (the group's sum of live lane-0 words + r) % 251 and the XOR are the
    reference's, so 5 chained reps land on jax_shard's bytes."""
    sp = dict(method=method, n=16, a=5, d=32, c=4, p=2,
              b=2 if method == 13 else 0)
    b = JaxShardBackend(devices=jax.devices()[:W])
    s = _sched(sp)
    fn, mesh, ndev, bsz, extra = b._compiled(s)
    send = jax.device_put(
        b._global_send_flat(s.pattern, 0, ndev, bsz, extra[1], extra[0]),
        NamedSharding(mesh, P("dev")))
    want = np.asarray(extra[4](5)(send))
    if W == 1:
        tb = TorchShardBackend("cpu")
        ps = _port_sched(sp)
        built = tb._compiled(ps)
        from tpu_aggcomm_torch.backends.lanes import to_reference
        got = [to_reference(built.make_chain()(5)(
            tb._send(ps.pattern, 0, built)))]
    else:
        got = pool().call(W, "shard_chain", sched=sp, iters=5)
    for d, g in enumerate(got):
        np.testing.assert_array_equal(g, want[d])


def test_scanned_rounds_byte_exact(pool):
    """64 barrier-free rounds take the padded-table (scan) lowering: the
    pads land in the trash row as the reference's do."""
    sp = dict(method=1, n=64, a=5, d=16, c=1)
    res = pool().call(4, "shard_run", sched=sp, run=dict(verify=True))
    ref_recv, ref_flat, _ = _ref(4, sp)
    _assert_parity(res, ref_recv, ref_flat)


def test_flagship_throttled_scan_rounds(pool):
    """The flagship rank count with a mid-grid throttle (c=256: 64
    scanned rounds), the exact cell shape of the Theta sweep."""
    sp = dict(method=1, n=16384, a=16, d=8, c=256)
    res = pool().call(8, "shard_run", sched=sp, run=dict(verify=True),
                      flat=False)
    assert sum(len(r["recv"]) for r in res) == 16
    assert all(r["total"] > 0 for r in res)


@pytest.mark.parametrize("method", [1, 17])
def test_profile_rounds(method, pool):
    """One timed launch sequence per throttle round (the same
    ``_apply_block_round`` the rep is built from), per-round times
    positive, delivery byte-exact — including the barrier-carrying m=17."""
    sp = dict(method=method, n=16, a=5, d=32, c=4, p=2)
    res = pool().call(2, "shard_run", sched=sp,
                      run=dict(verify=True, profile_rounds=True))
    ref_recv, ref_flat, _ = _ref(2, sp)
    _assert_parity(res, ref_recv, ref_flat)
    for r in res:
        [round_times] = r["round_times"]
        assert len(round_times) >= 2 and all(t > 0 for t in round_times)
        assert r["provenance"] == ("torch_shard", "attributed-rounds")
    err = pool().call(2, "shard_refusal", sched=sp,
                      run=dict(chained=True, profile_rounds=True))
    assert "exclusive" in err[0][1]


def test_profile_rounds_collective_fallback():
    """Dense collectives have one synthesized round: profiled mode times
    the whole rep, one segment a rep, and last_round_times is fresh."""
    b = TorchShardBackend("cpu")
    p = AggregatorPattern(16, 5, data_size=32, comm_size=4)
    b.run(compile_method(1, p), profile_rounds=True)
    assert len(b.last_round_times[0]) > 1
    _recv, timers = b.run(compile_method(8, p), verify=True,
                          profile_rounds=True, ntimes=2)
    assert timers[0].total_time > 0
    assert [len(rt) for rt in b.last_round_times] == [1, 1]


def test_measured_round_times_are_additive(pool):
    """Round-prefix truncation differencing over the group: the rounds'
    times sum to the full rep's chained time (the additivity contract),
    the same on every process (the group's maximum)."""
    sp = dict(method=1, n=16, a=5, d=32, c=3)
    res = pool().call(2, "shard_rounds", sched=sp)
    for r in res:
        assert len(r["rt"]) == 6
        assert sum(r["rt"].values()) == pytest.approx(r["per"], rel=1e-9)
        assert all(v >= 0 for v in r["rt"].values())
        assert r["provenance"] == ("torch_shard",
                                   "measured-rounds+attributed(buckets)")
        assert r["round_times"] == [list(r["rt"].values())]
    assert res[0]["per"] == res[1]["per"]


def test_chained_run_and_tam_chain(pool):
    """``run(chained=True)``: positive per-rep time, attributed columns;
    TAM with no group rides the relay's chain with the chained
    provenance, and the blocked engine's chain, called directly, still
    runs on one process."""
    b = TorchShardBackend("cpu")
    s = compile_method(1, AggregatorPattern(16, 5, data_size=32,
                                            comm_size=4))
    _recv, timers = b.run(s, verify=True, chained=True, ntimes=2)
    assert timers[0].total_time > 0 and timers[0].post_request_time > 0
    assert np.isclose(timers[0].total_time, b.measure_per_rep(s) * 2)
    tam = compile_method(15, AggregatorPattern(16, 5, data_size=32,
                                               comm_size=4))
    b.run(tam, chained=True, verify=True)
    assert b.last_provenance == ("torch_shard", "attributed-chained")
    assert b.last_route == "relay"
    assert engine.tam_two_level_sharded_chained(
        tam, [0], device="cpu", iters_small=2, iters_big=12, trials=2,
        windows=1) > 0


@pytest.mark.parametrize("W", [1, 2])
def test_slow_rank_fault_bytes_equal_the_reference(W, pool):
    """``slow:r2*2``: the delay of the process holding rank 2 (the sum
    over its slow ranks) runs once a rep after the rounds and adds 0, so
    every byte, trash row included, is the reference's. The reference's
    own faulted jax_shard does not trace on this jax (its uint32
    ``fori_loop`` carry changes type, jax_shard.py:450), so the bytes are
    held against its healthy program, which its delay provably leaves
    unchanged (the named substitution)."""
    sp = dict(method=1, n=16, a=5, d=32, c=3, fault="slow:r2*2")
    healthy = dict(sp, fault=None)
    ref_recv, ref_flat, _ = _ref(W, healthy)
    if W == 1:
        calls = []
        delay = torch_shard.slow_delay

        def counted(*a, **k):
            calls.append(a[2])
            return delay(*a, **k)

        b = TorchShardBackend("cpu")
        s = _port_sched(sp)
        assert s.fault
        torch_shard.slow_delay = counted
        try:
            recv, _ = b.run(s, verify=True, ntimes=2)
        finally:
            torch_shard.slow_delay = delay
        assert len(calls) == 3            # warm-up + 2 reps, one a rep
        assert calls[0].ranks == (0,) and calls[0].iters[0] > 0
        res = [{"recv": {r: x for r, x in enumerate(recv) if x is not None},
                "idx": 0, "flat": b.run_flat(s)}]
    else:
        res = pool().call(W, "shard_run", sched=sp, run=dict(verify=True))
        # rank 2 lives on process 0 (B=8): its rep runs the delay
        # (warm-up and one timed rep, then the flat rep), process 1 none
        assert [r["delay_calls"] for r in res] == [2, 0]
    _assert_parity(res, ref_recv, ref_flat)


def test_unrepaired_dead_link_drops_and_staged_repair_is_refused(pool):
    """An unrepaired dead link drops its edges (verify fails, the bytes
    are the reference's); a repaired one is refused with the reference's
    words, torch_sim named where it names jax_sim."""
    sp = dict(method=1, n=16, a=5, d=32, c=3, unrepaired="deadlink:5>0")
    res = pool().call(2, "shard_run", sched=sp, flat=True)
    ref_recv, ref_flat, _ = _ref(2, sp, verify=False)
    _assert_parity(res, ref_recv, ref_flat)
    err = pool().call(2, "shard_refusal", sched=sp, run=dict(verify=True))
    assert err[0][0] == "VerificationError"
    staged = dict(sp, unrepaired=None, fault="deadlink:5>0")
    got = pool().call(2, "shard_refusal", sched=staged)[0]
    with pytest.raises(ValueError) as want:
        JaxShardBackend(devices=jax.devices()[:2]).run(_sched(staged))
    assert got[0] == "ValueError"
    assert got[1] == str(want.value).replace(
        "jax_shard's", "torch_shard's").replace("jax_sim", "torch_sim")


def test_tam_without_a_grid_is_refused_by_name(pool):
    """An explicit ranks_per_device whose device count has no (Dn, Dl)
    factorization: the reference falls back to jax_sim's XLA-partitioned
    route, which is not ported — refused by name; too few devices is the
    mesh's own refusal."""
    sp = dict(method=15, n=10, a=3, d=32, p=4)
    got = pool().call(8, "shard_refusal", sched=sp, rpd=2)
    assert {g[0] for g in got} == {"NotPortedError"}
    assert "no (Dn, Dl) grid" in got[0][1]
    with pytest.raises(ValueError, match="needs 5 devices, have 1"):
        TorchShardBackend("cpu", ranks_per_device=2).run(_port_sched(sp))


def test_send_refuses_another_directions_pattern():
    """The send arena is built for the schedule's own pattern: a pattern
    of the other direction (compile_method sets the method's) is refused,
    not scattered through negative offsets."""
    b = TorchShardBackend("cpu")
    p = AggregatorPattern(16, 5, data_size=32, comm_size=3)
    s = compile_method(2, p)
    assert s.pattern.direction != p.direction
    with pytest.raises(ValueError, match="pass schedule.pattern"):
        b._send(p, 0, b._compiled(s))
    assert b._send(s.pattern, 0, b._compiled(s)).shape[0] == 5 * 16 + 1


def test_nothing_falls_back(monkeypatch):
    """No card and no device='cpu': NoCudaDeviceError; a CUDA world
    larger than the visible cards: TooFewCardsError; a failed NCCL
    bring-up propagates."""
    import torch
    import torch.distributed as dist

    from tpu_aggcomm_torch import parallel
    from tpu_aggcomm_torch.device import NoCudaDeviceError

    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            TorchShardBackend()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(parallel.TooFewCardsError, match="needs 2 cards"):
        parallel.check_cards(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(parallel.TooFewCardsError):
        parallel.distributed_init("localhost:1", 4, 0)

    def boom(**kw):
        raise RuntimeError("NCCL error: unhandled system error")
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="NCCL error"):
        parallel.distributed_init("localhost:1", 1, 0)


def test_torchrun_rank_zero_alone_prints(tmp_path):
    """``torchrun`` of 2 CPU processes: both run every method of the run
    (TAM on the blocked route), verified, and only rank 0 prints its
    console block and writes the CSV."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    csv = tmp_path / "r.csv"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tpu_aggcomm_torch.cli", "-n", "8",
         "-m", "0", "-a", "3", "-d", "256", "-c", "2", "-p", "2",
         "--backend", "torch_shard", "--device", "cpu", "--verify",
         "--results-csv", str(csv)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("max total time") == 20
    assert r.stdout.count("| All to many TAM max total time") == 1
    assert len(csv.read_text().splitlines()) == 21
    with open(tmp_path / "r.provenance.csv") as f:
        rows = f.read().splitlines()[1:]
    assert len(rows) == 20 and all("torch_shard" in row for row in rows)


def test_sweep_on_torch_shard_matches_torch_sims_rows(tmp_path, capsys):
    """``sweep --backend torch_shard`` (one process): every throttle cell
    verified, a CSV row and a provenance row naming torch_shard each."""
    from tpu_aggcomm_torch import cli
    csv = tmp_path / "s.csv"
    assert cli.main(["sweep", "-n", "8", "-a", "3", "-d", "256", "-m", "1",
                     "-i", "1", "--comm-sizes", "1,2,999999999", "--backend",
                     "torch_shard", "--device", "cpu", "--verify",
                     "--results-csv", str(csv)]) == 0
    out = capsys.readouterr().out
    assert out.count("RUN_OPTS: -a 3 -d 256 -c ") == 3
    assert len(csv.read_text().splitlines()) == 4
    rows = (tmp_path / "s.provenance.csv").read_text().splitlines()[1:]
    assert len(rows) == 3 and all(",torch_shard,torch_shard," in r
                                  for r in rows)
