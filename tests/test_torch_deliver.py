"""The row-delivery kernel's host half (``backends/deliver_rows.py``) on
the CPU: its round tables, the rows a rep leaves to the first launch's
zeroing, and its plain version.

The kernel itself (``csrc/deliver_rows.cu``) runs only on the card
(``tests/test_torch_gpu.py``). ``torch_shard``'s one-device rep is the
same program on both devices: here its tables and zero runs drive the
plain version over a receive arena that ``torch.empty`` hands back
filled (:mod:`torch_fill`), and every byte must equal a gather and
``index_put_`` of the reference's host block tables into a zeroed arena.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_fill import filled_empty  # noqa: F401

from tpu_aggcomm_torch.backends import deliver_rows as dr
from tpu_aggcomm_torch.backends import torch_shard
from tpu_aggcomm_torch.backends.torch_shard import (TorchShardBackend,
                                                    schedule_edges)
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern


def _brute_unwritten(F, rounds) -> set:
    """Rows a rep leaves to the zeroing, by sets: every row no round
    writes (a pad writes the trash row, a barrier token writes none), and
    row 0 where a barrier comes before every write of row 0."""
    written, row0_read = set(), False
    for dst, nbar in rounds:
        written |= {int(r) for r in dst}
        row0_read = row0_read or (nbar > 0 and 0 not in written)
    return (set(range(F)) - written) | ({0} if row0_read else set())


def _rep_bytes(F, rounds, fill, zeroed=()):
    """A rep over an arena of ``fill``, the ``zeroed`` rows zeroed first,
    every round writing 7s into its rows, then its barrier tokens."""
    recv = np.full((F, 2), fill, dtype=np.int64)
    recv[list(zeroed)] = 0
    for dst, nbar in rounds:
        recv[np.asarray(dst, dtype=np.int64)] = 7
        for _ in range(nbar):
            recv[F - 1, 0] = recv[0, 0]
    return recv


def _random_rounds(rng, F, n_rounds):
    """Random rounds over an ``F``-row arena: each writes distinct rows
    below the trash row, some rounds pads into the trash row ``F - 1``,
    some carry barrier tokens."""
    out = []
    for _ in range(n_rounds):
        k = int(rng.integers(0, F))
        dst = rng.choice(F - 1, size=min(k, F - 1), replace=False)
        if rng.random() < 0.3:
            dst = np.append(dst, [F - 1] * int(rng.integers(1, 4)))
        out.append((dst.astype(np.int32), int(rng.integers(0, 3))
                    if rng.random() < 0.4 else 0))
    return out


@pytest.mark.parametrize("seed", range(24))
def test_unwritten_runs_equal_a_brute_force_set(seed):
    """Runs in order, disjoint, and exactly the brute-force set: rows no
    round writes (the trash row unless a pad writes it: a barrier token
    writes only its lane 0) and row 0 where a barrier reads it before its
    first write. Zeroing them makes a rep over an arena of 0xFF give the
    bytes of a rep over a zeroed arena."""
    rng = np.random.default_rng(seed)
    F = int(rng.integers(2, 40))
    rounds = _random_rounds(rng, F, int(rng.integers(0, 6)))
    for upto in range(len(rounds) + 1):
        runs = dr.unwritten_runs(F, rounds[:upto])
        rows = [r for a, b in runs for r in range(a, b)]
        assert len(rows) == len(set(rows))
        assert all(a < b for a, b in runs)
        assert all(b0 <= a1 for (_a0, b0), (a1, _b1) in zip(runs, runs[1:]))
        assert set(rows) == _brute_unwritten(F, rounds[:upto])
        assert np.array_equal(_rep_bytes(F, rounds[:upto], -1, rows),
                              _rep_bytes(F, rounds[:upto], 0))


def test_trash_row_rule():
    """Pads write the trash row; barrier tokens do not; a barrier before
    row 0's first write zeroes row 0 though a later round writes it."""
    F = 6
    assert dr.unwritten_runs(F, [([0, 1, 2, 3, 4], 2)]) == [(5, 6)]
    assert dr.unwritten_runs(F, [([0, 1, 2, 3, 4, 5, 5], 2)]) == []
    assert dr.unwritten_runs(F, [([1, 2], 1), ([0, 3, 4], 0)]) == [
        (0, 1), (5, 6)]
    assert dr.unwritten_runs(F, [([1, 2], 0), ([0, 3, 4], 1)]) == [(5, 6)]
    assert dr.unwritten_runs(F, []) == [(0, 6)]


def test_int32_overflow_is_refused_by_name():
    big = dr.INT32_LIMIT
    with pytest.raises(ValueError, match="receive rows overflows .* int32"):
        dr.unwritten_runs(big, [])
    with pytest.raises(ValueError, match="receive rows overflows .* int32"):
        dr.row_tables(np.zeros(3), np.zeros(3), F=big, Fs=8, device="cpu")
    with pytest.raises(ValueError, match="send rows overflows .* int32"):
        dr.row_tables(np.zeros(3), np.zeros(3), F=8, Fs=big, device="cpu")
    dr.row_tables(np.zeros(3), np.zeros(3), F=big - 1, Fs=big - 1,
                  device="cpu")


def test_row_tables_fold_the_pads_into_one_trash_entry():
    pk = np.array([[4, -1, 2, -1, -1]], dtype=np.int32)
    sc = np.array([[0, 9, 3, 9, 9]], dtype=np.int32)
    t = dr.row_tables(pk, sc, F=10, Fs=5, device="cpu")
    assert t.src.tolist() == [4, 2, 0] and t.dst.tolist() == [0, 3, 9]
    assert (t.n_rows, t.send_rows, t.recv_rows) == (3, 5, 10)
    assert t.args[2] == 3
    t = dr.row_tables(pk[:, [0, 2]], sc[:, [0, 2]], F=10, Fs=5,
                      device="cpu")
    assert t.dst.tolist() == [0, 3]
    with pytest.raises(ValueError, match="negative"):
        dr.row_tables(np.array([1]), np.array([-2]), F=10, Fs=5,
                      device="cpu")


def test_wrapper_on_the_cpu_is_the_plain_version_and_checks():
    send = torch.arange(5 * 3, dtype=torch.int32).reshape(5, 3)
    recv = torch.full((10, 3), -1, dtype=torch.int32)
    t = dr.row_tables(np.array([4, 2]), np.array([0, 3]), F=10, Fs=5,
                      device="cpu")
    z = dr.zero_runs([(1, 3), (4, 10)], "cpu")
    assert (z.rows, z.args[2:]) == (8, (2, 8))
    assert z.start_dev.tolist() == [1, 4] and z.ptr_dev.tolist() == [0, 2, 8]
    before = dr.deliver_rows.launches
    got = dr.deliver_rows(send, recv, t, z)
    assert got is recv and dr.deliver_rows.launches == before
    want = torch.zeros((10, 3), dtype=torch.int32)
    want[0], want[3] = send[4], send[2]
    assert torch.equal(recv, want)
    assert dr.zero_runs([], "cpu") is dr.NO_ZERO
    for bad in (recv[:, :2], recv.to(torch.int64), recv[:4], recv.t()):
        with pytest.raises(ValueError, match="deliver_rows"):
            dr.deliver_rows(send, bad, t, z)
    with pytest.raises(ValueError, match="outside send"):
        dr.deliver_rows(send[:4], recv, t)


def _gather_rep(b, s, send, upto):
    """The reference's single-device rep of ``s`` on ``b``'s host block
    tables, in the scan form where it applies: a zeroed arena, each
    round's gather (pads read send row 0) and ``index_put_`` (pads land
    in the trash row), then its barrier tokens."""
    built, host = b._mesh_layout(s)
    F = built.F
    recv = torch.zeros((F, send.shape[1]), dtype=send.dtype)
    for (_r, pk, sc, nbar) in torch_shard._scan_form(host, F)[:upto]:
        recv[torch.from_numpy(sc.reshape(-1).astype(np.int64))] = send[
            torch.from_numpy(np.maximum(pk, 0).reshape(-1).astype(np.int64))]
        for _ in range(nbar):
            recv[F - 1, 0] = recv[0, 0]
    return recv


@pytest.mark.parametrize("method,n,a,d,c,bt,fault", [
    (1, 32, 14, 64, 999_999_999, 0, None),      # one round
    (1, 32, 14, 100, 3, 0, None),               # throttled
    (1, 100, 7, 16, 3, 0, None),                # 34 rounds: scan pads
    (13, 32, 14, 6, 2, 2, None),                # barrier rounds, bytes
    (17, 32, 14, 64, 3, 1, None),
    (7, 32, 14, 64, 3, 1, None),
    (2, 16, 4, 64, 2, 0, None),                 # many-to-all
    (1, 8, 3, 64, 2, 0, "deadlink:5>3"),        # unrepaired dead link
])
def test_kernel_tables_give_the_cpu_reps_bytes(method, n, a, d, c, bt,
                                                fault, filled_empty):
    """For every prefix of the rounds: the one-device rep on the CPU (the
    kernel's tables and zero runs through its plain version, over an
    arena ``torch.empty`` hands back filled) gives the bytes of the
    reference's gather and ``index_put_`` into a zeroed arena, trash row
    included; the CPU launches no kernel."""
    s = compile_method(method, AggregatorPattern(n, a, data_size=d,
                                                 comm_size=c),
                       barrier_type=bt)
    if fault:
        s = dataclasses.replace(s, fault=fault)
    b = TorchShardBackend("cpu")
    built = b._compiled(s)
    send = b._send(s.pattern, 3, built)
    launches = dr.deliver_rows.launches
    for upto in range(len(built.rounds) + 1):
        want = _gather_rep(b, s, send, upto)
        assert torch.equal(built.rep(send, upto), want), upto
    assert dr.deliver_rows.launches == launches


@pytest.mark.parametrize("method,n,a,d,c,bt,fault", [
    (1, 32, 14, 64, 999_999_999, 0, None),
    (1, 100, 7, 16, 3, 0, None),
    (17, 32, 14, 66, 3, 1, None),
    (8, 16, 4, 64, 2, 0, None),                 # dense: one round
    (1, 8, 3, 64, 2, 0, "deadlink:5>3"),
])
def test_roofline_prices_the_kernels_rounds(method, n, a, d, c, bt, fault):
    """``lowering="torch_shard"`` on one device prices the card's rounds:
    every edge's row read and written once, nothing in between, the rows
    of the first launch's zero runs, two int32 entries a table row and
    the zero runs' tables, the round offsets of a rep of many barrier-free
    rounds (one launch), one pad entry a padded round; fewer bytes than a
    zero fill of the arena and a gather and ``index_put_`` of the same
    entries."""
    from tpu_aggcomm_torch.harness import roofline
    s = compile_method(method, AggregatorPattern(n, a, data_size=d,
                                                 comm_size=c),
                       barrier_type=bt)
    if fault:
        s = dataclasses.replace(s, fault=fault)
    built = TorchShardBackend("cpu")._compiled(s)
    F = built.F
    tabs = [(tab.rows, nbar) for (_r, tab, nbar) in built.rounds]
    runs = dr.unwritten_runs(F, [(t.dst, nbar) for t, nbar in tabs])
    assert list(built.zero.runs) == runs
    entries = sum(t.n_rows for t, _nb in tabs)
    E = len(schedule_edges(s))
    pads = entries - E
    rb = roofline.rep_bytes(s, lowering="torch_shard")
    assert (rb.gather_read, rb.scatter_write, rb.intermediate,
            rb.refence_walks, rb.barrier) == (E * d, E * d, 0, 0, 0)
    assert rb.zero_init == sum(b_ - a_ for a_, b_ in runs) * d
    assert rb.pad == 2 * pads * d
    one_launch = len(tabs) > 1 and not any(nb for _t, nb in tabs)
    assert (built.fused is not None) == one_launch
    assert rb.index_read == 8 * entries + (4 * (2 * len(runs) + 1)
                                           if runs else 0) + (
        4 * (len(tabs) + 1) if one_launch else 0)
    assert (rb.rounds, rb.devices) == (len(tabs), 1)
    zero_fill_gather_put = F * d + 4 * entries * d + 2 * 8 * entries
    assert rb.total() < zero_fill_gather_put


def test_roofline_prices_the_kernel_on_one_device_only():
    """Over two devices the row is the group program's; TAM on
    torch_shard is the blocked engine's; the kernel is no lowering of its
    own."""
    from tpu_aggcomm_torch.harness import roofline
    s = compile_method(1, AggregatorPattern(8, 3, data_size=64, comm_size=2))
    assert roofline.rep_bytes(s, lowering="torch_shard", ndev=2) == \
        roofline._shard_rep_bytes(s, 2)
    tam = compile_method(15, AggregatorPattern(16, 3, data_size=64,
                                               proc_node=4))
    assert roofline.tam_rep_bytes(tam, lowering="torch_shard") == \
        roofline._tam_shard_rep_bytes(tam)
    with pytest.raises(ValueError, match="unknown lowering 'deliver_rows'"):
        roofline.rep_bytes(s, lowering="deliver_rows")


# -- a rep of many rounds as one launch ---------------------------------------

def _per_round_plain(built, send, k, fill):
    """Today's per-round rounds: the first ``k`` rounds of ``built``, one
    plain round each through the round issuer, the prefix's zero runs
    with the first, into an arena of ``fill``."""
    zero = dr.zero_runs(dr.unwritten_runs(
        built.F, [(t.rows.dst, nb) for (_r, t, nb) in built.rounds[:k]]),
        "cpu")
    recv = torch.full((built.F, send.shape[1]), fill, dtype=send.dtype)
    issue = dr.arena_launcher(send, recv)
    for i, (_r, t, _nb) in enumerate(built.rounds[:k]):
        issue(t.rows, zero if i == 0 else None)
    return recv, zero


@pytest.mark.parametrize("n,a,c,d,upto", [
    (32, 14, 3, 64, None),          # the README's m=1 c=3: 11 rounds
    (256, 16, 16, 32, None),        # 16 rounds
    (1024, 64, 16, 16, None),       # Theta-shaped m=1 (closed form): 64
                                    # rounds in the scan form
    (1024, 64, 16, 16, 5),          # a truncated prefix
    (256, 16, 16, 32, 2),
])
def test_many_round_plain_equals_the_per_round_plain_rounds(n, a, c, d, upto,
                                                            filled_empty):
    """The many-round issue's plain version (the zero runs, then the
    rounds in order) gives the bytes of today's per-round plain rounds,
    each prefix with its own zero runs, over arenas of other contents; the
    rep takes it, and the CPU counts no launch."""
    s = compile_method(1, AggregatorPattern(n, a, data_size=d, comm_size=c))
    b = TorchShardBackend("cpu")
    built = b._compiled(s)
    assert built.fused is not None and len(built.rounds) > 1
    send = b._send(s.pattern, 5, built)
    k = len(built.rounds[:upto])
    want, zero = _per_round_plain(built, send, k, -1)
    launches, fused = dr.deliver_rows.launches, dr.deliver_rows.fused_rounds
    got = torch.full_like(want, 7)
    assert dr.deliver_rounds(send, got, built.fused, k, zero) is got
    assert torch.equal(got, want)
    got = torch.full_like(want, 9)
    dr.rounds_launcher(built.fused, k, zero, send_shape=send.shape,
                       recv_shape=got.shape, dtype=send.dtype)(send, got)
    assert torch.equal(got, want)
    assert torch.equal(built.rep(send, upto), want)
    assert (dr.deliver_rows.launches, dr.deliver_rows.fused_rounds) == (
        launches, fused)


def test_a_row_written_in_two_rounds_keeps_the_later_rounds_bytes():
    """Round 0 writes rows 2 and 3, round 1 writes row 2 again from
    another send row: row 2 holds round 1's bytes, and the zero runs are
    zeroed."""
    send = torch.arange(4 * 3, dtype=torch.int32).reshape(4, 3) + 1
    tabs = dr.round_tables([(np.array([0, 1]), np.array([2, 3])),
                            (np.array([3]), np.array([2]))],
                           F=5, Fs=4, device="cpu")
    zero = dr.zero_runs([(0, 2), (4, 5)], "cpu")
    recv = dr.deliver_rounds(send, torch.full((5, 3), -1, dtype=torch.int32),
                             tabs, zero=zero)
    assert recv[2].tolist() == send[3].tolist()
    assert recv[3].tolist() == send[1].tolist()
    assert recv[[0, 1, 4]].eq(0).all()
    first = dr.deliver_rounds(send, torch.full((5, 3), -1, dtype=torch.int32),
                              tabs, 1, zero)
    assert first[2].tolist() == send[0].tolist()


def test_round_tables_are_csr_views_of_one_upload():
    """``round_ptr`` is the prefix sum of the rounds' row counts; each
    round's tables are views of the concatenated tensors, so no round is
    held twice; ``widest`` is the running maximum of the counts."""
    pairs = [(np.array([3, -1, 1]), np.array([0, 9, 4])),
             (np.array([], dtype=np.int64), np.array([], dtype=np.int64)),
             (np.array([2, 0, 1, 3]), np.array([5, 6, 7, 8]))]
    tabs = dr.round_tables(pairs, F=10, Fs=4, device="cpu")
    counts = [t.n_rows for t in tabs.rounds]
    assert counts == [3, 0, 4]                  # the pad folded into one
    assert list(tabs.round_ptr) == [0, 3, 3, 7]
    assert tabs.ptr_dev.tolist() == [0, 3, 3, 7]
    assert tabs.ptr_dev.dtype == torch.int32
    assert list(tabs.widest) == [0, 3, 3, 4]
    assert (tabs.n_rounds, tabs.send_rows, tabs.recv_rows) == (3, 4, 10)
    base = tabs.src_dev.untyped_storage().data_ptr()
    for k, t in enumerate(tabs.rounds):
        a, b = tabs.round_ptr[k], tabs.round_ptr[k + 1]
        assert t.src_dev.untyped_storage().data_ptr() == base
        assert torch.equal(t.src_dev, tabs.src_dev[a:b])
        assert torch.equal(t.dst_dev, tabs.dst_dev[a:b])
        one = dr.row_tables(*pairs[k], F=10, Fs=4, device="cpu")
        assert (t.src.tolist(), t.dst.tolist()) == (one.src.tolist(),
                                                     one.dst.tolist())
    assert tabs.sync.tolist() == [0, 0, 0, 0]


def test_built_rounds_share_the_one_launchs_tables():
    """A one-device build uploads its rounds once: every round's tables
    are views of ``fused``'s, whose offsets count the rounds' rows."""
    s = compile_method(1, AggregatorPattern(64, 8, data_size=16,
                                            comm_size=2))
    built = TorchShardBackend("cpu")._compiled(s)
    tabs = built.fused
    assert np.diff(tabs.round_ptr).tolist() == [
        t.rows.n_rows for (_r, t, _nb) in built.rounds]
    for k, (_r, t, _nb) in enumerate(built.rounds):
        assert t.rows is tabs.rounds[k]
        assert (t.rows.src_dev.untyped_storage().data_ptr()
                == tabs.src_dev.untyped_storage().data_ptr())


def test_many_round_issue_refuses_by_name():
    send = torch.zeros((4, 3), dtype=torch.int32)
    tabs = dr.round_tables([(np.array([0]), np.array([1])),
                            (np.array([3]), np.array([2]))],
                           F=5, Fs=4, device="cpu")
    recv = torch.zeros((5, 3), dtype=torch.int32)
    for n in (0, 3):
        with pytest.raises(ValueError, match=f"{n} rounds of a rep of 2"):
            dr.deliver_rounds(send, recv, tabs, n)
    with pytest.raises(ValueError, match="outside send"):
        dr.deliver_rounds(send[:3], recv, tabs)
    with pytest.raises(ValueError, match="zero run ends past"):
        dr.deliver_rounds(send, recv, tabs, zero=dr.zero_runs([(4, 6)],
                                                              "cpu"))
    with pytest.raises(ValueError, match="deliver_rows"):
        dr.deliver_rounds(send, recv.to(torch.int64), tabs)


def test_check_fence_raises_the_record_and_clears_it():
    tabs = dr.round_tables([(np.array([0]), np.array([1]))] * 2, F=2, Fs=1,
                           device="cpu")
    dr.check_fence(tabs)
    tabs.sync[1:] = torch.tensor([8, 3, 41], dtype=torch.int32)
    with pytest.raises(dr.DeliverFenceError,
                       match="CTA 7 waited .* after round 3 .41 arrivals"):
        dr.check_fence(tabs)
    assert tabs.sync.tolist() == [0, 0, 0, 0]
    dr.check_fence(tabs)


# The one-round launch's two grids on the card: the rule that sends a
# launch to the wide-row engine (csrc/deliver_rows.cu's wide_engine), by
# which the wrapper counts ``wide_launches``. On the CPU nothing launches.

@pytest.mark.parametrize("lane,row_bytes,wide", [
    (16, 2048, True),                   # a Theta pass, TAM's hops
    (16, 2064, True),                   # rows of a chunk and a lane
    (16, 4096, True),
    (16, 1 << 20, True),
    (16, 2032, False),                  # under 2 KB
    (16, 256, False),                   # the d=256 flagship
    (16, 16, False),
    (4, 2048, False),                   # 4-byte lanes
    (4, 2052, False),
    (1, 4097, False),
    (1, 2048, False),
    (4, 1 << 20, False),
])
def test_wide_engine_rule(lane, row_bytes, wide):
    assert dr.wide_engine(lane, row_bytes) is wide


@pytest.mark.parametrize("send,recv,row_bytes,lane", [
    (0, 0, 2048, 16), (512, 4096, 2064, 16), (1 << 40, 1 << 36, 4096, 16),
    (4, 0, 2048, 4), (0, 8, 2048, 4), (16, 32, 2052, 4),
    (0, 0, 2050, 1), (2, 0, 2048, 1),
])
def test_lane_bytes_follows_the_row_width_and_both_addresses(send, recv,
                                                             row_bytes, lane):
    assert dr.lane_bytes(send, recv, row_bytes) == lane


def test_wide_launches_stay_zero_on_the_cpu():
    """A round the card would send to the wide-row engine (4,096 rows of
    2048 bytes) is the plain version on the CPU through every issuer, and
    no counter moves; the named-grid launch refuses the CPU by name."""
    n, d = 4096, 2048
    rng = np.random.default_rng(26)
    send = torch.from_numpy(rng.integers(0, 256, (n, d), dtype=np.uint8))
    perm = rng.permutation(n)
    t = dr.row_tables(np.arange(n), perm, F=n + 1, Fs=n, device="cpu")
    z = dr.zero_runs([(n, n + 1)], "cpu")
    want = torch.zeros((n + 1, d), dtype=torch.uint8)
    want[torch.from_numpy(perm)] = send
    counts = (dr.deliver_rows.launches, dr.deliver_rows.wide_launches)
    issuers = (lambda recv: dr.deliver_rows(send, recv, t, z),
               lambda recv: dr.arena_launcher(send, recv)(t, z),
               lambda recv: dr.row_launcher(
                   t, z, send_shape=(n, d), recv_shape=(n + 1, d),
                   dtype=torch.uint8)(send, recv))
    for issue in issuers:
        recv = torch.full((n + 1, d), 0xFF, dtype=torch.uint8)
        issue(recv)
        assert torch.equal(recv, want)
    assert (dr.deliver_rows.launches, dr.deliver_rows.wide_launches) == counts
    with pytest.raises(ValueError, match="on the card"):
        dr._deliver_rows_on("wide", send, recv, t, z)


def test_deliver_rows_on_names_its_engines():
    send = torch.zeros((4, 512), dtype=torch.int32)
    t = dr.row_tables(np.array([0]), np.array([1]), F=5, Fs=4, device="cpu")
    for grid in ("bulk", "", None):
        with pytest.raises(ValueError, match="persistent"):
            dr._deliver_rows_on(grid, send, torch.zeros((5, 512),
                                                        dtype=torch.int32),
                                t)
