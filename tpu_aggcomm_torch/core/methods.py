"""Method registry: reference schedules 0-20 compiled to the op IR.

Each ``gen_*`` function reproduces one reference pattern algorithm
(mpi_test.c:313-1950) as per-rank op programs. The method ids, names, and
direction match the reference dispatch table (mpi_test.c:2181-2338) exactly;
``method 0`` means "run all" there and is handled by the driver here too.

Conventions (from prepare_* — mpi_test.c:94-133, 162-202):

- ALL_TO_MANY: every rank owns ``cb_nodes`` send slabs (slot = aggregator
  index); aggregators own ``nprocs`` recv slabs (slot = source rank).
- MANY_TO_ALL: aggregators own ``nprocs`` send slabs (slot = dest rank);
  every rank owns ``cb_nodes`` recv slabs (slot = aggregator index).
- Every slab is exactly ``data_size`` bytes (span=1, mpi_test.c:98).

Timer-bucket annotations follow each reference function's MPI_Wtime
bracketing exactly (who charges post_request / recv_wait_all /
send_wait_all, and the non-aggregator double-charge paths).

Known reference quirks reproduced or deliberately fixed (documented where
they occur): methods 4, 6, 11, 12 do not reset the mutated throttle between
reps in the reference (e.g. mpi_test.c:1604) — our programs are per-rep, so
every rep uses the first-rep round sizes; that is the obviously intended
behavior and the deviation only affects reps ≥ 2 of those methods.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _replace
from typing import Callable

import numpy as np

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction, node_robin_map
from tpu_aggcomm_torch.core.schedule import Op, OpKind, Schedule, TimerBucket
from tpu_aggcomm_torch.obs import trace

__all__ = ["METHODS", "MethodSpec", "compile_method", "method_ids"]


# --------------------------------------------------------------------------
# small helpers

def _balanced_partition(procs: int, cb: int):
    """ceiling/floor partition of [0, procs) into cb blocks
    (reference: mpi_test.c:1447-1452)."""
    remainder = procs % cb
    ceil_ = (procs + cb - 1) // cb
    floor_ = procs // cb
    offs = [j * ceil_ if j < remainder else remainder * ceil_ + (j - remainder) * floor_
            for j in range(cb)]
    return offs, remainder, ceil_, floor_


def _send_start(pos: int, remainder: int, ceil_: int, floor_: int) -> int:
    """Which balanced block a (possibly permuted) rank position falls in
    (reference: mpi_test.c:1449-1453)."""
    if pos >= remainder * ceil_:
        return remainder + (pos - remainder * ceil_) // floor_
    return pos // ceil_


def _window_contains(pos: int, temp: int, cs: int, procs: int) -> bool:
    """Membership of ``pos`` in the rotating window [temp, temp+cs) mod procs,
    with the reference's exact straddle test (mpi_test.c:1484-1496)."""
    if (temp >= procs and temp + cs >= procs) or (temp < procs and temp + cs < procs):
        return (temp % procs) <= pos < ((temp + cs) % procs)
    return pos >= temp or pos < (temp + cs) % procs


class _Prog:
    """Per-rank program builder with token bookkeeping."""

    def __init__(self):
        self.ops: list[Op] = []
        self._next_token = 0

    def nb(self, kind: OpKind, peer: int, slot: int, rnd: int, nbytes: int,
           bucket: TimerBucket = TimerBucket.NONE) -> int:
        tok = self._next_token
        self._next_token += 1
        self.ops.append(Op(kind=kind, peer=peer, slot=slot, round=rnd,
                           token=tok, nbytes=nbytes, bucket=bucket))
        return tok

    def blocking(self, kind: OpKind, peer: int, slot: int, rnd: int, nbytes: int,
                 bucket: TimerBucket = TimerBucket.NONE):
        self.ops.append(Op(kind=kind, peer=peer, slot=slot, round=rnd,
                           nbytes=nbytes, bucket=bucket))

    def sendrecv(self, dst: int, sslot: int, src: int, rslot: int, rnd: int,
                 nbytes: int, bucket: TimerBucket = TimerBucket.NONE):
        self.ops.append(Op(kind=OpKind.SENDRECV, peer=dst, slot=sslot,
                           peer2=src, slot2=rslot, round=rnd, nbytes=nbytes,
                           bucket=bucket))

    def copy(self, sslot: int, rslot: int, rnd: int):
        self.ops.append(Op(kind=OpKind.COPY, slot=sslot, slot2=rslot, round=rnd))

    def waitall(self, tokens: list[int], bucket: TimerBucket, rnd: int = 0):
        if tokens:
            self.ops.append(Op(kind=OpKind.WAITALL, tokens=tuple(tokens),
                               bucket=bucket, round=rnd))

    def barrier(self, rnd: int = 0, bucket: TimerBucket = TimerBucket.NONE):
        self.ops.append(Op(kind=OpKind.BARRIER, round=rnd, bucket=bucket))


def _wait_bucket(isagg: bool) -> TimerBucket:
    """Waitall bucket for methods that charge send_wait too on non-aggregators
    (e.g. mpi_test.c:1505-1510)."""
    return TimerBucket.RECV_WAIT if isagg else TimerBucket.RECV_AND_SEND_WAIT


def _dense_slots(p: AggregatorPattern):
    """Slot maps for the dense (translate-based) methods — the analog of
    sdispls/rdispls from *_alltoall_translate (mpi_test.c:233-311):
    ``sslot_of[dst]`` = index into the sender's slab array for a message to
    ``dst``; ``rslot_of[src]`` = index into the receiver's slab array for a
    message from ``src``."""
    agg_index = p.agg_index
    if p.direction is Direction.ALL_TO_MANY:
        sslot_of = agg_index           # send slab = aggregator index of dst
        rslot_of = np.arange(p.nprocs)  # recv slab = source rank
    else:
        sslot_of = np.arange(p.nprocs)  # send slab = dest rank
        rslot_of = agg_index            # recv slab = aggregator index of src
    return sslot_of, rslot_of


# --------------------------------------------------------------------------
# m=1 / m=2 — canonical unordered methods (mpi_test.c:1748-1824, 1871-1950)

def gen_all_to_many(p: AggregatorPattern) -> Schedule:
    """m=1: every rank Issends its cb_nodes slabs up front; aggregators drain
    sources in ``steps`` strided rounds of throttled Irecv+Waitall
    (mpi_test.c:1748-1824). Transfer round of edge (s → agg) is s % steps."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    progs = []
    unthrottled = p.comm_size >= procs
    steps = 1 if unthrottled else (procs + p.comm_size - 1) // p.comm_size
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        if unthrottled:
            toks = []
            if isagg:
                for i in range(procs):
                    toks.append(b.nb(OpKind.IRECV, i, i, 0, ds, TimerBucket.POST))
            for i in range(cb):
                toks.append(b.nb(OpKind.ISSEND, int(p.rank_list[i]), i, 0, ds,
                                 TimerBucket.POST))
            b.waitall(toks, TimerBucket.RECV_WAIT)
        else:
            send_toks = [b.nb(OpKind.ISSEND, int(p.rank_list[i]), i,
                              rank % steps, ds, TimerBucket.POST)
                         for i in range(cb)]
            for k in range(steps):
                recv_toks = []
                if isagg:
                    for i in range(k, procs, steps):
                        recv_toks.append(b.nb(OpKind.IRECV, i, i, k, ds,
                                              TimerBucket.POST))
                b.waitall(recv_toks, TimerBucket.RECV_WAIT, rnd=k)
            b.waitall(send_toks, TimerBucket.SEND_WAIT, rnd=steps - 1)
        progs.append(b.ops)
    return Schedule(p, 1, "All to many", progs, uses_rendezvous=True)


def gen_many_to_all(p: AggregatorPattern) -> Schedule:
    """m=2: mirror of m=1 — recvs pre-posted, aggregator Issends strided with
    a per-round send Waitall (mpi_test.c:1871-1950)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    progs = []
    unthrottled = p.comm_size >= procs
    steps = 1 if unthrottled else (procs + p.comm_size - 1) // p.comm_size
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        if unthrottled:
            toks = [b.nb(OpKind.IRECV, int(p.rank_list[i]), i, 0, ds,
                         TimerBucket.POST) for i in range(cb)]
            if isagg:
                for i in range(procs):
                    toks.append(b.nb(OpKind.ISSEND, i, i, 0, ds, TimerBucket.POST))
            b.waitall(toks, TimerBucket.RECV_WAIT)
        else:
            recv_toks = [b.nb(OpKind.IRECV, int(p.rank_list[i]), i,
                              rank % steps, ds, TimerBucket.POST)
                         for i in range(cb)]
            for k in range(steps):
                send_toks = []
                if isagg:
                    for i in range(k, procs, steps):
                        send_toks.append(b.nb(OpKind.ISSEND, i, i, k, ds,
                                              TimerBucket.POST))
                b.waitall(send_toks, TimerBucket.SEND_WAIT, rnd=k)
            b.waitall(recv_toks, TimerBucket.RECV_WAIT, rnd=steps - 1)
        progs.append(b.ops)
    return Schedule(p, 2, "Many to all", progs, uses_rendezvous=True)


# --------------------------------------------------------------------------
# m=3 / m=17 / m=18 — balanced rotation family (mpi_test.c:1422-1517,
# 1135-1227, 1229-1336)

def _gen_balanced_a2m(p: AggregatorPattern, *, robin: bool, handshake: bool,
                      method_id: int, name: str) -> Schedule:
    """Shared body of the all-to-many balanced family. Aggregator j Irecvs a
    rotating round-k window of source positions; each sender walks aggregator
    blocks backward from its own partition while its position lies in the
    aggregator's window (``send_start`` persists across rounds). Variants:
    m=17 permutes positions by the node-robin map and barriers inside every
    round (mpi_test.c:1188); m=18 adds the 0-byte receiver→sender signal
    handshake on a separate channel before each Issend (mpi_test.c:1283-1301)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    offs, remainder, ceil_, floor_ = _balanced_partition(procs, cb)
    bblock = min(p.comm_size, procs)
    robin_map = node_robin_map(procs, p.proc_node) if robin else None
    pos_of = np.argsort(robin_map) if robin else np.arange(procs)
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        pos = int(pos_of[rank])
        send_start = _send_start(pos, remainder, ceil_, floor_)
        rnd = 0
        k = 0
        cs = bblock
        while k < procs:
            if procs - k < cs:
                cs = procs - k
            toks = []
            if isagg:
                for i in range(cs):
                    temp = (k + i + offs[myindex]) % procs
                    if robin:
                        src = int(robin_map[temp])
                        toks.append(b.nb(OpKind.IRECV, src, src, rnd, ds,
                                         TimerBucket.POST))
                    elif temp != rank:
                        toks.append(b.nb(OpKind.IRECV, temp, temp, rnd, ds,
                                         TimerBucket.POST))
                        if handshake:
                            toks.append(b.nb(OpKind.SIGNAL_SEND, temp, -1, rnd,
                                             0, TimerBucket.POST))
                    else:
                        b.copy(myindex, temp, rnd)
            if robin:
                b.barrier(rnd, TimerBucket.POST)  # mpi_test.c:1188
            # sender walk (mpi_test.c:1479-1502); m=3 leaves it untimed,
            # m=17/18 charge it to post_request.
            send_bucket = TimerBucket.POST if (robin or handshake) else TimerBucket.NONE
            for _ in range(cb):
                temp = k + offs[send_start]
                if not _window_contains(pos, temp, cs, procs):
                    break
                dst = int(p.rank_list[send_start])
                if robin or dst != rank:
                    if handshake:
                        b.blocking(OpKind.SIGNAL_RECV, dst, -1, rnd, 0,
                                   send_bucket)
                    toks.append(b.nb(OpKind.ISSEND, dst, send_start, rnd, ds,
                                     send_bucket))
                send_start = (send_start - 1 + cb) % cb
            b.waitall(toks, _wait_bucket(isagg), rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, method_id, name, progs, uses_rendezvous=True)


def gen_all_to_many_balanced(p: AggregatorPattern) -> Schedule:
    return _gen_balanced_a2m(p, robin=False, handshake=False, method_id=3,
                             name="All to many balanced")


def gen_all_to_many_node_robin(p: AggregatorPattern) -> Schedule:
    return _gen_balanced_a2m(p, robin=True, handshake=False, method_id=17,
                             name="All to many node robin")


def gen_all_to_many_balanced_control(p: AggregatorPattern) -> Schedule:
    return _gen_balanced_a2m(p, robin=False, handshake=True, method_id=18,
                             name="All to many balanced control")


def gen_many_to_all_balanced(p: AggregatorPattern) -> Schedule:
    """m=4: mirror of m=3 — each rank Irecvs from aggregators whose rotating
    window covers it (same backward walk), aggregators Issend their round
    window; one Waitall per round (mpi_test.c:1576-1663)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    offs, remainder, ceil_, floor_ = _balanced_partition(procs, cb)
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        send_start = _send_start(rank, remainder, ceil_, floor_)
        rnd = 0
        k = 0
        cs = min(p.comm_size, procs)
        while k < procs:
            if procs - k < cs:
                cs = procs - k
            toks = []
            for _ in range(cb):
                temp = k + offs[send_start]
                if not _window_contains(rank, temp, cs, procs):
                    break
                src = int(p.rank_list[send_start])
                if src != rank:
                    toks.append(b.nb(OpKind.IRECV, src, send_start, rnd, ds,
                                     TimerBucket.POST))
                send_start = (send_start - 1 + cb) % cb
            if isagg:
                for i in range(cs):
                    temp = (k + i + offs[myindex]) % procs
                    if temp != rank:
                        toks.append(b.nb(OpKind.ISSEND, temp, temp, rnd, ds,
                                         TimerBucket.POST))
                    else:
                        b.copy(temp, myindex, rnd)
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, 4, "Many to all balanced", progs, uses_rendezvous=True)


# --------------------------------------------------------------------------
# m=5 / m=8 — dense vendor collective (mpi_test.c:599-654, 885-940)

def _gen_benchmark(p: AggregatorPattern, method_id: int, name: str) -> Schedule:
    """One Alltoallw per rep — the "let the library schedule it" control arm.
    TPU lowering: one lax.all_to_all with zero-masked slots."""
    progs = []
    for _rank in range(p.nprocs):
        b = _Prog()
        b.ops.append(Op(kind=OpKind.ALLTOALLW, round=0, nbytes=p.data_size))
        progs.append(b.ops)
    return Schedule(p, method_id, name, progs, collective=True)


def gen_many_to_all_benchmark(p: AggregatorPattern) -> Schedule:
    return _gen_benchmark(p, 5, "Many to all benchmark")


def gen_all_to_many_benchmark(p: AggregatorPattern) -> Schedule:
    return _gen_benchmark(p, 8, "All to many benchmark")


# --------------------------------------------------------------------------
# m=6 — fully synchronous rotation (mpi_test.c:1665-1746)

def gen_all_to_many_sync(p: AggregatorPattern) -> Schedule:
    """m=6: blocking rotation. At step (k, i) rank r targets aggregator index
    (r+k+i) mod cb; aggregator with index a drains every source ≡ (a-k-i)
    mod cb. Aggregator pairs exchange via Sendrecv; self-edges via memcpy.
    The whole step is charged to recv_wait_all (mpi_test.c:1685, 1736)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        rnd = 0
        k = 0
        cs = min(p.comm_size, cb)
        while k < cb:
            if cb - k < cs:
                cs = cb - k
            for i in range(cs):
                temp = (rank + k + i) % cb
                if isagg:
                    temp2 = (myindex - k - i + cb) % cb
                    dst = int(p.rank_list[temp])
                    if dst != rank and temp2 != rank:
                        b.sendrecv(dst, temp, temp2, temp2, rnd, ds,
                                   TimerBucket.RECV_WAIT)
                    elif dst == rank:
                        b.copy(temp, rank, rnd)
                        if temp2 != rank:
                            b.blocking(OpKind.RECV, temp2, temp2, rnd, ds,
                                       TimerBucket.RECV_WAIT)
                    else:  # temp2 == rank: self delivery done by the copy branch
                        b.blocking(OpKind.SEND, dst, temp, rnd, ds,
                                   TimerBucket.RECV_WAIT)
                    for x in range(temp2 + cb, procs, cb):
                        if x != rank:
                            b.blocking(OpKind.RECV, x, x, rnd, ds,
                                       TimerBucket.RECV_WAIT)
                else:
                    b.blocking(OpKind.SEND, int(p.rank_list[temp]), temp, rnd,
                               ds, TimerBucket.RECV_WAIT)
                rnd += 1
            k += cs
        progs.append(b.ops)
    return Schedule(p, 6, "All to many sync", progs)


# --------------------------------------------------------------------------
# m=7 / m=12 — half-sync all-to-many (mpi_test.c:1055-1114, 999-1053)

def gen_all_to_many_half_sync(p: AggregatorPattern) -> Schedule:
    """m=7: aggregators pre-post the round's Irecvs; senders use blocking
    Send; Waitall per round charged to recv_wait_all (mpi_test.c:1105-1109)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        rnd = 0
        k = 0
        cs = min(p.comm_size, cb)
        while k < cb:
            if cb - k < cs:
                cs = cb - k
            toks = []
            if isagg:
                for i in range(cs):
                    for x in range((myindex - k - i + cb) % cb, procs, cb):
                        toks.append(b.nb(OpKind.IRECV, x, x, rnd, ds))
            for i in range(cs):
                temp = (rank + k + i) % cb
                b.blocking(OpKind.SEND, int(p.rank_list[temp]), temp, rnd, ds)
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, 7, "All to many half sync", progs)


def gen_all_to_many_half_sync2(p: AggregatorPattern) -> Schedule:
    """m=12: all ranks Issend the round's targets; aggregators drain sources
    with blocking Recv interleaved; Waitall for the sends
    (mpi_test.c:999-1053)."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        rnd = 0
        k = 0
        cs = min(p.comm_size, cb)
        while k < cb:
            if cb - k < cs:
                cs = cb - k
            toks = []
            for i in range(cs):
                temp = (rank + k + i) % cb
                toks.append(b.nb(OpKind.ISSEND, int(p.rank_list[temp]), temp,
                                 rnd, ds))
            if isagg:
                for i in range(cs):
                    for x in range((myindex - k - i + cb) % cb, procs, cb):
                        b.blocking(OpKind.RECV, x, x, rnd, ds)
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, 12, "All to many half sync 2", progs, uses_rendezvous=True)


# --------------------------------------------------------------------------
# m=11 — half-sync many-to-all (mpi_test.c:942-997)

def gen_many_to_all_half_sync(p: AggregatorPattern) -> Schedule:
    """m=11: aggregators Issend a strided round window; receivers drain their
    aggregators with blocking Recv in schedule order; per-round send Waitall."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    stride = (procs + cb - 1) // cb
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        rnd = 0
        k = 0
        cs = min(p.comm_size, procs)
        while k < procs:
            if procs - k < cs:
                cs = procs - k
            toks = []
            if isagg:
                for i in range(cs):
                    temp = (stride * myindex + k + i) % procs
                    toks.append(b.nb(OpKind.ISSEND, temp, temp, rnd, ds,
                                     TimerBucket.POST))
            for x in range(cs):
                for i in range(cb):
                    if rank == (k + i * stride + x) % procs:
                        b.blocking(OpKind.RECV, int(p.rank_list[i]), i, rnd,
                                   ds, TimerBucket.RECV_WAIT)
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, 11, "Many to all half sync", progs, uses_rendezvous=True)


# --------------------------------------------------------------------------
# m=9 / m=10 — MPICH pairwise exchange (mpi_test.c:421-597)

def _gen_pairwise(p: AggregatorPattern, method_id: int, name: str) -> Schedule:
    """XOR partners when nprocs is a power of two, else ring shift; one
    blocking Sendrecv per step. Zero-byte slots still synchronize (the
    reference posts them with count 0). Only total time is measured."""
    procs = p.nprocs
    send, _recv = p.dense_counts()
    sslot_of, rslot_of = _dense_slots(p)
    progs = []
    pof2 = procs & (procs - 1) == 0
    for rank in range(procs):
        b = _Prog()
        for i in range(procs):
            if pof2:
                src = dst = rank ^ i
            else:
                src = (rank - i + procs) % procs
                dst = (rank + i) % procs
            b.sendrecv(dst, int(sslot_of[dst]), src, int(rslot_of[src]), i,
                       int(send[rank, dst]))
        progs.append(b.ops)
    return Schedule(p, method_id, name, progs)


def gen_all_to_many_pairwise(p: AggregatorPattern) -> Schedule:
    return _gen_pairwise(p, 9, "All to many pairwise")


def gen_many_to_all_pairwise(p: AggregatorPattern) -> Schedule:
    return _gen_pairwise(p, 10, "Many to all pairwise")


# --------------------------------------------------------------------------
# m=13 / m=14 / m=19 — MPICH scattered alltoallv schedule
# (mpi_test.c:797-882, 656-720, 722-795)

def _gen_scattered(p: AggregatorPattern, method_id: int, name: str, *,
                   eager: bool, barrier_type: int = 0) -> Schedule:
    """Blocks of ``bblock`` Irecv (from rank+i+ii) and Issend/Isend (to
    rank-i-ii), Waitall per block. m=13 adds optional barrier per block
    (barrier_type=2) or per rep (=1); m=19 uses eager Isend, times posting
    only on non-aggregators, and ends the rep with an untimed barrier."""
    procs = p.nprocs
    send, recv = p.dense_counts()
    sslot_of, rslot_of = _dense_slots(p)
    agg_index = p.agg_index
    bblock = min(p.comm_size, procs)
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        rnd = 0
        for ii in range(0, procs, bblock):
            ss = min(procs - ii, bblock)
            toks = []
            recv_bucket = TimerBucket.NONE if eager else TimerBucket.POST
            for i in range(ss):
                dst = (rank + i + ii) % procs
                if recv[rank, dst]:
                    toks.append(b.nb(OpKind.IRECV, dst, int(rslot_of[dst]), rnd,
                                     int(recv[rank, dst]), recv_bucket))
            for i in range(ss):
                dst = (rank - i - ii + procs) % procs
                if send[rank, dst]:
                    kind = OpKind.ISEND if eager else OpKind.ISSEND
                    bucket = (TimerBucket.POST if (not eager or not isagg)
                              else TimerBucket.NONE)
                    toks.append(b.nb(kind, dst, int(sslot_of[dst]), rnd,
                                     int(send[rank, dst]), bucket))
            wb = TimerBucket.RECV_WAIT if method_id == 14 else _wait_bucket(isagg)
            b.waitall(toks, wb, rnd=rnd)
            if barrier_type == 2:
                b.barrier(rnd, TimerBucket.BARRIER)
            rnd += 1
        if barrier_type == 1:
            b.barrier(rnd - 1, TimerBucket.BARRIER)
        if method_id == 19:
            b.barrier(rnd - 1)  # mpi_test.c:785 — untimed, inside total
        progs.append(b.ops)
    return Schedule(p, method_id, name, progs, uses_rendezvous=not eager)


def gen_all_to_many_scattered(p: AggregatorPattern, barrier_type: int = 0) -> Schedule:
    return _gen_scattered(p, 13, "All to many scattered", eager=False,
                          barrier_type=barrier_type)


def gen_many_to_all_scattered(p: AggregatorPattern) -> Schedule:
    return _gen_scattered(p, 14, "Many to all scattered", eager=False)


def gen_all_to_many_scattered_isend(p: AggregatorPattern) -> Schedule:
    return _gen_scattered(p, 19, "All to many scattered isend", eager=True)


# --------------------------------------------------------------------------
# m=20 — balanced with all sends pre-posted (mpi_test.c:1338-1419)

def gen_all_to_many_balanced_pre_send(p: AggregatorPattern) -> Schedule:
    """m=20: every rank Issends ALL its slabs once at rep start (walking
    backward from its partition, skipping self), then aggregators run the
    balanced Irecv rounds; separate send Waitall at rep end. A pre-posted
    send's transfer round is the round in which its receiver posts the
    matching Irecv."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    offs, remainder, ceil_, floor_ = _balanced_partition(procs, cb)
    bblock = min(p.comm_size, procs)
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        send_start = _send_start(rank, remainder, ceil_, floor_)
        send_toks = []
        for k in range(cb):
            i = (send_start - k + cb) % cb
            dst = int(p.rank_list[i])
            if dst != rank:
                # receiver (block i) posts our Irecv in round ((rank - offs[i]) mod procs) // bblock
                rnd_s = ((rank - offs[i]) % procs) // bblock
                send_toks.append(b.nb(OpKind.ISSEND, dst, i, rnd_s, ds))
        rnd = 0
        k = 0
        cs = bblock
        while k < procs:
            if procs - k < cs:
                cs = procs - k
            toks = []
            if isagg:
                for i in range(cs):
                    temp = (k + i + offs[myindex]) % procs
                    if temp != rank:
                        toks.append(b.nb(OpKind.IRECV, temp, temp, rnd, ds,
                                         TimerBucket.POST))
                    else:
                        b.copy(myindex, temp, rnd)
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        b.waitall(send_toks, TimerBucket.SEND_WAIT, rnd=max(rnd - 1, 0))
        progs.append(b.ops)
    return Schedule(p, 20, "All to many balanced presend", progs,
                    uses_rendezvous=True)


# --------------------------------------------------------------------------
# dead-but-kept reference variants (SURVEY.md §2.1 C20/C24): registered so
# the design space stays visible, but not dispatched by the reference main.

def gen_many_to_all_balanced_boundary(p: AggregatorPattern) -> Schedule:
    """Dead code in the reference (mpi_test.c:1519-1574): strided windows on
    both sides with per-round waitall."""
    procs, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    stride = (procs + cb - 1) // cb
    progs = []
    for rank in range(procs):
        b = _Prog()
        isagg = agg_index[rank] >= 0
        myindex = int(agg_index[rank])
        rnd = 0
        k = 0
        cs = min(p.comm_size, procs)
        while k < procs:
            if procs - k < cs:
                cs = procs - k
            toks = []
            for x in range(cs):
                for i in range(cb):
                    if rank == (k + i * stride + x) % procs:
                        toks.append(b.nb(OpKind.IRECV, int(p.rank_list[i]), i,
                                         rnd, ds, TimerBucket.POST))
            if isagg:
                for i in range(cs):
                    temp = (stride * myindex + k + i) % procs
                    toks.append(b.nb(OpKind.ISSEND, temp, temp, rnd, ds,
                                     TimerBucket.POST))
            b.waitall(toks, TimerBucket.RECV_WAIT, rnd=rnd)
            k += cs
            rnd += 1
        progs.append(b.ops)
    return Schedule(p, 21, "Many to all balanced boundary", progs,
                    uses_rendezvous=True)


def gen_many_to_all_interleaved(p: AggregatorPattern) -> Schedule:
    """Dead code in the reference (mpi_test.c:1826-1869): unthrottled branch
    of m=2 with recvs first; the throttled branch is empty there, so this
    schedule ignores comm_size."""
    q = p if p.comm_size >= p.nprocs else _replace(p, comm_size=200_000_000)
    s = gen_many_to_all(q)
    return Schedule(p, 22, "Many to all interleaved", s.programs,
                    uses_rendezvous=True)


# --------------------------------------------------------------------------
# registry

@dataclass(frozen=True)
class MethodSpec:
    method_id: int
    name: str
    direction: Direction
    generator: Callable[[AggregatorPattern], Schedule]
    dispatched: bool = True  # False = dead code kept for parity
    tam: bool = False
    #: Canonical composition string for synthesized methods
    #: (tpu_aggcomm/synth/ — ids >= synth.SYNTH_ID_BASE); None for the
    #: 22 reference methods. Carrying it HERE is what makes a winner a
    #: first-class method: schedule_shape_key, caches, journals,
    #: traffic, check, fuse, and serve consume the registry unchanged.
    composition: str | None = None


def _tam_generator(p: AggregatorPattern) -> Schedule:
    from tpu_aggcomm_torch.tam.engine import gen_tam_schedule  # lazy: avoid cycle
    return gen_tam_schedule(p)


METHODS: dict[int, MethodSpec] = {
    1: MethodSpec(1, "All to many", Direction.ALL_TO_MANY, gen_all_to_many),
    2: MethodSpec(2, "Many to all", Direction.MANY_TO_ALL, gen_many_to_all),
    3: MethodSpec(3, "All to many balanced", Direction.ALL_TO_MANY,
                  gen_all_to_many_balanced),
    4: MethodSpec(4, "Many to all balanced", Direction.MANY_TO_ALL,
                  gen_many_to_all_balanced),
    5: MethodSpec(5, "Many to all benchmark", Direction.MANY_TO_ALL,
                  gen_many_to_all_benchmark),
    6: MethodSpec(6, "All to many sync", Direction.ALL_TO_MANY,
                  gen_all_to_many_sync),
    7: MethodSpec(7, "All to many half sync", Direction.ALL_TO_MANY,
                  gen_all_to_many_half_sync),
    8: MethodSpec(8, "All to many benchmark", Direction.ALL_TO_MANY,
                  gen_all_to_many_benchmark),
    9: MethodSpec(9, "All to many pairwise", Direction.ALL_TO_MANY,
                  gen_all_to_many_pairwise),
    10: MethodSpec(10, "Many to all pairwise", Direction.MANY_TO_ALL,
                   gen_many_to_all_pairwise),
    11: MethodSpec(11, "Many to all half sync", Direction.MANY_TO_ALL,
                   gen_many_to_all_half_sync),
    12: MethodSpec(12, "All to many half sync 2", Direction.ALL_TO_MANY,
                   gen_all_to_many_half_sync2),
    13: MethodSpec(13, "All to many scattered", Direction.ALL_TO_MANY,
                   gen_all_to_many_scattered),
    14: MethodSpec(14, "Many to all scattered", Direction.MANY_TO_ALL,
                   gen_many_to_all_scattered),
    15: MethodSpec(15, "All to many TAM", Direction.ALL_TO_MANY,
                   _tam_generator, tam=True),
    16: MethodSpec(16, "Many to all TAM", Direction.MANY_TO_ALL,
                   _tam_generator, tam=True),
    17: MethodSpec(17, "All to many node robin", Direction.ALL_TO_MANY,
                   gen_all_to_many_node_robin),
    18: MethodSpec(18, "All to many balanced control", Direction.ALL_TO_MANY,
                   gen_all_to_many_balanced_control),
    19: MethodSpec(19, "All to many scattered isend", Direction.ALL_TO_MANY,
                   gen_all_to_many_scattered_isend),
    20: MethodSpec(20, "All to many balanced presend", Direction.ALL_TO_MANY,
                   gen_all_to_many_balanced_pre_send),
    21: MethodSpec(21, "Many to all balanced boundary", Direction.MANY_TO_ALL,
                   gen_many_to_all_balanced_boundary, dispatched=False),
    22: MethodSpec(22, "Many to all interleaved", Direction.MANY_TO_ALL,
                   gen_many_to_all_interleaved, dispatched=False),
}


def method_ids(include_dead: bool = False) -> list[int]:
    out = [m for m, s in sorted(METHODS.items())
           if include_dead or s.dispatched]
    try:  # TAM methods are dispatchable only once the engine module exists
        import tpu_aggcomm_torch.tam.engine  # noqa: F401
    except ImportError:
        out = [m for m in out if not METHODS[m].tam]
    return out


def compile_method(method_id: int, pattern: AggregatorPattern,
                   barrier_type: int = 0) -> Schedule:
    """Compile a method id + pattern into a Schedule. The pattern's
    ``direction`` is overridden by the method's inherent direction, exactly
    like the reference where direction is baked into each function."""
    if method_id not in METHODS:
        raise ValueError(f"unknown method id {method_id}; valid ids: "
                         f"{sorted(METHODS)}")
    spec = METHODS[method_id]
    if pattern.direction is not spec.direction:
        pattern = _replace(pattern, direction=spec.direction)
    with trace.span("schedule.compile"):
        if method_id == 13:
            return gen_all_to_many_scattered(pattern,
                                             barrier_type=barrier_type)
        return spec.generator(pattern)
