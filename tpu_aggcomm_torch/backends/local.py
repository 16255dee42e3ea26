"""Local event-driven oracle backend.

Executes a Schedule's per-rank op programs in a single process with a
discrete-event scheduler that models MPI semantics precisely enough to serve
as a correctness *and liveness* oracle:

- ISSEND (MPI_Issend) completes only when the matching receive is posted
  (rendezvous — the reference uses Issend deliberately to expose
  congestion, SURVEY.md §5.8).
- ISEND completes immediately (eager).
- RECV/SEND block; SENDRECV posts both sides then blocks on both.
- WAITALL blocks until all listed tokens are complete.
- BARRIER blocks until every rank arrives.
- Messages match by directed (src, dst) pair within one rep — unique in all
  reference methods (tag = src+dst per edge, mpi_test.c:1776).

If no rank can advance and the programs are unfinished, the schedule
deadlocks under MPI semantics: we raise with a per-rank stuck-op dump. This
makes the oracle a schedule-semantics validator, not just a data checker —
something the reference never had (its only guard was "it hung on Theta").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.schedule import Op, OpKind, Schedule
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import make_send_slabs
from tpu_aggcomm_torch.obs import trace

__all__ = ["LocalBackend", "DeadlockError", "run_schedule_local"]


class DeadlockError(RuntimeError):
    pass


@dataclass
class _RankState:
    prog: list[Op]
    pc: int = 0
    # tokens completed so far
    done: set = field(default_factory=set)
    # pending nonblocking sends: token -> (dst, slot, rendezvous)
    blocked: bool = False


class LocalBackend:
    """Single-process oracle executor. ``run`` returns (recv_bufs, timers)."""

    name = "local"

    def run(self, schedule, *, ntimes: int = 1, iter_: int = 0,
            verify: bool = False):
        from tpu_aggcomm_torch.tam.engine import TamMethod, tam_oracle
        # rep wall time only; phase columns stay zero (the oracle times
        # whole reps, not ops) — recorded so report sidecars can't read
        # the zeros as measured phases
        self.last_provenance = ("local", "total-only")
        p = schedule.pattern
        if isinstance(schedule, TamMethod):
            run_rep = lambda bufs: tam_oracle(schedule, iter_)  # noqa: E731
            recv_bufs = None
        else:
            recv_bufs = _alloc_recv(p, getattr(schedule, "n_staging", 0))
            send_slabs = make_send_slabs(p, iter_)  # same every rep

            def run_rep(bufs):
                _run_one_rep(schedule, bufs, send_slabs)
                return bufs

        self.last_rep_timers = []  # [rep][rank] -> Timer (save_all_timing)
        for rep in range(ntimes):
            with trace.span("local.rep", rep=rep, method=schedule.name):
                t0 = time.perf_counter()
                recv_bufs = run_rep(recv_bufs)
                dt = time.perf_counter() - t0
            self.last_rep_timers.append(
                [Timer(total_time=dt) for _ in range(p.nprocs)])
        if getattr(schedule, "n_staging", 0) and recv_bufs is not None:
            # relay staging rows are repair plumbing, not pattern data —
            # strip them so verify and callers see the healthy layout
            from tpu_aggcomm_torch.harness.verify import recv_slot_counts
            recv_bufs = [b[:c] if c else None
                         for b, c in zip(recv_bufs, recv_slot_counts(p))]
        if verify:
            from tpu_aggcomm_torch.harness.verify import verify_recv
            verify_recv(p, recv_bufs, iter_)
        timers = [Timer() for _ in range(p.nprocs)]
        for rep in self.last_rep_timers:
            for t, rt in zip(timers, rep):
                t += rt
        return recv_bufs, timers


def _alloc_recv(p: AggregatorPattern,
                n_staging: int = 0) -> list[np.ndarray | None]:
    from tpu_aggcomm_torch.harness.verify import recv_slot_counts
    # with staging (dead-link repair), EVERY rank gets the extra rows past
    # its pattern slots — any live rank can be elected relay intermediate
    return [np.zeros((c + n_staging, p.data_size), dtype=np.uint8)
            if c + n_staging else None
            for c in recv_slot_counts(p)]


def _run_one_rep(schedule: Schedule, recv_bufs, send_slabs) -> None:
    p = schedule.pattern
    n = p.nprocs

    if schedule.collective:
        _run_alltoallw(p, send_slabs, recv_bufs)
        return

    states = [_RankState(prog) for prog in schedule.programs]
    # flight recorder: every delivery emits a host-measured instant with
    # its throttle round — the oracle's real per-round boundary events
    # (the compiled backends reconstruct theirs from attribution instead)
    rec = trace.current()
    # fault plumbing (faults/): staging row base per rank for relay hops,
    # and the dead chan-0 edges whose payload the link drops. A REPAIRED
    # schedule has no chan-0 op left on a dead edge (the detour replaced
    # it); an UNREPAIRED faulted schedule loses the message here — eager
    # sends complete but bytes never land (verify fails), rendezvous
    # sends never match (DeadlockError) — which is the injection working.
    n_staging = getattr(schedule, "n_staging", 0)
    stage_base = None
    if n_staging:
        from tpu_aggcomm_torch.harness.verify import recv_slot_counts
        stage_base = recv_slot_counts(p)
    dead_edges: set = set()
    fault = getattr(schedule, "fault", None)
    if fault:
        from tpu_aggcomm_torch.faults.spec import parse_fault
        dead_edges = set(parse_fault(fault).deadlinks)
    # message plumbing, keyed by (src, dst, chan) — chan 0 is the pattern
    # data channel; nonzero channels carry repair relay hops:
    #  sends_posted[key] = (slot, token|None, rendezvous, nbytes, round,
    #                       from_stage)
    #  recvs_posted[key] = (row, token|None)  [row = resolved buffer row]
    sends_posted: dict = {}
    recvs_posted: dict = {}
    delivered: set = set()
    signals_posted: set = set()
    # barriers are SPMD-symmetric: rank r waits at its g-th barrier; release
    # when all n ranks sit at the same generation (guards against mixing
    # distinct barrier instances when ranks run ahead).
    barrier_waiting: dict = {}
    barrier_gen = [0] * n
    in_collective: set = set()

    def try_deliver(key):
        if key in delivered:
            return
        if key in sends_posted and key in recvs_posted:
            src, dst, chan = key
            if chan == 0 and (src, dst) in dead_edges:
                return  # the link drops it: no delivery, no completion
            sslot, stok, rendezvous, nbytes, rnd, from_stage = \
                sends_posted[key]
            rslot, rtok = recvs_posted[key]
            if nbytes > 0:
                if from_stage:
                    # relay forward hop: source bytes come from the relay
                    # rank's staging row (.copy(): both live in recv_bufs)
                    src_bytes = recv_bufs[src][
                        stage_base[src] + sslot].copy()
                else:
                    src_bytes = send_slabs[src][sslot]
                recv_bufs[dst][rslot] = src_bytes
            delivered.add(key)
            if rec is not None:
                rec.instant("local.deliver", src=src, dst=dst,
                            round=rnd, nbytes=nbytes)
            # completion: send token completes (rendezvous satisfied), recv
            # token completes.
            if stok is not None:
                states[src].done.add(stok)
            if rtok is not None:
                states[dst].done.add(rtok)

    def send_complete(key) -> bool:
        return key in delivered

    def recv_complete(key) -> bool:
        return key in delivered

    def step(rank: int) -> bool:
        """Try to advance rank by one op. Returns True if progress was made."""
        st = states[rank]
        if st.pc >= len(st.prog):
            return False
        op = st.prog[st.pc]
        k = op.kind
        if k is OpKind.ISSEND or k is OpKind.ISEND:
            key = (rank, op.peer, op.chan)
            sends_posted[key] = (op.slot, op.token, k is OpKind.ISSEND,
                                 op.nbytes, op.round, op.from_stage)
            if k is OpKind.ISEND:
                # eager: complete at post time; delivery happens at match
                states[rank].done.add(op.token)
            try_deliver(key)
            st.pc += 1
            return True
        if k is OpKind.IRECV:
            key = (op.peer, rank, op.chan)
            row = (stage_base[rank] + op.slot if op.to_stage else op.slot)
            recvs_posted[key] = (row, op.token)
            try_deliver(key)
            st.pc += 1
            return True
        if k is OpKind.SEND:
            # Blocking MPI_Send completes once the message is buffered; for
            # benchmark-sized payloads MPICH sends eagerly, and the reference's
            # sync methods (m=6/7) NEED that: under strict rendezvous their
            # send→recv chains deadlock (verified by this oracle). Model SEND
            # as eager; only Issend keeps rendezvous semantics.
            key = (rank, op.peer, op.chan)
            if key not in sends_posted:
                sends_posted[key] = (op.slot, None, False, op.nbytes,
                                     op.round, op.from_stage)
                try_deliver(key)
            st.pc += 1
            return True
        if k is OpKind.RECV:
            key = (op.peer, rank, op.chan)
            if key not in recvs_posted:
                recvs_posted[key] = (op.slot, None)
                try_deliver(key)
            if recv_complete(key):
                st.pc += 1
                return True
            return False
        if k is OpKind.SENDRECV:
            # The send half is a standard-mode send (eager, like SEND above);
            # the call blocks only until the receive half completes.
            skey = (rank, op.peer, 0)
            rkey = (op.peer2, rank, 0)
            if skey not in sends_posted:
                sends_posted[skey] = (op.slot, None, False, op.nbytes,
                                      op.round, False)
                try_deliver(skey)
            if rkey not in recvs_posted:
                recvs_posted[rkey] = (op.slot2, None)
                try_deliver(rkey)
            if recv_complete(rkey):
                st.pc += 1
                return True
            return False
        if k is OpKind.WAITALL:
            if all(t in st.done for t in op.tokens):
                st.pc += 1
                return True
            return False
        if k is OpKind.BARRIER:
            barrier_waiting[rank] = barrier_gen[rank]
            if len(barrier_waiting) == n:
                gens = set(barrier_waiting.values())
                assert len(gens) == 1, f"barrier generation skew: {gens}"
                for r in list(barrier_waiting):
                    states[r].pc += 1
                    barrier_gen[r] += 1
                barrier_waiting.clear()
                return True
            return False
        if k is OpKind.COPY:
            recv_bufs[rank][op.slot2] = send_slabs[rank][op.slot]
            st.pc += 1
            return True
        if k is OpKind.SIGNAL_SEND:
            signals_posted.add((rank, op.peer))
            if op.token >= 0:
                st.done.add(op.token)  # 0-byte eager Isend completes immediately
            st.pc += 1
            return True
        if k is OpKind.SIGNAL_RECV:
            if (op.peer, rank) in signals_posted:
                signals_posted.discard((op.peer, rank))
                st.pc += 1
                return True
            return False
        if k is OpKind.ALLTOALLW:
            in_collective.add(rank)
            if len(in_collective) == n:
                _run_alltoallw(p, send_slabs, recv_bufs)
                for r in list(in_collective):
                    states[r].pc += 1
                in_collective.clear()
                return True
            return False
        raise AssertionError(f"unknown op kind {k}")

    # round-robin until quiescent
    while True:
        progress = False
        all_done = True
        for rank in range(n):
            while step(rank):
                progress = True
            if states[rank].pc < len(states[rank].prog):
                all_done = False
        if all_done:
            break
        if not progress:
            stuck = {r: str(states[r].prog[states[r].pc])
                     for r in range(n) if states[r].pc < len(states[r].prog)}
            raise DeadlockError(
                f"schedule '{schedule.name}' deadlocks under MPI semantics; "
                f"stuck ops: {dict(list(stuck.items())[:4])}")


def _run_alltoallw(p: AggregatorPattern, send_slabs, recv_bufs) -> None:
    """Dense delivery of the whole pattern (MPI_Alltoallw analog)."""
    agg_index = p.agg_index
    if p.direction is Direction.ALL_TO_MANY:
        for g in p.rank_list:
            g = int(g)
            slot = int(agg_index[g])
            for src in range(p.nprocs):
                recv_bufs[g][src] = send_slabs[src][slot]
    else:
        for rank in range(p.nprocs):
            for i, g in enumerate(p.rank_list):
                recv_bufs[rank][i] = send_slabs[int(g)][rank]


def run_schedule_local(schedule: Schedule, **kw):
    return LocalBackend().run(schedule, **kw)
