"""Schedule intermediate representation.

A *schedule* is what a reference "method" (the ``-m`` switch,
mpi_test.c:2132-2134) compiles to: one op-program per rank, describing
exactly which messages are posted, in which order, with which completion
(waitall) structure, which synchronization mode (eager / rendezvous /
blocking), and which timer bucket each phase charges.

Two views of the same schedule:

- **per-rank op programs** (`Schedule.programs`) — the ground truth, faithful
  to the reference's per-rank MPI call sequences. The local oracle and the
  native C++ runtime execute these directly, preserving rendezvous and
  blocking semantics. m=1 and m=2 build their programs only when
  ``programs`` is first read: until then their closed form
  (``Schedule.closed_form``) gives the edges straight from the pattern,
  and the barrier signature is empty (they have no barriers), so a
  backend that needs only the edge view (``torch_shard``'s build) never
  makes one ``Op`` per message.
- **global round/edge view** (`Schedule.rounds()`) — edges grouped by the
  round in which their transfer completes. The JAX/ICI backend lowers each
  round to masked collective steps (ppermute batches / all_to_all); this is
  the TPU-idiomatic reinterpretation: MPI's per-rank progress becomes
  mesh-global program steps. The semantic difference (per-rank unordered
  completion vs. deterministic global steps) is intentional and documented —
  see SURVEY.md §7 "hard parts" (5).

Op vocabulary (mirrors the reference's L0 call set, SURVEY.md §5.8):
ISEND (eager, MPI_Isend), ISSEND (rendezvous, MPI_Issend), IRECV, SEND/RECV
(blocking), SENDRECV (paired blocking), WAITALL (token subset), BARRIER,
COPY (self-edge memcpy), SIGNAL_SEND/SIGNAL_RECV (0-byte handshake on a
separate channel — the dup'ed signal_comm of mpi_test.c:1252).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from tpu_aggcomm_torch.core.pattern import AggregatorPattern

__all__ = ["OpKind", "Op", "Schedule", "TimerBucket",
           "ScheduleAsymmetryError", "barrier_signatures",
           "check_barrier_symmetry", "barrier_rounds_of",
           "schedule_shape_key"]


class ScheduleAsymmetryError(AssertionError):
    """The schedule's barrier structure differs across ranks.

    Rank 0's barrier signature stands in for every rank's in
    :func:`barrier_rounds_of` and :func:`schedule_shape_key` — an
    asymmetric schedule would deadlock at runtime (generation-matched
    n-rank joins) AND alias cache entries it must not share, so both
    entry points refuse it instead of assuming symmetry.
    """


def _closed_form(schedule):
    """The schedule's closed form while its programs are unbuilt, else
    None (built programs are the ground truth, edits included)."""
    unbuilt = getattr(schedule, "unbuilt_closed_form", None)
    return unbuilt() if unbuilt is not None else None


def barrier_signatures(schedule) -> list:
    """Per-rank barrier signature: the tuple of round tags of each
    rank's BARRIER ops, in program order. Equal across ranks iff the
    schedule is barrier-SPMD-symmetric."""
    if _closed_form(schedule) is not None:
        return [()] * schedule.nprocs
    progs = getattr(schedule, "programs", None) or ()
    return [tuple(op.round for op in prog if op.kind is OpKind.BARRIER)
            for prog in progs]


def check_barrier_symmetry(schedule) -> tuple:
    """Prove every rank shares rank 0's barrier signature and return it.

    Raises :class:`ScheduleAsymmetryError` naming the first divergent
    rank otherwise. O(total ops) — cheap next to anything a signature
    consumer does with the result; a schedule answering from its closed
    form has no barriers.
    """
    if _closed_form(schedule) is not None:
        return ()
    sigs = barrier_signatures(schedule)
    ref = sigs[0] if sigs else ()
    for rank, sig in enumerate(sigs):
        if sig != ref:
            raise ScheduleAsymmetryError(
                f"{getattr(schedule, 'name', schedule)}: barrier "
                f"structure is not SPMD-symmetric — rank {rank} has "
                f"signature {sig}, rank 0 has {ref}; refusing to reuse "
                f"rank 0's signature for shape keys")
    return ref


def barrier_rounds_of(schedule) -> dict:
    """round -> number of MPI_Barrier ops in it. Barrier structure being
    SPMD-symmetric is CHECKED (:func:`check_barrier_symmetry`), not
    assumed: an asymmetric schedule raises rather than silently
    reporting rank 0's view."""
    out: dict[int, int] = {}
    for rnd in check_barrier_symmetry(schedule):
        out[rnd] = out.get(rnd, 0) + 1
    return out


def schedule_shape_key(schedule) -> tuple:
    """THE cache-key contract for anything derived from a schedule's shape
    (compiled programs, attribution weights): ``(pattern, method_id,
    collective, barrier signature)``. The method id is load-bearing —
    methods can lower to identical comm shapes while charging different
    timer buckets (m=4 vs m=11); the barrier signature is the one
    schedule-shape input not captured by (pattern, method_id): m=13's
    ``-b`` modes compile different programs from the same pattern.
    ``variant`` (the canonical fault spec stamped by faults/repair.py)
    keeps repaired/fault-injected programs from aliasing the healthy
    compiled cache entries — same pattern, different program. The
    barrier signature is rank 0's only after
    :func:`check_barrier_symmetry` proves every rank matches it — an
    asymmetric schedule must poison cache reuse (raise), never alias a
    symmetric entry."""
    barrier_sig = check_barrier_symmetry(schedule)
    return (schedule.pattern, schedule.method_id,
            getattr(schedule, "collective", False), barrier_sig,
            getattr(schedule, "variant", ""),
            getattr(schedule, "fault", None))


class OpKind(enum.IntEnum):
    ISEND = 0        # eager nonblocking send
    ISSEND = 1       # rendezvous nonblocking send (MPI_Issend semantics)
    IRECV = 2        # nonblocking receive
    SEND = 3         # blocking send
    RECV = 4         # blocking receive
    SENDRECV = 5     # paired blocking send+receive
    WAITALL = 6      # complete a set of nonblocking tokens
    BARRIER = 7      # global barrier
    COPY = 8         # local memcpy (self-edge)
    SIGNAL_SEND = 9  # 0-byte nonblocking send on the signal channel
    SIGNAL_RECV = 10 # 0-byte blocking receive on the signal channel
    ALLTOALLW = 11   # dense vendor collective (whole pattern in one call)


class TimerBucket(enum.Enum):
    """Which Timer field a timed segment charges (reference Timer,
    mpi_test.c:25-31)."""

    POST = "post_request_time"
    RECV_WAIT = "recv_wait_all_time"
    SEND_WAIT = "send_wait_all_time"
    RECV_AND_SEND_WAIT = "recv+send"  # waitall charged to both (non-agg paths)
    BARRIER = "barrier_time"
    NONE = "none"


@dataclass
class Op:
    """One step of a rank's program. Field meaning depends on kind:

    sends: ``peer`` = destination rank, ``slot`` = index into the sender's
    slab array. recvs: ``peer`` = source rank, ``slot`` = index into the
    receiver's slab array. SENDRECV: send to (peer, slot), receive from
    (peer2, slot2). WAITALL: ``tokens`` = token ids to complete. COPY:
    local ``slot`` (send side) → ``slot2`` (recv side). ``round`` tags the
    global round in which the transfer completes (collective-backend view).
    ``nbytes`` = payload size (0 ⇒ pure synchronization message).
    """

    kind: OpKind
    peer: int = -1
    slot: int = -1
    peer2: int = -1
    slot2: int = -1
    round: int = 0
    token: int = -1
    tokens: tuple[int, ...] = ()
    bucket: TimerBucket = TimerBucket.NONE
    nbytes: int = 0
    #: Matching channel. 0 = the pattern's data channel (message matching
    #: by directed (src, dst) pair, unique per rep — mpi_test.c:1776).
    #: Nonzero channels carry relay hops added by the dead-link repair
    #: pass (faults/repair.py): each rerouted edge gets its own channel so
    #: a detour sharing a directed pair with a pattern edge (or another
    #: detour) still matches uniquely.
    chan: int = 0
    #: Send side reads from the rank's RECEIVE staging row ``slot`` (set on
    #: the relay intermediate's forward hop) instead of its send slabs.
    from_stage: bool = False
    #: Receive side lands in the staging row ``slot`` (past the pattern's
    #: recv slots) instead of a pattern recv slot.
    to_stage: bool = False


class _Programs:
    """The ``programs`` field: a list of op programs, or a function that
    builds them, called on the first read and replaced by its result.
    Raises AttributeError on the class, so the field keeps no default."""

    def __set_name__(self, owner, name):
        self.slot = "_" + name

    def __get__(self, obj, owner=None):
        if obj is None:
            raise AttributeError(self.slot[1:])
        progs = obj.__dict__[self.slot]
        if callable(progs):
            progs = obj.__dict__[self.slot] = progs()
        return progs

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value


@dataclass
class Schedule:
    """A compiled method: one op program per rank plus pattern metadata.
    ``programs`` may be given as a function of no arguments that builds
    them on first read; such a schedule carries a ``closed_form`` that
    its edge and barrier views read until then."""

    pattern: AggregatorPattern
    method_id: int
    name: str              # reference label, e.g. "All to many balanced"
    programs: list[list[Op]] = _Programs()
    collective: bool = False  # True for alltoallw-style dense methods
    uses_rendezvous: bool = False
    per_rep: bool = True   # program covers ONE rep; harness loops ntimes
    #: Canonical fault spec (faults/spec.py) realized in this schedule's
    #: programs, or None for a healthy schedule. Backends read it to apply
    #: the injection layer (slow-rank work, dead-edge masking).
    fault: str | None = None
    #: Program-variant tag folded into :func:`schedule_shape_key`. The
    #: repair pass stamps the canonical fault spec here so compiled caches
    #: never alias a repaired program with the healthy one.
    variant: str = ""
    #: Number of relay staging rows appended past every rank's pattern
    #: recv slots (dead-link repair). 0 for healthy schedules.
    n_staging: int = 0
    #: Directed (src, dst) pattern edges that the fault killed and the
    #: repair rerouted — validate() exempts these from chan-0 coverage.
    dead_edges: tuple[tuple[int, int], ...] = ()
    #: Closed form of a barrier-free schedule built with deferred
    #: programs: a function of no arguments returning the (E, 5) int64
    #: rows of :meth:`data_edges` from the pattern (chan 0, no staging),
    #: in the order the op walk gives them. Not an init field, so
    #: ``dataclasses.replace`` (the repair pass, which passes new
    #: programs) never carries it over.
    closed_form: Callable[[], np.ndarray] | None = field(
        default=None, init=False, repr=False, compare=False)

    @property
    def nprocs(self) -> int:
        return self.pattern.nprocs

    def unbuilt_closed_form(self) -> Callable[[], np.ndarray] | None:
        """:attr:`closed_form` while ``programs`` has not been built."""
        if self.closed_form is None or not callable(self.__dict__["_programs"]):
            return None
        return self.closed_form

    def data_edges(self) -> np.ndarray:
        """All payload-carrying (src, dst, slot_src, slot_dst, round) tuples.

        Derived from the *send* side ops plus COPY self-edges, with
        ``slot_dst`` joined from :meth:`recv_slot_table` (directed pairs
        are unique per rep in every reference method, so the join is
        exact; -1 only when no matching receive exists). Shape (E, 5).
        Relay hops (chan != 0) are included — they are real traffic; their
        ``slot_dst`` is the logical landing index (staging rows count past
        the pattern recv slots). Consumers that must distinguish staging
        use :meth:`data_edges_ext`. A schedule whose programs are unbuilt
        answers from its closed form, the same rows in the same order.
        """
        cf = self.unbuilt_closed_form()
        if cf is not None:
            return cf()
        return self.data_edges_ext()[:, :5]

    def data_edges_ext(self) -> np.ndarray:
        """Extended edge view: (src, dst, slot_src, slot_dst, round, chan,
        flags), shape (E, 7). ``flags`` bit 0 = the send side reads from
        the source rank's staging row ``slot_src``; bit 1 = the receive
        lands in the destination's staging row ``slot_dst``. chan-0 rows
        reproduce :meth:`data_edges` exactly on healthy schedules."""
        cf = self.unbuilt_closed_form()
        if cf is not None:
            e = cf()
            return np.concatenate([e, np.zeros((len(e), 2), np.int64)], axis=1)
        rows = []
        rtable = self.recv_slot_table()
        relay = self.relay_recv_table()
        for rank, prog in enumerate(self.programs):
            for op in prog:
                if (op.kind in (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND)
                        and op.nbytes > 0):
                    if op.chan:
                        dslot, to_stage = relay.get(
                            (rank, op.peer, op.chan), (-1, False))
                    else:
                        dslot, to_stage = rtable.get((rank, op.peer), -1), False
                    flags = (1 if op.from_stage else 0) | (2 if to_stage else 0)
                    rows.append((rank, op.peer, op.slot, dslot, op.round,
                                 op.chan, flags))
                elif op.kind is OpKind.SENDRECV and op.nbytes > 0:
                    dslot = rtable.get((rank, op.peer), -1)
                    rows.append((rank, op.peer, op.slot, dslot, op.round, 0, 0))
                elif op.kind is OpKind.COPY:
                    rows.append((rank, rank, op.slot, op.slot2, op.round, 0, 0))
        return np.array(rows, dtype=np.int64).reshape(-1, 7)

    def rounds(self) -> list[np.ndarray]:
        """Edges grouped by completion round: list of (E_k, 2) arrays of
        (src, dst), self-edges included. Rounds are indexed densely from 0."""
        edges = self.data_edges()
        if len(edges) == 0:
            return []
        out = []
        for r in range(int(edges[:, 4].max()) + 1):
            sel = edges[edges[:, 4] == r]
            out.append(sel[:, :2])
        return out

    def recv_slot_table(self) -> dict[tuple[int, int], int]:
        """(src, dst) → receiver slot index, from the receive-side ops.

        Message matching is by directed pair, which is unique per rep in
        every reference method (tags are ``src + dst`` per edge,
        mpi_test.c:1776 — unique per direction within a rep). Relay-hop
        receives (chan != 0) live in :meth:`relay_recv_table` instead.
        """
        table: dict[tuple[int, int], int] = {}
        for rank, prog in enumerate(self.programs):
            for op in prog:
                if op.chan:
                    continue
                if op.kind in (OpKind.IRECV, OpKind.RECV):
                    table[(op.peer, rank)] = op.slot
                elif op.kind is OpKind.SENDRECV:
                    table[(op.peer2, rank)] = op.slot2
                elif op.kind is OpKind.COPY:
                    table[(rank, rank)] = op.slot2
        return table

    def relay_recv_table(self) -> dict[tuple[int, int, int],
                                       tuple[int, bool]]:
        """(src, dst, chan) → (receiver slot, lands_in_staging) for the
        relay-channel receives (chan != 0) the repair pass appends."""
        table: dict[tuple[int, int, int], tuple[int, bool]] = {}
        for rank, prog in enumerate(self.programs):
            for op in prog:
                if op.chan and op.kind in (OpKind.IRECV, OpKind.RECV):
                    table[(op.peer, rank, op.chan)] = (op.slot, op.to_stage)
        return table

    def validate(self) -> None:
        """Sanity-check the schedule: every data send has a matching
        receive, duplicates are checked per matching key (src, dst, chan),
        and chan-0 coverage equals the pattern's expected edges minus any
        ``dead_edges`` the repair rerouted (whose payloads arrive via the
        relay channels instead). Collective schedules get the per-edge
        checks too (their payload rides ALLTOALLW, so any point-to-point
        op they carry must still match) plus conservation of the dense
        matrices: recvcounts must be the exact transpose of sendcounts
        and every rank must post the same number of collective calls."""
        table = self.recv_slot_table()
        relay = self.relay_recv_table()
        edges = self.data_edges_ext()
        seen = set()
        chan0 = set()
        for src, dst, _sslot, _dslot, _r, chan, _flags in edges:
            key = (int(src), int(dst), int(chan))
            if key in seen:
                raise AssertionError(f"{self.name}: duplicate edge {key}")
            seen.add(key)
            if chan:
                if key not in relay:
                    raise AssertionError(
                        f"{self.name}: relay send {key} has no matching recv")
            else:
                chan0.add(key[:2])
                if key[:2] not in table:
                    raise AssertionError(
                        f"{self.name}: send {key[:2]} has no matching recv")
        if self.collective:
            send, recv = self.pattern.dense_counts()
            if (send.T != recv).any():
                raise AssertionError(
                    f"{self.name}: dense sendcounts do not transpose to "
                    f"recvcounts — {int(send.sum())} B posted vs "
                    f"{int(recv.sum())} B expected")
            arity = {sum(1 for op in prog if op.kind is OpKind.ALLTOALLW)
                     for prog in self.programs}
            if len(arity) > 1:
                raise AssertionError(
                    f"{self.name}: collective call arity differs across "
                    f"ranks: {sorted(arity)}")
        # expected coverage: every (sender, receiver) pair of the pattern,
        # less the dead edges whose chan-0 message the repair removed
        p = self.pattern
        expected = {(int(s), int(d)) for s in p.senders for d in p.receivers}
        expected -= {(int(s), int(d)) for s, d in self.dead_edges}
        if not self.collective and chan0 != expected:
            missing = sorted(expected - chan0)[:5]
            extra = sorted(chan0 - expected)[:5]
            raise AssertionError(
                f"{self.name}: edge coverage mismatch; missing={missing} extra={extra}")
