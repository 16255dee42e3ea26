"""torch_sim: every logical rank on ONE device, as the leading axis of the
arenas. The port of ``tpu_aggcomm/backends/jax_sim.py``'s healthy
lowering.

One throttle round is one gather plus one scatter over the rank axis
(``recv[dsts, dslots] = send[srcs, sslots]``), exactly the round's
message set. Rounds are separate launches on one stream, in order, so no
round can start before the previous one has landed: the ``-c`` rounds
stay distinct device steps (nothing is traced or compiled, so nothing can
merge them). A reference MPI_Barrier becomes a reduction over every
rank's recv lane 0 written into the trash row, the data dependency a real
barrier has. Dense methods (m=5/8) lower to the transpose plus placement
gather exchange.

Two lowerings share one predicate, :func:`_scan_lowered`, as in the
reference: many-round, barrier-light schedules run padded per-round
tables (pad entries scatter ``send[0, 0]`` into rank 0's trash row, and
a barrier token is written only in rounds that carry one); everything
else runs the round tables as they are. Both are reproduced so the recv
arena, trash row included, is byte-equal to the reference's.

Arenas are int32 views of uint32 lanes (or bytes when ``d % 4``), see
:mod:`tpu_aggcomm_torch.backends.lanes`. The plain indexing here is the
reference's XLA code, not a Pallas kernel, so it stays torch indexing;
the fused backend (:mod:`tpu_aggcomm_torch.backends.cuda_fused`) is the
one-kernel lowering.

Not ported yet (each raises :class:`NotPortedError`, see ROADMAP.md):
TAM schedules, fault-injected schedules, ``profile_rounds``, measured
phases and round-prefix truncation.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from tpu_aggcomm_torch.backends.lanes import (from_reference, lane_layout,
                                              lanes_to_bytes, to_lanes,
                                              to_reference, wrap_i32)
from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.schedule import (Schedule, barrier_rounds_of,
                                             schedule_shape_key)
from tpu_aggcomm_torch.device import resolve_device, sync
from tpu_aggcomm_torch.harness.attribution import (attribute_total,
                                                   weights_for)
from tpu_aggcomm_torch.harness.chained import (chain_token,
                                               differenced_trials, xor_word)
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import (make_send_slabs,
                                              recv_slot_counts, slot_shapes,
                                              verify_recv)

__all__ = ["TorchSimBackend", "NotPortedError", "dense_send_bytes",
           "dense_send_lanes"]


class NotPortedError(NotImplementedError):
    """A reference feature this port does not carry yet; ROADMAP.md
    (queue A) lists it in the order it will be ported."""


def dense_send_bytes(p: AggregatorPattern, iter_: int) -> np.ndarray:
    """Dense (nprocs, n_send_slots, data_size) uint8 send payload: every
    rank's deterministic-fill slabs, zero rows for ranks that send none."""
    n_send_slots, _ = slot_shapes(p)
    out = np.zeros((p.nprocs, n_send_slots, p.data_size), dtype=np.uint8)
    for r, s in enumerate(make_send_slabs(p, iter_)):
        if s is not None:
            out[r, :s.shape[0]] = s
    return out


def dense_send_lanes(p: AggregatorPattern, iter_: int) -> np.ndarray:
    """Dense (nprocs, n_send_slots, w) send payload in the lane layout —
    the global-slab-index addressing the rank-axis reps use."""
    return to_lanes(dense_send_bytes(p, iter_), p.data_size)


def _round_tables(schedule: Schedule):
    """Per-round (round id, srcs, sslots, dsts, dslots) int32 arrays plus
    the barrier counts. Within one round every (src, dst) edge is unique
    and each receiver slot is written by exactly one edge, so a single
    scatter per round is exact."""
    if getattr(schedule, "n_staging", 0):
        raise ValueError(
            f"schedule {schedule.name!r} carries dead-link relay staging; "
            f"the healthy round tables cannot represent it (the faulted "
            f"lowering builds its own from data_edges_ext)")
    edges = schedule.data_edges()
    rtable = schedule.recv_slot_table()
    rounds = []
    n_rounds = int(edges[:, 4].max()) + 1 if len(edges) else 0
    for r in range(n_rounds):
        sel = edges[edges[:, 4] == r]
        if len(sel) == 0:
            continue
        srcs = sel[:, 0].astype(np.int32)
        dsts = sel[:, 1].astype(np.int32)
        sslots = sel[:, 2].astype(np.int32)
        dslots = np.array([rtable[(int(s), int(d))]
                           for s, d in zip(srcs, dsts)], dtype=np.int32)
        rounds.append((r, srcs, sslots, dsts, dslots))

    barrier_rounds = barrier_rounds_of(schedule)
    kept = {r for r, *_ in rounds}
    orphans = set(barrier_rounds) - kept
    if orphans:
        raise ValueError(
            f"schedule {schedule.name!r} has barrier-only rounds "
            f"{sorted(orphans)} with no data edges; the torch_sim round "
            f"lowering cannot represent a standalone fence")
    return rounds, barrier_rounds


def _scan_lowered(tabs, barrier_rounds) -> bool:
    """THE lowering predicate, as in the reference: schedules of at least
    32 rounds with at most one barrier per round take the padded-table
    form, everything else the round tables as they are."""
    return (len(tabs) >= 32
            and all(v <= 1 for v in barrier_rounds.values()))


def _scatter_tables(schedule: Schedule, n_recv_slots: int):
    """The per-round ``(srcs, sslots, dsts, dslots)`` int64 arrays the rep
    runs, and each round's barrier count. Under :func:`_scan_lowered` the
    rounds are padded to one width as the reference's ``lax.scan`` form
    pads them: a pad entry gathers ``send[0, 0]`` into rank 0's trash row,
    so duplicate scatter targets only ever carry that one value."""
    rounds, barrier_rounds = _round_tables(schedule)
    tabs = [tuple(np.asarray(t, dtype=np.int64) for t in tab)
            for (_r, *tab) in rounds]
    nbars = [barrier_rounds.get(r, 0) for (r, *_rest) in rounds]
    if not _scan_lowered(tabs, barrier_rounds):
        return tabs, nbars
    width = max(len(srcs) for (srcs, *_rest) in tabs)
    padded = []
    for srcs, ss, dsts, ds_ in tabs:
        pad = width - len(srcs)
        zeros = np.zeros(pad, dtype=np.int64)
        padded.append((np.concatenate([srcs, zeros]),
                       np.concatenate([ss, zeros]),
                       np.concatenate([dsts, zeros]),
                       np.concatenate([ds_, np.full(pad, n_recv_slots,
                                                    dtype=np.int64)])))
    return padded, nbars


def _dense_tables(p: AggregatorPattern, n_recv_slots: int):
    """m=5/8 dense exchange tables: per destination rank d, the send slot
    it reads (``sslot``), whether that slot exists (``smask``), and the
    recv slot every source lands in (``rslot``; the trash row for ranks
    that receive nothing, whose rows are all zero)."""
    n = p.nprocs
    agg_index = np.asarray(p.agg_index)
    if p.direction is Direction.ALL_TO_MANY:
        sslot_of, rslot_of = agg_index, np.arange(n)
    else:
        sslot_of, rslot_of = np.arange(n), agg_index
    return (np.maximum(sslot_of, 0).astype(np.int64), sslot_of >= 0,
            np.where(rslot_of >= 0, rslot_of, n_recv_slots).astype(np.int64))


def _barrier_token(recv: torch.Tensor, n_recv_slots: int) -> torch.Tensor:
    """int32 sum of every rank's recv lane 0 (wrapping, as the reference's
    x64-off sum does), in the arena's lane dtype."""
    tok = wrap_i32(recv[:, :n_recv_slots, 0].to(torch.int64).sum())
    if recv.dtype == torch.uint8:
        return (tok & 0xFF).to(torch.uint8)
    return tok


class TorchSimBackend:
    """Executes schedules on one device with ranks as an array axis."""

    name = "torch_sim"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache: dict = {}
        self._chain_cache: dict = {}
        #: per-trial differenced seconds behind the last measure_per_rep
        self.last_samples: list[float] | None = None

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    def one_rep(self, schedule):
        """rep(send) -> recv over the dense rank-axis layout
        (:func:`dense_send_lanes` through ``lanes.from_reference``)."""
        return self._one_rep(schedule)

    def _one_rep(self, schedule, upto: int | None = None):
        if upto is not None:
            raise NotPortedError(
                "torch_sim: round-prefix truncation (measured phases) is "
                "not ported yet; see ROADMAP.md")
        if not isinstance(schedule, Schedule):
            raise NotPortedError(
                f"torch_sim: {getattr(schedule, 'name', schedule)!r} is a "
                f"TAM schedule; the 3-hop TAM route is not ported yet, see "
                f"ROADMAP.md")
        if (getattr(schedule, "fault", None)
                or getattr(schedule, "n_staging", 0)):
            raise NotPortedError(
                f"torch_sim: schedule {schedule.name!r} is fault-injected; "
                f"the faulted lowering is not ported yet, see ROADMAP.md")

        p = schedule.pattern
        n = p.nprocs
        _, n_recv_slots = slot_shapes(p)
        _, dt, w = lane_layout(p.data_size)
        dev = self.device

        if schedule.collective:
            # m=5/8: the whole pattern as one dense exchange — dst-major
            # rows built per rank, exchanged by transpose, scattered into
            # recv slots (uniform sizes make the zero-masked form exact)
            sslot, smask, rslot = _dense_tables(p, n_recv_slots)
            sslot_c, rslot_c = self._idx(sslot), self._idx(rslot)
            smask = torch.as_tensor(smask, device=dev).to(dt)[None, :, None]

            def rep(send):
                rows = send[:, sslot_c] * smask          # (n, n, w)
                got = rows.transpose(0, 1)               # got[d, s]
                recv = torch.zeros((n, n_recv_slots + 1, w), dtype=dt,
                                   device=dev)
                recv[:, rslot_c] = got
                return recv

            return rep

        tabs, nbars = _scatter_tables(schedule, n_recv_slots)
        kept = [tuple(self._idx(t) for t in tab) for tab in tabs]

        def rep(send):
            recv = torch.zeros((n, n_recv_slots + 1, w), dtype=dt,
                               device=dev)
            for (srcs, ss, dsts, ds_), nbar in zip(kept, nbars):
                recv[dsts, ds_] = send[srcs, ss]
                for _ in range(nbar):
                    recv[:, n_recv_slots, 0] = _barrier_token(
                        recv, n_recv_slots)
            return recv

        return rep

    def _compiled(self, schedule):
        key = schedule_shape_key(schedule)
        if key not in self._cache:
            self._cache[key] = self._one_rep(schedule)
        return self._cache[key]

    # ------------------------------------------------------------------
    def _global_send(self, p: AggregatorPattern, iter_: int) -> torch.Tensor:
        return from_reference(dense_send_lanes(p, iter_), self.device)

    def _recv_bufs(self, p: AggregatorPattern, out: torch.Tensor) -> list:
        """Per-rank recv slab matrices in bytes (None for ranks that
        receive nothing); only receiving ranks leave the device."""
        counts = recv_slot_counts(p)
        _, n_recv_slots = slot_shapes(p)
        ranks = [r for r in range(p.nprocs) if counts[r]]
        bufs: list = [None] * p.nprocs
        if ranks:
            rows = out[self._idx(ranks), :n_recv_slots]
            got = lanes_to_bytes(to_reference(rows), p.data_size)
            for i, r in enumerate(ranks):
                bufs[r] = got[i]
        return bufs

    def run(self, schedule, *, ntimes: int = 1, iter_: int = 0,
            verify: bool = False, chained: bool = False,
            profile_rounds: bool = False, measured_phases: bool = False):
        if ntimes < 1:
            raise ValueError("ntimes must be >= 1")
        if profile_rounds:
            raise NotPortedError(
                f"{self.name}: profile_rounds is not ported yet; see "
                f"ROADMAP.md")
        if measured_phases:
            raise NotPortedError(
                f"{self.name}: measured phases are not ported yet; see "
                f"ROADMAP.md")
        p = schedule.pattern
        send = self._global_send(p, iter_)
        fn = self._compiled(schedule)
        out = fn(send)
        sync(self.device)                     # warm-up

        self.last_provenance = (
            self.name, "attributed-chained" if chained else "attributed")
        timers = [Timer() for _ in range(p.nprocs)]
        self.last_rep_timers = []
        attr_w = weights_for(schedule)
        if chained:
            per_rep = self.measure_per_rep(schedule)
            rep_attr = attribute_total(schedule, per_rep, weights=attr_w)
            for r, t in enumerate(timers):
                t += Timer.from_array(rep_attr[r].as_array() * ntimes)
            self.last_rep_timers = [
                [Timer.from_array(t.as_array()) for t in rep_attr]
                for _ in range(ntimes)]
        else:
            for _rep in range(ntimes):
                t0 = time.perf_counter()
                out = fn(send)
                sync(self.device)
                dt = time.perf_counter() - t0
                rep_attr = attribute_total(schedule, dt, weights=attr_w)
                for r, t in enumerate(timers):
                    t += rep_attr[r]
                self.last_rep_timers.append(rep_attr)

        recv_bufs = self._recv_bufs(p, out)
        if verify:
            verify_recv(p, recv_bufs, iter_)
        return recv_bufs, timers

    # ------------------------------------------------------------------
    def _chain_factory(self, rep, p):
        """THE serial-chain scaffold: ``iters`` reps of ``rep`` back to
        back, rep r+1's send XOR-perturbed by
        ``(sum of rep r's recv lane 0 + r) % 251`` — the reference's
        token, so chain end states are byte-equal across packages."""
        _, n_recv_slots = slot_shapes(p)
        _, dt, _w = lane_layout(p.data_size)

        def make_chain(iters: int):
            def chain(send0):
                send = send0
                for r in range(iters):
                    recv = rep(send)
                    send = send ^ xor_word(
                        chain_token(recv, n_recv_slots, r), dt)
                return send
            return chain

        return make_chain

    def measure_per_rep(self, schedule, *, iters_small: int = 50,
                        iters_big: int = 1050, trials: int = 3,
                        windows: int = 3) -> float:
        """Serial-chained per-rep seconds with the fixed overhead
        differenced away (harness/chained.py); cached per schedule."""
        key = (schedule_shape_key(schedule), iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            per_rep, samples = self._chain_cache[key]
            self.last_samples = list(samples)
            return per_rep
        p = schedule.pattern
        make_chain = self._chain_factory(self._compiled(schedule), p)
        samples = differenced_trials(make_chain, self._global_send(p, 0),
                                     iters_small=iters_small,
                                     iters_big=iters_big, trials=trials,
                                     windows=windows)
        per_rep = statistics.median(samples)
        self._chain_cache[key] = (per_rep, tuple(samples))
        self.last_samples = list(samples)
        return per_rep
