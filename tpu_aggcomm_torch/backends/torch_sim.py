"""torch_sim: every logical rank on ONE device, as the leading axis of the
arenas. The port of ``tpu_aggcomm/backends/jax_sim.py``.

One throttle round is one gather plus one scatter over the rank axis
(``recv[dsts, dslots] = send[srcs, sslots]``), exactly the round's
message set. Rounds are separate launches on one stream, in order, so no
round can start before the previous one has landed: the ``-c`` rounds
stay distinct device steps (nothing is traced or compiled, so nothing can
merge them). A reference MPI_Barrier becomes a reduction over every
rank's recv lane 0 written into the trash row, the data dependency a real
barrier has. Dense methods (m=5/8) lower to the transpose plus placement
gather exchange. TAM (m=15/16) runs the proxy engine's route as three
gather hops over flattened slab arrays (:func:`_tam_tables`).

Two lowerings share one predicate, :func:`_scan_lowered`, as in the
reference: many-round, barrier-light schedules run padded per-round
tables (pad entries scatter ``send[0, 0]`` into rank 0's trash row, and
a barrier token is written only in rounds that carry one); everything
else runs the round tables as they are. Both are reproduced so the recv
arena, trash row included, is byte-equal to the reference's.

Timing: ``--chained`` and the measured phases chain reps serially and
difference two chain lengths (:mod:`tpu_aggcomm_torch.harness.chained`;
on a CUDA device the chain is CUDA graph replays). The measured phases
difference truncated programs through that one scaffold: round prefixes
(``_one_rep(upto=k)``), the delivery-only rep (``_one_rep_scatters``),
the per-round hybrid (``_one_rep_hybrid``) and the TAM hop prefixes
(``_tam_rep(upto_hop=...)``). ``profile_rounds`` launches each round on
its own and times it on the host clock after a synchronize.

Arenas are int32 views of uint32 lanes (or bytes when ``d % 4``), see
:mod:`tpu_aggcomm_torch.backends.lanes`. The plain indexing here is the
reference's XLA code, not a Pallas kernel, so it stays torch indexing;
the fused backend (:mod:`tpu_aggcomm_torch.backends.cuda_fused`) is the
one-kernel lowering.

Every rep takes a leading request axis as it is (:meth:`TorchSimBackend.
batched_rep`, the serve layer's batch): ``(B, n, S, w)`` send lanes give
``(B, n, R+1, w)`` recv lanes, each round still one gather and one
scatter (now over all B requests at once) and each barrier token summed
over ONE request's data rows, so every request's arena, trash row
included, is the one its own rep writes. This is the reference's
``jax.vmap`` over ``one_rep`` written out: an added axis, never a merged
round.

Fault-injected schedules (``faults/``) take their own lowering,
:meth:`TorchSimBackend._one_rep_faulted`, the port of the reference's:
the recv arena grows by the relay staging rows of a dead-link repair,
a relay's forward hop gathers from its staging row of recv, the chan-0
edges an UNREPAIRED fault names drop out, and each slow rank runs the
delay loop of kernel ``csrc/slow_delay.cu``
(:mod:`tpu_aggcomm_torch.backends.slow_delay`) after the rounds.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from tpu_aggcomm_torch.backends.lanes import (from_reference, lane_layout,
                                              lanes_to_bytes, to_lanes,
                                              to_reference, wrap_i32)
from tpu_aggcomm_torch.backends.slow_delay import slow_delay, slow_tables
from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.schedule import (Schedule, barrier_rounds_of,
                                             schedule_shape_key)
from tpu_aggcomm_torch.device import resolve_device, sync
from tpu_aggcomm_torch.faults.inject import dead_edge_mask, slow_iter_table
from tpu_aggcomm_torch.faults.spec import parse_fault
from tpu_aggcomm_torch.harness.attribution import (attribute_measured_split,
                                                   attribute_round_splits,
                                                   attribute_rounds,
                                                   attribute_tam_hops,
                                                   attribute_total,
                                                   weights_for)
from tpu_aggcomm_torch.harness.chained import (MAX_MEASURED_ROUNDS,
                                               differenced_per_rep,
                                               differenced_round_times,
                                               differenced_trials,
                                               eager_chain, graph_chain)
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import (make_send_slabs,
                                              recv_slot_counts, slot_shapes,
                                              verify_recv)
from tpu_aggcomm_torch.tam.engine import TamMethod
from tpu_aggcomm_torch.tam.relay import relay_orders

__all__ = ["TorchSimBackend", "NotPortedError", "dense_send_bytes",
           "dense_send_lanes", "dense_send_batch"]


class NotPortedError(NotImplementedError):
    """A reference feature this port refuses by name: K3 across cards
    (``cuda_dma*`` under a process group), ``--fault`` on ``torch_ici``
    and on ``native``, and ``torch_shard``'s TAM fallback. ROADMAP.md
    says what each waits for."""


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


def dense_send_batch(p: AggregatorPattern, iters, padded: int,
                     device) -> torch.Tensor:
    """``(padded, n, S, w)`` send lanes on ``device`` for a batch of
    requests (one per ``iters`` entry), padded to ``padded`` by repeating
    the last request's payload, as the reference's serve executor pads:
    one host build, one copy to the device."""
    sends = np.stack([dense_send_lanes(p, it) for it in iters])
    if padded > len(iters):
        pad = np.broadcast_to(sends[-1], (padded - len(iters),)
                              + sends.shape[1:])
        sends = np.concatenate([sends, pad], axis=0)
    return from_reference(sends, device)


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


def _faulted_tables(schedule: Schedule, n_recv_slots: int):
    """The faulted lowering's tables, as the reference builds them
    (``jax_sim.py:400-430``): the extended edge table with the chan-0
    edges an unrepaired fault names masked out, one entry per round
    ``(round id, srcs, sslots, dsts, dslots, from_stage)``. A relay hop's
    staging slots are offset past the pattern recv slots (rows
    ``n_recv_slots .. F-1``; F, the trash row, follows them). Also the
    barrier counts, F, and the per-rank delay-loop iterations, whose
    depth is the largest round id + 1 of the masked table, relay rounds
    included."""
    p = schedule.pattern
    F = n_recv_slots + int(getattr(schedule, "n_staging", 0))
    spec = parse_fault(getattr(schedule, "fault", None))
    ext = schedule.data_edges_ext()
    ext = ext[dead_edge_mask(ext, spec)]
    barrier_rounds = barrier_rounds_of(schedule)
    rounds = []
    n_rounds = int(ext[:, 4].max()) + 1 if len(ext) else 0
    for r in range(n_rounds):
        sel = ext[ext[:, 4] == r]
        if len(sel) == 0:
            continue
        from_stage = (sel[:, 6] & 1) != 0
        to_stage = (sel[:, 6] & 2) != 0
        rounds.append((
            r,
            sel[:, 0].astype(np.int64),
            np.where(from_stage, n_recv_slots + sel[:, 2],
                     sel[:, 2]).astype(np.int64),
            sel[:, 1].astype(np.int64),
            np.where(to_stage, n_recv_slots + sel[:, 3],
                     sel[:, 3]).astype(np.int64),
            from_stage))
    orphans = set(barrier_rounds) - {r for r, *_ in rounds}
    if orphans:
        raise ValueError(
            f"schedule {schedule.name!r} has barrier-only rounds "
            f"{sorted(orphans)} with no data edges; the torch_sim round "
            f"lowering cannot represent a standalone fence")
    slow = slow_iter_table(spec, p.nprocs, max(n_rounds, 1))
    return rounds, barrier_rounds, F, slow


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
    x64-off sum does), in the arena's lane dtype: one token per request
    (shape ``recv.shape[:-3]``), each over that request's data rows only,
    as the reference's per-element vmap semantics give it."""
    tok = wrap_i32(recv[..., :n_recv_slots, 0].to(torch.int64)
                   .sum(dim=(-2, -1)))
    if recv.dtype == torch.uint8:
        return (tok & 0xFF).to(torch.uint8)
    return tok


def _apply_round(send, recv, srcs, ss, dsts, ds_, nbar: int,
                 n_recv_slots: int):
    """One throttle round, in place on ``recv``: gather the round's
    messages, land them in their recv slots, then emit its barriers (each
    a reduction of every rank's recv lane 0 into the trash row). Shared
    by the whole rep, its prefixes and the profile_rounds segments, so
    the profiled and measured decompositions cannot drift from the
    program they decompose."""
    recv[..., dsts, ds_, :] = send[..., srcs, ss, :]
    return _barriers(recv, nbar, n_recv_slots)


def _barriers(recv, nbar: int, n_recv_slots: int, row: int | None = None):
    """``nbar`` barrier tokens into lane 0 of the trash row (``row``,
    default ``n_recv_slots``), one per request."""
    row = n_recv_slots if row is None else row
    for _ in range(nbar):
        recv[..., row, 0] = _barrier_token(recv, n_recv_slots)[..., None]
    return recv


def _deliver_round(send, recv, srcs, ss, dsts, ds_, nbar: int,
                   n_recv_slots: int):
    """:func:`_apply_round` without its per-edge gather: the round's recv
    slots all receive ONE gathered row (the round's first edge's), so
    only the delivery side runs. Barriers stay (they are deliver-side),
    and the single-row read keeps the chain's dependence on ``send``."""
    one = send[..., srcs[:1], ss[:1], :]
    recv[..., dsts, ds_, :] = one.expand(*one.shape[:-2], len(dsts),
                                         send.shape[-1])
    return _barriers(recv, nbar, n_recv_slots)


def _tam_tables(tam):
    """Static index maps for the single-device TAM route (the analog of
    collective_write2's hindexed views, l_d_t.c:848-904: datatype tricks
    become index maps). Three hops over flattened slab arrays:

    P2 staging:   staged[k]    = send_flat[stage_idx[k]]   (gather at proxy)
    P3 exchange:  exch[k]      = staged[exch_idx[k]]       (proxy <-> proxy)
    P4/P5 deliver recv[recv_dst[k], recv_slot[k]] = exch[k]

    The orders are :func:`~tpu_aggcomm_torch.tam.relay.relay_orders`'
    (tam_oracle's proxy_hold / node_in walks), so the staged layout is
    the aggregate-buffer layout of the reference engine, and
    ``torch_shard``'s relay reads the same orders."""
    o = relay_orders(tam.pattern, tam.assignment)
    stage_idx = o.stage_src.astype(np.int64) * o.nslots + o.stage_slot
    return stage_idx.astype(np.int32), o.exch, o.dst, o.dst_slot


def _no_round_structure(schedule) -> bool:
    return isinstance(schedule, TamMethod) or schedule.collective


def _faulted(schedule) -> bool:
    return bool(getattr(schedule, "fault", None)
                or getattr(schedule, "n_staging", 0))


class TorchSimBackend:
    """Executes schedules on one device with ranks as an array axis."""

    name = "torch_sim"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._cache: dict = {}
        #: schedule key -> measured per-rep seconds and decompositions
        self._chain_cache: dict = {}
        #: per-trial differenced seconds behind the last measure_per_rep
        self.last_samples: list[float] | None = None

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    def _key(self, schedule):
        return schedule_shape_key(schedule)

    def _arena(self, p: AggregatorPattern, lead=()) -> torch.Tensor:
        """A zeroed ([B,] n, R+1, w) recv arena in the lane layout."""
        _, n_recv_slots = slot_shapes(p)
        _, dt, w = lane_layout(p.data_size)
        return torch.zeros((*lead, p.nprocs, n_recv_slots + 1, w), dtype=dt,
                           device=self.device)

    def one_rep(self, schedule):
        """rep(send) -> recv over the dense rank-axis layout
        (:func:`dense_send_lanes` through ``lanes.from_reference``)."""
        return self._one_rep(schedule)

    def batched_rep(self, schedule):
        """rep(sends (B, n, S, w)) -> recvs (B, n, R+1, w): the serve
        layer's batch over a leading request axis, for every lowering
        :meth:`one_rep` has (rounds as they are or padded, the dense
        collectives, TAM, faulted schedules). It is the same rep: each
        round one gather and one scatter over all B requests, each
        barrier token its own request's, one delay launch for every
        request's slow ranks. Request b's arena is byte-equal to
        ``one_rep(schedule)(sends[b])``."""
        return self._one_rep(schedule)

    def _one_rep(self, schedule, upto: int | None = None):
        """Build rep(send) -> recv.

        ``upto`` truncates the rep to its first ``upto`` throttle rounds
        at FULL fidelity (every kept round gathers and scatters exactly
        as in the whole rep): the prefix programs ``measure_round_times``
        differences. The lowering (padded tables or not) is chosen on the
        FULL round table, so every prefix shares the full rep's lowering;
        differencing across lowerings would measure the asymmetry, not
        the dropped rounds."""
        if upto is not None and _no_round_structure(schedule):
            raise ValueError(
                "round-prefix truncation needs a round-structured "
                "schedule (TAM prefixes are _tam_rep(upto_hop=...); the "
                "dense collectives have no throttle rounds to truncate)")
        if _faulted(schedule) and not _no_round_structure(schedule):
            if upto is not None:
                raise ValueError(
                    "round-prefix truncation is not supported on "
                    "fault-injected schedules (the injected delay work "
                    "and relay rounds are not part of the healthy "
                    "prefix family)")
            return self._one_rep_faulted(schedule)
        if isinstance(schedule, TamMethod):
            return self._tam_rep(schedule)
        if not isinstance(schedule, Schedule):
            raise TypeError(f"torch_sim: {schedule!r} is not a schedule")

        p = schedule.pattern
        _, n_recv_slots = slot_shapes(p)
        dt = lane_layout(p.data_size)[1]

        if schedule.collective:
            # m=5/8: the whole pattern as one dense exchange — dst-major
            # rows built per rank, exchanged by transpose, scattered into
            # recv slots (uniform sizes make the zero-masked form exact)
            sslot, smask, rslot = _dense_tables(p, n_recv_slots)
            sslot_c, rslot_c = self._idx(sslot), self._idx(rslot)
            smask = torch.as_tensor(smask, device=self.device).to(dt)[
                None, :, None]

            def rep(send):
                rows = send[..., sslot_c, :] * smask     # ([B,] n, n, w)
                got = rows.transpose(-3, -2)             # got[d, s]
                recv = self._arena(p, send.shape[:-3])
                recv[..., rslot_c, :] = got
                return recv

            return rep

        tabs, nbars = _scatter_tables(schedule, n_recv_slots)
        kept = [tuple(self._idx(t) for t in tab) for tab in tabs[:upto]]
        nbars = nbars[:upto]

        def rep(send):
            recv = self._arena(p, send.shape[:-3])
            for tab, nbar in zip(kept, nbars):
                _apply_round(send, recv, *tab, nbar, n_recv_slots)
            return recv

        return rep

    def _one_rep_faulted(self, schedule):
        """The faulted-schedule lowering, the port of the reference's
        ``_one_rep_faulted`` (``jax_sim.py:367-509``): the same round
        structure with three additions over :meth:`_one_rep`.

        - **Staging rows.** The recv arena is ``(n, F + 1, w)``, ``F =
          n_recv_slots + S``: the S relay staging rows of a dead-link
          repair sit between the data rows and the trash row, which both
          lowerings pad to and barrier tokens land in (the tokens still
          sum only the data rows' lane 0). A relay's forward hop
          (``from_stage``) gathers the source rank's staging row of recv,
          not send: the round's values are gathered (both sources) before
          its scatter, and the hop that filled the row ran in an earlier
          round.
        - **Dead-edge masks.** The chan-0 edges an unrepaired fault names
          drop out, so ``--verify`` fails: the injection working.
        - **Slow ranks.** After the rounds, one launch of the delay kernel
          runs every slow rank's loop over its live send row and adds its
          provably zero result to ``recv[r, 0, 0]``
          (:func:`~tpu_aggcomm_torch.backends.slow_delay.slow_delay`).

        The lowering (padded tables under :func:`_scan_lowered`, else the
        rounds as they are) is the reference's: a padded round's pad
        entries gather ``send[0, 0]`` into rank 0's row F. Each round
        stays its own launch sequence, and ``run()`` hands verification
        the data rows only."""
        p = schedule.pattern
        n = p.nprocs
        _, n_recv_slots = slot_shapes(p)
        _, dt, w = lane_layout(p.data_size)
        dev = self.device
        rounds, barrier_rounds, F, slow = _faulted_tables(schedule,
                                                          n_recv_slots)
        tabs = [(srcs, ss, dsts, ds_) for (_r, srcs, ss, dsts, ds_, _fm)
                in rounds]
        nbars = [barrier_rounds.get(r, 0) for (r, *_rest) in rounds]
        fms = [fm for (*_rest, fm) in rounds]
        if _scan_lowered(tabs, barrier_rounds):
            width = max(len(srcs) for (srcs, *_rest) in tabs)

            def pad(a, value):
                return np.concatenate(
                    [a, np.full(width - len(a), value, dtype=a.dtype)])

            tabs = [(pad(srcs, 0), pad(ss, 0), pad(dsts, 0), pad(ds_, F))
                    for (srcs, ss, dsts, ds_) in tabs]
            fms = [pad(fm, False) for fm in fms]
        kept = []
        for (srcs, ss, dsts, ds_), fm in zip(tabs, fms):
            # the send gather reads every edge not from_stage; the staging
            # gather overwrites the from_stage positions, so neither reads
            # a row outside its own arena
            staged = np.flatnonzero(fm)
            kept.append((self._idx(srcs), self._idx(np.where(fm, 0, ss)),
                         self._idx(dsts), self._idx(ds_),
                         (self._idx(staged), self._idx(srcs[staged]),
                          self._idx(ss[staged])) if len(staged) else None))
        delay = slow_tables(slow, dev)

        def rep(send):
            recv = torch.zeros((*send.shape[:-3], n, F + 1, w), dtype=dt,
                               device=dev)
            for (srcs, ss, dsts, ds_, staged), nbar in zip(kept, nbars):
                vals = send[..., srcs, ss, :]
                if staged is not None:
                    pos, s_src, s_row = staged
                    vals[..., pos, :] = recv[..., s_src, s_row, :]
                recv[..., dsts, ds_, :] = vals
                _barriers(recv, nbar, n_recv_slots, row=F)
            if delay is not None:
                slow_delay(send, recv, delay)
            return recv

        return rep

    def _one_rep_scatters(self, schedule):
        """The rep truncated to its delivery side: every round scatters
        into exactly the recv slots the real round writes, but the
        scattered values are ONE gathered row broadcast across the
        round's edges — the per-edge gather (message preparation) never
        runs. ``measure_phase_split`` differences this against the full
        rep: T(full) - T(scatters) is the measured preparation-side
        time. Same lowering (padded tables or not) as the full rep."""
        if _no_round_structure(schedule):
            raise ValueError(
                "measured phase split needs a round-structured schedule "
                "(TAM's 3-hop decomposition is measured by "
                "measure_tam_hops; the dense collectives have none)")
        p = schedule.pattern
        _, n_recv_slots = slot_shapes(p)
        tabs, nbars = _scatter_tables(schedule, n_recv_slots)
        kept = [tuple(self._idx(t) for t in tab) for tab in tabs]

        def rep(send):
            recv = self._arena(p, send.shape[:-3])
            for tab, nbar in zip(kept, nbars):
                _deliver_round(send, recv, *tab, nbar, n_recv_slots)
            return recv

        return rep

    def _one_rep_hybrid(self, schedule, upto: int):
        """Rounds 0..upto-2 at FULL fidelity, then round upto-1 with its
        per-edge gather replaced by the broadcast-row scatter (the
        ``_one_rep_scatters`` truncation applied to ONE round): the prefix
        family ``measure_round_splits`` differences against the full
        prefixes to separate round k's preparation (gather) side from its
        delivery side. Unrolled lowering only, as in the reference."""
        if _no_round_structure(schedule):
            raise ValueError(
                "round splits need a round-structured schedule "
                "(TAM's 3-hop decomposition is measured by "
                "measure_tam_hops; the dense collectives have none)")
        p = schedule.pattern
        _, n_recv_slots = slot_shapes(p)
        rounds, barrier_rounds = _round_tables(schedule)
        if _scan_lowered(rounds, barrier_rounds):
            raise ValueError(
                "round splits need the unrolled lowering (< 32 rounds); "
                "deep scan-lowered schedules have measure_round_times")
        if not 1 <= upto <= len(rounds):
            raise ValueError(f"upto must be in [1, {len(rounds)}]")
        kept = [(tuple(self._idx(t) for t in tab),
                 barrier_rounds.get(r, 0))
                for (r, *tab) in rounds[:upto]]

        def rep(send):
            recv = self._arena(p, send.shape[:-3])
            for k, (tab, nbar) in enumerate(kept):
                step = _deliver_round if k == upto - 1 else _apply_round
                step(send, recv, *tab, nbar, n_recv_slots)
            return recv

        return rep

    def _tam_rep(self, tam, upto_hop: int | None = None):
        """THE TAM lowering: three gather hops over the staged slab
        arrays, the proxy engine's P2/P3/P4 made index maps
        (l_d_t.c:996-1309), each a separate launch on one stream. Shared
        by the full rep (``upto_hop=None``) and the measured-hop prefixes
        ``measure_tam_hops`` differences (1 = P2 only, 2 = P2+P3).

        Hop prefixes end in a fixed SINK: the hop's output rows summed per
        rank (wrapping in the lane dtype) into recv's first data row. The
        sink is identical work for both prefixes (staged and exch have the
        same row count), so T2 - T1 isolates P3; it reads every gathered
        row; and it lands in a DATA row, so the chain's token (a sum over
        data rows) depends on the hop."""
        if upto_hop not in (None, 1, 2):
            raise ValueError("upto_hop must be None (full rep), 1 (P2) "
                             "or 2 (P2+P3)")
        p = tam.pattern
        n = p.nprocs
        n_send_slots, _ = slot_shapes(p)
        _, dt, w = lane_layout(p.data_size)
        stage, exch_of, dst, slot = (self._idx(t) for t in _tam_tables(tam))

        def sink(x, lead):
            # ([B,] E, w) -> ([B,] n, w) per-rank sum, landed in data row 0
            recv = self._arena(p, lead)
            tot = x.reshape(*lead, n, -1, w).sum(dim=-2, dtype=torch.int64)
            recv[..., 0, :] = (wrap_i32(tot) if dt == torch.int32
                               else (tot & 0xFF).to(torch.uint8))
            return recv

        def rep(send):
            lead = send.shape[:-3]
            flat = send.reshape(*lead, n * n_send_slots, w)
            staged = flat[..., stage, :]                    # P2 gather
            if upto_hop == 1:
                return sink(staged, lead)
            exch = staged[..., exch_of, :]                  # P3 exchange
            if upto_hop == 2:
                return sink(exch, lead)
            recv = self._arena(p, lead)
            recv[..., dst, slot, :] = exch                  # P4/P5
            return recv

        return rep

    def _compiled(self, schedule):
        key = self._key(schedule)
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
        if chained and profile_rounds:
            raise ValueError("chained and profile_rounds are exclusive "
                             "(one program vs per-round programs)")
        if measured_phases and profile_rounds:
            raise ValueError("measured_phases and profile_rounds are "
                             "exclusive (truncation-differenced split vs "
                             "per-round dispatch timing)")
        if measured_phases and _faulted(schedule):
            raise ValueError(
                "measured_phases is not supported on fault-injected "
                "schedules (the prefix families decompose the healthy "
                "program; injected delay loops and relay rounds are not "
                "in it) — use --chained timing for faulted runs")
        p = schedule.pattern
        send = self._global_send(p, iter_)
        # profile_rounds with a round structure never runs the whole rep
        profiled_segs = (self._round_segments(schedule) if profile_rounds
                         else None)
        # "attributed-rounds" only when a real multi-round split was
        # measured — a single segment is whole-rep attribution whatever
        # machinery ran it. measured_phases provenance is set below once
        # the round count is known.
        self.last_provenance = (
            self.name,
            "attributed-chained" if chained
            else "attributed-rounds" if (profiled_segs is not None
                                         and len(profiled_segs[0]) > 1)
            else "attributed")
        out = None
        if not (profile_rounds and profiled_segs is not None):
            fn = self._compiled(schedule)
            out = fn(send)
            sync(self.device)                 # warm-up

        timers = [Timer() for _ in range(p.nprocs)]
        self.last_rep_timers = []
        self.last_round_times = []            # [rep] -> [per-round seconds]
        attr_w = weights_for(schedule)
        if measured_phases:
            # multi-round schedules: per-round durations MEASURED by prefix
            # truncation; only the split of a round's time among the
            # buckets charged in that round is structural. TAM: the 3-hop
            # relay is the decomposition (measure_tam_hops). Single-round
            # schedules keep the measured post/deliver boundary
            # (measure_phase_split).
            if schedule.collective:
                raise ValueError(
                    "measured phases need a round-structured schedule "
                    "(TAM's 3-hop decomposition is measured by "
                    "measure_tam_hops; the dense collectives have none)")
            rounds_tab, bars = (([], {}) if isinstance(schedule, TamMethod)
                                else _round_tables(schedule))
            if isinstance(schedule, TamMethod):
                hops = self.measure_tam_hops(schedule)
                rep_attr = attribute_tam_hops(
                    schedule, hops["p2"], hops["p3"], hops["p4"],
                    weights=attr_w)
                self.last_provenance = (
                    self.name, "measured-hops(P2,P3,P4)+attributed(ranks)")
                self.last_round_times = [
                    [hops["p2"], hops["p3"], hops["p4"]]
                    for _ in range(ntimes)]
            elif (len(rounds_tab) >= 2
                  and not _scan_lowered(rounds_tab, bars)):
                # unrolled multi-round: per round, post AND deliver
                # windows measured
                splits = self.measure_round_splits(schedule)
                rep_attr = attribute_round_splits(schedule, splits,
                                                  weights=attr_w)
                self.last_provenance = (
                    self.name,
                    "measured-rounds(post,deliver)+attributed(waits)")
                self.last_round_times = [
                    [p_ + d_ for (p_, d_) in splits.values()]
                    for _ in range(ntimes)]
            elif len(rt := self.measure_round_times(schedule)) >= 2:
                # deep padded-table schedules: per-round totals measured
                rep_attr = attribute_rounds(schedule, rt, weights=attr_w)
                self.last_provenance = (
                    self.name, "measured-rounds+attributed(buckets)")
                self.last_round_times = [list(rt.values())
                                         for _ in range(ntimes)]
            else:
                split = self.measure_phase_split(schedule)
                rep_attr = attribute_measured_split(
                    schedule, split["post"], split["deliver"],
                    weights=attr_w)
                self.last_provenance = (
                    self.name,
                    "measured-split(post,deliver)+attributed(waits)")
            for r, t in enumerate(timers):
                t += Timer.from_array(rep_attr[r].as_array() * ntimes)
            # fresh Timer objects per rep — rep rows must not alias
            self.last_rep_timers = [
                [Timer.from_array(t.as_array()) for t in rep_attr]
                for _ in range(ntimes)]
        elif chained:
            per_rep = self.measure_per_rep(schedule)
            rep_attr = attribute_total(schedule, per_rep, weights=attr_w)
            for r, t in enumerate(timers):
                t += Timer.from_array(rep_attr[r].as_array() * ntimes)
            self.last_rep_timers = [
                [Timer.from_array(t.as_array()) for t in rep_attr]
                for _ in range(ntimes)]
        elif profile_rounds:
            out = self._run_profiled(schedule, send, ntimes, timers,
                                     profiled_segs)
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
    def _round_segments(self, schedule):
        """Per-round ``seg(send, recv) -> recv`` programs plus their round
        ids, for profiling (each round's own tables, unpadded, as in the
        reference). None when the schedule has no round structure to
        split (dense collectives and the 3-hop TAM route) or is
        fault-injected (profile_rounds then times the whole rep)."""
        if _no_round_structure(schedule) or _faulted(schedule):
            return None
        key = (self._key(schedule), "segments")
        if key in self._cache:
            return self._cache[key]
        _, n_recv_slots = slot_shapes(schedule.pattern)
        rounds, barrier_rounds = _round_tables(schedule)

        def make_seg(tab, nbar):
            def seg(send, recv):
                return _apply_round(send, recv, *tab, nbar, n_recv_slots)
            return seg

        segs = [make_seg(tuple(self._idx(t) for t in tab),
                         barrier_rounds.get(r, 0))
                for (r, *tab) in rounds]
        round_ids = [r for (r, *_rest) in rounds]
        self._cache[key] = (segs, round_ids)
        return self._cache[key]

    def _run_profiled(self, schedule, send, ntimes: int, timers, segs):
        """profile_rounds execution: one launch sequence per throttle
        round, each synchronized and timed on the host clock —
        schedule-shape analysis, not headline numbers (each round's time
        includes a launch and a synchronize). Per-round times land in
        ``last_round_times`` and are mapped onto each rank's TimerBucket
        structure (harness/attribution.py): round k's time is split among
        the post/wait/barrier buckets the rank's ops charge in round k,
        the fenced-segment analog of the reference's per-phase MPI_Wtime
        brackets (mpi_test.c:1768-1815)."""
        p = schedule.pattern
        attr_w = weights_for(schedule)
        if segs is None:
            segs_run, round_ids = None, None
        else:
            segs_run, round_ids = segs
            recv_w = self._arena(p)
            for seg in segs_run:              # warm-up every segment
                recv_w = seg(send, recv_w)
            sync(self.device)

        out = None
        for _ in range(ntimes):
            if segs_run is None:
                fn = self._compiled(schedule)
                t0 = time.perf_counter()
                out = fn(send)
                sync(self.device)
                dt = time.perf_counter() - t0
                self.last_round_times.append([dt])
                rep_attr = attribute_total(schedule, dt, weights=attr_w)
            else:
                recv = self._arena(p)
                sync(self.device)
                round_times = []
                for seg in segs_run:
                    ts = time.perf_counter()
                    recv = seg(send, recv)
                    sync(self.device)
                    round_times.append(time.perf_counter() - ts)
                out = recv
                self.last_round_times.append(round_times)
                rep_attr = attribute_rounds(
                    schedule, dict(zip(round_ids, round_times)),
                    weights=attr_w)
            for r, t in enumerate(timers):
                t += rep_attr[r]
            self.last_rep_timers.append(rep_attr)
        return out

    # ------------------------------------------------------------------
    def _chain_factory(self, rep, p):
        """THE serial-chain scaffold shared by every chained measurement:
        ``iters`` reps of ``rep`` back to back, rep r+1's send
        XOR-perturbed by ``(sum of rep r's recv lane 0 + r) % 251`` — the
        reference's token, so chain end states are byte-equal across
        packages. On a CUDA device the chain runs as CUDA graph replays
        (:func:`~tpu_aggcomm_torch.harness.chained.graph_chain`), on the
        CPU one operation at a time. One definition, so the full-rep and
        truncated-rep chains cancel the same scaffold cost."""
        _, n_recv_slots = slot_shapes(p)
        if self.device.type == "cuda":
            return graph_chain(rep, n_recv_slots)
        return eager_chain(rep, n_recv_slots)

    def _timing(self, iters_small, iters_big, trials, windows) -> dict:
        return dict(iters_small=iters_small, iters_big=iters_big,
                    trials=trials, windows=windows)

    def measure_round_splits(self, schedule, *, iters_small: int = 50,
                             iters_big: int = 1050, trials: int = 3,
                             windows: int = 3,
                             max_rounds: int = MAX_MEASURED_ROUNDS
                             ) -> dict:
        """MEASURED 2-D decomposition: per round k, BOTH the preparation
        (gather) side and the delivery side, by differencing three prefix
        families through the shared chain scaffold:

        - P_k  — rounds 0..k-1 at full fidelity (``_one_rep(upto=k)``);
        - S_k  — rounds 0..k-2 full + round k-1 delivery-only
          (``_one_rep_hybrid``);
        - round k's deliver ≈ S_{k+1} - P_k, post ≈ P_{k+1} - S_{k+1}.

        Increments are clamped and rescaled so all posts + delivers sum
        EXACTLY to the full-rep chain time; within each round the
        post/deliver ratio comes from the raw differenced pair. Returns
        ``{round id: (post_seconds, deliver_seconds)}``. Unrolled lowering
        only (< 32 rounds); cost is 2R-1 chain families. Cached per
        schedule."""
        if _no_round_structure(schedule):
            raise ValueError(
                "round splits need a round-structured schedule "
                "(TAM's 3-hop decomposition is measured by "
                "measure_tam_hops; the dense collectives have none)")
        rounds, bars = _round_tables(schedule)
        round_ids = [r for (r, *_rest) in rounds]
        R = len(round_ids)
        if _scan_lowered(rounds, bars):
            raise ValueError(
                "round splits need the unrolled lowering (< 32 rounds); "
                "deep scan-lowered schedules have measure_round_times")
        if R > max_rounds:
            raise ValueError(
                f"{R} rounds exceeds max_rounds={max_rounds} (two chain "
                f"families are built per round); use profile_rounds "
                f"for very deep schedules")
        key = (self._key(schedule), "round_splits", iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            return self._chain_cache[key]
        timing = self._timing(iters_small, iters_big, trials, windows)
        per_full = self.measure_per_rep(schedule, **timing)
        p = schedule.pattern
        send0 = self._global_send(p, 0)

        def timed(rep_fn):
            return differenced_per_rep(self._chain_factory(rep_fn, p),
                                       send0, **timing)

        memo = self._prefix_memo(schedule, iters_small, iters_big,
                                 trials, windows)
        P = [0.0]
        for k in range(1, R):
            if k not in memo:
                memo[k] = timed(self._one_rep(schedule, upto=k))
            P.append(memo[k])
        P.append(per_full)
        S = [timed(self._one_rep_hybrid(schedule, k))
             for k in range(1, R + 1)]

        inc = np.maximum(np.diff(np.asarray(P)), 0.0)
        s = float(inc.sum())
        inc = inc * (per_full / s) if s > 0 else np.full(R, per_full / R)
        out = {}
        for k in range(R):
            post_raw = max(P[k + 1] - S[k], 0.0)
            del_raw = max(S[k] - P[k], 0.0)
            tot_raw = post_raw + del_raw
            # the raw pair sets the WITHIN-round ratio; the rescaled
            # increment sets the round's total (additivity contract).
            # tot_raw == 0 (pure noise) -> all deliver: a round's scatter
            # exists by construction, its gather may be arbitrarily cheap
            frac_post = post_raw / tot_raw if tot_raw > 0 else 0.0
            out[round_ids[k]] = (float(inc[k] * frac_post),
                                 float(inc[k] * (1.0 - frac_post)))
        self._chain_cache[key] = out
        return out

    def measure_tam_hops(self, tam, *, iters_small: int = 50,
                         iters_big: int = 1050, trials: int = 3,
                         windows: int = 3) -> dict:
        """MEASURED 3-way decomposition of a TAM rep by chained hop-prefix
        truncation differencing:

        - ``p2`` — the intra-node staging gather (proxy pack, the
          reference's P2 bracket, l_d_t.c:1015-1106);
        - ``p3`` — the inter-node proxy exchange (l_d_t.c:1162-1195),
          isolated exactly (both its prefixes carry the identical sink);
        - ``p4`` — the local delivery scatter (l_d_t.c:1264-1266);
        - ``total`` — the full-rep differenced time (== p2+p3+p4 by the
          same clamp-and-rescale contract as measure_round_times; the
          hop-1/hop-3 boundaries carry the sink asymmetry, bounded by one
          reduction pass over the staged arena).

        Cached per schedule."""
        if not isinstance(tam, TamMethod):
            raise ValueError("measure_tam_hops needs a TAM schedule "
                             "(m=15/16); round-structured schedules use "
                             "measure_round_times")
        key = (self._key(tam), "tam_hops", iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            return self._chain_cache[key]
        timing = self._timing(iters_small, iters_big, trials, windows)
        per_full = self.measure_per_rep(tam, **timing)
        p = tam.pattern
        send0 = self._global_send(p, 0)
        bounds = []
        for k in (1, 2):
            mk = self._chain_factory(self._tam_rep(tam, upto_hop=k), p)
            bounds.append(differenced_per_rep(mk, send0, **timing))
        bounds.append(per_full)
        inc = np.maximum(np.diff(np.asarray([0.0] + bounds)), 0.0)
        s = float(inc.sum())
        inc = inc * (per_full / s) if s > 0 else np.full(3, per_full / 3)
        out = {"p2": float(inc[0]), "p3": float(inc[1]),
               "p4": float(inc[2]), "total": per_full}
        self._chain_cache[key] = out
        return out

    def measure_phase_split(self, schedule, *, iters_small: int = 50,
                            iters_big: int = 1050, trials: int = 3,
                            windows: int = 3) -> dict:
        """MEASURED two-way decomposition of one rep via chained
        program-truncation differencing:

        - ``deliver`` — differenced per-rep seconds of the scatters-only
          rep (landing every round's rows in their recv slots), clamped
          to the full-rep time;
        - ``post``    — T(full) - T(scatters): the message-preparation
          (per-edge gather) side;
        - ``total``   — the full-rep differenced time (== post+deliver).

        Both chains ride the same serial-chain scaffold as
        measure_per_rep, so the fixed overhead cancels identically.
        Cached per schedule."""
        key = (self._key(schedule), "phase_split", iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            return self._chain_cache[key]
        timing = self._timing(iters_small, iters_big, trials, windows)
        per_full = self.measure_per_rep(schedule, **timing)
        p = schedule.pattern
        make_chain = self._chain_factory(self._one_rep_scatters(schedule), p)
        per_s = differenced_per_rep(make_chain, self._global_send(p, 0),
                                    **timing)
        deliver = min(per_s, per_full)
        out = {"total": per_full, "post": per_full - deliver,
               "deliver": deliver}
        self._chain_cache[key] = out
        return out

    def measure_round_times(self, schedule, *, iters_small: int = 50,
                            iters_big: int = 1050, trials: int = 3,
                            windows: int = 3,
                            max_rounds: int = MAX_MEASURED_ROUNDS) -> dict:
        """MEASURED per-round durations by chained round-PREFIX truncation
        differencing: for k = 1..R-1, chain reps of rounds 0..k-1 only
        (full fidelity) through THE shared serial scaffold; round k's
        duration is the increment T(prefix k+1) - T(prefix k), with
        T(prefix R) the full ``measure_per_rep`` chain. Increments are
        clamped at 0 and rescaled so they sum EXACTLY to the full-rep
        time. Returns ``{round id: seconds}`` in program order; one chain
        family per round, ``max_rounds`` guards the deep schedules (use
        profile_rounds there). Cached per schedule.

        A round's time lands on the buckets charged in that round, so
        m=2's per-round send Waitalls (mpi_test.c:1909-1918) become
        MEASURED send-wait entries, and m=1's final-round send drain
        (mpi_test.c:1814) is inside its last round's increment."""
        if _no_round_structure(schedule):
            raise ValueError(
                "measured round times need a round-structured schedule "
                "(TAM's 3-hop decomposition is measured by "
                "measure_tam_hops; the dense collectives have none)")
        rounds, _ = _round_tables(schedule)
        round_ids = [r for (r, *_rest) in rounds]
        if len(round_ids) > max_rounds:
            raise ValueError(
                f"{len(round_ids)} rounds exceeds max_rounds={max_rounds} "
                f"(one chain family is built per round); use "
                f"profile_rounds for very deep schedules")
        key = (self._key(schedule), "round_times", iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            return self._chain_cache[key]
        timing = self._timing(iters_small, iters_big, trials, windows)
        per_full = self.measure_per_rep(schedule, **timing)
        p = schedule.pattern
        out = differenced_round_times(
            lambda k: self._chain_factory(self._one_rep(schedule, upto=k),
                                          p),
            self._global_send(p, 0), round_ids, per_full, **timing,
            memo=self._prefix_memo(schedule, iters_small, iters_big,
                                   trials, windows))
        self._chain_cache[key] = out
        return out

    def _prefix_memo(self, schedule, *timing_key) -> dict:
        """Per-(schedule, timing-params) memo of measured P-prefix chain
        times, shared by measure_round_times and measure_round_splits so
        the identical prefix families are built and timed once."""
        return self._chain_cache.setdefault(
            (self._key(schedule), "prefix_memo", *timing_key), {})

    def measure_per_rep(self, schedule, *, iters_small: int = 50,
                        iters_big: int = 1050, trials: int = 3,
                        windows: int = 3) -> float:
        """Serial-chained per-rep seconds with the fixed overhead
        differenced away (harness/chained.py); cached per schedule."""
        key = (self._key(schedule), iters_small, iters_big, trials, windows)
        if key in self._chain_cache:
            per_rep, samples = self._chain_cache[key]
            self.last_samples = list(samples)
            return per_rep
        p = schedule.pattern
        make_chain = self._chain_factory(self._compiled(schedule), p)
        samples = differenced_trials(
            make_chain, self._global_send(p, 0),
            **self._timing(iters_small, iters_big, trials, windows))
        per_rep = statistics.median(samples)
        self._chain_cache[key] = (per_rep, tuple(samples))
        self.last_samples = list(samples)
        return per_rep

    def measure_trial_samples(self, schedule, *, iters_small: int = 50,
                              iters_big: int = 1050, trials: int = 3,
                              windows: int = 1) -> list[float]:
        """FRESH per-trial differenced seconds (the tuner's sampler): the
        same serial-chain scaffold as measure_per_rep, but the SAMPLES are
        never cached, so every batch is a new measurement. Only the chain
        pair and the initial send buffer are kept (per schedule and chain
        lengths), so repeat batches re-time without rebuilding."""
        key = (self._key(schedule), "tune_chains", iters_small, iters_big)
        if key not in self._chain_cache:
            p = schedule.pattern
            make_chain = self._chain_factory(self._compiled(schedule), p)
            chains = {iters_small: make_chain(iters_small),
                      iters_big: make_chain(iters_big)}
            self._chain_cache[key] = (chains, self._global_send(p, 0))
        chains, send0 = self._chain_cache[key]
        samples = differenced_trials(
            lambda it: chains[it], send0,
            **self._timing(iters_small, iters_big, trials, windows))
        self.last_samples = list(samples)
        return list(samples)
