"""Schedule fusion: one CUDA kernel per whole throttled schedule.

The port of ``tpu_aggcomm/native/fuse.py``, in two halves:

- **plan half (copied)** — :func:`fuse_plan` turns ``Schedule.programs``
  into a :class:`FusePlan`: per-round edge lists over the dense rank-axis
  arenas, fusability decided by NAMED refusal
  (:class:`UnfusableScheduleError` — TAM, dense collectives, staged
  dead-link repairs, slow-rank injection, oversize plans), plus the step
  export (:func:`plan_round_matrices`, :func:`semaphore_deps`) and its
  cross-check against the traffic audit (:func:`cross_check_export`,
  :func:`export_sweep`, ``inspect traffic|check --fused-export``).
- **kernel half (new)** — kernel K2 (``csrc/fused_rep.cu``) replaces
  ``build_fused_rep``'s Pallas kernel (``fuse.py:354-410``): the plan
  enters as int32 CSR tables (:func:`plan_tables`), with the recv rows no
  edge writes as runs of contiguous rows, and ONE launch per rep zeroes
  those rows and copies every round's edge rows, with one fence per
  round, so rounds stay distinct steps. The wrapper :func:`fused_rep`
  takes the plain version (:func:`fused_rep_plain`, a Python loop of
  per-round index copies) for a CPU tensor, launches the kernel for a
  CUDA tensor into a ``torch.empty`` (or the caller's ``out``) and counts
  launches in ``fused_rep.launches``.

What bounds K2 on an H100: bytes — E*d read and E*d written by the
copies, plus the never-written rows zeroed; at the README shape (448
edges in 11 rounds) the ten round fences dominate. The Mosaic tile
padding of the TPU kernel (``_row_geometry``) is not carried over: rows
are exactly ``d`` bytes. ``MAX_FUSED_EDGES`` is kept as the reference
has it, although it is a Mosaic instruction-count limit the table-driven
kernel does not share.

The rep signature matches ``TorchSimBackend._one_rep``
(``rep(send (n, S, w) lanes) -> recv (n, R+1, w) lanes``, trash row last,
left at zero), so the fused backend inherits the torch_sim harness.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aggcomm_torch.core.schedule import Schedule, barrier_rounds_of
from tpu_aggcomm_torch.obs import trace

__all__ = ["MAX_FUSED_EDGES", "UnfusableScheduleError", "FusedExportError",
           "FusePlan", "fuse_plan", "plan_round_matrices", "semaphore_deps",
           "cross_check_export", "export_sweep", "render_export_sweep",
           "FusedTables", "plan_tables", "zero_runs_of", "fused_rep",
           "fused_rep_plain", "fused_plan", "check_fence", "build_fused_rep",
           "FusedFenceError"]

#: Hard ceiling on the per-kernel copy count: each edge unrolls to one
#: DMA start + wait pair in the Mosaic instruction stream, so a flagship
#: shape (n=16,384) would emit a multi-million-instruction kernel. The
#: quiet-chip grids this lowering targets (n=32) sit near 450 edges;
#: oversize schedules refuse by name instead of wedging the compiler.
MAX_FUSED_EDGES = 16384


class UnfusableScheduleError(ValueError):
    """Schedule cannot lower to one fused kernel — named reason, never a
    silent fallback (the jax_shard staged-schedule refusal discipline)."""


class FusedExportError(ValueError):
    """The fused step export drifted from the op-program traffic
    accounting — the two views of one schedule must never disagree."""


@dataclass(frozen=True)
class FusePlan:
    """The fused kernel's step program, derived ONLY from the schedule.

    ``rounds`` is a tuple of ``(round_id, edges)`` in strictly increasing
    round order; each edge is ``(src, sslot, dst, dslot)`` over the dense
    rank-axis arenas (``dslot`` indexes pattern recv slots; the trash row
    is ``n_recv_slots``). ``barriers`` maps round id -> reference
    MPI_Barrier count attached to that round (fence-structure export
    only: on one chip the round drain already IS the global fence).
    """

    nprocs: int
    data_size: int
    n_send_slots: int
    n_recv_slots: int
    rounds: tuple
    barriers: tuple  # sorted (round_id, count) pairs

    @property
    def n_edges(self) -> int:
        return sum(len(edges) for _r, edges in self.rounds)

    def barrier_counts(self) -> dict:
        return dict(self.barriers)


def fuse_plan(schedule) -> FusePlan:
    """Build the fused step program, or refuse by name.

    Fusable = round-structured, non-collective, non-TAM, no relay
    staging rows, no slow-rank injection, every edge joinable to a recv
    slot. Dead-link realization for UNREPAIRED faulted schedules matches
    the other lowerings (``faults/inject.dead_edge_mask``): named chan-0
    edges drop their payload so ``--verify`` fails visibly — a repaired
    schedule has no such edge left.
    """
    from tpu_aggcomm_torch.faults.inject import dead_edge_mask
    from tpu_aggcomm_torch.faults.spec import parse_fault

    if not isinstance(schedule, Schedule):
        raise UnfusableScheduleError(
            f"{getattr(schedule, 'name', schedule)!r}: the hierarchical "
            f"TAM engine has no rank op programs to fuse (m=15/16 run "
            f"their 3-hop relay on torch_sim)")
    if schedule.collective:
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r} is a dense collective (m=5/8): "
            f"it lowers to one vendor exchange and has no throttle "
            f"rounds to fuse")
    if getattr(schedule, "n_staging", 0):
        raise UnfusableScheduleError(
            f"repaired schedule (fault={schedule.fault!r}): the fused "
            f"kernel cannot represent relay staging rows; run the "
            f"detour on local or jax_sim (the jax_shard refusal)")
    spec = parse_fault(getattr(schedule, "fault", None))
    if spec.slow:
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r} carries slow-rank injection "
            f"(fault={schedule.fault!r}): the fused kernel does not "
            f"lower delay loops; run slow-rank scenarios on jax_sim "
            f"or jax_shard")

    p = schedule.pattern
    from tpu_aggcomm_torch.harness.verify import slot_shapes
    n_send_slots, n_recv_slots = slot_shapes(p)

    ext = schedule.data_edges_ext()
    ext = ext[dead_edge_mask(ext, spec)]
    if len(ext) and (ext[:, 6] != 0).any():
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r} has staging-flagged edges "
            f"without staging rows — refusing to guess a lowering")
    if len(ext) and (ext[:, 3] < 0).any():
        bad = ext[ext[:, 3] < 0][0]
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r}: edge {int(bad[0])}->"
            f"{int(bad[1])} in round {int(bad[4])} has no matching "
            f"receive slot to land in")
    if len(ext) > MAX_FUSED_EDGES:
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r} has {len(ext)} copy edges, over "
            f"the fused-kernel ceiling of {MAX_FUSED_EDGES} (each edge "
            f"unrolls to one in-kernel DMA); use the fenced jax_sim "
            f"lowering at this scale")

    barriers = barrier_rounds_of(schedule)
    rounds = []
    n_rounds = int(ext[:, 4].max()) + 1 if len(ext) else 0
    for r in range(n_rounds):
        sel = ext[ext[:, 4] == r]
        if len(sel) == 0:
            continue
        seen: dict = {}
        edges = []
        for row in sel:
            src, dst, ss, ds = (int(row[0]), int(row[1]), int(row[2]),
                                int(row[3]))
            cell = (dst, ds)
            if cell in seen:
                raise UnfusableScheduleError(
                    f"schedule {schedule.name!r}: recv slot {cell} is "
                    f"written twice in round {r} (by {seen[cell]} and "
                    f"{src}) — racing in-flight copies")
            seen[cell] = src
            edges.append((src, ss, dst, ds))
        rounds.append((r, tuple(edges)))

    orphans = set(barriers) - {r for r, _e in rounds}
    if orphans:
        raise UnfusableScheduleError(
            f"schedule {schedule.name!r} has barrier-only rounds "
            f"{sorted(orphans)} with no data edges; the fused round "
            f"lowering cannot represent a standalone fence")
    return FusePlan(nprocs=p.nprocs, data_size=p.data_size,
                    n_send_slots=n_send_slots, n_recv_slots=n_recv_slots,
                    rounds=tuple(rounds),
                    barriers=tuple(sorted(barriers.items())))


def plan_round_matrices(plan: FusePlan) -> dict:
    """The fused step export: per-round ``{(src, dst): bytes}`` payload
    matrices, every edge one ``data_size`` arena-row copy — the view
    :func:`cross_check_export` pins against ``obs/traffic.round_edges``."""
    out: dict = {}
    for r, edges in plan.rounds:
        cell: dict = {}
        for (src, _ss, dst, _ds) in edges:
            cell[(src, dst)] = cell.get((src, dst), 0) + plan.data_size
        out[r] = cell
    return out


def semaphore_deps(plan: FusePlan) -> list:
    """The in-kernel wait graph as ``(earlier_round, later_round)``
    pairs: round k+1's copy starts are program-ordered after round k's
    semaphore drain, so the transitive order covers every round pair —
    the fence structure tests pin against ``analysis/check.py``'s
    round-monotonicity property."""
    ids = [r for r, _e in plan.rounds]
    return list(zip(ids, ids[1:]))


def cross_check_export(schedule) -> dict:
    """Prove the fused step export equals the op-program traffic view.

    Returns ``{"status": "MATCH", ...}`` or ``{"status": "SKIPPED",
    "reason": ...}`` (unfusable schedules refuse by design — a refusal
    is not a drift); raises :class:`FusedExportError` when the two
    accountings disagree, naming the divergent round and cell. The
    payload universe on both sides is network edges + COPY self-edges
    (``Schedule.data_edges`` == ``round_edges``' edges+copies), so the
    fused kernel's per-round src→dst matrices can never drift from what
    ``inspect traffic`` audits and bounds against ``-c``.
    """
    from tpu_aggcomm_torch.faults.spec import parse_fault
    from tpu_aggcomm_torch.obs.traffic import round_edges

    spec = parse_fault(getattr(schedule, "fault", None))
    if spec.deadlinks and isinstance(schedule, Schedule):
        from tpu_aggcomm_torch.faults.inject import dead_edge_mask
        if not dead_edge_mask(schedule.data_edges_ext(), spec).all():
            return {"status": "SKIPPED",
                    "reason": "unrepaired dead-link realization drops "
                              "payload by design (masked edges would "
                              "fail --verify visibly); the export "
                              "cross-check audits healthy or repaired "
                              "schedules"}
    try:
        plan = fuse_plan(schedule)
    except UnfusableScheduleError as e:
        return {"status": "SKIPPED", "reason": str(e)}

    fused = plan_round_matrices(plan)
    program: dict = {}
    for r, cell in round_edges(schedule).items():
        merged: dict = {}
        for table in (cell["edges"], cell["copies"]):
            for pair, nbytes in table.items():
                merged[pair] = merged.get(pair, 0) + int(nbytes)
        if merged:
            program[r] = merged

    for r in sorted(set(fused) | set(program)):
        f, g = fused.get(r, {}), program.get(r, {})
        for pair in sorted(set(f) | set(g)):
            if f.get(pair, 0) != g.get(pair, 0):
                raise FusedExportError(
                    f"schedule {schedule.name!r} round {r}: fused plan "
                    f"moves {f.get(pair, 0)} bytes for "
                    f"{pair[0]}->{pair[1]}, op programs say "
                    f"{g.get(pair, 0)}")

    deps = semaphore_deps(plan)
    ids = [r for r, _e in plan.rounds]
    if ids != sorted(ids):
        raise FusedExportError(
            f"schedule {schedule.name!r}: fused rounds out of order "
            f"({ids})")
    if plan.barrier_counts() != barrier_rounds_of(schedule):
        raise FusedExportError(
            f"schedule {schedule.name!r}: fused barrier export "
            f"{plan.barrier_counts()} != schedule barriers "
            f"{barrier_rounds_of(schedule)}")
    return {"status": "MATCH", "rounds": len(plan.rounds),
            "edges": plan.n_edges, "fences": len(deps),
            "bytes": plan.n_edges * plan.data_size}


def export_sweep(nprocs: int, cb_nodes: int, comm_size: int, *,
                 data_size: int = 2048, proc_node: int = 1,
                 agg_type: int = 0, fault: str | None = None,
                 barrier_type: int = 0) -> list:
    """Cross-check every registry method's fused export at one shape —
    the ``inspect check/traffic --fused-export`` gate body (jax-free).
    Drift is a row, not an exception, so one bad method cannot hide the
    rest of the sweep."""
    from tpu_aggcomm_torch.core.methods import METHODS, compile_method, method_ids
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    p = AggregatorPattern(nprocs=nprocs, cb_nodes=cb_nodes,
                          data_size=data_size, placement=agg_type,
                          proc_node=proc_node, comm_size=comm_size)
    rows = []
    for m in method_ids():
        sched = compile_method(m, p, barrier_type=barrier_type)
        if fault:
            from tpu_aggcomm_torch.faults import (FaultSpecError, RepairError,
                                            repair_schedule)
            try:
                sched = repair_schedule(sched, fault,
                                        barrier_type=barrier_type)
            except (FaultSpecError, RepairError) as e:
                rows.append({"method": m, "name": METHODS[m].name,
                             "status": "SKIPPED",
                             "reason": f"repair refused: {e}"})
                continue
        try:
            rep = cross_check_export(sched)
        except FusedExportError as e:
            rows.append({"method": m, "name": METHODS[m].name,
                         "status": "DRIFT", "reason": str(e)})
            continue
        rows.append({"method": m, "name": METHODS[m].name, **rep})
    return rows


def render_export_sweep(rows: list, *, fault: str | None = None) -> str:
    lines = [f"fused step export vs op-program traffic"
             f"{' (fault=' + fault + ')' if fault else ''}:"]
    for r in rows:
        if r["status"] == "MATCH":
            lines.append(f"  m={r['method']:>2} {r['name']:<26} MATCH "
                         f"({r['rounds']} rounds, {r['edges']} edges, "
                         f"{r['fences']} fences)")
        else:
            lines.append(f"  m={r['method']:>2} {r['name']:<26} "
                         f"{r['status']}: {r['reason']}")
    n_drift = sum(1 for r in rows if r["status"] == "DRIFT")
    lines.append(f"  {sum(1 for r in rows if r['status'] == 'MATCH')} "
                 f"matched, {sum(1 for r in rows if r['status'] == 'SKIPPED')} "
                 f"skipped (unfusable by design), {n_drift} drifted")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# kernel half

#: the round fence the kernel chose, by its code: the release/acquire
#: counter of csrc/sync.cuh, or the hardware barrier of one thread-block
#: cluster (where the copying CTAs fit one cluster)
FENCE_NAMES = {1: "hand", 2: "cluster"}
#: how long one wait of a CTA at the hand-rolled fence may last
TIMEOUT_S = 10.0


class FusedFenceError(RuntimeError):
    """A CTA of K2 waited past the timeout at a round fence; the rep did
    not complete."""


@dataclass(frozen=True)
class FusedTables:
    """A plan as the kernel reads it: CSR round pointers and per-edge
    int32 tables on one device, the arena geometry, and the recv rows no
    edge of any round writes (the trash row among them) as runs of
    contiguous flat rows ``dst * n_recv_rows + dslot``: ``zero_runs`` the
    host ``(start, stop)`` pairs, ``zero_start``/``zero_ptr`` their device
    CSR form (run starts; prefix row counts)."""

    nprocs: int
    n_send_slots: int
    n_recv_rows: int            # pattern recv slots + the trash row
    round_ptr: tuple            # host copy of the round pointers
    max_round_edges: int
    round_ptr_dev: torch.Tensor
    src: torch.Tensor
    sslot: torch.Tensor
    dst: torch.Tensor
    dslot: torch.Tensor
    src_row: torch.Tensor       # flat send row src * S + sslot per edge
    dst_row: torch.Tensor       # flat recv row dst * (R+1) + dslot
    zero_runs: tuple
    zero_rows: int
    zero_start: torch.Tensor
    zero_ptr: torch.Tensor
    sync: torch.Tensor          # the hand-rolled fence's counter + error

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def n_rounds(self) -> int:
        return len(self.round_ptr) - 1


def zero_runs_of(n: int, n_recv_rows: int, dst, dslot) -> list:
    """The flat recv rows of an ``(n, n_recv_rows)`` arena that no edge
    writes, as ``(start, stop)`` runs of contiguous rows, in order."""
    free = np.ones(n * n_recv_rows, dtype=bool)
    free[np.asarray(dst, dtype=np.int64) * n_recv_rows
         + np.asarray(dslot, dtype=np.int64)] = False
    edges = np.diff(np.concatenate([[0], free.astype(np.int8), [0]]))
    return list(zip(np.flatnonzero(edges == 1).tolist(),
                    np.flatnonzero(edges == -1).tolist()))


def plan_tables(plan: FusePlan, device) -> FusedTables:
    """Flatten ``plan.rounds`` into the kernel's int32 tables."""
    ptr = [0]
    cols: list = [[], [], [], []]
    for _r, edges in plan.rounds:
        for edge in edges:
            for col, v in zip(cols, edge):
                col.append(v)
        ptr.append(ptr[-1] + len(edges))

    def t(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    counts = np.diff(np.asarray(ptr))
    n_recv_rows = plan.n_recv_slots + 1
    runs = zero_runs_of(plan.nprocs, n_recv_rows, cols[2], cols[3])
    lens = [b - a for a, b in runs]
    return FusedTables(
        nprocs=plan.nprocs, n_send_slots=plan.n_send_slots,
        n_recv_rows=n_recv_rows, round_ptr=tuple(ptr),
        max_round_edges=int(counts.max()) if len(counts) else 0,
        round_ptr_dev=t(ptr), src=t(cols[0]), sslot=t(cols[1]),
        dst=t(cols[2]), dslot=t(cols[3]),
        src_row=t([s * plan.n_send_slots + ss
                   for s, ss in zip(cols[0], cols[1])]),
        dst_row=t([d * n_recv_rows + ds for d, ds in zip(cols[2], cols[3])]),
        zero_runs=tuple(runs),
        zero_rows=sum(lens), zero_start=t([a for a, _b in runs]),
        zero_ptr=t(np.concatenate([[0], np.cumsum(lens)]).tolist()),
        sync=torch.zeros(4, dtype=torch.int32, device=device))


def fused_rep_plain(send: torch.Tensor, tabs: FusedTables) -> torch.Tensor:
    """The plain version: zeroed recv, then per round
    ``recv[dst, dslot] = send[src, sslot]``, rounds in order."""
    recv = send.new_zeros((tabs.nprocs, tabs.n_recv_rows, send.shape[2]))
    return _plain_rounds(send, tabs, recv)


def _plain_rounds(send: torch.Tensor, tabs: FusedTables,
                  recv: torch.Tensor) -> torch.Tensor:
    """The plain version's copies into a zeroed ``recv``."""
    src, ss = tabs.src.long(), tabs.sslot.long()
    dst, ds = tabs.dst.long(), tabs.dslot.long()
    ptr = tabs.round_ptr
    for k in range(len(ptr) - 1):
        a, b = ptr[k], ptr[k + 1]
        recv[dst[a:b], ds[a:b]] = send[src[a:b], ss[a:b]]
    return recv


def _fused_rep_into(send: torch.Tensor, tabs: FusedTables,
                    out: torch.Tensor) -> torch.Tensor:
    """The kernel's contract in plain torch, into any ``out``: the zero
    runs zeroed, then the rounds' copies in order."""
    flat = out.view(-1, out.shape[2])
    for a, b in tabs.zero_runs:
        flat[a:b] = 0
    ptr = tabs.round_ptr
    src, ss = tabs.src.long(), tabs.sslot.long()
    dst, ds = tabs.dst.long(), tabs.dslot.long()
    for k in range(len(ptr) - 1):
        a, b = ptr[k], ptr[k + 1]
        out[dst[a:b], ds[a:b]] = send[src[a:b], ss[a:b]]
    return out


@functools.cache
def _c_lib():
    """The kernel's C entry points, built and loaded at first use."""
    from tpu_aggcomm_torch.csrc.build import load
    lib = load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.aggcomm_fused_rep
    fn.argtypes = [p, p, p, p, p, p, p, i, i, ll, ll, i, p,
                   ctypes.c_ulonglong, p, p, i]
    fn.restype = i
    plan = lib.aggcomm_fused_rep_plan
    plan.argtypes = [p, p, ll, i, ll, i, ctypes.POINTER(i)]
    plan.restype = i
    return fn, plan


def _dev_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _check_args(send: torch.Tensor, tabs: FusedTables, out) -> None:
    if (send.dim() != 3 or send.dtype not in (torch.int32, torch.uint8)
            or tuple(send.shape[:2]) != (tabs.nprocs, tabs.n_send_slots)):
        raise ValueError(
            f"fused_rep: send must be ({tabs.nprocs}, {tabs.n_send_slots}, "
            f"w) int32 or uint8 lanes, got {tuple(send.shape)} {send.dtype}")
    if not send.is_contiguous():
        raise ValueError("fused_rep: send must be contiguous")
    if send.device != tabs.device:
        raise ValueError(f"fused_rep: send on {send.device}, plan tables "
                         f"on {tabs.device}")
    shape = (tabs.nprocs, tabs.n_recv_rows, send.shape[2])
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != send.dtype
                            or out.device != send.device
                            or not out.is_contiguous()):
        raise ValueError(f"fused_rep: out must be a contiguous {shape} "
                         f"{send.dtype} tensor on {send.device}")


def fused_plan(send: torch.Tensor, tabs: FusedTables) -> dict:
    """What :func:`fused_rep` launches for ``send`` on a CUDA device:
    ``grid``, ``copy_ctas`` (the CTAs that copy and fence; the rest zero),
    ``fence`` (its name) and the lane width in bytes."""
    recv = torch.empty((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                       dtype=send.dtype, device=send.device)
    out = (ctypes.c_int * 4)()
    rc = _c_lib()[1](
        send.data_ptr(), recv.data_ptr(), send.shape[2] * send.element_size(),
        tabs.max_round_edges, tabs.zero_rows, _dev_index(send), out)
    if rc != 0:
        raise RuntimeError(f"fused_rep plan query failed: cudaError {rc}")
    return dict(grid=out[0], copy_ctas=out[1], fence=FENCE_NAMES[out[2]],
                lane_bytes=out[3])


def check_fence(tabs: FusedTables) -> None:
    """Wait for the device and raise :class:`FusedFenceError` if a CTA of
    an earlier launch on these tables timed out at a round fence (the
    record is cleared)."""
    cta1, rnd, got = tabs.sync[1:].tolist()
    if cta1:
        tabs.sync.zero_()
        raise FusedFenceError(
            f"fused_rep: CTA {cta1 - 1} waited over {TIMEOUT_S} s at the "
            f"fence after round {rnd} ({got} arrivals); the rep did not "
            f"complete")


def fused_rep(send: torch.Tensor, tabs: FusedTables,
              out: torch.Tensor | None = None, *,
              stamps: torch.Tensor | None = None) -> torch.Tensor:
    """One rep of the whole plan: recv (n, R+1, w), trash row last and
    zero, into ``out`` when given (its contents are overwritten, every
    row). CPU tensors take the plain version. On the card: ONE launch,
    the never-written rows zeroed inside it; ``stamps`` (int64, ``grid *
    (2 + 2 * max(R, 1))``, diagnostic calls only) receives each CTA's
    %globaltimer stamps. The call stays asynchronous: :func:`check_fence`
    raises a fence timeout after the device has run it. While a trace
    recorder is on, the call is a ``rep`` span holding ``rep.arena`` (the
    receive arena's allocation) and ``rep.issue`` (the launch; on the CPU
    the plain version's copies)."""
    rec = trace.current()
    if rec is not None:
        return _traced_fused_rep(rec, send, tabs, out, stamps)
    _check_args(send, tabs, out)
    if send.device.type == "cpu":
        if out is None:
            return fused_rep_plain(send, tabs)
        return _fused_rep_into(send, tabs, out)
    if out is None:
        out = torch.empty((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                          dtype=send.dtype, device=send.device)
    _launch(send, tabs, out, stamps)
    return out


def _traced_fused_rep(rec, send: torch.Tensor, tabs: FusedTables, out,
                      stamps) -> torch.Tensor:
    """:func:`fused_rep` inside its spans."""
    with rec.span("rep"):
        _check_args(send, tabs, out)
        cpu = send.device.type == "cpu"
        fresh = out is None
        if fresh:
            with rec.span("rep.arena"):
                shape = (tabs.nprocs, tabs.n_recv_rows, send.shape[2])
                out = (send.new_zeros(shape) if cpu else
                       torch.empty(shape, dtype=send.dtype,
                                   device=send.device))
        with rec.span("rep.issue"):
            if not cpu:
                _launch(send, tabs, out, stamps)
            elif fresh:
                _plain_rounds(send, tabs, out)
            else:
                _fused_rep_into(send, tabs, out)
    return out


def _launch(send: torch.Tensor, tabs: FusedTables, out: torch.Tensor,
            stamps) -> None:
    """One launch of K2 on the current stream; counted in
    ``fused_rep.launches``."""
    dev = _dev_index(send)
    rc = _c_lib()[0](
        send.data_ptr(), out.data_ptr(), tabs.round_ptr_dev.data_ptr(),
        tabs.src_row.data_ptr(), tabs.dst_row.data_ptr(),
        tabs.zero_start.data_ptr(), tabs.zero_ptr.data_ptr(), tabs.n_rounds,
        len(tabs.zero_runs), tabs.zero_rows,
        send.shape[2] * send.element_size(), tabs.max_round_edges,
        tabs.sync.data_ptr(), int(TIMEOUT_S * 1e9),
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev)
    if rc != 0:
        raise RuntimeError(f"fused_rep kernel launch failed: cudaError {rc}")
    fused_rep.launches += 1


fused_rep.launches = 0


def build_fused_rep(plan: FusePlan, *, device):
    """``rep(send (n, S, w) lanes) -> recv (n, R+1, w) lanes`` running the
    whole plan through :func:`fused_rep` on ``device``; its tables are
    ``rep.tables`` (for :func:`check_fence`)."""
    with trace.span("tables.rounds"):
        tabs = plan_tables(plan, device)

    def rep(send):
        return fused_rep(send, tabs)

    rep.tables = tabs
    return rep
