"""cuda_dma: the remote-DMA semaphore transport on one card (kernel K3).

The port of ``tpu_aggcomm/backends/pallas_dma.py``, the transport of the
synchronization-sensitive methods: MPI_Issend rendezvous becomes
CTS-before-RTS grant steps, a reference MPI_Barrier becomes a log-depth
dissemination barrier, and the posting discipline is lockstep (one copy
in flight per rank, registry name ``cuda_dma``) or concurrent (a whole
round posted, then drained, ``cuda_dma_conc``). In two halves:

- **host half (copied)** — :func:`barrier_shifts` and
  :func:`complete_permutation` (``pallas_dma.py:70-100``; the latter
  rewritten with boolean masks in O(n), output pinned equal by the tests),
  and :func:`build_steps` / :func:`wave_profile` (``:235-360``): the
  uniform permutation-step program. Each step every rank sends one row to
  one other rank's recv slot, each step's ``dst`` column is a full
  permutation (idle ranks name the zero dummy row and a trash row: on the
  TPU they copy it, on the card such a step only signals), and the steps
  are grouped into waves whose copies are all posted before any wait.
- **kernel half (ported)** — kernel K3 (``csrc/dma_steps.cu``) replaces
  ``PallasDmaBackend._lower``'s Pallas kernel (``:378-446``, the call at
  ``:420``). On the TPU each rank was a device and a step a remote DMA
  with send and recv semaphores; on one H100 each rank is one CTA of a
  cooperative launch (for the co-residency guarantee: the CTAs spin on
  each other). A wave posts its real row copies, then one release
  increment of the receiver's arrival counter per step (a dummy step only
  signals), and ends with an acquire spin until the rank's own counter
  has moved the wave's cumulative step count past the rank's base word.
  One launch is one rep: the recv rows no real step writes are zeroed
  inside it, and the counters are never reset (each rank's base word
  advances by NS a launch, on the device). The checked wrapper
  :func:`dma_steps` takes the plain version (:func:`dma_steps_plain`, a
  Python loop of one index copy per step) for a CPU tensor and launches
  the kernel for a CUDA tensor after checking every argument and the
  capacity. :func:`step_rep` binds the launch once for one program's
  tables (:class:`BoundSteps`): the rep :meth:`CudaDmaBackend.one_rep`
  returns and :meth:`CudaDmaBackend.run` times. Counters, on the card:
  ``dma_steps.launches`` (every launch), ``dma_steps.waves`` (the waves
  those launches issued, so ``waves / launches`` is the chain a rep
  runs) and ``dma_steps.full_checks`` (launches through the checked
  entry). Spans, while a trace recorder is on: ``tables.steps`` around
  :func:`dma_tables`, and around each rep ``rep`` holding ``rep.arena``
  (the receive arena's allocation) and ``rep.issue`` (the launch; args
  ``waves`` and ``steps``).

What bounds K3 on an H100 is the dependent wave chain — one cross-SM
release/acquire signal per wave, NS of them in lockstep — and, second,
the bytes (the real rows read and written once, the rest of the recv
arena zeroed). The
Mosaic padding of the TPU kernel (``pds = _pad128(d)``, rows shaped
``(4, pds/4)``) is not carried over: arenas are ``(n, S+1, d)`` and
``(n, R+1, d)`` uint8, dummy send row and trash recv row last.

Dense collectives (m=5/8) and TAM (m=15/16) are routed by method to this
package's own :class:`TorchSimBackend` on the same device, whose
provenance is recorded: the reference hands TAM to ``jax_sim`` and the
collectives to ``jax_ici``, whose port (``torch_ici``) needs one process a
rank, which one card without a group is not. This is a routing, not a
fallback on failure (a named divergence, ROADMAP.md queue C). Fault-injected
schedules raise :class:`DmaFaultError` by name: the reference's
lowering would drop the fault silently.
"""

from __future__ import annotations

import ctypes
import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aggcomm_torch.backends.ici_lower import lower_schedule
from tpu_aggcomm_torch.backends.torch_sim import (NotPortedError,
                                                  TorchSimBackend,
                                                  dense_send_bytes)
from tpu_aggcomm_torch.core.schedule import Schedule, schedule_shape_key
from tpu_aggcomm_torch.device import resolve_device, sync
from tpu_aggcomm_torch.harness.attribution import attribute_total, weights_for
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import recv_slot_counts, verify_recv
from tpu_aggcomm_torch.native.fuse import _dev_index, zero_runs_of
from tpu_aggcomm_torch.obs import trace
from tpu_aggcomm_torch.tam.engine import TamMethod

__all__ = ["CudaDmaBackend", "DmaTables", "DmaCapacityError",
           "DmaFaultError", "DmaProtocolError", "DmaTableError",
           "barrier_shifts", "complete_permutation", "build_steps",
           "wave_profile", "make_tables", "dma_tables", "check_step_tables",
           "capacity", "check_capacity", "check_protocol", "send_arena",
           "dma_steps", "dma_steps_plain", "BoundSteps", "step_rep",
           "TIMEOUT_S"]

#: how long one wait of a CTA may spin before it gives up and reports the
#: step it was waiting for (a malformed program must not hang the card);
#: the clock starts at each wait's first check, so a healthy program of
#: any length completes
TIMEOUT_S = 10.0
#: uint32 words between two ranks' arrival counters: one counter per
#: 128-byte line; ``kCounterStride`` in ``csrc/dma_steps.cu`` is the same
COUNTER_STRIDE = 32


class DmaCapacityError(RuntimeError):
    """More ranks than CTAs that can be co-resident on the card: the
    step program would deadlock, so nothing is launched."""


class DmaFaultError(NotPortedError):
    """A fault-injected schedule on the remote-DMA transport. The step
    program has no faulted lowering: the reference's
    (``jax_ici.lower_schedule``, which ``pallas_dma`` runs) reads
    ``data_edges()`` with no dead-edge mask, staging row or delay, so it
    drops a slow rank or an unrepaired dead link silently and lands a
    repair's relay hops in data slots. The port refuses instead of
    reproducing that (ROADMAP.md, queue C)."""


class DmaProtocolError(RuntimeError):
    """A CTA of K3 timed out waiting for an arrival: the step program did
    not complete on the card."""


class DmaTableError(ValueError):
    """A step table that could deadlock or write out of bounds: a ``dst``
    column that is not a permutation, a ``src`` that is not its inverse,
    a slot outside the arena, or waves that do not tile the steps."""


# ---------------------------------------------------------------------------
# host half


def barrier_shifts(n: int) -> list[int]:
    """Rotation amounts of the dissemination barrier: 1, 2, 4, … < n —
    ``ceil(log2 n)`` steps (empty for n == 1, where a barrier is a no-op)."""
    out = []
    k = 1
    while k < n:
        out.append(k)
        k *= 2
    return out


def complete_permutation(pairs: list[tuple[int, int]], n: int) -> np.ndarray:
    """Extend a partial permutation (unique srcs, unique dsts) to a full
    bijection on [0, n): unmatched sources are paired with unmatched
    destinations (self first when possible). Returns dst_of (n,).

    The reference's list form is O(n^2) per step; this one is O(n) with
    boolean masks and gives the same bijection: self-loops wherever a rank
    is both an unmatched source and an unmatched destination, then the
    remaining sources and destinations zipped in ascending order."""
    dst_of = np.full(n, -1, dtype=np.int64)
    used_dst = np.zeros(n, dtype=bool)
    if len(pairs):
        a = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        dst_of[a[:, 0]] = a[:, 1]
        used_dst[a[:, 1]] = True
    free_src = dst_of < 0
    free_dst = ~used_dst
    self_loop = free_src & free_dst
    dst_of[self_loop] = np.flatnonzero(self_loop)
    rest_src = np.flatnonzero(free_src & ~self_loop)
    rest_dst = np.flatnonzero(free_dst & ~self_loop)
    k = min(len(rest_src), len(rest_dst))
    dst_of[rest_src[:k]] = rest_dst[:k]
    return dst_of


def build_steps(schedule: Schedule, concurrent: bool = False):
    """Host-side step tables + wave partition: ``(low, (dst, src, sslot,
    rslot), WAVES, n_recv_slots)``, each table (n, NS) int32. The copy of
    ``PallasDmaBackend._build_steps`` (``pallas_dma.py:250-360``) without
    the Mosaic row padding; :func:`wave_profile` and :func:`dma_tables`
    share it so the accounting cannot drift from the program."""
    p = schedule.pattern
    n = p.nprocs
    low = lower_schedule(schedule)
    rtable = schedule.recv_slot_table()
    rdv = bool(schedule.uses_rendezvous)
    n_recv_slots = low.n_recv_slots
    trash = n_recv_slots            # recv trash row index
    dummy = low.n_send_slots        # send dummy row index

    # Build the uniform permutation-step program: per step, tables of
    # (dst, src, send slot, remote recv slot) for every rank — plus the
    # WAVE structure: a wave is a span of steps whose copies are all
    # posted before any wait (lockstep: every wave is one step;
    # concurrent: a round's grant steps form one wave and its data steps
    # another, so in-flight copies per round = throttle c)
    step_dst: list[np.ndarray] = []
    step_src: list[np.ndarray] = []
    step_sslot: list[np.ndarray] = []
    step_rslot: list[np.ndarray] = []
    waves: list[tuple[int, int]] = []

    def add_step(dst_of: np.ndarray, sslot: np.ndarray,
                 rslot: np.ndarray):
        src_of = np.empty(n, dtype=np.int64)
        src_of[dst_of] = np.arange(n)
        step_dst.append(dst_of.astype(np.int32))
        step_src.append(src_of.astype(np.int32))
        step_sslot.append(sslot.astype(np.int32))
        step_rslot.append(rslot.astype(np.int32))

    def add_barrier():
        # dissemination barrier in ceil(log2 n) rotation steps: round k
        # signals (i + 2^k) mod n; because every step's wait gates the
        # next step's send, rank i transitively synchronizes with all n
        # ranks after the last round — log depth, not O(n). ALWAYS
        # lockstep (one-step waves), in both modes: the gating IS the
        # barrier
        for k in barrier_shifts(n):
            dst_of = (np.arange(n) + k) % n
            s0 = len(step_dst)
            add_step(dst_of, np.full(n, dummy), np.full(n, trash))
            waves.append((s0, s0 + 1))

    def grant_step(pairs):
        # CTS grant: the reverse permutation (receiver -> sender)
        cts_pairs = [(d, s) for (s, d) in pairs]
        add_step(complete_permutation(cts_pairs, n),
                 np.full(n, dummy), np.full(n, trash))

    def data_step(c):
        pairs = low.perms[c]
        sslot = np.full(n, dummy, dtype=np.int64)
        rslot = np.full(n, trash, dtype=np.int64)
        for (s, d) in pairs:
            sslot[s] = int(low.sslot_tab[s, c])
            rslot[s] = rtable[(s, d)]   # sender-side view of remote slot
        add_step(complete_permutation(pairs, n), sslot, rslot)

    # init barrier: no data may land before every rank has zeroed its
    # recv buffer (the reference's MPI_Barrier after prepare_*, e.g.
    # mpi_test.c:1762). Tokens landing early only touch the trash row.
    add_barrier()

    C = low.n_colors
    cols_of_round: dict[int, list[int]] = {}
    for c in range(C):
        cols_of_round.setdefault(low.round_of_color[c], []).append(c)
    for rnd in sorted(cols_of_round):
        cols = cols_of_round[rnd]
        if concurrent:
            # the Issend storm: post the whole round, then drain — grants
            # fully drain before any data posts (rendezvous stays
            # CTS-before-RTS at round granularity)
            if rdv:
                s0 = len(step_dst)
                for c in cols:
                    grant_step(low.perms[c])
                waves.append((s0, len(step_dst)))
            s0 = len(step_dst)
            for c in cols:
                data_step(c)
            waves.append((s0, len(step_dst)))
        else:
            for c in cols:
                if rdv:
                    s0 = len(step_dst)
                    grant_step(low.perms[c])
                    waves.append((s0, s0 + 1))
                s0 = len(step_dst)
                data_step(c)
                waves.append((s0, s0 + 1))
        for _ in range(low.barrier_rounds.get(rnd, 0)):
            add_barrier()

    NS = len(step_dst)
    WAVES = tuple(waves)
    assert NS == sum(s1 - s0 for s0, s1 in WAVES)
    dst_tab = np.stack(step_dst, axis=1)      # (n, NS)
    src_tab = np.stack(step_src, axis=1)
    sslot_tab = np.stack(step_sslot, axis=1)
    rslot_tab = np.stack(step_rslot, axis=1)
    tabs = (dst_tab, src_tab, sslot_tab, rslot_tab)
    return low, tabs, WAVES, n_recv_slots


def wave_profile(schedule: Schedule, concurrent: bool = False) -> dict:
    """Step/wave accounting of the lowered program: a wave's width IS its
    in-flight copy count, so ``max_in_flight`` is where the throttle
    ``-c`` becomes physical concurrency. Returns ``{"steps", "n_waves",
    "widths", "max_in_flight"}``; both disciplines have identical step
    counts, only the wave partition differs."""
    _low, _tabs, WAVES, _n_recv_slots = build_steps(schedule, concurrent)
    widths = [s1 - s0 for (s0, s1) in WAVES]
    return {"steps": sum(widths), "n_waves": len(widths),
            "widths": widths, "max_in_flight": max(widths)}


# ---------------------------------------------------------------------------
# kernel half


@dataclass(frozen=True)
class DmaTables:
    """A step program as K3 reads it, all on one device: the (n, NS)
    int32 tables ``dst, src, sslot, rslot`` (row r is rank r's program),
    the cumulative wave ends ``wave_end`` (n_waves,) int32, the arena
    geometry, the recv rows no real step writes (the trash rows among
    them) as runs of contiguous flat rows ``dst * n_recv_rows + rslot``
    (``zero_runs`` the host ``(start, stop)`` pairs, ``zero_start`` /
    ``zero_ptr`` their device form: run starts, prefix row counts), and
    the kernel's scratch: the ranks' arrival counters,
    :data:`COUNTER_STRIDE` words apart (the kernel's ``kCounterStride``),
    and their base words ``base[r]`` (the counter when rank
    r's CTA last exited), both zero when made and never reset,
    and the error word ``(rank + 1, step, arrivals)`` a timed-out CTA
    writes (sticky)."""

    nprocs: int
    n_send_rows: int            # send slots + the zero dummy row
    n_recv_rows: int            # recv slots + the trash row
    waves: tuple                # host copy of the (s0, s1) wave spans
    dst: torch.Tensor
    src: torch.Tensor
    sslot: torch.Tensor
    rslot: torch.Tensor
    wave_end: torch.Tensor
    zero_runs: tuple
    zero_rows: int
    zero_start: torch.Tensor
    zero_ptr: torch.Tensor
    arrival: torch.Tensor
    base: torch.Tensor
    error: torch.Tensor

    @property
    def n_steps(self) -> int:
        return int(self.dst.shape[1])

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def device(self) -> torch.device:
        return self.dst.device


def check_step_tables(tabs, waves, n_send_rows: int, n_recv_rows: int
                      ) -> None:
    """Refuse, on the host, a step program the kernel could deadlock on,
    write out of bounds with, or compute differently from
    :func:`dma_steps_plain` (:class:`DmaTableError`). The kernel moves no
    bytes for a dummy step and orders no two writes of one row, so a
    dummy step must target the trash row, a real step must not, and no
    row may be written by two real steps."""
    dst, src, sslot, rslot = (np.asarray(t) for t in tabs)
    n = dst.shape[0]
    if dst.ndim != 2 or any(t.shape != dst.shape for t in (src, sslot,
                                                           rslot)):
        raise DmaTableError(f"step tables must share one (n, NS) shape, got "
                            f"{[t.shape for t in (dst, src, sslot, rslot)]}")
    ranks = np.arange(n)[:, None]
    if not (np.sort(dst, axis=0) == ranks).all():
        st = int(np.flatnonzero(~(np.sort(dst, axis=0) == ranks).all(0))[0])
        raise DmaTableError(f"step {st}: dst column {dst[:, st].tolist()} is "
                            f"not a permutation of the {n} ranks")
    if not (np.take_along_axis(src, dst, axis=0) == ranks).all():
        raise DmaTableError("src is not the inverse of dst in every step")
    if not ((sslot >= 0) & (sslot < n_send_rows)).all():
        raise DmaTableError(f"a send slot lies outside [0, {n_send_rows})")
    if not ((rslot >= 0) & (rslot < n_recv_rows)).all():
        raise DmaTableError(f"a recv slot lies outside [0, {n_recv_rows})")
    dummy = sslot == n_send_rows - 1
    if (rslot[dummy] != n_recv_rows - 1).any():
        raise DmaTableError("a dummy step (send slot = the dummy row) "
                            "targets a recv row other than the trash row")
    if (rslot[~dummy] == n_recv_rows - 1).any():
        raise DmaTableError("a real step writes the trash row")
    rows = (dst.astype(np.int64) * n_recv_rows + rslot)[~dummy]
    if len(np.unique(rows)) != len(rows):
        raise DmaTableError("a recv row is written by two real steps")
    ends = [0]
    for s0, s1 in waves:
        if s0 != ends[-1] or s1 <= s0:
            raise DmaTableError(f"waves {list(waves)} do not tile the steps "
                                f"in order")
        ends.append(s1)
    if ends[-1] != dst.shape[1]:
        raise DmaTableError(f"waves end at step {ends[-1]}, the program has "
                            f"{dst.shape[1]}")


def make_tables(tabs, waves, n_send_rows: int, n_recv_rows: int,
                device) -> DmaTables:
    """Check host step tables (:func:`check_step_tables`) and put them on
    ``device`` with their zero runs and the kernel's scratch."""
    check_step_tables(tabs, waves, n_send_rows, n_recv_rows)
    n = int(np.asarray(tabs[0]).shape[0])
    real = np.asarray(tabs[2]) != n_send_rows - 1
    runs = zero_runs_of(n, n_recv_rows, np.asarray(tabs[0])[real],
                        np.asarray(tabs[3])[real])
    lens = [b - a for a, b in runs]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=device)

    dst, src, sslot, rslot = (t(a) for a in tabs)
    return DmaTables(
        nprocs=n, n_send_rows=n_send_rows,
        n_recv_rows=n_recv_rows, waves=tuple(waves),
        dst=dst, src=src, sslot=sslot, rslot=rslot,
        wave_end=t([s1 for _s0, s1 in waves]),
        zero_runs=tuple(runs), zero_rows=sum(lens),
        zero_start=t([a for a, _b in runs]),
        zero_ptr=t(np.concatenate([[0], np.cumsum(lens)])),
        arrival=torch.zeros(n * COUNTER_STRIDE, dtype=torch.int32,
                            device=device),
        base=torch.zeros(n, dtype=torch.int32, device=device),
        error=torch.zeros(3, dtype=torch.int32, device=device))


def dma_tables(schedule: Schedule, concurrent: bool, device) -> DmaTables:
    """The schedule's step program in one discipline (its waves), checked,
    on ``device``; a ``tables.steps`` span while a trace recorder is on."""
    with trace.span("tables.steps"):
        low, tabs, waves, n_recv_slots = build_steps(schedule, concurrent)
        return make_tables(tabs, waves, low.n_send_slots + 1,
                           n_recv_slots + 1, device)


def send_arena(p, iter_: int, device) -> torch.Tensor:
    """The (n, S+1, d) uint8 send arena of iteration ``iter_``: every
    rank's deterministic-fill slabs, then the zero dummy row."""
    slabs = dense_send_bytes(p, iter_)
    dummy = np.zeros((p.nprocs, 1, p.data_size), dtype=np.uint8)
    return torch.as_tensor(np.concatenate([slabs, dummy], axis=1),
                           device=device)


def dma_steps_plain(send: torch.Tensor, tabs: DmaTables,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: a zeroed recv arena (``out`` zeroed, when
    given), then per step ``recv[dst[:, st], rslot[:, st]] = send[ranks,
    sslot[:, st]]``, steps in order. Exact because each step's ``dst`` is
    a permutation; the same for both disciplines (only the step order
    differs, and rows written twice are zero dummy rows in the trash
    row)."""
    n = tabs.nprocs
    recv = (send.new_zeros((n, tabs.n_recv_rows, send.shape[2]))
            if out is None else out.zero_())
    ranks = torch.arange(n, device=send.device)
    dst, ss, rs = (t.long() for t in (tabs.dst, tabs.sslot, tabs.rslot))
    for st in range(tabs.n_steps):
        recv[dst[:, st], rs[:, st]] = send[ranks, ss[:, st]]
    return recv


def check_capacity(n: int, cap: int) -> None:
    """Raise :class:`DmaCapacityError` unless ``n`` rank CTAs can be
    co-resident (``cap`` = blocks per SM x SMs, from the occupancy API)."""
    if n > cap:
        raise DmaCapacityError(
            f"cuda_dma: {n} ranks need {n} co-resident CTAs (one per rank, "
            f"spinning on each other), but this card holds at most {cap}; "
            f"run at most {cap} ranks on this transport")


@functools.cache
def _c_lib():
    """The kernel library's two K3 entry points, built and loaded at first
    use."""
    from tpu_aggcomm_torch.csrc.build import load
    lib = load()
    p, i = ctypes.c_void_p, ctypes.c_int
    cap = lib.aggcomm_dma_capacity
    cap.argtypes = [i, ctypes.POINTER(i)]
    cap.restype = i
    ll = ctypes.c_longlong
    fn = lib.aggcomm_dma_steps
    fn.argtypes = [p, p, p, p, p, p, p, p, i, ll, i, i, i, i, i, ll, p, p, p,
                   ctypes.c_ulonglong, p, p, i]
    fn.restype = i
    return cap, fn


@functools.cache
def _capacity(device: int) -> int:
    """Co-resident CTA cap of K3 on ``device``, once per process."""
    out = ctypes.c_int(0)
    rc = _c_lib()[0](device, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"dma_steps capacity query failed: cudaError {rc}")
    return out.value


def capacity(device=None) -> int:
    """K3's co-resident CTA cap on a CUDA ``device`` (the current one by
    default): the most ranks :func:`dma_steps` can run."""
    dev = torch.device("cuda" if device is None else device)
    return _capacity(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def check_protocol(tabs: DmaTables) -> None:
    """Wait for the device and raise :class:`DmaProtocolError` if a CTA of
    an earlier launch on these tables timed out. The record is sticky: a
    launch on tables that timed out returns at once without posting, so
    they stay refused."""
    rank1, step, got = tabs.error.tolist()
    if rank1:
        raise DmaProtocolError(
            f"dma_steps: rank {rank1 - 1} waited over {TIMEOUT_S} s in one "
            f"wait for the arrivals up to step {step} (had {got}); the step "
            f"program did not complete")


def _check_args(send: torch.Tensor, tabs: DmaTables, out, stamps) -> None:
    n = tabs.nprocs
    if (send.dim() != 3 or send.dtype != torch.uint8
            or tuple(send.shape[:2]) != (n, tabs.n_send_rows)
            or send.shape[2] < 1):
        raise ValueError(
            f"dma_steps: send must be ({n}, {tabs.n_send_rows}, d) uint8, "
            f"got {tuple(send.shape)} {send.dtype}")
    if not send.is_contiguous():
        raise ValueError("dma_steps: send must be contiguous")
    if send.device != tabs.device:
        raise ValueError(f"dma_steps: send on {send.device}, step tables on "
                         f"{tabs.device}")
    shape = (n, tabs.n_recv_rows, send.shape[2])
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.uint8
                            or out.device != send.device
                            or not out.is_contiguous()):
        raise ValueError(f"dma_steps: out must be a contiguous {shape} "
                         f"uint8 tensor on {send.device}")
    if stamps is not None and (
            tuple(stamps.shape) != (tabs.n_waves + 1, 3)
            or stamps.dtype != torch.int64 or stamps.device != send.device
            or not stamps.is_contiguous()):
        raise ValueError(f"dma_steps: stamps must be a contiguous "
                         f"({tabs.n_waves + 1}, 3) int64 tensor on "
                         f"{send.device}")


def _launch(send: torch.Tensor, tabs: DmaTables, recv: torch.Tensor,
            stamps) -> None:
    """One launch of K3 on the current stream through the 23-argument
    entry, the capacity checked first; counted in ``dma_steps.launches``,
    ``.waves`` and ``.full_checks``."""
    dev = _dev_index(send)
    n = tabs.nprocs
    check_capacity(n, _capacity(dev))
    rc = _c_lib()[1](
        send.data_ptr(), recv.data_ptr(), tabs.dst.data_ptr(),
        tabs.sslot.data_ptr(), tabs.rslot.data_ptr(),
        tabs.wave_end.data_ptr(), tabs.zero_start.data_ptr(),
        tabs.zero_ptr.data_ptr(), len(tabs.zero_runs), tabs.zero_rows, n,
        tabs.n_waves, tabs.n_steps, tabs.n_send_rows, tabs.n_recv_rows,
        send.shape[2], tabs.arrival.data_ptr(), tabs.base.data_ptr(),
        tabs.error.data_ptr(), int(TIMEOUT_S * 1e9),
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev)
    if rc != 0:
        raise RuntimeError(f"dma_steps kernel launch failed: cudaError {rc}")
    dma_steps.launches += 1
    dma_steps.waves += tabs.n_waves
    dma_steps.full_checks += 1


def dma_steps(send: torch.Tensor, tabs: DmaTables,
              out: torch.Tensor | None = None, *, check: bool = True,
              stamps: torch.Tensor | None = None) -> torch.Tensor:
    """One rep of the step program: recv (n, R+1, d) uint8, trash row
    last and zero, into ``out`` when given (any contents: every row is
    overwritten). ``send``'s last row per rank is the dummy row and must
    be zero, as :func:`send_arena` makes it. CPU tensors take
    :func:`dma_steps_plain`. On the card: ONE cooperative launch on the
    current stream, the recv zeroing and the counters' bookkeeping inside
    it, after every argument and the capacity are checked (counted in
    ``dma_steps.full_checks``); with ``check`` the wrapper then waits for
    the device and raises :class:`DmaProtocolError` on a timeout (pass
    ``check=False`` to keep the call asynchronous, for timing or graph
    capture, and call :func:`check_protocol` after). ``stamps`` (int64
    ``(n_waves + 1, 3)``, diagnostic calls only) receives rank 0's
    %globaltimer stamps: row 0 (start, zeroing done, exit), then per wave
    (post start, signals issued, wait end)."""
    _check_args(send, tabs, out, stamps)
    if send.device.type == "cpu":
        return dma_steps_plain(send, tabs, out)
    recv = torch.empty((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                       dtype=torch.uint8, device=send.device) \
        if out is None else out
    _launch(send, tabs, recv, stamps)
    if check:
        check_protocol(tabs)
    return recv


dma_steps.launches = 0
dma_steps.waves = 0
dma_steps.full_checks = 0


@dataclass(frozen=True)
class BoundSteps:
    """K3's launch bound to one step program's tables on their card, for
    sends of :attr:`send_shape` uint8, contiguous and on that card: the
    capacity checked once, and every argument of the C entry but the two
    arenas and the stream packed once (:attr:`args`, the tables'
    pointers, the geometry, the timeout and no stamps)."""

    send_shape: torch.Size
    device_index: int
    n_waves: int
    args: tuple
    launch: object                 # the C entry aggcomm_dma_steps
    stream: object                 # device index -> the current raw stream

    def takes(self, send: torch.Tensor) -> bool:
        """Whether ``send`` is what the tables were bound for."""
        return (send.shape == self.send_shape and send.dtype is torch.uint8
                and send.get_device() == self.device_index
                and send.is_contiguous())

    def issue(self, send: torch.Tensor, out: torch.Tensor) -> None:
        """One launch of K3 from ``send`` into ``out`` on PyTorch's
        current stream; counted in ``dma_steps.launches`` and
        ``.waves``."""
        rc = self.launch(send.data_ptr(), out.data_ptr(), *self.args,
                         self.stream(self.device_index), self.device_index)
        if rc != 0:
            raise RuntimeError(
                f"dma_steps kernel launch failed: cudaError {rc}")
        dma_steps.launches += 1
        dma_steps.waves += self.n_waves


def _bind(tabs: DmaTables, data_size: int) -> BoundSteps:
    """K3's launch for CUDA ``tabs`` and rows of ``data_size`` bytes,
    bound once; raises :class:`DmaCapacityError` for more ranks than the
    card holds co-resident."""
    index = _dev_index(tabs.dst)
    check_capacity(tabs.nprocs, _capacity(index))
    fn = _c_lib()[1]
    values = (tabs.dst.data_ptr(), tabs.sslot.data_ptr(),
              tabs.rslot.data_ptr(), tabs.wave_end.data_ptr(),
              tabs.zero_start.data_ptr(), tabs.zero_ptr.data_ptr(),
              len(tabs.zero_runs), tabs.zero_rows, tabs.nprocs,
              tabs.n_waves, tabs.n_steps, tabs.n_send_rows,
              tabs.n_recv_rows, data_size, tabs.arrival.data_ptr(),
              tabs.base.data_ptr(), tabs.error.data_ptr(),
              int(TIMEOUT_S * 1e9), None)
    # what the entry takes between the two arenas and the stream
    args = tuple(t(v) for t, v in zip(fn.argtypes[2:21], values))
    return BoundSteps(
        send_shape=torch.Size((tabs.nprocs, tabs.n_send_rows, data_size)),
        device_index=index, n_waves=tabs.n_waves, args=args, launch=fn,
        stream=torch._C._cuda_getCurrentRawStream)


def step_rep(tabs: DmaTables, data_size: int):
    """``rep(send (n, S+1, d) uint8) -> recv (n, R+1, d) uint8``: one rep
    of the step program in ``tabs``, into a fresh ``torch.empty`` arena.
    On the card the launch is bound once (:class:`BoundSteps`): a send it
    was bound for is a key compare, an allocation and one ctypes call,
    asynchronous (:func:`check_protocol` after the device has run it);
    any other send takes :func:`dma_steps`' argument check and launch.
    On the CPU it runs :func:`dma_steps_plain`. A ``rep`` span holding
    ``rep.arena`` and ``rep.issue`` (args ``waves``, ``steps``) while a
    trace recorder is on. The tables are ``rep.tables``."""
    bound = _bind(tabs, data_size) if tabs.device.type == "cuda" else None
    dev, issue = tabs.device, {"waves": tabs.n_waves, "steps": tabs.n_steps}

    def rep(send):
        with trace.span("rep"):
            hit = bound is not None and bound.takes(send)
            if not hit:
                _check_args(send, tabs, None, None)
            with trace.span("rep.arena"):
                recv = torch.empty((tabs.nprocs, tabs.n_recv_rows,
                                    send.shape[2]), dtype=torch.uint8,
                                   device=dev)
            with trace.span("rep.issue", **issue):
                if hit:
                    bound.issue(send, recv)
                elif dev.type == "cpu":
                    dma_steps_plain(send, tabs, recv)
                else:
                    _launch(send, tabs, recv, None)
        return recv

    rep.tables = tabs
    return rep


# ---------------------------------------------------------------------------
# backend


class CudaDmaBackend:
    """Executes schedules as K3 step programs, one CTA per rank.

    ``concurrent=False`` (``cuda_dma``): lockstep, every step posts one
    copy and waits for its arrival. ``concurrent=True``
    (``cuda_dma_conc``): a round's copies are all posted before the wait,
    grants drained before data (CTS-before-RTS at round granularity);
    dissemination-barrier steps stay lockstep in both.

    Timing follows the reference: one untimed warm-up launch, then each
    rep is the host clock around the one launch (recv zeroing inside it)
    and the synchronize, spread onto the timer buckets by
    ``attribute_total`` (provenance ``(name, "attributed")``); the rep
    timed is :meth:`one_rep`'s, the one the benchmark drives. Without a
    card and unless ``device="cpu"`` is asked for, construction raises
    ``NoCudaDeviceError``; on the CPU the plain version runs. Under a
    process group construction raises ``NotPortedError`` naming ROADMAP
    B1: the step program across devices is not ported.
    """

    def __init__(self, device="cuda", concurrent: bool = False):
        from tpu_aggcomm_torch.parallel import is_distributed
        name = "cuda_dma_conc" if concurrent else "cuda_dma"
        if is_distributed():
            raise NotPortedError(
                f"{name} under a process group: K3 across devices (the "
                f"reference's pallas_dma step program across chips: "
                f"device-initiated peer writes and signals over NVLink) is "
                f"not ported (ROADMAP.md queue B1); {name} runs one CTA a "
                f"rank on one card with no group. Across processes run "
                f"--backend torch_ici")
        self.device = resolve_device(device)
        self.concurrent = concurrent
        self.name = "cuda_dma_conc" if concurrent else "cuda_dma"
        self._cache: dict = {}
        self._reps: dict = {}
        self._sim_delegate: TorchSimBackend | None = None

    def tables(self, schedule: Schedule) -> DmaTables:
        """The schedule's checked step tables on this backend's device,
        built once per schedule and cached."""
        key = schedule_shape_key(schedule)
        if key not in self._cache:
            self._cache[key] = dma_tables(schedule, self.concurrent,
                                          self.device)
        return self._cache[key]

    def wave_profile(self, schedule: Schedule) -> dict:
        return wave_profile(schedule, self.concurrent)

    def one_rep(self, schedule):
        """``rep(send (n, S+1, d) uint8) -> recv (n, R+1, d) uint8``: one
        rep of the schedule's step program (:func:`step_rep`), built once
        per schedule shape: the tables on the device, on the card the
        capacity checked and the launch bound once. The rep is
        asynchronous on the card: call :func:`check_protocol` on
        ``rep.tables`` after the device has run it. TAM and the dense
        m=5/8, which :meth:`run` routes to ``torch_sim``, have no step
        program (``ValueError``); a fault-injected schedule raises
        :class:`DmaFaultError`."""
        if isinstance(schedule, TamMethod) or schedule.collective:
            raise ValueError(
                f"{self.name}: schedule {schedule.name!r} has no "
                f"permutation steps (TAM and the dense m=5/8); run() routes "
                f"it to torch_sim on the same device")
        if (getattr(schedule, "fault", None)
                or getattr(schedule, "n_staging", 0)):
            raise DmaFaultError(
                f"{self.name}: schedule {schedule.name!r} is fault-injected "
                f"(fault={schedule.fault!r}); the remote-DMA step program "
                f"has no faulted lowering (the reference's drops the fault "
                f"silently); run it on torch_sim")
        key = schedule_shape_key(schedule)
        if key not in self._reps:
            self._reps[key] = step_rep(self.tables(schedule),
                                       schedule.pattern.data_size)
        return self._reps[key]

    def run(self, schedule, *, ntimes: int = 1, iter_: int = 0,
            verify: bool = False, chained: bool = False):
        if ntimes < 1:
            raise ValueError("ntimes must be >= 1")
        if chained:
            raise ValueError(
                f"{self.name}: --chained is not supported (the step program "
                f"is timed whole per rep, as pallas_dma is); use torch_sim "
                f"or cuda_fused for chained timing")
        if isinstance(schedule, TamMethod) or schedule.collective:
            # TAM's 3-hop relay and the dense m=5/8 have no permutation
            # steps: routed by method to the rank-axis lowering on the
            # same device (the reference routes TAM to jax_sim and the
            # collectives to jax_ici, whose port torch_ici holds one rank
            # on a card with no process group)
            if self._sim_delegate is None:
                self._sim_delegate = TorchSimBackend(device=self.device)
            sb = self._sim_delegate
            out = sb.run(schedule, ntimes=ntimes, iter_=iter_, verify=verify)
            self.last_rep_timers = sb.last_rep_timers
            self.last_provenance = sb.last_provenance
            return out
        p = schedule.pattern
        rep = self.one_rep(schedule)            # refuses a faulted schedule
        tabs = rep.tables
        send = send_arena(p, iter_, self.device)
        out = rep(send)                           # warm-up, checked
        check_protocol(tabs)

        self.last_provenance = (self.name, "attributed")
        timers = [Timer() for _ in range(p.nprocs)]
        self.last_rep_timers = []
        attr_w = weights_for(schedule)
        for _rep in range(ntimes):
            t0 = time.perf_counter()
            out = rep(send)
            sync(self.device)
            dt = time.perf_counter() - t0
            rep_attr = attribute_total(schedule, dt, weights=attr_w)
            for r, t in enumerate(timers):
                t += rep_attr[r]
            self.last_rep_timers.append(rep_attr)
        check_protocol(tabs)

        counts = recv_slot_counts(p)
        n_recv_slots = tabs.n_recv_rows - 1
        ranks = [r for r in range(p.nprocs) if counts[r]]
        recv_bufs: list = [None] * p.nprocs
        if ranks:
            idx = torch.as_tensor(ranks, device=self.device)
            got = out[idx, :n_recv_slots].cpu().numpy()
            for i, r in enumerate(ranks):
                recv_bufs[r] = got[i]
        if verify:
            verify_recv(p, recv_bufs, iter_)
        return recv_bufs, timers
