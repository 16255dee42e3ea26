"""torch_shard: the sharded rank-axis tier, B logical ranks per process.
The port of ``tpu_aggcomm/backends/jax_shard.py``.

The reference's flagship configuration is 16,384 MPI ranks on 256 nodes
(script_theta_all_to_many_256.sh:3,11), far more ranks than cards.
``torch_sim`` carries the whole rank set on ONE card as an array axis;
this backend shards the rank axis over the processes of a
``torch.distributed`` group, each process (a card under NCCL, a CPU
process under gloo) owning a contiguous block of ``B = nprocs / ndev``
ranks (the contiguous node map static_node_assignment type 0 fabricates,
lustre_driver_test.c:359-429: a "device" is a "node" of logical ranks).

Lowering, as the reference's: one throttle round is one padded **block
all_to_all** over the group. On the host the round's (src, dst) edges
are grouped by (src device, dst device) block, every block padded to the
round's widest block M, and two index tables built (copied from the
reference: :func:`block_round_tables`, :func:`recv_layout`):

- ``pack[a, b, j]`` — flat local send index of the j-th message device a
  ships to device b (-1 = padding, contributes zeros);
- ``scat[b, a, j]`` — flat local recv index where device b lands the
  j-th message from device a (the trash row F-1 for padding).

On each process a round is an indexing gather of the pack table (padding
rows zeroed), one ``dist.all_to_all_single`` of the ``(ndev, M, w)``
blocks and an ``index_put_`` of the scatter table; each of the round's
barriers is a ``dist.all_reduce`` of the int32 token ``recv[0, 0]``
written into the trash row ``[F-1, 0]``. Rounds are separate launches on
one stream (and, on the card, separate steps of the CUDA graph a chain
replays); they are never merged.

**One device** (one process, or a mesh the group's size steps down to
one) is the reference's single-device path: no collective and no padding
mask, padded entries copy ``flat_send[0]`` into the trash row, so its
bytes equal the reference's. This is how the reference ran its defining
configuration, 16,384 ranks x 256 aggregators, on one chip: the
compacted layouts (rows only for ranks that send or receive) are what
fit it in device memory. A round is then one row delivery
(:mod:`~tpu_aggcomm_torch.backends.deliver_rows`: the kernel
``csrc/deliver_rows.cu`` on the card, its plain version on the CPU):
every receive row the round writes is copied once from its send row, and
the rep's first launch zeroes the rows its rounds leave unwritten, so the
receive arena is a ``torch.empty``. A rep of more than one round and no
barrier token is ONE launch, its rounds fenced inside the kernel
(``deliver_rounds``); one round, or rounds with tokens between them,
take one launch a round. :func:`one_device_build` builds these rounds
and zero runs from a schedule alone.

Deep barrier-free schedules (32 rounds or more) take the reference's
padded-table form (every round at the widest round's width, pads into
the trash row); each round stays its own launch sequence.

TAM methods (m=15/16) on one device with no process group run the
proxy engine's relay (``collective_write``, lustre_driver_test.c:944-1309)
over the same compacted arenas as m=1/m=2 on the pattern: three row
deliveries, P2 from the send arena into a staging arena in
``proxy_hold`` order, P3 into a second staging arena in ``node_in``
order, P4/P5 into each receiver's slot (orders from
:func:`tpu_aggcomm_torch.tam.relay.relay_orders`). Each hop is its own
launch, a pass over every slab: the hops are never composed into one
gather, as throttle rounds are never merged, and a hop whose order is
the identity is still copied (the reference's pack and transfer,
l_d_t.c:1069-1105). Under a process group they run the blocked
two-level engine (:func:`tpu_aggcomm_torch.tam.engine.
tam_two_level_sharded`): two padded block all_to_alls, along the
``node`` and the ``local`` axis of a (Dn, Dl) grid of processes.

Slow-rank faults add, after the rounds, each process's delay iterations
(the sum over its slow ranks) into ``recv[0, 0]`` through the delay
kernel ``csrc/slow_delay.cu`` (its plain version on the CPU), the
one-rank form of :func:`~tpu_aggcomm_torch.backends.slow_delay.slow_delay`
over the process's flat arenas. The kernel sums as ``torch_sim``'s (the
reference's ``jax_sim``) int32 loop does, where ``jax_shard`` sums in
uint32: the accumulators differ, the delta added is 0 in both, and the
bytes are the same.

Timing: whole-rep wall time, phases filled by the fenced-segment
attribution (harness/attribution.py), as ``torch_sim``; ``--chained``
and the measured round times ride the shared serial-chain scaffold
(:mod:`tpu_aggcomm_torch.harness.chained`, CUDA graph replays on the
card), the token ``(sum over every process's live recv rows + r) %
251`` summed across the group. Under a group every process runs the
same program; each verifies and returns the recv slabs of its own ranks
(the others are None), and every measured time is the group's maximum,
so all processes agree.

A process group of ``W`` ranks runs ``ndev = min(W, nprocs)`` devices,
stepped down until ``ndev`` divides ``nprocs`` (the reference's
``_mesh``). The processes past ``ndev`` hold no ranks: they run the same
program over empty blocks, so every collective is one call over the
whole group (an all_to_all sends them zero rows, and they add 0 to every
token). No process group is created for a part of the group.
"""

from __future__ import annotations

import statistics
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aggcomm_torch.backends.deliver_rows import (RoundTables,
                                                     RowTables, ZeroRuns,
                                                     arena_launcher,
                                                     check_fence,
                                                     deliver_rows,
                                                     round_tables,
                                                     row_launcher,
                                                     row_tables,
                                                     rounds_launcher,
                                                     unwritten_runs,
                                                     zero_runs)
from tpu_aggcomm_torch.backends.lanes import (lane_layout, lanes_to_bytes,
                                              to_reference, wrap_i32)
from tpu_aggcomm_torch.backends.slow_delay import slow_delay, slow_tables
from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.schedule import (Schedule, barrier_rounds_of,
                                             schedule_shape_key)
from tpu_aggcomm_torch.device import resolve_device, sync
from tpu_aggcomm_torch.harness.attribution import (attribute_rounds,
                                                   attribute_total,
                                                   weights_for)
from tpu_aggcomm_torch.harness.chained import (MAX_MEASURED_ROUNDS,
                                               differenced_per_rep,
                                               differenced_round_times,
                                               differenced_trials,
                                               eager_chain, graph_chain,
                                               token_from_sum, xor_token_)
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import recv_slot_counts
from tpu_aggcomm_torch.obs import trace
from tpu_aggcomm_torch.parallel import (agree_max, collective_group,
                                        group_ranks, group_sum,
                                        verify_ranks)
from tpu_aggcomm_torch.tam.engine import TamMethod
from tpu_aggcomm_torch.tam.relay import relay_orders

__all__ = ["TorchShardBackend", "block_round_tables", "recv_layout",
           "send_counts", "fill_rows", "schedule_edges", "one_device_build"]


def _apply_block_round(flat_send, recv, tab, nbar: int, F: int, coll,
                       zero: ZeroRuns | None = None, issue=None):
    """One throttle round on one process's shard, then the round's
    barriers as tokens into the trash row. Shared by the whole rep, its
    prefixes and the profile_rounds segments, so the profiled
    decomposition cannot drift from the program it decomposes.

    ``tab`` is :class:`_RoundTab`. With one device the exchange is the
    identity, so neither the collective nor the padding mask runs (the
    reference's ``single_dev`` path): the round is one row delivery of
    ``tab.rows``, which also zeroes ``zero``'s rows (the rep's first
    round), through the rep's ``issue`` (:func:`arena_launcher`) when
    given, and a barrier is the one device's own token. Under an
    exchange: gather the round's outgoing blocks, one all_to_all over the
    group, the scatter of the landed payload, and each barrier an
    all-reduced token. A process outside the mesh runs the same
    collectives with empty blocks and adds 0 to every token."""
    import torch.distributed as dist

    if tab.rows is not None:
        (issue or arena_launcher(flat_send, recv))(tab.rows, zero)
        for _ in range(nbar):
            recv[F - 1, 0] = recv[0, 0]
        return recv
    vals = flat_send[tab.pk] * tab.mask
    got = torch.empty_like(vals)
    dist.all_to_all_single(got, vals, tab.splits, tab.splits, group=coll)
    recv[tab.sc] = got
    for _ in range(nbar):
        tok = (recv[0, 0:1].to(torch.int64) if tab.member
               else torch.zeros(1, dtype=torch.int64, device=recv.device))
        dist.all_reduce(tok, group=coll)
        if tab.member:
            recv[F - 1, 0:1] = (wrap_i32(tok) if recv.dtype == torch.int32
                                else (tok & 0xFF).to(torch.uint8))
    return recv


def _schedule_edges(schedule: Schedule) -> np.ndarray:
    """(src, dst, sslot, dslot, round) int64 rows for every payload edge,
    with receive slots resolved: :meth:`Schedule.data_edges`, which m=1
    and m=2 give from the pattern in numpy while their programs are
    unbuilt, and any other schedule from an O(E) Python walk of its ops.
    Collective schedules (m=5/8) synthesize the full pattern as a single
    round: the Alltoallw's whole exchange is one program step, as in the
    reference (mpi_test.c:627-645).

    Fault handling: dead-link-repaired schedules carry relay staging rows
    and chan != 0 detour edges the compacted block layout cannot
    represent — clean refusal (the detour route runs on local/torch_sim;
    dead-AGGREGATOR repair regenerates a healthy program and runs here
    fine). UNREPAIRED dead links are realized by dropping the dead
    chan-0 edges from the block tables (faults/inject.dead_edge_mask
    semantics) — the run then fails --verify, which is the injection
    working."""
    p = schedule.pattern
    n = p.nprocs
    if getattr(schedule, "n_staging", 0):
        raise ValueError(
            f"m={schedule.method_id} ({schedule.name}) is a dead-link-"
            f"repaired schedule (fault={schedule.fault!r}): torch_shard's "
            f"block lowering cannot represent relay staging rows; run the "
            f"detour route on --backend local or torch_sim")
    if schedule.collective:
        agg_index = np.asarray(p.agg_index)
        if p.direction is Direction.ALL_TO_MANY:
            srcs = np.repeat(np.arange(n), p.cb_nodes)
            dsts = np.tile(np.asarray(p.rank_list), n)
            sslots = np.tile(np.arange(p.cb_nodes), n)
            dslots = srcs
        else:
            srcs = np.repeat(np.asarray(p.rank_list), n)
            dsts = np.tile(np.arange(n), p.cb_nodes)
            sslots = dsts
            dslots = agg_index[srcs]
        rounds = np.zeros(len(srcs), dtype=np.int64)
        return _drop_dead_edges(
            np.stack([srcs, dsts, sslots, dslots, rounds],
                     axis=1).astype(np.int64), schedule)

    return _drop_dead_edges(schedule.data_edges(), schedule)


#: the last schedule's edge table: (weak reference to it, its table). The
#: flagship's table is 168 MB (an op walk of tens of host seconds for a
#: method with no closed form), so the backend, the roofline and the
#: --ndev view share one
_EDGE_MEMO: list = []


def schedule_edges(schedule: Schedule) -> np.ndarray:
    """:func:`_schedule_edges`, memoized for the last schedule asked for
    (the same object: schedules are not hashed)."""
    if _EDGE_MEMO and _EDGE_MEMO[0][0]() is schedule:
        return _EDGE_MEMO[0][1]
    edges = _schedule_edges(schedule)
    _EDGE_MEMO[:] = [(weakref.ref(schedule), edges)]
    return edges


def _drop_dead_edges(edges: np.ndarray, schedule: Schedule) -> np.ndarray:
    """UNREPAIRED fault realization: drop the chan-0 edges named dead (all
    edges here are chan-0 — staged schedules were refused above)."""
    fault = getattr(schedule, "fault", None)
    if not fault or len(edges) == 0:
        return edges
    from tpu_aggcomm_torch.faults.spec import parse_fault
    dead = set(parse_fault(fault).deadlinks)
    if not dead:
        return edges
    keep = np.array([(int(s), int(d)) not in dead
                     for s, d in edges[:, :2]], dtype=bool)
    return edges[keep]


def recv_layout(counts: np.ndarray, ndev: int, bsz: int):
    """Compacted per-device recv layout: only ranks that receive get rows
    (all-to-many non-aggregators own zero recv slabs, mpi_test.c:162-202
    — padding them to nprocs rows each would be 1000x the needed memory
    at flagship scale). Returns (base, F): ``base[rank]`` = offset of the
    rank's first row in its device's flat recv buffer (-1 if it receives
    nothing), ``F`` = uniform per-device buffer length incl. 1 trash row.
    """
    n = len(counts)
    base = np.full(n, -1, dtype=np.int64)
    F = 1
    for dev in range(ndev):
        off = 0
        for r in range(dev * bsz, min((dev + 1) * bsz, n)):
            if counts[r]:
                base[r] = off
                off += int(counts[r])
        F = max(F, off + 1)
    return base, F


def block_round_tables(edges: np.ndarray, *, ndev: int, bsz: int,
                       send_base: np.ndarray, recv_base: np.ndarray,
                       F: int):
    """Per-round (pack, scat, M) block tables for the device all_to_all.

    pack: (ndev, ndev, M) flat local-send indices (send_base[src] + sslot,
    -1 pad); scat: (ndev, ndev, M) flat local-recv indices (recv_base[dst]
    + dslot), b-major (scat[b, a, j] matches the all_to_all output block
    from device a), trash = F - 1 for padding. Vectorized group-by, so the
    flagship edge counts (4M+ edges) stay in numpy: the edges are sorted
    by round once (stably, so each round keeps its rows' order) and each
    round is a slice of that.
    """
    trash = F - 1
    out = []
    if len(edges) == 0:
        return out
    by_round = edges[np.argsort(edges[:, 4], kind="stable")]
    ends = np.cumsum(np.bincount(by_round[:, 4]))
    for r in range(len(ends)):
        sel = by_round[ends[r - 1] if r else 0:ends[r]]
        if len(sel) == 0:
            continue
        src, dst, sslot, dslot = sel[:, 0], sel[:, 1], sel[:, 2], sel[:, 3]
        sdev, ddev = src // bsz, dst // bsz
        pair = sdev * ndev + ddev
        order = np.argsort(pair, kind="stable")
        pair_s = pair[order]
        counts = np.bincount(pair_s, minlength=ndev * ndev)
        M = int(counts.max())
        # position of each edge within its (a, b) block
        starts = np.zeros(ndev * ndev, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        pos = np.arange(len(sel)) - starts[pair_s]
        pack = np.full((ndev * ndev, M), -1, dtype=np.int32)
        scat = np.full((ndev * ndev, M), trash, dtype=np.int32)
        pack[pair_s, pos] = (send_base[src] + sslot)[order]
        scat[pair_s, pos] = (recv_base[dst] + dslot)[order]
        pack = pack.reshape(ndev, ndev, M)
        # b-major view: device b's landing table over source devices a
        scat = scat.reshape(ndev, ndev, M).transpose(1, 0, 2).copy()
        out.append((r, pack, scat, M))
    return out


def send_counts(p: AggregatorPattern) -> np.ndarray:
    """Send slabs per rank: every rank sends cb_nodes all-to-many, only
    aggregators send (nprocs each) many-to-all."""
    n = p.nprocs
    if p.direction is Direction.ALL_TO_MANY:
        return np.full(n, p.cb_nodes, dtype=np.int64)
    return np.where(np.asarray(p.agg_index) >= 0, n, 0)


def fill_rows(src, seed, iter_: int, data_size: int, device) -> torch.Tensor:
    """Deterministic-fill slab rows built on ``device``: row k is
    ``MAP_DATA(src[k], offset, seed[k], iter_)`` (mpi_test.c:23,71-77),
    ``(src + seed + iter + offset) % 256`` as bytes, in the lane layout.
    Byte arithmetic wraps mod 256, so no wider temporary is made: the
    flagship's 8.59 GB send arena at d=2048 is built where it lives."""
    _, dt, w = lane_layout(data_size)
    base = ((np.asarray(src, dtype=np.int64) + np.asarray(seed, dtype=np.int64)
             + iter_) % 256).astype(np.uint8)
    rows = (torch.from_numpy(base).to(device)[:, None]
            + torch.arange(data_size, device=device).to(torch.uint8)[None, :])
    return rows.view(dt) if dt == torch.int32 else rows


@dataclass(frozen=True)
class _RoundTab:
    """One round's tables on one process: the round's payload edges
    across the mesh (``edges``) and whether this process holds ranks
    (``member``). On one device, the row delivery's tables (``rows``)
    alone. Under an exchange, int64 gather (``pk``, pads clamped to 0)
    and scatter (``sc``, pads to the trash row) indices in the group's
    rank order, the ``(entries, 1)`` padding mask and the per-rank chunk
    sizes of the all_to_all (``splits``, 0 for processes outside the
    mesh)."""

    edges: int
    member: bool
    rows: RowTables | None = None
    pk: torch.Tensor | None = None
    sc: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    splits: list | None = None


@dataclass
class _Built:
    """One schedule's build on this process: its mesh, layouts, per-round
    device tables, on one device the whole rep's zero runs (``zero``;
    None under an exchange, whose arena is zeroed) and, for a rep of more
    than one round and no barrier token, the rounds as one launch reads
    them (``fused``; every round's tables are views of it), and the
    rep/chain constructors. A TAM relay has no rounds: ``relay`` holds its
    three hops' row tables (P2, P3, P4/P5) and ``zero`` the receive rows
    P4/P5 leaves unwritten. ``idx`` is None for a process outside the
    mesh: it holds no ranks and runs the same program over empty
    blocks."""

    ndev: int
    bsz: int
    idx: int | None
    members: list = ()
    coll: object = None
    data_size: int = 1
    F: int = 1
    Fs: int = 1
    counts: np.ndarray | None = None
    recv_base: np.ndarray | None = None
    send_base: np.ndarray | None = None
    rounds: list | None = None          # [(round id, _RoundTab, nbar)]
    zero: ZeroRuns | None = None
    fused: RoundTables | None = None
    relay: tuple | None = None
    rep: object = None
    make_chain: object = None


def _host_layout(schedule, ndev: int, idx: int | None
                 ) -> tuple[_Built, list]:
    """The host side of ``schedule``'s build over ``ndev`` devices, on
    device ``idx`` (None: a process outside the mesh): compacted flat
    layouts (only ranks that send/receive get rows — a dense (n,
    nprocs)-slot layout would be n² at flagship scale), per-round block
    tables, barrier rounds, and the orphan-barrier check. Returns the
    :class:`_Built` holding the layouts and the host rounds, one ``(round
    id, pack, scat, barriers)`` a round — one code path, so the profiled
    segments can never decompose a different program than the whole-rep
    build runs, and both modes accept exactly the same schedules."""
    p = schedule.pattern
    bsz = p.nprocs // ndev
    with trace.span("tables.edges"):
        edges = schedule_edges(schedule)
    with trace.span("tables.rounds"):
        counts = np.asarray(recv_slot_counts(p))
        recv_base, F = recv_layout(counts, ndev, bsz)
        send_base, Fs = recv_layout(send_counts(p), ndev, bsz)
        tabs = block_round_tables(edges, ndev=ndev, bsz=bsz,
                                  send_base=send_base, recv_base=recv_base,
                                  F=F)
        barrier_rounds = barrier_rounds_of(schedule)
    orphans = set(barrier_rounds) - {r for (r, *_rest) in tabs}
    if orphans:
        raise ValueError(
            f"schedule {schedule.name!r} has barrier-only rounds "
            f"{sorted(orphans)}; the block lowering cannot represent "
            f"a standalone fence")
    built = _Built(ndev=ndev, bsz=bsz, idx=idx, data_size=p.data_size)
    if idx is not None:
        built.F, built.Fs = F, Fs
        built.counts, built.recv_base = counts, recv_base
        built.send_base = send_base
    return built, [(r, pk, sc, barrier_rounds.get(r, 0))
                   for (r, pk, sc, _m) in tabs]


def _scan_form(host: list, F: int) -> list:
    """``host``'s rounds as the rep runs them. Many-round barrier-free
    schedules take the reference's scan form: every round padded to the
    widest round (pads -> trash)."""
    if len(host) < 32 or any(nbar for (*_rest, nbar) in host):
        return host
    Mmax = max(pk.shape[-1] for (_r, pk, _sc, _nb) in host)
    out = []
    for (r, pk, sc, nbar) in host:
        if pk.shape[-1] < Mmax:
            pad = [(0, 0), (0, 0), (0, Mmax - pk.shape[-1])]
            pk = np.pad(pk, pad, constant_values=-1)
            sc = np.pad(sc, pad, constant_values=F - 1)
        out.append((r, pk, sc, nbar))
    return out


def _one_device_rounds(built: _Built, host: list, device
                       ) -> tuple[list, RoundTables]:
    """``host``'s rounds on one device, ``[(round id, _RoundTab,
    barriers)]``: each round the row delivery's tables of the reference's
    (1, 1, M) block tables (none outside the mesh), views of one upload,
    the :class:`RoundTables` returned beside them."""
    member = built.idx is not None
    empty = np.zeros(0, dtype=np.int32)
    tabs = round_tables([(pk, sc) if member else (empty, empty)
                         for (_r, pk, sc, _nb) in host],
                        F=built.F, Fs=built.Fs, device=device)
    return [(r, _RoundTab(edges=int((pk >= 0).sum()), member=member,
                          rows=rows), nbar)
            for (r, pk, _sc, nbar), rows in zip(host, tabs.rounds)], tabs


def _zero_runs(F: int, rounds: list, device) -> ZeroRuns:
    """The zero runs of a one-device rep of ``rounds`` into an ``F``-row
    arena."""
    return zero_runs(unwritten_runs(
        F, [(tab.rows.dst, nbar) for (_r, tab, nbar) in rounds]), device)


def _relay_build(tam: TamMethod, device) -> _Built:
    """A TAM schedule's relay on one device: m=1/m=2's compacted layouts
    on the pattern, and the three hops' row tables over them (P2: send
    rows into staging rows ``0 .. E-1`` in ``proxy_hold`` order; P3:
    those into a second staging arena in ``node_in`` order; P4/P5: its
    rows into the receivers' slots, zeroing the receive rows none
    writes)."""
    p = tam.pattern
    with trace.span("tables.relay"):
        o = relay_orders(p, tam.assignment)
        counts = np.asarray(recv_slot_counts(p))
        recv_base, F = recv_layout(counts, 1, p.nprocs)
        send_base, Fs = recv_layout(send_counts(p), 1, p.nprocs)
        E = o.n_slabs
        rows = np.arange(E, dtype=np.int32)
        hops = (
            row_tables(send_base[o.stage_src] + o.stage_slot, rows, F=E,
                       Fs=Fs, device=device),
            row_tables(o.exch, rows, F=E, Fs=E, device=device),
            row_tables(rows, recv_base[o.dst] + o.dst_slot, F=F, Fs=E,
                       device=device))
        zero = zero_runs(unwritten_runs(F, [(hops[2].dst, 0)]), device)
    return _Built(ndev=1, bsz=p.nprocs, idx=0, data_size=p.data_size, F=F,
                  Fs=Fs, counts=counts, recv_base=recv_base,
                  send_base=send_base, rounds=[], zero=zero, relay=hops)


def _relay_rep(built: _Built, device):
    """``rep(flat_send (Fs, w), upto=None, stages=None) -> recv (F, w)``:
    the relay's three hops, each one bound row delivery
    (:func:`row_launcher`) from the previous hop's arena into a fresh
    ``torch.empty`` one, P2 and P3 into staging arenas of E rows, P4/P5
    into the receive arena. A staging arena is dropped once the next hop
    has been issued, so the receive arena can take its memory. While a
    trace recorder is on, a ``rep`` span holding each allocation's
    ``rep.arena`` and each hop's ``rep.hop`` (``hop`` 1-3, ``rows`` its
    slabs); ``deliver_rows.relay_hops`` counts the hops. ``stages``, a
    list, gets each hop's output appended (the staging arenas kept);
    ``upto`` is the chain scaffold's and takes None alone: the relay has
    no round prefixes."""
    _, dt, w = lane_layout(built.data_size)
    rows_in = (built.Fs, *(t.recv_rows for t in built.relay[:2]))
    rows_out = (*rows_in[1:], built.F)
    hops = []

    def bind() -> list:
        """Each hop's ``(rows, slabs, issue)``, bound at the first rep (on
        the card that loads the kernel library, as a round's launcher
        does)."""
        return [(rows, tabs.n_rows, row_launcher(
                    tabs, built.zero if k == 3 else None,
                    send_shape=(src, w), recv_shape=(rows, w), dtype=dt))
                for k, (tabs, src, rows) in enumerate(
                    zip(built.relay, rows_in, rows_out), 1)]

    def rep(flat_send, upto: int | None = None, stages: list | None = None):
        if upto is not None:
            raise ValueError("the TAM relay has no round prefixes")
        if not hops:
            hops.extend(bind())
        src = flat_send
        with trace.span("rep"):
            for k, (rows, slabs, issue) in enumerate(hops, 1):
                with trace.span("rep.arena"):
                    dst = torch.empty((rows, w), dtype=dt, device=device)
                with trace.span("rep.hop", hop=k, rows=slabs):
                    issue(src, dst)
                deliver_rows.relay_hops += 1
                if stages is not None:
                    stages.append(dst)
                src = dst
        return src

    return rep


def one_device_build(schedule: Schedule, device, *, member: bool = True
                     ) -> _Built:
    """``schedule``'s build on one device, with no backend and no process
    group: its layouts, its rounds (each the row delivery's tables, in
    the scan form where it applies; all of them uploaded at once, each
    round's a view) and the whole rep's zero runs; ``fused``, the rounds
    in one launch's form, where there are more than one and no barrier
    token. What ``TorchShardBackend`` runs at one device and the roofline
    prices. ``member=False`` is a process outside a one-device mesh: the
    same rounds over a one-row arena and no rows. A TAM schedule builds
    its relay (``relay``; a member alone: under a group TAM runs the
    blocked engine)."""
    if isinstance(schedule, TamMethod):
        if not member:
            raise ValueError("a TAM relay is built on the one device that "
                             "holds every rank")
        return _relay_build(schedule, device)
    built, host = _host_layout(schedule, 1, 0 if member else None)
    with trace.span("tables.rounds"):
        built.rounds, tabs = _one_device_rounds(
            built, _scan_form(host, built.F), device)
        if len(host) > 1 and not any(nbar for (*_rest, nbar) in host):
            built.fused = tabs
        built.zero = _zero_runs(built.F, built.rounds, device)
    return built


class TorchShardBackend:
    """Executes schedules with the rank axis sharded over a process
    group (the default group, or ``group``; one process alone when no
    group is up). Every process of the group runs the same program."""

    name = "torch_shard"

    def __init__(self, device="cuda", group=None, ranks_per_device=None):
        from tpu_aggcomm_torch.parallel import (check_cards, is_distributed,
                                                local_card)
        if group is not None and not is_distributed():
            raise ValueError("torch_shard: a process group was given but "
                             "torch.distributed is not initialized")
        self._group = group
        self._ranks = group_ranks(group)
        self._coll = collective_group(group)
        if is_distributed():
            import torch.distributed as dist
            self._me = dist.get_rank()
        else:
            self._me = 0
        self._ranks_per_device = ranks_per_device
        dev = resolve_device(device)
        if self._coll is not None:
            import torch.distributed as dist
            backend = str(dist.get_backend(self._coll)).lower()
            want = "nccl" if dev.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(
                    f"torch_shard on {dev.type} needs a {want} process "
                    f"group, got {backend} (distributed_init picks it from "
                    f"--device)")
            if dev.type == "cuda":
                check_cards(len(self._ranks))
                if dev.index is None:
                    dev = torch.device("cuda", local_card(self._me))
        self.device = dev
        self._hosts = None
        self._cache: dict = {}
        #: schedule key -> measured per-rep seconds and decompositions
        self._chain_cache: dict = {}
        self.last_samples: list[float] | None = None
        self.last_rep_timers: list = []
        self.last_round_times: list = []

    # ------------------------------------------------------------------
    def _devices(self) -> list[int]:
        """The group's ranks, host-major (host names gathered once)."""
        if self._coll is None:
            return list(self._ranks)
        from tpu_aggcomm_torch.parallel import group_hosts, host_major_devices
        if self._hosts is None:
            self._hosts = group_hosts(self._group)
        return host_major_devices(self._ranks, hosts=self._hosts)

    def _mesh(self, nprocs: int):
        """(members, ndev, this process's device index or None): the
        reference's ``_mesh`` rule over the group's host-major ranks."""
        devs = self._devices()
        if self._ranks_per_device:
            b = self._ranks_per_device
            if nprocs % b:
                raise ValueError(
                    f"ranks_per_device={b} must divide nprocs={nprocs}")
            d = nprocs // b
            if d > len(devs):
                raise ValueError(
                    f"nprocs={nprocs} at {b} ranks/device needs {d} "
                    f"devices, have {len(devs)}")
        else:
            d = min(len(devs), nprocs)
            while nprocs % d:
                d -= 1
        members = devs[:d]
        idx = members.index(self._me) if self._me in members else None
        return members, d, idx

    def _order(self, members) -> list:
        """Device indices in the group's rank order (the order of an
        all_to_all's chunks), members only."""
        return [members.index(r) for r in self._ranks if r in members]

    def _splits(self, members, size: int) -> list:
        """All_to_all chunk sizes by group rank: ``size`` rows to and
        from every member of the mesh, none to the other processes."""
        return [size if r in members else 0 for r in self._ranks]

    def _key(self, schedule):
        return schedule_shape_key(schedule)

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    # ------------------------------------------------------------------
    def _tam_grid(self, schedule, devs):
        """Resolve the (ndev, (Dn, Dl)) device grid for the blocked TAM
        engine, or None when an explicit ranks_per_device split has no
        fitting factorization — shared by the plain and chained TAM
        routes so they can never resolve different grids."""
        from tpu_aggcomm_torch.tam.engine import sharded_grid

        p = schedule.pattern
        na = schedule.assignment
        N = na.nnodes
        L = int(na.node_sizes.max())        # Lmax: ragged maps allowed
        if self._ranks_per_device and p.nprocs % self._ranks_per_device:
            # same contract as _mesh on every other route: an invalid
            # explicit split raises, it is never silently floor-divided
            raise ValueError(
                f"ranks_per_device={self._ranks_per_device} must divide "
                f"nprocs={p.nprocs}")
        ndev = (p.nprocs // self._ranks_per_device
                if self._ranks_per_device else min(len(devs), p.nprocs))
        while ndev > 0:
            try:
                grid = sharded_grid(N, L, ndev)
                break
            except ValueError:
                if self._ranks_per_device:
                    return None             # explicit split doesn't fit
                ndev -= 1
        if ndev <= 0 or ndev > len(devs):
            return None
        return ndev, grid

    def _tam(self, schedule, iter_: int, ntimes: int):
        """Resolve the grid and run the blocked engine (None when no
        grid fits): (recv slabs, per-rep seconds, engine state)."""
        from tpu_aggcomm_torch.tam.engine import tam_two_level_sharded

        devs = self._devices()
        resolved = self._tam_grid(schedule, devs)
        if resolved is None:
            return None
        ndev, grid = resolved
        return tam_two_level_sharded(
            schedule, devs[:ndev], iter_, ntimes, mesh_shape=grid,
            cache=self._cache, return_state=True, device=self.device,
            group=self._group)

    def _run_tam_chained(self, schedule, iter_: int, ntimes: int,
                         verify: bool):
        """TAM with chained (differenced) timing through the blocked
        engine: delivery + verification from one plain rep; per-rep
        seconds from the engine's serial-chain scaffold; per-rank
        columns by the byte-weighted TAM split of the measured total."""
        # ONE plain rep: delivery/verification AND the chain-seed state
        res = self._tam(schedule, iter_, 1)
        if res is None:
            return None
        recv_bufs, _times, st = res
        p = schedule.pattern
        per_rep = differenced_per_rep(
            st["make_chain"], st["last_send_dev"],
            iters_small=20, iters_big=220, trials=3, windows=2,
            agree=st["agree"])
        self.last_provenance = ("torch_shard", "attributed-chained")
        attr_w = weights_for(schedule)
        rep_attr = attribute_total(schedule, per_rep, weights=attr_w)
        timers = [Timer() for _ in range(p.nprocs)]
        for r, t in enumerate(timers):
            t += Timer.from_array(rep_attr[r].as_array() * ntimes)
        self.last_rep_timers = [
            [Timer.from_array(t.as_array()) for t in rep_attr]
            for _ in range(ntimes)]
        self.last_round_times = []
        if verify:
            self._verify(p, recv_bufs, iter_, st["local_ranks"])
        return recv_bufs, timers

    def _run_tam_sharded(self, schedule, iter_: int, ntimes: int,
                         verify: bool, profile_rounds: bool):
        """m=15/16 through the explicit blocked two-level engine
        (tam_two_level_sharded): B logical ranks per device on a
        (node, local) grid — the collective_write relay as two padded
        block all_to_alls. Ragged node maps run this route too (the
        engine pads blocks to ceil(N/Dn) x ceil(Lmax/Dl)); None when an
        explicit ranks_per_device split has no factorization fitting
        inside the (N, Lmax) topology."""
        res = self._tam(schedule, iter_, ntimes)
        if res is None:
            return None
        recv_bufs, rep_times, st = res
        p = schedule.pattern
        attr_w = weights_for(schedule)
        timers = [Timer() for _ in range(p.nprocs)]
        self.last_rep_timers = []
        self.last_round_times = []
        for dt in rep_times:
            rep_attr = attribute_total(schedule, dt, weights=attr_w)
            for r, t in enumerate(timers):
                t += rep_attr[r]
            self.last_rep_timers.append(rep_attr)
            if profile_rounds:
                # whole rep = the single profiled segment (no round
                # structure in the blocked route), as on torch_sim
                self.last_round_times.append([dt])
        if verify:
            self._verify(p, recv_bufs, iter_, st["local_ranks"])
        return recv_bufs, timers

    # ------------------------------------------------------------------
    def _mesh_layout(self, schedule) -> tuple[_Built, list]:
        """The mesh and the host-side layouts of a round-structured
        schedule on this process, and its host block tables, one
        ``(round id, pack, scat, barriers)`` a round
        (:func:`_host_layout`)."""
        members, ndev, idx = self._mesh(schedule.pattern.nprocs)
        built, host = _host_layout(schedule, ndev, idx)
        built.members, built.coll = members, self._coll
        return built, host

    def _device_tab(self, built: _Built, pk, sc) -> _RoundTab:
        """One round's :class:`_RoundTab` on this process from the
        reference's (ndev, ndev, M) block tables, ndev >= 2."""
        _, dt, _w = lane_layout(built.data_size)
        if built.idx is None:
            pkl = scl = np.zeros(0, dtype=np.int64)
            mask_np = np.zeros((0, 1), dtype=bool)
        else:
            order = self._order(built.members)
            pkl, scl = pk[built.idx][order], sc[built.idx][order]
            mask_np = (pkl >= 0).reshape(-1, 1)
        return _RoundTab(
            edges=int((pk >= 0).sum()), member=built.idx is not None,
            pk=self._idx(np.maximum(pkl, 0).reshape(-1)),
            sc=self._idx(scl.reshape(-1)),
            mask=torch.as_tensor(mask_np, device=self.device).to(dt),
            splits=self._splits(built.members if built.idx is not None
                                else (), pk.shape[-1]))

    def _compiled(self, schedule) -> _Built:
        """The schedule's build on this process (cached): mesh, layouts,
        per-round device tables, rep and chain factory."""
        key = self._key(schedule)
        if key in self._cache:
            return self._cache[key]
        if isinstance(schedule, TamMethod):
            if not self._relay_applies(schedule):
                raise TypeError("TAM schedules under a process group run "
                                "the blocked engine (_run_tam_sharded), not "
                                "the relay")
            built = one_device_build(schedule, self.device)
            return self._bind(key, built, _relay_rep(built, self.device))
        p = schedule.pattern
        n = p.nprocs
        _, dt, w = lane_layout(p.data_size)
        members, ndev, idx = self._mesh(n)
        if ndev == 1:
            built = one_device_build(schedule, self.device,
                                     member=idx is not None)
            built.members, built.coll = members, self._coll
        else:
            built, host = self._mesh_layout(schedule)
            with trace.span("tables.rounds"):
                built.rounds = [
                    (r, self._device_tab(built, pk, sc), nbar)
                    for (r, pk, sc, nbar) in _scan_form(host, built.F)]
        F, rounds, coll, dev = built.F, built.rounds, built.coll, self.device
        # slow-rank fault injection: per-DEVICE delay-loop iterations
        # (ranks sharing a device serialize on it, so the device's busy
        # work is the sum over its slow ranks), after the rounds INSIDE
        # the rep; a device with none skips the launch (its loop would
        # add 0 to nothing)
        delay = None
        if getattr(schedule, "fault", None) and idx is not None:
            from tpu_aggcomm_torch.faults.inject import slow_iter_table
            from tpu_aggcomm_torch.faults.spec import parse_fault
            tbl = slow_iter_table(parse_fault(schedule.fault), n,
                                  max(len(rounds), 1))
            per_dev = tbl.reshape(ndev, built.bsz).sum(axis=1)
            delay = slow_tables(per_dev[idx:idx + 1], self.device)
        # one device: row deliveries into an unfilled arena, the first
        # zeroing the rows the rep's rounds never write; under an
        # exchange the arena is zeroed
        new_arena = torch.zeros if built.zero is None else torch.empty
        zeros = {len(rounds): built.zero}
        fused, launchers = built.fused, {}
        edges_upto = np.cumsum([0] + [tab.edges for (_r, tab, _nb) in rounds]
                               ).tolist()

        def zero_of(upto):
            """The zero runs of the rep truncated to ``upto`` rounds,
            made once for each length."""
            k = len(rounds[:upto])
            if k not in zeros:
                zeros[k] = _zero_runs(F, rounds[:k], dev)
            return zeros[k]

        def launcher_of(k: int):
            """The first ``k`` rounds as one launch, bound once for each
            length."""
            if k not in launchers:
                zero = zero_of(k)
                launchers[k] = (zero, rounds_launcher(
                    fused, k, zero, send_shape=(built.Fs, w),
                    recv_shape=(F, w), dtype=dt))
            return launchers[k]

        def rep(flat_send, upto: int | None = None):
            """One whole rep on this device's shard: flat_send (Fs, w) ->
            recv (F, w); ``upto`` truncates to the first upto rounds (the
            prefix programs measure_round_times differences). While a
            trace recorder is on, a ``rep`` span holding the receive
            arena's ``rep.arena``, then one ``rep.issue`` a round (its id
            and its edges across the mesh; on one device, the first also
            the rows it zeroes), or, where the rep's rounds are one
            launch, one ``rep.issue`` for all (``rounds``, their
            ``edges`` and ``zero_rows``)."""
            with trace.span("rep"):
                with trace.span("rep.arena"):
                    recv = new_arena((F, w), dtype=dt, device=dev)
                k = len(range(len(rounds))[:upto])
                if fused is not None and k > 1:
                    zero, issue = launcher_of(k)
                    with trace.span("rep.issue", rounds=k,
                                    edges=edges_upto[k], zero_rows=zero.rows):
                        issue(flat_send, recv)
                else:
                    zero = None if built.zero is None else zero_of(upto)
                    issue = (None if zero is None
                             else arena_launcher(flat_send, recv))
                    for (r, tab, nbar) in rounds[:upto]:
                        args = {} if zero is None else {"zero_rows":
                                                        zero.rows}
                        with trace.span("rep.issue", round=r,
                                        edges=tab.edges, **args):
                            _apply_block_round(flat_send, recv, tab, nbar, F,
                                               coll, zero, issue)
                        zero = None
                    if zero is not None:        # no round: the zeroing
                        with trace.span("rep.issue", zero_rows=zero.rows):
                            issue(None, zero)
                if delay is not None:
                    slow_delay(flat_send[None], recv[None], delay)
            return recv

        return self._bind(key, built, rep)

    def _bind(self, key, built: _Built, rep) -> _Built:
        """Finish and cache a build around its ``rep``: the serial-chain
        factory over it, and the layout the rep's arenas follow on it."""
        F, coll, dev = built.F, built.coll, self.device

        def make_chain(upto: int | None = None):
            """The serial-chain factory: rep r+1's send XOR-perturbed by
            the token of rep r's delivered rows summed over every
            process (an all_reduce under a group), so reps can neither
            fuse nor elide and every device depends on every other
            device's previous rep. ``upto`` truncates every rep to its
            first upto rounds through this SAME scaffold."""
            def step(carry, r):
                recv = rep(carry, upto)
                xor_token_(carry, token_from_sum(
                    group_sum(recv[:F - 1, 0], coll), r))
            if dev.type == "cuda":
                return graph_chain(None, step=step)
            return eager_chain(None, step=step)

        rep.F, rep.Fs, rep.counts = built.F, built.Fs, built.counts
        rep.send_base, rep.recv_base = built.send_base, built.recv_base
        built.rep, built.make_chain = rep, make_chain
        self._cache[key] = built
        return built

    def _relay_applies(self, schedule) -> bool:
        """Whether ``schedule`` is TAM on one device with no process group
        (and no split asking for more devices): the relay's case."""
        return (isinstance(schedule, TamMethod) and self._coll is None
                and self._ranks_per_device in (None, schedule.nprocs))

    def one_rep(self, schedule):
        """``rep(flat_send (Fs, w)) -> recv (F, w)`` on this process's
        shard: the rep :meth:`run` times, built once. It carries the
        compacted layout its arenas follow: ``Fs`` and ``F`` (rows, the
        trash row last), ``send_base`` and ``recv_base`` (a rank's first
        send and receive row, -1 for none) and ``counts`` (receive slots a
        rank), as :func:`~tpu_aggcomm_torch.native.fuse.build_fused_rep`'s
        rep carries its ``tables``."""
        return self._compiled(schedule).rep

    # ------------------------------------------------------------------
    def _send(self, p: AggregatorPattern, iter_: int, built: _Built
              ) -> torch.Tensor:
        """This device's compact (Fs, w) send layout: each sender's slabs
        at its send_base offset, built on the device (one zero row on a
        process outside the mesh)."""
        _, dt, w = lane_layout(p.data_size)
        out = torch.zeros((built.Fs, w), dtype=dt, device=self.device)
        if built.idx is None:
            return out
        lo, hi = built.idx * built.bsz, (built.idx + 1) * built.bsz
        scounts = send_counts(p)[lo:hi]
        src = np.repeat(np.arange(lo, hi), scounts)
        if len(src):
            slot = np.arange(len(src)) - np.repeat(
                np.cumsum(scounts) - scounts, scounts)
            base = np.asarray(built.send_base)[src]
            if (base < 0).any():
                raise ValueError(
                    "torch_shard: the pattern's senders are not the "
                    "schedule's (pass schedule.pattern: compile_method "
                    "sets the method's direction)")
            rows = base + slot
            out[self._idx(rows)] = fill_rows(src, slot, iter_, p.data_size,
                                             self.device)
        return out

    def _recv_bufs(self, p: AggregatorPattern, built: _Built,
                   out: torch.Tensor) -> list:
        """Per-rank recv slab matrices in bytes for this device's ranks
        (None for ranks that receive nothing and for other devices'):
        one read-back of the device's flat buffer."""
        bufs: list = [None] * p.nprocs
        if built.idx is None:
            return bufs
        got = lanes_to_bytes(to_reference(out), p.data_size)
        for r in self._local_ranks(built, p.nprocs):
            if built.counts[r]:
                b = int(built.recv_base[r])
                bufs[r] = got[b:b + int(built.counts[r])]
        return bufs

    def _local_ranks(self, built: _Built, n: int) -> range:
        if built.idx is None:
            return range(0)
        return range(built.idx * built.bsz,
                     min((built.idx + 1) * built.bsz, n))

    def _verify(self, p: AggregatorPattern, recv_bufs, iter_: int,
                local_ranks) -> None:
        """``harness/verify.verify_recv`` on one process; under a group
        each process checks its own ranks and a failure anywhere fails
        every process (:func:`tpu_aggcomm_torch.parallel.verify_ranks`)."""
        verify_ranks(p, recv_bufs, iter_, local_ranks, self._coll,
                     self.device)

    def run_flat(self, schedule, iter_: int = 0) -> np.ndarray | None:
        """One plain rep's flat recv buffer of this device, trash row
        included, in the reference's lane layout: ``(F, w)`` uint32 or
        uint8 (what the reference's program returns for this device).
        Every process of the group runs the rep; one outside the mesh
        gets None."""
        built = self._compiled(schedule)
        out = built.rep(self._send(schedule.pattern, iter_, built))
        sync(self.device)
        self._check_fence(built)
        return None if built.idx is None else to_reference(out)

    @staticmethod
    def _check_fence(built: _Built) -> None:
        """Raise :class:`~tpu_aggcomm_torch.backends.deliver_rows.
        DeliverFenceError` if a launch of the build's many-round rep timed
        out at a round fence."""
        if built.fused is not None:
            check_fence(built.fused)

    # ------------------------------------------------------------------
    def _round_segments(self, schedule):
        """Per-round ``seg(send, recv) -> recv`` programs plus their round
        ids, for profile_rounds; None for TAM (the blocked route has no
        throttle-round structure to split) and for the dense collective
        methods (one synthesized round), and for fault-injected schedules
        (per-round segments would omit the injected slow work). Each
        segment is one ``_apply_block_round`` over the round's own
        (unpadded) tables — the function the whole rep is built from."""
        if isinstance(schedule, TamMethod) or schedule.collective:
            return None
        if getattr(schedule, "fault", None) or getattr(schedule,
                                                       "n_staging", 0):
            return None
        key = (self._key(schedule), "segments")
        if key in self._cache:
            return self._cache[key]
        built, host = self._mesh_layout(schedule)
        if built.ndev == 1:
            rounds, _tabs = _one_device_rounds(built, host, self.device)
        else:
            rounds = [(r, self._device_tab(built, pk, sc), nbar)
                      for (r, pk, sc, nbar) in host]
        segs, round_ids = [], []
        for (r, tab, nbar) in rounds:
            def seg(send, recv, tab=tab, nbar=nbar):
                return _apply_block_round(send, recv, tab, nbar, built.F,
                                          built.coll)
            segs.append(seg)
            round_ids.append(r)
        self._cache[key] = (segs, round_ids, built)
        return self._cache[key]

    def _run_profiled(self, schedule, iter_: int, verify: bool,
                      ntimes: int, profiled):
        """profile_rounds execution: one launch sequence per throttle
        round, each synchronized and timed on the host clock, mapped onto
        the TimerBucket structure — torch_sim's profiled mode on the
        sharded tier (per-round launch and synchronize included;
        schedule-shape analysis, not headline numbers)."""
        segs, round_ids, built = profiled
        p = schedule.pattern
        _, dt, w = lane_layout(p.data_size)
        send = self._send(p, iter_, built)

        def fresh():
            return torch.zeros((built.F, w), dtype=dt, device=self.device)

        recv = fresh()
        for seg in segs:                   # warm-up every segment
            recv = seg(send, recv)
        sync(self.device)
        timers = [Timer() for _ in range(p.nprocs)]
        self.last_rep_timers = []
        self.last_round_times = []
        attr_w = weights_for(schedule)
        out = None
        for rep in range(ntimes):
            recv = fresh()
            sync(self.device)
            round_times = []
            for rnd, seg in zip(round_ids, segs):
                with trace.span("torch_shard.round", rep=rep, round=rnd,
                                method=schedule.name):
                    ts = time.perf_counter()
                    recv = seg(send, recv)
                    sync(self.device)
                    round_times.append(time.perf_counter() - ts)
            out = recv
            self.last_round_times.append(round_times)
            rep_attr = attribute_rounds(
                schedule, dict(zip(round_ids, round_times)), weights=attr_w)
            for r, t in enumerate(timers):
                t += rep_attr[r]
            self.last_rep_timers.append(rep_attr)
        recv_bufs = self._recv_bufs(p, built, out)
        if verify:
            self._verify(p, recv_bufs, iter_,
                         self._local_ranks(built, p.nprocs))
        return recv_bufs, timers

    # ------------------------------------------------------------------
    def _timing(self, iters_small, iters_big, trials, windows) -> dict:
        return dict(iters_small=iters_small, iters_big=iters_big,
                    trials=trials, windows=windows)

    def measure_per_rep(self, schedule, *, iters_small: int = 50,
                        iters_big: int = 1050, trials: int = 3,
                        windows: int = 3) -> float:
        """Serial-chained differenced per-rep seconds over the group
        (harness/chained.py): reps run back to back (CUDA graph replays
        on the card), rep r+1's send perturbed by the group-summed token
        of rep r's delivery, the fixed overhead differenced away; the
        group's maximum. Cached per schedule (iteration-invariant)."""
        if (isinstance(schedule, TamMethod)
                and not self._relay_applies(schedule)):
            raise ValueError(
                "TAM has no round-program chain here; chained TAM on "
                "torch_shard rides the blocked engine — call "
                "run(schedule, chained=True) (or use torch_sim)")
        key = (self._key(schedule), iters_small, iters_big, trials, windows)
        if key in self._chain_cache:
            per_rep, samples = self._chain_cache[key]
            self.last_samples = list(samples)
            return per_rep
        built = self._compiled(schedule)
        samples = differenced_trials(
            built.make_chain(), self._send(schedule.pattern, 0, built),
            agree=agree_max(self._coll, self.device),
            **self._timing(iters_small, iters_big, trials, windows))
        per_rep = statistics.median(samples)
        self._chain_cache[key] = (per_rep, tuple(samples))
        self.last_samples = list(samples)
        return per_rep

    def measure_trial_samples(self, schedule, *, iters_small: int = 50,
                              iters_big: int = 1050, trials: int = 3,
                              windows: int = 1) -> list[float]:
        """FRESH per-trial differenced seconds on the sharded tier for
        the autotuner (tune/measure.py): only the chain pair and the
        initial send buffer are kept (per schedule and chain lengths),
        the SAMPLES are never cached, so every racing batch re-times
        without rebuilding. Refusals are the backend's own, by name (TAM
        has no round chain; staged dead-link repairs are refused in the
        table lowering)."""
        if isinstance(schedule, TamMethod):
            raise ValueError(
                "TAM has no round-program chain here; tune TAM "
                "candidates on torch_sim")
        key = (self._key(schedule), "tune_chains", iters_small, iters_big)
        if key not in self._chain_cache:
            built = self._compiled(schedule)
            make_chain = built.make_chain()
            chains = {iters_small: make_chain(iters_small),
                      iters_big: make_chain(iters_big)}
            self._chain_cache[key] = (chains, self._send(schedule.pattern,
                                                         0, built))
        chains, send0 = self._chain_cache[key]
        samples = differenced_trials(
            lambda it: chains[it], send0,
            agree=agree_max(self._coll, self.device),
            **self._timing(iters_small, iters_big, trials, windows))
        self.last_samples = list(samples)
        return list(samples)

    def measure_round_times(self, schedule, *, iters_small: int = 50,
                            iters_big: int = 1050, trials: int = 3,
                            windows: int = 3,
                            max_rounds: int = MAX_MEASURED_ROUNDS) -> dict:
        """MEASURED per-round durations on the sharded tier by chained
        round-prefix truncation differencing (``harness/chained.
        differenced_round_times``): for each k the chain runs reps
        truncated to rounds 0..k-1 (full fidelity, same lowering, same
        group token), and round k's duration is the differenced
        increment, clamped at 0 and rescaled to sum exactly to the
        full-rep chain time. Returns ``{round id: seconds}``; cached per
        schedule."""
        if isinstance(schedule, TamMethod) or schedule.collective:
            raise ValueError(
                "measured round times need a round-structured schedule "
                "(TAM and the dense collectives have no gather/deliver "
                "round decomposition to truncate)")
        if getattr(schedule, "fault", None) or getattr(schedule,
                                                       "n_staging", 0):
            raise ValueError(
                "measured round times are not supported on fault-injected "
                "schedules (round-prefix truncation would replay the "
                "injected delay once per prefix); use --chained timing")
        built = self._compiled(schedule)
        round_ids = [r for (r, _tab, _nbar) in built.rounds]
        R = len(round_ids)
        if R > max_rounds:
            raise ValueError(
                f"{R} rounds exceeds max_rounds={max_rounds} (one chain "
                f"family is built per round); use profile_rounds for "
                f"very deep schedules")
        key = (self._key(schedule), "round_times", iters_small, iters_big,
               trials, windows)
        if key in self._chain_cache:
            return self._chain_cache[key]
        timing = self._timing(iters_small, iters_big, trials, windows)
        per_full = self.measure_per_rep(schedule, **timing)
        out = differenced_round_times(
            lambda k: built.make_chain(upto=k),
            self._send(schedule.pattern, 0, built), round_ids, per_full,
            agree=agree_max(self._coll, self.device), **timing)
        self._chain_cache[key] = out
        return out

    # ------------------------------------------------------------------
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
                             "exclusive (truncation-differenced rounds vs "
                             "per-round dispatch timing)")
        self.last_provenance = ("torch_shard",
                                "attributed-chained" if chained
                                else "attributed")
        self.last_route = "rounds"
        if profile_rounds:
            profiled = self._round_segments(schedule)
            if profiled is not None:
                # single-segment split = whole-rep attribution (same
                # downgrade rule as torch_sim)
                self.last_provenance = (
                    "torch_shard", "attributed-rounds"
                    if len(profiled[1]) > 1 else "attributed")
                return self._run_profiled(schedule, iter_, verify, ntimes,
                                          profiled)
            # TAM: no round structure to split — whole-rep timing below
        p = schedule.pattern
        n = p.nprocs
        is_tam = isinstance(schedule, TamMethod)
        if measured_phases and (is_tam or schedule.collective):
            raise ValueError(
                "measured phases need a round-structured schedule "
                "(TAM's 3-hop decomposition is measured by torch_sim's "
                "measure_tam_hops; the dense collectives have none)")
        if is_tam and self._relay_applies(schedule):
            # one device, no group: the relay's three row deliveries run
            # the normal path below (plain, --verify, --chained)
            self.last_route, is_tam = "relay", False
        elif is_tam:
            self.last_route = "blocked"
        if is_tam and chained:
            # honest flagship-TAM timing: the blocked engine's chain
            # scaffold — delivery and verification from the same rep
            # whose state seeds the chain
            out = self._run_tam_chained(schedule, iter_, ntimes, verify)
            if out is not None:
                return out
            raise ValueError(
                "chained TAM on torch_shard needs a (Dn, Dl) grid for the "
                "blocked engine (explicit ranks_per_device split does "
                "not fit); use --backend torch_sim")
        if is_tam:
            out = self._run_tam_sharded(schedule, iter_, ntimes, verify,
                                        profile_rounds)
            if out is not None:
                return out
            # the reference falls back to jax_sim's 3-hop route with the
            # rank axis sharded and XLA inserting the collectives
            self._mesh(n)          # too few devices: the _mesh refusal
            raise NotPortedError(
                f"m={schedule.method_id} with ranks_per_device="
                f"{self._ranks_per_device} has no (Dn, Dl) grid for the "
                f"blocked TAM engine; the reference's fallback (jax_sim's "
                f"3-hop route, rank axis sharded, collectives inserted by "
                f"XLA) is not ported. Drop ranks_per_device, or run "
                f"--backend torch_sim")
        built = self._compiled(schedule)
        send = self._send(p, iter_, built)
        out = built.rep(send)
        sync(self.device)                  # warm-up
        local = self._local_ranks(built, n)

        timers = [Timer() for _ in range(n)]
        self.last_rep_timers = []
        self.last_round_times = []         # [rep] -> [per-round seconds]
        attr_w = weights_for(schedule)
        if measured_phases or chained:
            # read back and free the rep's arenas before the chains run:
            # at the flagship's full payload each is 8.59 GB
            recv_bufs = self._recv_bufs(p, built, out)
            del out, send
        if measured_phases:
            # per-round durations MEASURED by prefix truncation over the
            # group; in-round bucket split structural (same contract and
            # provenance label as torch_sim). Single-round schedules have
            # no boundary torch_shard can measure — the trivial
            # decomposition downgrades the label to attributed-chained.
            rt = self.measure_round_times(schedule)
            if len(rt) >= 2:
                rep_attr = attribute_rounds(schedule, rt, weights=attr_w)
                self.last_provenance = (
                    "torch_shard", "measured-rounds+attributed(buckets)")
                self.last_round_times = [list(rt.values())
                                         for _ in range(ntimes)]
            else:
                rep_attr = attribute_total(
                    schedule, sum(rt.values()), weights=attr_w)
                self.last_provenance = ("torch_shard", "attributed-chained")
            for r, t in enumerate(timers):
                t += Timer.from_array(rep_attr[r].as_array() * ntimes)
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
        else:
            for rep in range(ntimes):
                with trace.span("torch_shard.dispatch", rep=rep,
                                method=schedule.name):
                    t0 = time.perf_counter()
                    out = built.rep(send)
                    sync(self.device)
                    dt = time.perf_counter() - t0
                rep_attr = attribute_total(schedule, dt, weights=attr_w)
                for r, t in enumerate(timers):
                    t += rep_attr[r]
                self.last_rep_timers.append(rep_attr)
                if profile_rounds:
                    # collective fallback: no round structure to split —
                    # the whole rep is the single profiled segment, as on
                    # torch_sim
                    self.last_round_times.append([dt])
            recv_bufs = self._recv_bufs(p, built, out)
        self._check_fence(built)
        if verify:
            self._verify(p, recv_bufs, iter_, local)
        return recv_bufs, timers
