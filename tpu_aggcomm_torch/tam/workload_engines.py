"""Variable-size workload engines: the collective_write family.

The port of ``tpu_aggcomm/tam/workload_engines.py``. The reference ships
four generations of its hierarchical exchange engine
(lustre_driver_test.c): ``collective_write`` (944-1309, the production
proxy path), ``collective_write2`` (754-926, two-level local aggregators +
zero-copy derived datatypes), ``collective_write3`` (604-728, MPI-3 shared
-memory windows for the intra-node hop), and ``collective_write_benchmark``
(1311-1330, flat direct exchange). All four deliver the same bytes — for
every destination ``g`` and source ``s``, ``recv_buf[s] = MAP_DATA(s,g,·)``
— and differ only in the *route*.

- **The numpy oracles** (:class:`RouteStats`, :func:`recv_index_map`,
  :func:`cw_benchmark`, :func:`cw_proxy`, :func:`cw2_local_agg`,
  :func:`cw3_shared`, :data:`WORKLOAD_ENGINES`,
  :func:`run_workload_engine`) are copied verbatim, import paths
  rewritten: explicit simulations of each route returning the delivered
  buffers plus per-hop byte accounting.
- **The single-device proxy route** (:func:`cw_proxy_sim`) runs in torch
  on the card: three byte-granular gathers of one flat uint8 array, each
  its own device step. Its index tables are the reference's, element for
  element, built with vectorised numpy (:func:`proxy_route_tables`)
  where the reference extends Python lists byte by byte; its chained
  timing goes through ``harness/chained``'s graph chain with the
  reference's scan body as the step.
- **The mesh engines** (``cw2_local_agg_jax``, ``cw3_shared_jax``) need
  one device per rank and belong to the multi-device tier (ROADMAP.md
  queue A item 8); here they raise ``NotPortedError`` by name.

Source ordering: the reference orders a group's sources by the
``aggregator_local_ranks`` array on the send side (l_d_t.c:885-904) but by
ascending rank scan on the receive side (create_recv_type, 1339-1346);
those differ whenever the binding scan inserts the aggregator's own rank
out of order (l_d_t.c:193-229).  Since collective_write2 is dead code in
the reference (call commented out at 1497), we fix the hazard: both sides
use ascending source rank within a group (:func:`recv_index_map`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aggcomm_torch.core.meta import AggregatorMeta
from tpu_aggcomm_torch.core.topology import NodeAssignment
from tpu_aggcomm_torch.core.workload import Workload
from tpu_aggcomm_torch.device import resolve_device, sync
from tpu_aggcomm_torch.harness.verify import VerificationError
from tpu_aggcomm_torch.obs import ledger

__all__ = [
    "RouteStats", "recv_index_map",
    "cw_benchmark", "cw_proxy", "cw2_local_agg", "cw3_shared",
    "cw2_local_agg_jax", "cw3_shared_jax", "cw_proxy_sim",
    "WORKLOAD_ENGINES", "run_workload_engine",
    "proxy_route_tables", "proxy_route_program", "proxy_route",
    "recv_from_flat",
    "expected_recv_flat", "verify_recv_flat",
]


@dataclass
class RouteStats:
    """Bytes moved per hop class — the quantities the reference's phase
    timers bracket. ``staged_bytes`` counts shared-memory staging
    (collective_write3's window fill), which crosses no network link."""

    direct_bytes: int = 0        # flat src -> dst messages
    gather_bytes: int = 0        # non-aggregator -> its local aggregator/proxy
    exchange_intra_bytes: int = 0  # agg <-> agg on the same node
    exchange_inter_bytes: int = 0  # agg <-> agg across nodes (the DCN hop)
    delivery_bytes: int = 0      # proxy -> final local destination
    staged_bytes: int = 0        # shared-window staging (no link crossed)

    @property
    def network_bytes(self) -> int:
        return (self.direct_bytes + self.gather_bytes +
                self.exchange_intra_bytes + self.exchange_inter_bytes +
                self.delivery_bytes)


def _empty_recv(wl: Workload) -> dict[int, list[np.ndarray | None]]:
    return {int(g): wl.alloc_recv_bufs(int(g)) for g in wl.aggregators}


def recv_index_map(wl: Workload, meta: AggregatorMeta) -> dict[int, list[tuple[int, int]]]:
    """``create_recv_type`` analog (l_d_t.c:1332-1361): for each local
    aggregator, the ordered ``(source_rank, size)`` runs that make up one
    incoming group message at any destination.  In MPI this list becomes an
    hindexed datatype over scattered ``recv_buf`` pointers; on TPU it is the
    static scatter map from a received packed segment into per-source slots."""
    sizes = wl.msg_size
    out: dict[int, list[tuple[int, int]]] = {}
    for agg in meta.local_aggregators:
        out[int(agg)] = [(int(w), int(sizes[w]))
                         for w in np.nonzero(meta.owner_of == agg)[0]]
    return out


# ---------------------------------------------------------------------------
# collective_write_benchmark (l_d_t.c:1311-1330): flat direct exchange

def cw_benchmark(wl: Workload):
    """Direct Issend/Irecv per (src, dst) pair — the baseline route."""
    recv = _empty_recv(wl)
    stats = RouteStats()
    for dst in wl.aggregators:
        for src in range(wl.nprocs):
            msg = wl.fill(src, int(dst))
            recv[int(dst)][src][:] = msg
            stats.direct_bytes += len(msg)
    return recv, stats


# ---------------------------------------------------------------------------
# collective_write (l_d_t.c:944-1309): proxy path, one relay per node

def cw_proxy(wl: Workload, na: NodeAssignment, corrupt_hook=None):
    """The production 5-phase proxy route with variable sizes.

    P1 (size exchange) is compile-time static here — sizes are pure
    functions of rank (the reference's runtime handshake, l_d_t.c:996-1041,
    carries no extra information for these workloads).  P2: every rank's
    packed sends go to its node proxy; P3: proxies exchange per-node runs;
    P4: destination proxies deliver each local destination its slab;
    P5: local scatter into recv_buf.

    Payload bytes are filled ONCE at the sender (P2) and carried through
    the staging structures to delivery — a routing bug therefore delivers
    wrong bytes and fails ``verify_all``, instead of being masked by a
    delivery-time re-fill (VERDICT r2 item 6). ``corrupt_hook(holdings)``
    is the fault-injection seam: tests corrupt one staged message between
    P2 and P3 and assert verification catches it.
    """
    recv = _empty_recv(wl)
    stats = RouteStats()
    sizes = wl.msg_size
    is_dst = wl.is_aggregator

    # P2: sender pack -> node proxy (self-pack for the proxy, l_d_t.c:1069-1105)
    # holdings[node] = (src, dst, payload) messages staged at the proxy
    holdings: list[list[tuple[int, int, np.ndarray]]] = \
        [[] for _ in range(na.nnodes)]
    for src in range(wl.nprocs):
        node = int(na.node_of[src])
        for d in wl.aggregators:
            holdings[node].append((src, int(d), wl.fill(src, int(d))))
        if not na.is_proxy(src):
            stats.gather_bytes += int(sizes[src]) * len(wl.aggregators)
    if corrupt_hook is not None:
        corrupt_hook(holdings)

    # P3: proxy -> proxy per-destination-node runs (l_d_t.c:1121-1194);
    # the STAGED payload travels, nothing is re-derived
    incoming: list[list[tuple[int, int, np.ndarray]]] = \
        [[] for _ in range(na.nnodes)]
    for node, held in enumerate(holdings):
        for (src, dst, payload) in held:
            dnode = int(na.node_of[dst])
            incoming[dnode].append((src, dst, payload))
            if dnode != node:
                stats.exchange_inter_bytes += int(sizes[src])
            # same-node messages are the memcpy at l_d_t.c:1184 — no link

    # P4/P5: destination proxy re-packs per local destination and delivers
    for node, msgs in enumerate(incoming):
        for (src, dst, payload) in msgs:
            recv[dst][src][:] = payload
            if not na.is_proxy(dst):
                stats.delivery_bytes += int(sizes[src])
    # non-destination ranks receive nothing; is_dst guard for clarity
    assert all(is_dst[d] for d in recv)
    return recv, stats


# ---------------------------------------------------------------------------
# collective_write2 (l_d_t.c:754-926): two-level local aggregators

def cw2_local_agg(wl: Workload, na: NodeAssignment, meta: AggregatorMeta,
                  corrupt_hook=None):
    """Two-level route: rank → its local aggregator (packed hindexed send,
    l_d_t.c:848-856) → per-destination segments → global destination
    (received through the recv_index_map scatter). Payloads are staged at
    the local aggregator and carried into the segments — delivery reads
    the staged bytes, never re-fills (VERDICT r2 item 6);
    ``corrupt_hook(staged)`` injects faults between the hops for tests."""
    recv = _empty_recv(wl)
    stats = RouteStats()
    sizes = wl.msg_size
    rim = recv_index_map(wl, meta)

    # hop 1: gather at local aggregators (skip self, l_d_t.c:829-856):
    # staged[agg][src][dst] = the member's packed block for dst
    staged: dict[int, dict[int, dict[int, np.ndarray]]] = {
        int(a): {} for a in meta.local_aggregators}
    for src in range(wl.nprocs):
        owner = int(meta.owner_of[src])
        staged[owner][src] = {int(d): wl.fill(src, int(d))
                              for d in wl.aggregators}
        if owner != src:
            stats.gather_bytes += int(sizes[src]) * len(wl.aggregators)
    if corrupt_hook is not None:
        corrupt_hook(staged)

    # hop 2: local aggregator -> each global destination, one packed segment
    # per (group, destination); scattered at the destination via the index map
    for agg, group in rim.items():
        for dst in wl.aggregators:
            seg_bytes = 0
            for (src, sz) in group:
                recv[int(dst)][src][:] = staged[agg][src][int(dst)]
                seg_bytes += sz
            if int(na.node_of[agg]) == int(na.node_of[int(dst)]):
                stats.exchange_intra_bytes += seg_bytes
            else:
                stats.exchange_inter_bytes += seg_bytes
    return recv, stats


# ---------------------------------------------------------------------------
# collective_write3 (l_d_t.c:604-728): shared-window intra hop

def cw3_shared(wl: Workload, na: NodeAssignment, meta: AggregatorMeta,
               corrupt_hook=None):
    """Shared-memory route: group members stage [sizes header | packed
    sends] in a shared window (l_d_t.c:647-663); after the fence the local
    aggregator reads every member's staging zero-copy (shared_query,
    667-671) and exchanges hindexed segments directly with the destination
    aggregators (705-711). The window content is what gets delivered —
    no re-fill at delivery; ``corrupt_hook(windows)`` injects faults
    after the fence for tests.

    Requires every destination to be a local aggregator (the reference
    sends only to ``local_aggregators`` — use meta mode 1, which makes
    local aggregators a superset of the global set).  The TPU analog of the
    shared window is staging in same-slice HBM: the inner-axis hop of
    :func:`cw2_local_agg_jax` with zero link cost.
    """
    is_local = meta.is_local_aggregator
    missing = [int(d) for d in wl.aggregators if not is_local[int(d)]]
    if missing:
        raise ValueError(
            f"collective_write3 route requires destinations to be local "
            f"aggregators (meta mode 1); not local: {missing}")
    # shared windows exist per intra-group; groups must not span nodes
    for agg in meta.local_aggregators:
        nodes = {int(na.node_of[w]) for w in meta.owned_ranks(int(agg))}
        nodes.add(int(na.node_of[int(agg)]))
        if len(nodes) > 1:
            raise ValueError(f"group of local aggregator {int(agg)} spans "
                             f"nodes {sorted(nodes)}; shared window invalid")

    recv = _empty_recv(wl)
    stats = RouteStats()
    sizes = wl.msg_size
    rim = recv_index_map(wl, meta)

    # window fill (l_d_t.c:647-663): every member stages its packed sends
    # in its group's shared window; the fence makes them readable
    windows: dict[int, dict[int, dict[int, np.ndarray]]] = {}
    for agg, group in rim.items():
        windows[agg] = {}
        for (src, _sz) in group:
            windows[agg][src] = {int(d): wl.fill(src, int(d))
                                 for d in wl.aggregators}
            stats.staged_bytes += int(sizes[src]) * len(wl.aggregators)
    if corrupt_hook is not None:
        corrupt_hook(windows)

    for agg, group in rim.items():
        for dst in wl.aggregators:
            seg_bytes = 0
            for (src, sz) in group:
                recv[int(dst)][src][:] = windows[agg][src][int(dst)]
                seg_bytes += sz
            if int(agg) == int(dst):
                continue  # self segment: local memcpy
            if int(na.node_of[int(agg)]) == int(na.node_of[int(dst)]):
                stats.exchange_intra_bytes += seg_bytes
            else:
                stats.exchange_inter_bytes += seg_bytes
    return recv, stats


# ---------------------------------------------------------------------------
# The mesh engines: one device per rank (the multi-device tier)

def _mesh_engine_refused(name: str):
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    return NotPortedError(
        f"{name} runs the two-level route on a (node, local) mesh of one "
        f"device per rank; it belongs to the multi-device tier (ROADMAP.md "
        f"queue A item 8) and is not ported. On one card run --engine sim "
        f"(the proxy route) or the host engines")


def cw2_local_agg_jax(wl: Workload, na: NodeAssignment, meta: AggregatorMeta,
                      devices, ntimes: int = 1):
    """The collective_write2 route on a ``(node, local)`` mesh; not ported
    (ROADMAP.md queue A item 8)."""
    raise _mesh_engine_refused("cw2_local_agg_jax")


def cw3_shared_jax(wl: Workload, na: NodeAssignment, meta: AggregatorMeta,
                   devices, ntimes: int = 1):
    """The collective_write3 route on a ``(node, local)`` mesh; not ported
    (ROADMAP.md queue A item 8)."""
    raise _mesh_engine_refused("cw3_shared_jax")


# ---------------------------------------------------------------------------
# collective_write on ONE device: the proxy route as three byte-granular
# permutation hops of one flat byte array (variable sizes -> byte-granular
# index maps)

def _expand(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``concat(range(s, s + l) for s, l in zip(starts, lens))`` as one
    int64 array, without a Python loop."""
    lens = np.asarray(lens, dtype=np.int64)
    offs = np.cumsum(lens) - lens                 # exclusive prefix sums
    out = np.repeat(np.asarray(starts, dtype=np.int64) - offs, lens)
    out += np.arange(out.size, dtype=np.int64)
    return out


def proxy_route_tables(wl: Workload, na: NodeAssignment
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference ``cw_proxy_sim``'s three index tables
    (``stage_perm``, ``exch_perm``, ``recv_perm``; workload_engines.py
    :541-571), element for element and int32 as there, built with
    vectorised numpy: the reference extends Python lists byte by byte,
    which cannot reach 16384 ranks (35.7 M bytes a hop at ``-p 64 -t
    0``).

    The send stream is source-major with the destinations in
    ``wl.aggregators`` order, so source ``s``'s messages are one
    contiguous block of ``G * size[s]`` bytes and message ``(s, g)``
    starts ``g * size[s]`` into it.

    - P2 (proxy-hold order): sources node by node, each node's ranks
      ascending (``na.local_ranks``), each source's block whole;
    - P3 (destination-node runs): the staged messages stably sorted by
      their destination's node;
    - P4/P5 (the recv layout): per aggregator in ``wl.aggregators``
      order, per source ascending, where P3 left that message.
    """
    n = wl.nprocs
    sizes = np.asarray(wl.msg_size, dtype=np.int64)
    aggs = np.asarray(wl.aggregators, dtype=np.int64)
    G = len(aggs)
    block = sizes * G
    src_start = np.cumsum(block) - block
    # P2: walk = ranks node by node, ascending within a node
    walk = np.argsort(np.asarray(na.node_of, dtype=np.int64), kind="stable")
    stage = _expand(src_start[walk], block[walk])
    # the messages in stage order: (walk[i], g) for g in aggregator order
    msg_src = np.repeat(walk, G)
    msg_g = np.tile(np.arange(G, dtype=np.int64), n)
    msg_len = sizes[msg_src]
    stage_off = np.cumsum(msg_len) - msg_len
    # P3: stable by destination node (a narrow key sorts by radix)
    dnode = np.asarray(na.node_of, dtype=np.int64)[aggs][msg_g]
    key = dnode.astype(np.int16) if na.nnodes < 2 ** 15 else dnode
    order = np.argsort(key, kind="stable")
    exch = _expand(stage_off[order], msg_len[order])
    exch_off = np.empty_like(stage_off)
    sorted_len = msg_len[order]
    exch_off[order] = np.cumsum(sorted_len) - sorted_len
    # P4/P5: for each aggregator, each source ascending
    at = np.empty((n, G), dtype=np.int64)
    at[msg_src, msg_g] = exch_off
    recv = _expand(at.T.ravel(), np.tile(sizes, G))
    return (stage.astype(np.int32), exch.astype(np.int32),
            recv.astype(np.int32))


def _tam_fill(src: torch.Tensor, dst: torch.Tensor, lens: torch.Tensor
              ) -> torch.Tensor:
    """The messages ``(src[i], dst[i])`` of ``lens[i]`` bytes, one after
    another, as one uint8 tensor: byte j of a message is MAP_DATA(src,
    dst, j) = (1 + 3 src + 5 dst + 7 j) % 256 (``fill_slab_tam``)."""
    msg = torch.repeat_interleave(
        torch.arange(len(lens), device=lens.device), lens)
    starts = torch.cumsum(lens, 0) - lens
    j = torch.arange(msg.numel(), device=lens.device) - starts[msg]
    return ((1 + 3 * src[msg] + 5 * dst[msg] + 7 * j) % 256).to(torch.uint8)


def _send_flat(wl: Workload, device: torch.device) -> torch.Tensor:
    """The flat send stream (source-major, destinations in
    ``wl.aggregators`` order: the pack layout), made on ``device``."""
    n = wl.nprocs
    aggs = torch.as_tensor(np.asarray(wl.aggregators, dtype=np.int64),
                           device=device)
    sizes = torch.as_tensor(np.asarray(wl.msg_size, dtype=np.int64),
                            device=device)
    G = aggs.numel()
    src = torch.arange(n, device=device).repeat_interleave(G)
    return _tam_fill(src, aggs.repeat(n), sizes[src])


def expected_recv_flat(wl: Workload, device="cpu") -> torch.Tensor:
    """What the route must deliver, in its recv layout: per aggregator in
    ``wl.aggregators`` order, per source ascending, the source's message
    to that aggregator."""
    dev = torch.device(device)
    n = wl.nprocs
    aggs = torch.as_tensor(np.asarray(wl.aggregators, dtype=np.int64),
                           device=dev)
    sizes = torch.as_tensor(np.asarray(wl.msg_size, dtype=np.int64),
                            device=dev)
    G = aggs.numel()
    src = torch.arange(n, device=dev).repeat(G)
    return _tam_fill(src, aggs.repeat_interleave(n), sizes[src])


def verify_recv_flat(wl: Workload, flat: torch.Tensor) -> None:
    """``wl.verify_all`` in one vectorised pass over the route's flat
    delivery (the recv layout of :func:`expected_recv_flat`), on the
    tensor's device. Raises the same :class:`VerificationError`,
    naming the same first (aggregator, source, byte), that
    ``verify_all`` names for the same delivery: both walk aggregators
    in ``wl.aggregators`` order, then sources, then bytes."""
    exp = expected_recv_flat(wl, flat.device)
    if flat.dtype != torch.uint8 or flat.shape != exp.shape:
        raise VerificationError(
            f"flat delivery is {tuple(flat.shape)} {flat.dtype}, expected "
            f"{tuple(exp.shape)} torch.uint8")
    bad = torch.nonzero(flat != exp)
    if bad.numel() == 0:
        return
    k = int(bad[0, 0])
    sizes = np.asarray(wl.msg_size, dtype=np.int64)
    per_agg = int(sizes.sum())
    gi, rem = divmod(k, per_agg)
    src_start = np.cumsum(sizes) - sizes
    src = int(np.searchsorted(src_start, rem, side="right")) - 1
    j = rem - int(src_start[src])
    raise VerificationError(
        f"unexpected result at aggregator {int(wl.aggregators[gi])} from "
        f"{src}: byte {j}: {int(flat[k])} != {int(exp[k])}")


def recv_from_flat(wl: Workload, flat: np.ndarray
                   ) -> dict[int, list[np.ndarray | None]]:
    """The oracle engines' recv dict from the flat delivery (the
    reference's unpacking loop, workload_engines.py:623-634)."""
    recv = _empty_recv(wl)
    sizes = wl.msg_size
    pos = 0
    for dst in (int(a) for a in wl.aggregators):
        for src in range(wl.nprocs):
            sz = int(sizes[src])
            recv[dst][src][:] = flat[pos:pos + sz]
            pos += sz
    return recv


def proxy_route_program(wl: Workload, na: NodeAssignment, device="cuda"):
    """``(x0, route, step)`` of the proxy route on ``device``: the flat
    send stream, one route (three gathers), and the reference's chained
    scan body as an in-place chain step (``harness/chained``). The host
    builds the three tables once (a ``table-build`` record in the run
    ledger); the device makes the send stream."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    tabs = proxy_route_tables(wl, na)
    ledger.record_compile(
        f"tam sim n={wl.nprocs} b={wl.blocklen} t={int(wl.stripe)}",
        seconds=time.perf_counter() - t0, kind="table-build",
        bytes=int(tabs[0].size))
    p1, p2, p3 = (torch.as_tensor(t, device=dev) for t in tabs)

    def route(x: torch.Tensor) -> torch.Tensor:
        # Each hop is its own gather into its own buffer, one device
        # step each, as the reference fences each hop with
        # lax.optimization_barrier (workload_engines.py:579-584). The
        # three permutations are never composed into one gather: that
        # would merge hops.
        y = x.index_select(0, p1)                # P2 gather at proxies
        y = y.index_select(0, p2)                # P3 proxy <-> proxy
        return y.index_select(0, p3)             # P4/P5 delivery

    def step(x: torch.Tensor, r) -> None:
        # the reference's scan body (workload_engines.py:590-607): rep
        # r+1 reads rep r's delivery XORed with the byte r % 251, so reps
        # cannot be merged or hoisted; r restarts at 0 in each chain
        tok = r % 251
        if isinstance(tok, torch.Tensor):
            tok = tok.to(torch.uint8)
        torch.bitwise_xor(route(x), tok, out=x)

    return _send_flat(wl, dev), route, step


def proxy_route(wl: Workload, na: NodeAssignment, *, ntimes: int = 1,
                device="cuda", chained: bool = False
                ) -> tuple[torch.Tensor, list[float]]:
    """Run the proxy route on one device: ``(flat delivery, per-rep
    seconds)``, the flat delivery a uint8 tensor on ``device`` in the
    recv layout of :func:`expected_recv_flat`.

    Per-dispatch (the default): one warm-up route, then ``ntimes`` reps,
    each timed on the host clock around the route and a synchronize, as
    the reference times around ``block_until_ready``. ``chained``: the
    reference's scan body as the step of ``harness/chained``'s chain
    (CUDA graph replays on the card, the eager chain on the CPU),
    differenced over 50 and 1050 reps; every returned time is that
    per-rep figure."""
    from tpu_aggcomm_torch.harness.chained import (differenced_per_rep,
                                                   eager_chain,
                                                   graph_chain)
    x0, route, step = proxy_route_program(wl, na, device)
    dev = x0.device
    route(x0)
    sync(dev)                                    # warm-up
    if chained:
        chain = graph_chain if dev.type == "cuda" else eager_chain
        per_rep = differenced_per_rep(chain(None, step=step), x0,
                                      iters_small=50, iters_big=1050)
        times = [per_rep] * max(ntimes, 1)
        out = route(x0)
    else:
        times = []
        out = None
        for _ in range(max(ntimes, 1)):
            t0 = time.perf_counter()
            out = route(x0)
            sync(dev)
            times.append(time.perf_counter() - t0)
    return out, times


def cw_proxy_sim(wl: Workload, na: NodeAssignment, *, ntimes: int = 1,
                 device="cuda", chained: bool = False):
    """The 5-phase proxy route compiled for a single device.

    Message sizes vary per sender (1 + src % blocklen), so the static index
    maps are *byte*-granular: the whole exchange is three permutations of
    one flat byte array — P2 staging in proxy-hold order, P3 reorder into
    destination-node runs, P4/P5 delivery into the recv layout — each hop a
    separate gather, mirroring cw_proxy's walk order exactly (the
    reference's runtime size handshake, l_d_t.c:996-1041, is static
    here). This is the route the ``tam`` subcommand runs on the card
    (:func:`proxy_route`; the CPU only with ``device="cpu"``).

    ``chained=True`` replaces the per-dispatch wall times with the
    serial-chained differenced measurement (harness/chained.py): every
    returned rep time is then the differenced per-rep figure.

    Returns (recv dict like the oracle engines, per-rep wall seconds).
    """
    out, times = proxy_route(wl, na, ntimes=ntimes, device=device,
                             chained=chained)
    return recv_from_flat(wl, out.cpu().numpy()), times


# ---------------------------------------------------------------------------
# registry

WORKLOAD_ENGINES = {
    "benchmark": cw_benchmark,       # collective_write_benchmark
    "proxy": cw_proxy,               # collective_write
    "local_agg": cw2_local_agg,      # collective_write2
    "shared": cw3_shared,            # collective_write3
}


def run_workload_engine(engine: str, wl: Workload, na: NodeAssignment,
                        meta: AggregatorMeta | None = None):
    """Dispatch one oracle engine by name; verifies nothing — callers run
    ``wl.verify_all`` on the returned buffers (the reference's
    test_correctness step, l_d_t.c:1502)."""
    if engine == "benchmark":
        return cw_benchmark(wl)
    if engine == "proxy":
        return cw_proxy(wl, na)
    if meta is None:
        raise ValueError(f"engine {engine!r} needs aggregator metadata (co)")
    if engine == "local_agg":
        return cw2_local_agg(wl, na, meta)
    if engine == "shared":
        return cw3_shared(wl, na, meta)
    raise ValueError(f"unknown workload engine {engine!r}; "
                     f"choose from {sorted(WORKLOAD_ENGINES)}")
