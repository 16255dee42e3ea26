"""Native backend: ctypes bindings to the C++ threaded rank runtime.

Flattens a compiled Schedule into the C ABI of
``native/aggcomm_runtime.cc`` (one op array + program offsets per rank,
contiguous slab buffers) and executes it with one OS thread per rank. This
is the semantics-parity tier: real rendezvous Issend, real blocking
receives, real barriers, per-op wall-clock timer buckets — the closest
thing to the reference's MPI execution that runs without a cluster.

The shared library is compiled on demand with g++ (no pip deps) and cached
next to the source; rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from tpu_aggcomm_torch.core.schedule import OpKind, Schedule, TimerBucket
from tpu_aggcomm_torch.harness.timer import Timer
from tpu_aggcomm_torch.harness.verify import make_send_slabs

__all__ = ["NativeBackend", "build_library", "library_path",
           "run_workload_proxy"]

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "aggcomm_runtime.cc")

_BUCKET_CODE = {
    TimerBucket.POST: 0,
    TimerBucket.RECV_WAIT: 1,
    TimerBucket.SEND_WAIT: 2,
    TimerBucket.RECV_AND_SEND_WAIT: 3,
    TimerBucket.BARRIER: 4,
    TimerBucket.NONE: 5,
}

_OP_FIELDS = 10  # kind, peer, slot, peer2, slot2, token, nbytes, bucket,
                 # ntokens, tok_ofs


def library_path() -> str:
    return os.path.join(os.path.dirname(_SRC), "build", "libaggcomm.so")


def build_library(force: bool = False) -> str:
    """Compile the runtime with g++ if missing or stale."""
    out = library_path()
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(_SRC)):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # unique temp name + atomic rename: concurrent cold builds (parallel
    # test workers, two CLI runs) must not corrupt each other's output
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(out))
    os.close(fd)
    try:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
               _SRC, "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"native runtime build failed ({' '.join(cmd)}):\n"
                f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.agg_run_workload_proxy.restype = ctypes.c_int
        lib.agg_run_workload_proxy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),     # node_of
            np.ctypeslib.ndpointer(np.int32),     # proxies
            np.ctypeslib.ndpointer(np.int32),     # aggs
            np.ctypeslib.ndpointer(np.int32),     # msg_sizes
            np.ctypeslib.ndpointer(np.uint8),     # send_msgs
            np.ctypeslib.ndpointer(np.int64),     # send_block_ofs
            np.ctypeslib.ndpointer(np.uint8),     # recv_out
            np.ctypeslib.ndpointer(np.float64),   # rep_times_out
        ]
        lib.agg_run_workload_cw2.restype = ctypes.c_int
        lib.agg_run_workload_cw2.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),     # aggs
            np.ctypeslib.ndpointer(np.int32),     # msg_sizes
            np.ctypeslib.ndpointer(np.int32),     # owner_of
            np.ctypeslib.ndpointer(np.int32),     # laggs
            np.ctypeslib.ndpointer(np.uint8),     # send_msgs
            np.ctypeslib.ndpointer(np.int64),     # send_block_ofs
            np.ctypeslib.ndpointer(np.uint8),     # recv_out
            np.ctypeslib.ndpointer(np.float64),   # rep_times_out
        ]
        lib.agg_run_workload_cw3.restype = ctypes.c_int
        lib.agg_run_workload_cw3.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),     # node_of
            np.ctypeslib.ndpointer(np.int32),     # aggs
            np.ctypeslib.ndpointer(np.int32),     # msg_sizes
            np.ctypeslib.ndpointer(np.int32),     # owner_of
            np.ctypeslib.ndpointer(np.int32),     # laggs
            np.ctypeslib.ndpointer(np.uint8),     # send_msgs
            np.ctypeslib.ndpointer(np.int64),     # send_block_ofs
            np.ctypeslib.ndpointer(np.uint8),     # recv_out
            np.ctypeslib.ndpointer(np.float64),   # rep_times_out
        ]
        lib.agg_run_schedule.restype = ctypes.c_int
        lib.agg_run_schedule.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,                      # ops
            np.ctypeslib.ndpointer(np.int32),     # prog_ofs
            np.ctypeslib.ndpointer(np.int32),     # wait_tokens
            np.ctypeslib.ndpointer(np.uint8),     # send_slabs
            np.ctypeslib.ndpointer(np.int32),     # send_ofs
            np.ctypeslib.ndpointer(np.uint8),     # recv_bufs
            np.ctypeslib.ndpointer(np.int32),     # recv_ofs
            ctypes.c_void_p,                      # a2a_src_slot (or None)
            ctypes.c_void_p,                      # a2a_dst_slot (or None)
            ctypes.c_int,                         # max_token
            np.ctypeslib.ndpointer(np.float64),   # timers_out
        ]
        _lib = lib
    return _lib


def _flatten(schedule: Schedule):
    """Schedule -> (ops int32 (O, 10), prog_ofs, wait_tokens, max_token)."""
    rows = []
    prog_ofs = [0]
    wait_tokens: list[int] = []
    max_token = 0
    for prog in schedule.programs:
        for op in prog:
            ntok, tofs = 0, 0
            if op.kind is OpKind.WAITALL:
                ntok = len(op.tokens)
                tofs = len(wait_tokens)
                wait_tokens.extend(op.tokens)
            if op.token > max_token:
                max_token = op.token
            rows.append((int(op.kind), op.peer, op.slot, op.peer2, op.slot2,
                         op.token, op.nbytes, _BUCKET_CODE[op.bucket],
                         ntok, tofs))
        prog_ofs.append(len(rows))
    ops = np.asarray(rows, dtype=np.int32).reshape(-1, _OP_FIELDS)
    return (ops, np.asarray(prog_ofs, dtype=np.int32),
            np.asarray(wait_tokens or [0], dtype=np.int32), max_token)


def _pack_blocks(wl):
    """Per-src send blocks (G messages in ascending-aggregator order) as
    one flat byte arena + per-src offsets — the layout both native
    workload engines consume."""
    n = wl.nprocs
    sizes = np.asarray(wl.msg_size, dtype=np.int32)
    aggs = np.asarray(wl.aggregators, dtype=np.int32)
    G = len(aggs)
    block_bytes = (sizes.astype(np.int64)) * G
    send_block_ofs = np.zeros(n, dtype=np.int64)
    send_block_ofs[1:] = np.cumsum(block_bytes)[:-1]
    send_msgs = np.zeros(max(int(block_bytes.sum()), 1), dtype=np.uint8)
    for src in range(n):
        o = int(send_block_ofs[src])
        m = int(sizes[src])
        for gi, g in enumerate(aggs):
            send_msgs[o + gi * m:o + (gi + 1) * m] = wl.fill(src, int(g))
    return sizes, aggs, send_msgs, send_block_ofs


def _unpack_recv(wl, recv_out):
    """Delivery slabs (per aggregator, sources ascending) back to the
    oracle-shaped per-aggregator lists."""
    n = wl.nprocs
    sizes = np.asarray(wl.msg_size, dtype=np.int64)
    slab = int(sizes.sum())
    src_ofs = np.zeros(n, dtype=np.int64)
    src_ofs[1:] = np.cumsum(sizes)[:-1]
    recv_by_rank = {}
    for gi, g in enumerate(wl.aggregators):
        row = recv_out[gi * slab:(gi + 1) * slab]
        recv_by_rank[int(g)] = [
            row[int(src_ofs[s]):int(src_ofs[s]) + int(sizes[s])].copy()
            for s in range(n)]
    return recv_by_rank


def run_workload_proxy(wl, na, ntimes: int = 1):
    """Run a variable-size workload through the native collective_write
    proxy engine (``agg_run_workload_proxy``): real threads, real pack /
    proxy-exchange / re-pack memcpy walks.

    Returns ``(recv_by_rank, rep_times)`` in the same shape the oracle
    engines return — per-aggregator lists of per-source byte arrays and an
    (nprocs, ntimes) per-rank wall-time matrix reduced to per-rep maxima.
    """
    lib = _load()
    n = wl.nprocs
    sizes, aggs, send_msgs, send_block_ofs = _pack_blocks(wl)
    G = len(aggs)
    slab = int(sizes.sum())
    recv_out = np.zeros(max(G * slab, 1), dtype=np.uint8)
    rep_times = np.zeros((n, max(ntimes, 1)), dtype=np.float64)
    rc = lib.agg_run_workload_proxy(
        n, na.nnodes, G, max(ntimes, 1),
        np.asarray(na.node_of, dtype=np.int32),
        np.asarray(na.proxies, dtype=np.int32),
        aggs, sizes, send_msgs, send_block_ofs, recv_out, rep_times)
    if rc != 0:
        raise RuntimeError(f"native workload engine failed with rc={rc}")
    return _unpack_recv(wl, recv_out), rep_times.max(axis=0).tolist()


def run_workload_cw2(wl, meta, ntimes: int = 1):
    """Run a variable-size workload through the native collective_write2
    two-level engine (``agg_run_workload_cw2``): members pack-send to
    their local aggregator, local aggregators exchange per-destination
    segments with the global aggregators (l_d_t.c:754-926).

    ``meta`` is the two-level structure from aggregator_meta_information.
    Return shape matches :func:`run_workload_proxy`.
    """
    lib = _load()
    n = wl.nprocs
    sizes, aggs, send_msgs, send_block_ofs = _pack_blocks(wl)
    G = len(aggs)
    slab = int(sizes.sum())
    recv_out = np.zeros(max(G * slab, 1), dtype=np.uint8)
    laggs = np.asarray(meta.local_aggregators, dtype=np.int32)
    rep_times = np.zeros((n, max(ntimes, 1)), dtype=np.float64)
    rc = lib.agg_run_workload_cw2(
        n, G, len(laggs), max(ntimes, 1),
        aggs, sizes, np.asarray(meta.owner_of, dtype=np.int32),
        laggs, send_msgs, send_block_ofs, recv_out, rep_times)
    if rc != 0:
        raise RuntimeError(f"native cw2 engine failed with rc={rc} "
                           f"(is every rank bound to a local aggregator?)")
    return _unpack_recv(wl, recv_out), rep_times.max(axis=0).tolist()


def run_workload_cw3(wl, na, meta, ntimes: int = 1):
    """Run a variable-size workload through the native collective_write3
    shared-window engine (``agg_run_workload_cw3``): group members fill a
    per-node shared staging buffer (the MPI_Win_allocate_shared analog,
    l_d_t.c:647-663 — threads genuinely share the memory), a fence
    publishes it, local aggregators read members' staging zero-copy
    (shared_query, 667-671) and exchange hindexed segments directly with
    the destination aggregators (705-711).

    Requires meta mode 1 (destinations must be local aggregators) and
    node-local groups. Return shape matches :func:`run_workload_proxy`.
    """
    lib = _load()
    n = wl.nprocs
    sizes, aggs, send_msgs, send_block_ofs = _pack_blocks(wl)
    G = len(aggs)
    slab = int(sizes.sum())
    recv_out = np.zeros(max(G * slab, 1), dtype=np.uint8)
    laggs = np.asarray(meta.local_aggregators, dtype=np.int32)
    rep_times = np.zeros((n, max(ntimes, 1)), dtype=np.float64)
    rc = lib.agg_run_workload_cw3(
        n, G, len(laggs), na.nnodes, max(ntimes, 1),
        np.asarray(na.node_of, dtype=np.int32),
        aggs, sizes, np.asarray(meta.owner_of, dtype=np.int32),
        laggs, send_msgs, send_block_ofs, recv_out, rep_times)
    if rc == 2:
        raise ValueError(
            "collective_write3 route requires destinations to be local "
            "aggregators (meta mode 1)")
    if rc == 3:
        raise ValueError("a local-aggregator group spans nodes; "
                         "shared window invalid")
    if rc != 0:
        raise RuntimeError(f"native cw3 engine failed with rc={rc}")
    return _unpack_recv(wl, recv_out), rep_times.max(axis=0).tolist()


class NativeBackend:
    """Executes schedules on the C++ threaded rank runtime."""

    name = "native"

    def run(self, schedule, *, ntimes: int = 1, iter_: int = 0,
            verify: bool = False):
        from tpu_aggcomm_torch.tam.engine import TamMethod
        if ntimes < 1:
            raise ValueError("ntimes must be >= 1")
        if isinstance(schedule, TamMethod):
            # TAM is a separate engine behind the registry (the reference's
            # extern boundary, mpi_test.c:34-38); the threaded runtime
            # executes flat op programs, so the hierarchical route runs on
            # the host proxy-path oracle, keeping `--backend native -m 0`
            # complete (VERDICT r1 item 2)
            from tpu_aggcomm_torch.backends.local import LocalBackend
            if getattr(self, "_local_delegate", None) is None:
                self._local_delegate = LocalBackend()
            lb = self._local_delegate
            out = lb.run(schedule, ntimes=ntimes, iter_=iter_, verify=verify)
            self.last_rep_timers = getattr(lb, "last_rep_timers", [])
            self.last_provenance = lb.last_provenance
            return out
        self.last_provenance = ("native", "measured")
        lib = _load()
        p = schedule.pattern
        n, ds = p.nprocs, p.data_size
        agg_index = p.agg_index

        ops, prog_ofs, wait_tokens, max_token = _flatten(schedule)

        # contiguous slab arenas
        slabs = make_send_slabs(p, iter_)
        send_counts = [0 if s is None else s.shape[0] for s in slabs]
        send_ofs = np.zeros(n, dtype=np.int32)
        total = 0
        for r in range(n):
            send_ofs[r] = total
            total += send_counts[r]
        send_arena = np.zeros((max(total, 1), ds), dtype=np.uint8)
        for r, s in enumerate(slabs):
            if s is not None:
                send_arena[send_ofs[r]:send_ofs[r] + s.shape[0]] = s

        from tpu_aggcomm_torch.harness.verify import recv_slot_counts
        recv_counts = recv_slot_counts(p)
        recv_ofs = np.full(n, -1, dtype=np.int32)
        total_r = 0
        for r in range(n):
            if recv_counts[r]:
                recv_ofs[r] = total_r
                total_r += recv_counts[r]
        recv_arena = np.zeros((max(total_r, 1), ds), dtype=np.uint8)

        # alltoallw slot maps (dense methods)
        if schedule.collective:
            from tpu_aggcomm_torch.core.methods import _dense_slots
            sslot_of, rslot_of = _dense_slots(p)
            src_slot = np.zeros((n, n), dtype=np.int32)
            dst_slot = np.zeros((n, n), dtype=np.int32)
            for dst in range(n):
                for src in range(n):
                    # message src->dst exists iff sender has a slab for dst
                    ss = int(sslot_of[dst])  # sender-side slot keyed by dst
                    if ss < 0 or recv_ofs[dst] < 0 or int(rslot_of[src]) < 0:
                        src_slot[dst, src] = -1
                    else:
                        src_slot[dst, src] = ss
                        dst_slot[dst, src] = int(rslot_of[src])
            a2a_src = src_slot.ctypes.data_as(ctypes.c_void_p)
            a2a_dst = dst_slot.ctypes.data_as(ctypes.c_void_p)
        else:
            src_slot = dst_slot = None
            a2a_src = a2a_dst = None

        timers_out = np.zeros((n, ntimes, 5), dtype=np.float64)
        rc = lib.agg_run_schedule(
            n, ntimes, ds,
            ops.ctypes.data_as(ctypes.c_void_p), prog_ofs, wait_tokens,
            send_arena, send_ofs, recv_arena, recv_ofs,
            a2a_src, a2a_dst, max_token, timers_out)
        if rc != 0:
            raise RuntimeError(f"native runtime failed with rc={rc}")

        recv_bufs = []
        for r in range(n):
            if recv_counts[r] == 0:
                recv_bufs.append(None)
            else:
                o = recv_ofs[r]
                recv_bufs.append(recv_arena[o:o + recv_counts[r]].copy())
        if verify:
            from tpu_aggcomm_torch.harness.verify import verify_recv
            verify_recv(p, recv_bufs, iter_)

        timers = []
        self.last_rep_timers = [[None] * n for _ in range(ntimes)]
        for r in range(n):
            acc = Timer()
            for m in range(ntimes):
                t5 = timers_out[r, m]
                rep = Timer(post_request_time=t5[0], send_wait_all_time=t5[1],
                            recv_wait_all_time=t5[2], barrier_time=t5[3],
                            total_time=t5[4])
                self.last_rep_timers[m][r] = rep
                acc += rep
            timers.append(acc)
        return recv_bufs, timers
