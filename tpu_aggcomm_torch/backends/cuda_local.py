"""The headline exchange on one card: kernel K1 (``csrc/exchange.cu``).

Replaces ``tpu_aggcomm/backends/pallas_local.py::fused_exchange_chain``.
The README-shape dense exchange (every rank's slab to every aggregator,
32 x 14 x 2048 B) is a static row permutation plus the chain
perturbation that makes serial reps irreducible. One rep:

    out[j, s, :] = in[s, order[j], :] ^ rword

on uint32 lanes carried as int32, where ``order`` is the ascending
aggregator rank and ``rword`` the rep index byte replicated into every
lane byte (byte-exact with a per-byte XOR). ``out`` (cb, n, w) is read as
(n, cb, w) and feeds rep r+1.

What bounds it: bytes, one read and one write of the arena per rep
(2*n*cb*d; from L2 at the README shape, from HBM at 1024x64x2048). The
reference runs its chain as one device program (``lax.scan`` over the
Pallas call inside one ``jax.jit``); so does the port: one persistent
cooperative launch runs every rep of a chain, with one grid-wide barrier
between reps, so a rep costs no host launch. Its launch constants follow
where the two working arenas live (L2 or HBM) and are fixed in the
kernel source.

:func:`exchange_chain` is the chain's wrapper: one launch for a CUDA
tensor, counted in ``exchange.launches`` (and its reps in
``exchange.reps``); a Python loop of :func:`exchange_plain` for a CPU
tensor. :func:`exchange` is one rep through the same kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpu_aggcomm_torch.core.pattern import AggregatorPattern

__all__ = ["exchange", "exchange_plain", "exchange_chain", "make_chain",
           "order_table", "rep_word", "host_replay", "check_barrier",
           "chain_grid", "ExchangeBarrierError"]

#: how long one wait of a CTA at the barrier between reps may last
TIMEOUT_S = 10.0
_MAX_UNITS = 2 ** 31        # flat 32-bit indexing in the kernel
_MAX_CB = 12288             # the order table in 48 KB of shared memory
_MAX_ITERS = 2 ** 31        # the kernel's int rep count
_REFUSED_COUNTER = -1       # the kernel's return: the counter would overflow


class ExchangeBarrierError(RuntimeError):
    """A CTA of the chain kernel waited past the timeout at a barrier
    between reps; the chain did not complete."""


def _order(p: AggregatorPattern) -> list[int]:
    """Aggregator-row order: ascending aggregator rank (row j of the recv
    buffer belongs to the j-th aggregator by rank)."""
    return [int(x) for x in np.argsort(np.asarray(p.rank_list))]


def _lane_width(p: AggregatorPattern) -> int:
    """Words per slab on the uint32-lane layout; every entry point shares
    this check so the plain version and the replay cannot accept (and
    truncate) inputs the kernel rejects."""
    if p.data_size % 4:
        raise ValueError("data_size must be a multiple of 4 for the "
                         "uint32-lane kernel")
    return p.data_size // 4


def rep_word(r: int) -> int:
    """The rep-index perturbation word (unsigned): index byte replicated
    in every lane byte, so XOR-ing it equals a per-byte XOR."""
    return (r & 0xFF) * 0x01010101


def _i32(v: int) -> int:
    """An unsigned 32-bit word as the int32 with the same bits."""
    return v - 2 ** 32 if v >= 2 ** 31 else v


def order_table(p: AggregatorPattern, device) -> torch.Tensor:
    """The permutation as the int32 device table the kernel reads."""
    return torch.tensor(_order(p), dtype=torch.int32, device=device)


def exchange_plain(inp: torch.Tensor, order: torch.Tensor,
                   rword: int) -> torch.Tensor:
    """One rep in plain torch: transpose + ``index_select`` + xor."""
    n, cb, w = inp.shape
    out = torch.index_select(inp.transpose(0, 1), 0, order.long())
    return (out ^ _i32(rword)).reshape(n, cb, w)


def _check(inp: torch.Tensor, order: torch.Tensor, out) -> None:
    if inp.dim() != 3 or inp.dtype != torch.int32:
        raise ValueError(f"exchange: input must be (n, cb, w) int32 lanes, "
                         f"got {tuple(inp.shape)} {inp.dtype}")
    if not inp.is_contiguous():
        raise ValueError("exchange: input must be contiguous")
    cb = inp.shape[1]
    if (order.dtype != torch.int32 or order.shape != (cb,)
            or order.device != inp.device):
        raise ValueError(f"exchange: order must be ({cb},) int32 on "
                         f"{inp.device}")
    if out is not None:
        if (out.shape != inp.shape or out.dtype != inp.dtype
                or out.device != inp.device or not out.is_contiguous()):
            raise ValueError("exchange: out must match the input's shape, "
                             "dtype and device, contiguous")
        if out.data_ptr() == inp.data_ptr():
            raise ValueError("exchange: out must not alias the input")


def _check_size(n: int, cb: int, w: int) -> None:
    """Refuse, by name, shapes the kernel's indexing does not cover."""
    if n * cb * w >= _MAX_UNITS:
        raise ValueError(f"exchange: {n}x{cb}x{w} words is at or above the "
                         f"kernel's 2^31-word arena limit")
    if cb > _MAX_CB:
        raise ValueError(f"exchange: cb={cb} aggregators exceed the "
                         f"{_MAX_CB} the kernel's shared order table holds")


@functools.cache
def _c_lib():
    """The kernel's C entry points, built and loaded at first use."""
    from tpu_aggcomm_torch.csrc.build import load
    lib = load()
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.aggcomm_exchange_chain
    fn.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, i, i, p,
                   ctypes.c_ulonglong, p, p, i]
    fn.restype = i
    grid = lib.aggcomm_exchange_grid
    grid.argtypes = [i, i, ctypes.c_longlong, i, i, ctypes.POINTER(i)]
    grid.restype = i
    return fn, grid


@functools.cache
def _sync_words(device: torch.device) -> torch.Tensor:
    """The barrier's counter and error record on ``device``
    (one set per device: chains on one device run on one stream)."""
    return torch.zeros(4, dtype=torch.int32, device=device)


def _dev_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _launch(send0: torch.Tensor, buf0: torch.Tensor, buf1: torch.Tensor,
            order: torch.Tensor, iters: int, r0: int,
            stamps: torch.Tensor | None = None) -> None:
    n, cb, w = send0.shape
    _check_size(n, cb, w)
    if iters >= _MAX_ITERS:
        raise ValueError(f"exchange_chain: {iters} reps exceed the kernel's "
                         f"{_MAX_ITERS - 1}")
    dev = _dev_index(send0)
    rc = _c_lib()[0](
        send0.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), order.data_ptr(),
        n, cb, w, iters, r0, _sync_words(send0.device).data_ptr(),
        int(TIMEOUT_S * 1e9), None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev)
    if rc == _REFUSED_COUNTER:
        raise ValueError(f"exchange_chain: {iters} reps on this grid would "
                         f"overflow the barrier's 32-bit arrival counter "
                         f"((iters - 1) x grid >= 2^32); run a shorter chain")
    if rc != 0:
        raise RuntimeError(f"exchange kernel launch failed: cudaError {rc}")
    exchange.launches += 1
    exchange.reps += iters


def chain_grid(p: AggregatorPattern, device) -> int:
    """The grid (CTAs) a chain at ``p``'s shape launches on a CUDA
    ``device`` (16-byte path)."""
    dev = torch.device(device)
    out = ctypes.c_int(0)
    rc = _c_lib()[1](p.nprocs, p.cb_nodes, _lane_width(p), 1,
                     dev.index if dev.index is not None
                     else torch.cuda.current_device(), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"exchange grid query failed: cudaError {rc}")
    return out.value


def check_barrier(device) -> None:
    """Wait for ``device`` and raise :class:`ExchangeBarrierError` if a CTA
    of an earlier chain timed out at a barrier (the record is cleared)."""
    words = _sync_words(torch.device(device))
    cta1, rep, got = words[1:].tolist()
    if cta1:
        words.zero_()
        raise ExchangeBarrierError(
            f"exchange chain: CTA {cta1 - 1} waited over {TIMEOUT_S} s at the "
            f"barrier after rep {rep} ({got} arrivals); the chain did not "
            f"complete")


def exchange(inp: torch.Tensor, order: torch.Tensor, rword: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One rep of K1; returns the (n, cb, w) input of the next rep
    (``out`` when given). ``rword`` is a rep word (:func:`rep_word`). CPU
    tensors take :func:`exchange_plain`; a CUDA tensor launches the chain
    kernel for one rep."""
    _check(inp, order, out)
    if rword != rep_word(rword & 0xFF):
        raise ValueError(f"exchange: rword {rword:#x} is not a rep word "
                         f"(a byte replicated four times)")
    if inp.device.type == "cpu":
        res = exchange_plain(inp, order, rword)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty_like(inp)
    _launch(inp, out, out, order, 1, rword & 0xFF)
    return out


exchange.launches = 0
exchange.reps = 0


def exchange_chain(p: AggregatorPattern, send0: torch.Tensor, iters: int, *,
                   step=exchange, check: bool = True,
                   stamps: torch.Tensor | None = None) -> torch.Tensor:
    """``iters`` serially dependent reps from ``send0`` (n, cb, w) int32;
    ``send0`` is not modified, and ``iters = 0`` returns it. On a CUDA
    tensor (``step`` :func:`exchange`) ONE launch runs the whole chain,
    ping-ponging two buffers; with ``check`` and a barrier in the chain
    the call then waits for the device and raises
    :class:`ExchangeBarrierError` on a timeout. ``stamps`` (int64,
    ``chain_grid(p) * 2 * (iters - 1)``, diagnostic calls only) receives
    each CTA's %globaltimer before and after every barrier. On a CPU
    tensor, or with ``step=exchange_plain`` on any device, a Python loop
    of per-rep calls."""
    n, cb, w = p.nprocs, p.cb_nodes, _lane_width(p)
    if iters < 0:
        raise ValueError(f"exchange_chain: iters must be >= 0, got {iters}")
    if tuple(send0.shape) != (n, cb, w):
        raise ValueError(f"exchange_chain: send0 must be {(n, cb, w)}, got "
                         f"{tuple(send0.shape)}")
    order = order_table(p, send0.device)
    if step is exchange and send0.device.type == "cuda" and iters > 0:
        _check(send0, order, None)
        bufs = (torch.empty_like(send0), torch.empty_like(send0))
        _launch(send0, bufs[0], bufs[1], order, iters, 0, stamps)
        if check and iters > 1:
            check_barrier(send0.device)
        return bufs[(iters - 1) % 2]
    cur = send0
    for r in range(iters):
        cur = step(cur, order, rep_word(r))
    return cur


def make_chain(p: AggregatorPattern, iters: int):
    """``chain(send0)`` of :func:`exchange_chain`, the shape
    ``harness.chained.differenced_trials`` times."""
    _lane_width(p)
    return lambda send0: exchange_chain(p, send0, iters)


def host_replay(p: AggregatorPattern, send0: np.ndarray,
                iters: int) -> np.ndarray:
    """Exact numpy replay of the chain on uint32 lanes — the ground truth
    both the kernel and the plain version are checked against."""
    order = np.argsort(np.asarray(p.rank_list))
    n, cb, w = p.nprocs, p.cb_nodes, _lane_width(p)
    ref = np.asarray(send0)
    for r in range(iters):
        recv = np.transpose(ref, (1, 0, 2))[order]
        ref = recv.reshape(n, cb, w) ^ np.uint32((r & 0xFF) * 0x01010101)
    return ref
