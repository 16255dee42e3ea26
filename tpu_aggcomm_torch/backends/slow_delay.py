"""The slow-rank delay of a fault-injected rep: kernel ``csrc/slow_delay.cu``.

Replaces the delay loop of ``tpu_aggcomm/backends/jax_sim.py:435``
(``_one_rep_faulted.add_slow``), an XLA ``lax.fori_loop`` rather than a
Pallas kernel. A slow rank r with factor F does ``iters =
faults/inject.delay_iters(F, n_rounds)`` iterations over its live send
row ``row = send[r, 0]`` (int32 lanes, or bytes when ``d % 4``)::

    acc = sum_{i < iters} sum_j ((row_j + i) mod 251)     # floor mod
    recv[r, 0, 0] += parity(acc) * parity(acc + 1)        # always 0

``row_j + i`` and ``acc`` wrap as int32. The delta is provably 0, so the
received bytes stay exact, but the loop reads the live send buffer and
its result lands in recv, so nothing can drop it: chained timing pays
for it in every rep.

Why a kernel: as PyTorch operations the loop is ``iters`` x (add,
remainder, sum, accumulate) launches, about 10^4 a rep for ``slow:r2*8``
at the README shape (2464 iterations) and half a million nodes in a
50-rep CUDA graph. The kernel is one launch for every slow rank of a rep,
one CTA a rank running its iterations in order, each a block reduction
of the row (the bound is that latency, see the source).

:func:`slow_delay` is the wrapper: it launches the kernel for CUDA
tensors (counted in ``slow_delay.launches``) and takes
:func:`slow_delay_plain` for CPU tensors. Both update ``recv`` in place
and return ``acc`` per slow rank, since the bytes cannot show a wrong
``acc``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from tpu_aggcomm_torch.backends.lanes import wrap_i32

__all__ = ["SlowTables", "slow_tables", "slow_delay", "slow_delay_plain"]

#: the plain version's working set per chunk of iterations, in elements
_PLAIN_CHUNK_ELEMS = 1 << 23


@dataclass(frozen=True)
class SlowTables:
    """The slow ranks of a rep and their iteration counts, on the host
    (``ranks``, ``iters``) and on the device (int32)."""

    ranks: tuple
    iters: tuple
    ranks_dev: torch.Tensor
    iters_dev: torch.Tensor


def slow_tables(iter_table, device) -> SlowTables | None:
    """The tables of a ``faults/inject.slow_iter_table`` row (iterations
    per rank, 0 for healthy ranks), or None when no rank is slow."""
    it = np.asarray(iter_table, dtype=np.int64)
    ranks = tuple(int(r) for r in np.flatnonzero(it > 0))
    if not ranks:
        return None
    iters = tuple(int(it[r]) for r in ranks)
    if max(iters) >= 2 ** 31:
        raise ValueError(f"slow_delay: {max(iters)} iterations exceed the "
                         f"kernel's int32 count")
    return SlowTables(
        ranks=ranks, iters=iters,
        ranks_dev=torch.tensor(ranks, dtype=torch.int32, device=device),
        iters_dev=torch.tensor(iters, dtype=torch.int32, device=device))


def _check_args(send: torch.Tensor, recv: torch.Tensor,
                tabs: SlowTables) -> None:
    if (send.dim() != 3 or recv.dim() != 3
            or send.dtype not in (torch.int32, torch.uint8)
            or recv.dtype != send.dtype
            or send.shape[0] != recv.shape[0]
            or send.shape[2] != recv.shape[2]):
        raise ValueError(
            f"slow_delay: send (n, S, w) and recv (n, F+1, w) must share "
            f"n, w and an int32 or uint8 lane type; got "
            f"{tuple(send.shape)} {send.dtype}, {tuple(recv.shape)} "
            f"{recv.dtype}")
    if not (send.is_contiguous() and recv.is_contiguous()):
        raise ValueError("slow_delay: send and recv must be contiguous")
    if send.device != recv.device or send.device != tabs.ranks_dev.device:
        raise ValueError(f"slow_delay: send on {send.device}, recv on "
                         f"{recv.device}, tables on {tabs.ranks_dev.device}")
    if tabs.ranks[-1] >= send.shape[0]:
        raise ValueError(f"slow_delay: slow rank {tabs.ranks[-1]} outside "
                         f"{send.shape[0]} ranks")


def slow_delay_plain(send: torch.Tensor, recv: torch.Tensor,
                     tabs: SlowTables) -> torch.Tensor:
    """The plain version, in torch operations: every slow rank's
    iterations as a (ranks, iterations, w) array, a chunk of iterations
    at a time, int64 sums wrapped to int32 (the same residue mod 2^32 as
    the reference's wrapping int32 adds). Updates ``recv`` in place and
    returns ``acc`` (int32, one per slow rank)."""
    ranks = tabs.ranks_dev.long()
    rows = send[ranks, 0].to(torch.int64)
    limit = tabs.iters_dev.long()[:, None, None]
    w = rows.shape[1]
    chunk = max(1, _PLAIN_CHUNK_ELEMS // (w * len(tabs.ranks)))
    total = torch.zeros(len(tabs.ranks), dtype=torch.int64,
                        device=send.device)
    for i0 in range(0, max(tabs.iters), chunk):
        i = torch.arange(i0, min(i0 + chunk, max(tabs.iters)),
                         dtype=torch.int64, device=send.device)[None, :, None]
        v = torch.remainder(wrap_i32(rows[:, None, :] + i).to(torch.int64),
                            251)
        total += torch.where(i < limit, v, 0).sum(dim=(1, 2))
    acc = wrap_i32(total).to(torch.int64)
    delta = (acc & 1) * ((acc + 1) & 1)
    cell = recv[ranks, 0, 0].to(torch.int64) + delta
    recv[ranks, 0, 0] = (wrap_i32(cell) if recv.dtype == torch.int32
                         else (cell & 0xFF).to(torch.uint8))
    return acc.to(torch.int32)


@functools.cache
def _c_fn():
    """The kernel's C entry point, built and loaded at first use."""
    from tpu_aggcomm_torch.csrc.build import load
    fn = load().aggcomm_slow_delay
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, ll, ll, i, i, p, p, i]
    fn.restype = i
    return fn


def slow_delay(send: torch.Tensor, recv: torch.Tensor,
               tabs: SlowTables) -> torch.Tensor:
    """Run every slow rank's delay: ONE kernel launch for CUDA tensors,
    the plain version for CPU tensors. Updates ``recv[r, 0, 0]`` in place
    and returns ``acc`` per slow rank (int32, on ``send``'s device)."""
    _check_args(send, recv, tabs)
    if send.device.type == "cpu":
        return slow_delay_plain(send, recv, tabs)
    acc = torch.empty(len(tabs.ranks), dtype=torch.int32,
                      device=send.device)
    dev = send.device.index if send.device.index is not None \
        else torch.cuda.current_device()
    rc = _c_fn()(
        send.data_ptr(), recv.data_ptr(), tabs.ranks_dev.data_ptr(),
        tabs.iters_dev.data_ptr(), len(tabs.ranks),
        send.shape[1] * send.shape[2], recv.shape[1] * recv.shape[2],
        send.shape[2], send.element_size(), acc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev)
    if rc != 0:
        raise RuntimeError(f"slow_delay kernel launch failed: cudaError "
                           f"{rc}")
    slow_delay.launches += 1
    return acc


slow_delay.launches = 0
