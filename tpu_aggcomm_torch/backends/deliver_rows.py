"""One single-device round of ``torch_shard``: kernel ``csrc/deliver_rows.cu``.

Replaces the single-device round of ``tpu_aggcomm/backends/jax_shard.py``
(``_apply_block_round`` with ``single_dev=True``:
``recv.at[scat].set(send[pack])``, one XLA gather-scatter fusion). The
port had run it as three ATen kernels: a zero fill of the whole receive
arena, a gather of every send row into a temporary as large as the
payload, and an ``index_put_``. The kernel writes each receive row a
round writes once, straight from its send row, in one launch a round;
the rep's first launch also zeroes the rows the rep's rounds never
write, so the rep allocates its arena with ``torch.empty``.

- :func:`row_tables`: a round's entries as the kernel reads them, from
  the reference's pack and scatter tables of one device. Pads (pack -1,
  scatter the trash row ``F - 1``) copy send row 0 into the trash row,
  as the reference's single-device path does; all of a round's pads copy
  the same bytes, so they are one entry.
- :func:`unwritten_runs`: the host half of the zeroing. The rows that no
  entry of a rep's rounds writes, as runs of contiguous rows, and row 0
  as well where a barrier token reads it before a round writes it.
  Pads write the trash row; a barrier token, which writes only its lane
  0, does not.
- :func:`arena_launcher`: a rep's round issuer, and :func:`deliver_rows`
  one round through it. For CUDA tensors it launches the kernel on the
  current stream, counting launches in ``deliver_rows.launches``; a
  round's ctypes arguments are built once, with its tables, and the
  issuer reads the rep's two arenas and the stream once, so each of the
  rep's rounds is one ctypes call. CPU tensors take
  :func:`deliver_rows_plain`, the kernel's contract in plain torch.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["RowTables", "ZeroRuns", "row_tables", "unwritten_runs",
           "zero_runs", "deliver_rows", "deliver_rows_plain",
           "arena_launcher"]

#: rows, table entries and tasks of one launch stay below this (int32)
INT32_LIMIT = 2 ** 31


def _check_rows(what: str, rows: int) -> None:
    if rows >= INT32_LIMIT:
        raise ValueError(f"deliver_rows: an arena of {rows} {what} rows "
                         f"overflows the kernel's int32 row tables")


@dataclass(frozen=True)
class RowTables:
    """One round: ``src`` and ``dst`` (host int32) copy send row
    ``src[i]`` to receive row ``dst[i]``; ``src_dev`` and ``dst_dev`` on
    the device; ``args`` their part of the kernel's arguments."""

    src: np.ndarray
    dst: np.ndarray
    src_dev: torch.Tensor
    dst_dev: torch.Tensor
    args: tuple
    send_rows: int          # 1 + the largest send row read (0: none)
    recv_rows: int          # 1 + the largest receive row written

    @property
    def n_rows(self) -> int:
        return len(self.dst)


@dataclass(frozen=True)
class ZeroRuns:
    """Receive rows to zero as ``(start, stop)`` runs (``runs``, host),
    ``rows`` in all; ``start_dev`` and ``ptr_dev`` their device form (run
    starts; prefix row counts, int32); ``args`` their part of the kernel's
    arguments."""

    runs: tuple
    rows: int
    start_dev: torch.Tensor | None
    ptr_dev: torch.Tensor | None
    args: tuple


def row_tables(pack: np.ndarray, scat: np.ndarray, *, F: int, Fs: int,
               device) -> RowTables:
    """A round's :class:`RowTables` from one device's flat pack (send
    rows, -1 for a pad) and scatter (receive rows, ``F - 1`` for a pad)
    tables of ``Fs`` send and ``F`` receive rows."""
    _check_rows("send", Fs)
    _check_rows("receive", F)
    pack = np.asarray(pack).reshape(-1)
    scat = np.asarray(scat).reshape(-1)
    live = pack >= 0
    src, dst = pack[live], scat[live]
    if not live.all():                       # the pads: send row 0 -> trash
        src = np.append(src, 0)
        dst = np.append(dst, F - 1)
    if len(dst) and min(src.min(), dst.min()) < 0:
        raise ValueError("deliver_rows: a table row is negative")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    src_dev = torch.from_numpy(src).to(device)
    dst_dev = torch.from_numpy(dst).to(device)
    return RowTables(src=src, dst=dst, src_dev=src_dev, dst_dev=dst_dev,
                     args=(src_dev.data_ptr(), dst_dev.data_ptr(), len(dst)),
                     send_rows=int(src.max()) + 1 if len(src) else 0,
                     recv_rows=int(dst.max()) + 1 if len(dst) else 0)


def unwritten_runs(F: int, rounds) -> list:
    """The receive rows of an ``F``-row arena a rep leaves to its zeroing,
    as ``(start, stop)`` runs in order. ``rounds`` lists the rep's rounds
    in order, each ``(dst rows, barriers)``: the rows no round writes,
    and row 0 where a barrier token reads ``recv[0, 0]`` before the first
    round that writes row 0 has run."""
    from tpu_aggcomm_torch.native.fuse import runs_of
    _check_rows("receive", F)
    written = np.zeros(F, dtype=bool)
    row0_read = False
    for dst, nbar in rounds:
        written[np.asarray(dst, dtype=np.int64)] = True
        row0_read |= bool(nbar) and not written[0]
    runs = runs_of(~written)
    if row0_read and written[0]:
        runs = [(0, 1)] + runs
    return runs


def zero_runs(runs, device) -> ZeroRuns:
    """:class:`ZeroRuns` on ``device`` for ``(start, stop)`` runs."""
    runs = tuple((int(a), int(b)) for a, b in runs)
    if not runs:
        return NO_ZERO
    lens = [b - a for a, b in runs]
    rows = sum(lens)
    start = torch.tensor([a for a, _b in runs], dtype=torch.int32,
                         device=device)
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(lens)]).tolist(),
                       dtype=torch.int32, device=device)
    return ZeroRuns(runs=runs, rows=rows, start_dev=start, ptr_dev=ptr,
                    args=(start.data_ptr(), ptr.data_ptr(), len(runs), rows))


#: no zeroing: a launch's zero arguments
NO_ZERO = ZeroRuns(runs=(), rows=0, start_dev=None, ptr_dev=None,
                   args=(None, None, 0, 0))


def deliver_rows_plain(send: torch.Tensor, recv: torch.Tensor,
                       tabs: RowTables | None,
                       zero: ZeroRuns | None = None) -> torch.Tensor:
    """The plain version: the zero runs zeroed, then
    ``recv[dst] = send[src]``. Updates ``recv`` in place and returns it."""
    for a, b in (zero or NO_ZERO).runs:
        recv[a:b].zero_()
    if tabs is not None and tabs.n_rows:
        recv[tabs.dst_dev.long()] = send[tabs.src_dev.long()]
    return recv


@functools.cache
def _c_lib():
    """The kernel's C entry point, built and loaded at first use."""
    from tpu_aggcomm_torch.csrc.build import load
    lib = load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.aggcomm_deliver_rows
    fn.argtypes = [p, p, p, p, ll, p, p, i, ll, ll, p, i]
    fn.restype = i
    return fn


def _check_arenas(send: torch.Tensor, recv: torch.Tensor) -> None:
    if (send.dim() != 2 or recv.dim() != 2
            or send.dtype not in (torch.int32, torch.uint8)
            or recv.dtype != send.dtype or recv.shape[1] != send.shape[1]):
        raise ValueError(
            f"deliver_rows: send (Fs, w) and recv (F, w) must share w and "
            f"an int32 or uint8 lane type; got {tuple(send.shape)} "
            f"{send.dtype}, {tuple(recv.shape)} {recv.dtype}")
    if not (send.is_contiguous() and recv.is_contiguous()):
        raise ValueError("deliver_rows: send and recv must be contiguous")
    if send.device != recv.device:
        raise ValueError(f"deliver_rows: send on {send.device}, recv on "
                         f"{recv.device}")


def _check_tables(device, send_rows: int, recv_rows: int, tabs,
                  zero: ZeroRuns) -> None:
    """Raise unless ``tabs`` and ``zero`` lie on ``device`` and inside
    arenas of ``send_rows`` and ``recv_rows`` rows."""
    for t in (tabs.src_dev if tabs is not None else None, zero.start_dev):
        if t is not None and t.device != device:
            raise ValueError(f"deliver_rows: arenas on {device}, tables "
                             f"on {t.device}")
    if tabs is not None and (tabs.send_rows > send_rows
                             or tabs.recv_rows > recv_rows):
        raise ValueError(f"deliver_rows: the tables' rows lie outside "
                         f"send ({send_rows} rows) or recv ({recv_rows} "
                         f"rows)")
    if zero.runs and zero.runs[-1][1] > recv_rows:
        raise ValueError(f"deliver_rows: a zero run ends past recv's "
                         f"{recv_rows} rows")


def deliver_rows(send: torch.Tensor, recv: torch.Tensor,
                 tabs: RowTables | None, zero: ZeroRuns | None = None
                 ) -> torch.Tensor:
    """One round into ``recv`` in place: ``recv[tabs.dst] =
    send[tabs.src]``, and the ``zero`` runs zeroed (rows no entry of
    ``tabs`` writes). One kernel launch for CUDA tensors (none when there
    is nothing to copy or zero), the plain version for CPU tensors.
    Returns ``recv``."""
    arena_launcher(send, recv)(tabs, zero)
    return recv


def arena_launcher(send: torch.Tensor, recv: torch.Tensor):
    """``issue(tabs, zero=None)``: one round of :func:`deliver_rows` into
    these arenas. The arenas are checked once, and on the card their
    pointers, row width and PyTorch's current stream read once: a round
    is then one ctypes call (what a rep of many rounds issues). For CPU
    tensors a round is the plain version, after the same table checks."""
    _check_arenas(send, recv)
    device = send.device
    send_rows, recv_rows = send.shape[0], recv.shape[0]
    if device.type == "cpu":
        def plain(tabs: RowTables | None, zero: ZeroRuns | None = None
                  ) -> None:
            zero = zero or NO_ZERO
            _check_tables(device, send_rows, recv_rows, tabs, zero)
            deliver_rows_plain(send, recv, tabs, zero)

        return plain
    fn = _c_lib()
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    head = (send.data_ptr(), recv.data_ptr())
    tail = (recv.shape[1] * recv.element_size(),
            torch.cuda.current_stream(dev).cuda_stream, dev)

    def issue(tabs: RowTables | None, zero: ZeroRuns | None = None) -> None:
        zero = zero or NO_ZERO
        _check_tables(device, send_rows, recv_rows, tabs, zero)
        targs = tabs.args if tabs is not None else (None, None, 0)
        if not (targs[2] or zero.rows):
            return
        rc = fn(*head, *targs, *zero.args, *tail)
        if rc != 0:
            raise RuntimeError(f"deliver_rows kernel launch failed: "
                               f"cudaError {rc}")
        deliver_rows.launches += 1

    return issue


deliver_rows.launches = 0
