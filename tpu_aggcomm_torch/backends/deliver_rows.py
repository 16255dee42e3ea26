"""``torch_shard``'s rounds on one device: kernel ``csrc/deliver_rows.cu``.

Replaces the single-device round of ``tpu_aggcomm/backends/jax_shard.py``
(``_apply_block_round`` with ``single_dev=True``:
``recv.at[scat].set(send[pack])``, one XLA gather-scatter fusion). The
port had run it as three ATen kernels: a zero fill of the whole receive
arena, a gather of every send row into a temporary as large as the
payload, and an ``index_put_``. The kernel writes each receive row a
round writes once, straight from its send row; the rep's first launch
also zeroes the rows the rep's rounds never write, so the rep allocates
its arena with ``torch.empty``.

- :func:`row_tables`: a round's entries as the kernel reads them, from
  the reference's pack and scatter tables of one device. Pads (pack -1,
  scatter the trash row ``F - 1``) copy send row 0 into the trash row,
  as the reference's single-device path does; all of a round's pads copy
  the same bytes, so they are one entry. :func:`round_tables`: a rep's
  rounds uploaded once, in CSR form, each round's :class:`RowTables` a
  view of it.
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
  :func:`row_launcher` binds one round's tables instead, once, for any
  arenas of given shapes (each hop of ``torch_shard``'s TAM relay);
  ``deliver_rows.relay_hops`` counts the hops the relay issues. A
  launch of rows of at least :data:`WIDE_ROW_BYTES` bytes in 16-byte
  lanes takes the kernel's wide-row engine, a grid of a warp for every
  chunk (:func:`wide_engine`, the C entry's rule), counted in
  ``deliver_rows.wide_launches``.
- :func:`deliver_rounds`: the first ``n`` rounds of a :class:`RoundTables`
  in ONE cooperative launch, each round fenced from the next inside the
  kernel (a rep of many rounds with no barrier token between them). It
  counts one launch in ``deliver_rows.launches`` and its rounds in
  ``deliver_rows.fused_rounds``; CPU tensors take
  :func:`deliver_rounds_plain`, the rounds in order through
  :func:`deliver_rows_plain`. :func:`rounds_launcher` binds it once to a
  rep's tables and arena shapes: on the card a rep is then one C call.
  The call stays asynchronous: :func:`check_fence` raises a fence
  timeout after the device has run it, and until it has, every later
  launch on the same tables writes nothing.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["RowTables", "RoundTables", "ZeroRuns", "DeliverFenceError",
           "row_tables", "round_tables", "unwritten_runs", "zero_runs",
           "deliver_rows", "deliver_rows_plain", "arena_launcher",
           "row_launcher", "deliver_rounds", "deliver_rounds_plain",
           "rounds_launcher", "rounds_plan", "check_fence", "lane_bytes",
           "wide_engine"]

#: rows, table entries and tasks of one launch stay below this (int32)
INT32_LIMIT = 2 ** 31
#: the wide-row engine's narrowest row (``csrc/deliver_rows.cu``:
#: ``kWideRowBytes``)
WIDE_ROW_BYTES = 2048
#: :func:`_deliver_rows_on`'s grids, as the C entry numbers them
_GRIDS = {"persistent": 0, "wide": 1}
#: how long one wait of a CTA at a round fence may last
TIMEOUT_S = 10.0


class DeliverFenceError(RuntimeError):
    """A CTA of the many-round launch waited past the timeout at a round
    fence; the rep did not complete."""


def lane_bytes(send_ptr: int, recv_ptr: int, row_bytes: int) -> int:
    """The lane width the kernel moves rows of ``row_bytes`` in between
    arenas at these addresses: 16, 4 or 1 bytes (``rows.cuh``'s
    ``lane_size``)."""
    addr = send_ptr | recv_ptr
    if row_bytes % 16 == 0 and addr % 16 == 0:
        return 16
    if row_bytes % 4 == 0 and addr % 4 == 0:
        return 4
    return 1


def wide_engine(lane: int, row_bytes: int) -> bool:
    """Whether a one-round launch of rows of ``row_bytes`` in ``lane``-byte
    lanes takes the wide-row engine: the C entry's rule (``wide_engine``
    in ``csrc/deliver_rows.cu``)."""
    return lane == 16 and row_bytes >= WIDE_ROW_BYTES


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


def _host_rows(pack: np.ndarray, scat: np.ndarray, *, F: int, Fs: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """A round's host int32 ``(src, dst)`` entries (:func:`row_tables`)."""
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
    return (np.ascontiguousarray(src, dtype=np.int32),
            np.ascontiguousarray(dst, dtype=np.int32))


def _row_tables(src: np.ndarray, dst: np.ndarray, src_dev: torch.Tensor,
                dst_dev: torch.Tensor) -> RowTables:
    return RowTables(src=src, dst=dst, src_dev=src_dev, dst_dev=dst_dev,
                     args=(src_dev.data_ptr(), dst_dev.data_ptr(), len(dst)),
                     send_rows=int(src.max()) + 1 if len(src) else 0,
                     recv_rows=int(dst.max()) + 1 if len(dst) else 0)


def row_tables(pack: np.ndarray, scat: np.ndarray, *, F: int, Fs: int,
               device) -> RowTables:
    """A round's :class:`RowTables` from one device's flat pack (send
    rows, -1 for a pad) and scatter (receive rows, ``F - 1`` for a pad)
    tables of ``Fs`` send and ``F`` receive rows."""
    src, dst = _host_rows(pack, scat, F=F, Fs=Fs)
    return _row_tables(src, dst, torch.from_numpy(src).to(device),
                       torch.from_numpy(dst).to(device))


@dataclass(frozen=True)
class RoundTables:
    """A rep's rounds in CSR form: round ``k`` is entries
    ``round_ptr[k]`` to ``round_ptr[k + 1]`` of ``src_dev`` and
    ``dst_dev`` (int32, on the device; ``ptr_dev`` the offsets there).
    ``rounds`` holds each round's :class:`RowTables`, views of the same
    device tensors, so a round's tables are not kept twice.
    ``widest[k]`` is the most entries among the first ``k`` rounds.
    ``sync`` is the fence's four int32 words on the device: its counter,
    0 between launches, and its error record (CTA + 1, round, arrivals
    seen), zero unless a wait timed out."""

    round_ptr: tuple
    ptr_dev: torch.Tensor
    src_dev: torch.Tensor
    dst_dev: torch.Tensor
    rounds: tuple
    widest: tuple
    sync: torch.Tensor
    send_rows: int
    recv_rows: int

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def round_tables(pairs, *, F: int, Fs: int, device) -> RoundTables:
    """:class:`RoundTables` of a rep's rounds, each a ``(pack, scat)``
    pair as :func:`row_tables` takes it: the entries of every round
    concatenated and uploaded once."""
    host = [_host_rows(pk, sc, F=F, Fs=Fs) for pk, sc in pairs]
    counts = [len(dst) for _src, dst in host]
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    _check_rows("table", int(ptr[-1]))
    none = np.zeros(0, dtype=np.int32)
    src_dev, dst_dev = (
        torch.from_numpy(np.concatenate([none, *(h[j] for h in host)])
                         ).to(device) for j in (0, 1))
    rounds = tuple(
        _row_tables(src, dst, src_dev[a:b], dst_dev[a:b])
        for (src, dst), a, b in zip(host, ptr[:-1].tolist(),
                                    ptr[1:].tolist()))
    return RoundTables(
        round_ptr=tuple(ptr.tolist()),
        ptr_dev=torch.from_numpy(ptr.astype(np.int32)).to(device),
        src_dev=src_dev, dst_dev=dst_dev, rounds=rounds,
        widest=tuple(np.maximum.accumulate([0] + counts).tolist()),
        sync=torch.zeros(4, dtype=torch.int32, device=device),
        send_rows=max((t.send_rows for t in rounds), default=0),
        recv_rows=max((t.recv_rows for t in rounds), default=0))


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


def deliver_rounds_plain(send: torch.Tensor, recv: torch.Tensor,
                         tabs: RoundTables, n_rounds: int,
                         zero: ZeroRuns | None = None) -> torch.Tensor:
    """The plain version of :func:`deliver_rounds`: the zero runs
    zeroed, then the first ``n_rounds`` rounds in order, each through
    :func:`deliver_rows_plain`. Updates ``recv`` in place and returns
    it."""
    deliver_rows_plain(send, recv, None, zero)
    for t in tabs.rounds[:n_rounds]:
        deliver_rows_plain(send, recv, t)
    return recv


@functools.cache
def _c_lib():
    """The kernel's C entry points, built and loaded at first use: one
    round, the many-round launch and its plan, and one round on a named
    grid."""
    from tpu_aggcomm_torch.csrc.build import load
    lib = load()
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.aggcomm_deliver_rows
    fn.argtypes = [p, p, p, p, ll, p, p, i, ll, ll, p, i]
    fn.restype = i
    rounds = lib.aggcomm_deliver_rounds
    rounds.argtypes = [p, p, p, p, p]
    rounds.restype = i
    plan = lib.aggcomm_deliver_rounds_plan
    plan.argtypes = [p, p, p, p]
    plan.restype = i
    on = lib.aggcomm_deliver_rows_on
    on.argtypes = [i, p, p, p, p, ll, p, p, i, ll, ll, p, i]
    on.restype = i
    return fn, rounds, plan, on


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
    fn = _c_lib()[0]
    dev = _dev_index(device)
    head = (send.data_ptr(), recv.data_ptr())
    row_bytes = recv.shape[1] * recv.element_size()
    lane = lane_bytes(*head, row_bytes)
    tail = (row_bytes, torch.cuda.current_stream(dev).cuda_stream, dev)

    def issue(tabs: RowTables | None, zero: ZeroRuns | None = None) -> None:
        zero = zero or NO_ZERO
        _check_tables(device, send_rows, recv_rows, tabs, zero)
        targs = tabs.args if tabs is not None else (None, None, 0)
        if not (targs[2] or zero.rows):
            return
        _launched_round(fn(*head, *targs, *zero.args, *tail),
                        wide_engine(lane, row_bytes))

    return issue


def _launched_round(rc: int, wide: bool) -> None:
    """Raise on a failed one-round launch, else count it (and, on the
    wide-row engine, in ``wide_launches``)."""
    if rc != 0:
        raise RuntimeError(f"deliver_rows kernel launch failed: "
                           f"cudaError {rc}")
    deliver_rows.launches += 1
    deliver_rows.wide_launches += wide


def row_launcher(tabs: RowTables, zero: ZeroRuns | None, *,
                 send_shape: tuple, recv_shape: tuple, dtype: torch.dtype):
    """``issue(send, recv)``: one round of :func:`deliver_rows` of ``tabs``
    and ``zero``, bound once for arenas of ``send_shape`` and
    ``recv_shape`` in ``dtype`` on the tables' device. On the card the
    tables' and zero runs' arguments, the row width and the device are
    read once, so a call on such arenas, contiguous, is a key compare and
    one ctypes call on PyTorch's current stream; any other arenas take
    :func:`arena_launcher` with its checks. On the CPU every call is the
    plain version, after the same checks."""
    zero = zero or NO_ZERO
    device = tabs.src_dev.device

    def checked(send: torch.Tensor, recv: torch.Tensor) -> None:
        arena_launcher(send, recv)(tabs, zero)

    if device.type == "cpu":
        return checked
    send_shape, recv_shape = torch.Size(send_shape), torch.Size(recv_shape)
    if len(send_shape) != 2 or send_shape[1:] != recv_shape[1:]:
        raise ValueError(f"deliver_rows: send {tuple(send_shape)} and recv "
                         f"{tuple(recv_shape)} must share their row")
    _check_tables(device, send_shape[0], recv_shape[0], tabs, zero)
    index = _dev_index(device)
    fn, stream = _c_lib()[0], torch._C._cuda_getCurrentRawStream
    row_bytes = recv_shape[1] * dtype.itemsize
    args = (*tabs.args, *zero.args, row_bytes)
    empty = not (tabs.n_rows or zero.rows)

    def issue(send: torch.Tensor, recv: torch.Tensor) -> None:
        if not (send.shape == send_shape and recv.shape == recv_shape
                and send.dtype is dtype and recv.dtype is dtype
                and send.get_device() == index == recv.get_device()
                and send.is_contiguous() and recv.is_contiguous()):
            checked(send, recv)
            return
        if empty:
            return
        sp, rp = send.data_ptr(), recv.data_ptr()
        _launched_round(fn(sp, rp, *args, stream(index), index),
                        wide_engine(lane_bytes(sp, rp, row_bytes), row_bytes))

    return issue


deliver_rows.launches = 0
deliver_rows.fused_rounds = 0
deliver_rows.relay_hops = 0
deliver_rows.wide_launches = 0


def _deliver_rows_on(grid: str, send: torch.Tensor, recv: torch.Tensor,
                     tabs: RowTables | None, zero: ZeroRuns | None = None
                     ) -> torch.Tensor:
    """:func:`deliver_rows` of CUDA arenas on the grid ``grid`` names
    (``"persistent"``, or ``"wide"``, the wide-row engine's, which needs
    16-byte lanes), whatever :func:`wide_engine` picks: the two side by
    side in ``chip_smoke.py`` and the tests. Counted as :func:`deliver_rows`
    counts. Returns ``recv``."""
    if grid not in _GRIDS or send.device.type != "cuda":
        raise ValueError(f"_deliver_rows_on: grid {grid!r} on "
                         f"{send.device}; one of {sorted(_GRIDS)} on the "
                         f"card")
    zero = zero or NO_ZERO
    _check_arenas(send, recv)
    _check_tables(send.device, send.shape[0], recv.shape[0], tabs, zero)
    targs = tabs.args if tabs is not None else (None, None, 0)
    if not (targs[2] or zero.rows):
        return recv
    dev = _dev_index(send.device)
    _launched_round(_c_lib()[3](
        _GRIDS[grid], send.data_ptr(), recv.data_ptr(), *targs, *zero.args,
        recv.shape[1] * recv.element_size(),
        torch.cuda.current_stream(dev).cuda_stream, dev), grid == "wide")
    return recv


def _dev_index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _check_count(tabs: RoundTables, n_rounds: int) -> None:
    if not 1 <= n_rounds <= tabs.n_rounds:
        raise ValueError(f"deliver_rounds: {n_rounds} rounds of a rep of "
                         f"{tabs.n_rounds}")


class RoundsBlock(ctypes.Structure):
    """``RoundsBlock`` of ``csrc/deliver_rows.cu``, field for field: what
    the many-round launch reads that a prefix of one rep's tables fixes."""

    _fields_ = [("round_ptr", ctypes.c_void_p), ("src_row", ctypes.c_void_p),
                ("dst_row", ctypes.c_void_p), ("zero_start", ctypes.c_void_p),
                ("zero_ptr", ctypes.c_void_p), ("sync", ctypes.c_void_p),
                ("timeout_ns", ctypes.c_ulonglong),
                ("max_round_rows", ctypes.c_longlong),
                ("zero_rows", ctypes.c_longlong),
                ("row_bytes", ctypes.c_longlong), ("n_rounds", ctypes.c_int),
                ("n_zero_runs", ctypes.c_int), ("device", ctypes.c_int)]


def _rounds_block(tabs: RoundTables, n_rounds: int, zero: ZeroRuns,
                  row_bytes: int, index: int) -> RoundsBlock:
    """The first ``n_rounds`` rounds of ``tabs`` and ``zero``, rows of
    ``row_bytes``, on device ``index``, as the C entries read them."""
    return RoundsBlock(
        tabs.ptr_dev.data_ptr(), tabs.src_dev.data_ptr(),
        tabs.dst_dev.data_ptr(), *zero.args[:2], tabs.sync.data_ptr(),
        int(TIMEOUT_S * 1e9), tabs.widest[n_rounds], zero.rows, row_bytes,
        n_rounds, zero.args[2], index)


def _launched(rc: int, n_rounds: int) -> None:
    """Raise on a failed many-round launch, else count it."""
    if rc != 0:
        raise RuntimeError(f"deliver_rounds kernel launch failed: "
                           f"cudaError {rc}")
    deliver_rows.launches += 1
    deliver_rows.fused_rounds += n_rounds


def deliver_rounds(send: torch.Tensor, recv: torch.Tensor,
                   tabs: RoundTables, n_rounds: int | None = None,
                   zero: ZeroRuns | None = None,
                   stamps: torch.Tensor | None = None) -> torch.Tensor:
    """The first ``n_rounds`` rounds of ``tabs`` (all by default) into
    ``recv`` in place, in order, and the ``zero`` runs zeroed. For CUDA
    tensors ONE cooperative launch on the current stream (none when there
    is nothing to copy or zero), its rounds fenced from each other inside
    the kernel, counted in ``deliver_rows.launches`` (1) and
    ``deliver_rows.fused_rounds`` (``n_rounds``); ``stamps`` (int64,
    ``grid * (2 + 2 * n_rounds)``, :func:`rounds_plan`'s grid) takes each
    CTA's ``%globaltimer`` stamps: its start, after each round's copies,
    after each fence and its end. For CPU tensors the plain version.
    Returns ``recv``."""
    zero = zero or NO_ZERO
    n_rounds = tabs.n_rounds if n_rounds is None else n_rounds
    _check_arenas(send, recv)
    _check_count(tabs, n_rounds)
    _check_tables(send.device, send.shape[0], recv.shape[0], tabs, zero)
    if send.device.type == "cpu":
        return deliver_rounds_plain(send, recv, tabs, n_rounds, zero)
    if not (tabs.round_ptr[n_rounds] or zero.rows):
        return recv
    dev = _dev_index(send.device)
    block = _rounds_block(tabs, n_rounds, zero,
                          recv.shape[1] * recv.element_size(), dev)
    if stamps is not None and (
            stamps.dtype != torch.int64 or stamps.device != send.device
            or not stamps.is_contiguous()
            or stamps.numel() < (2 + 2 * n_rounds) * _plan(
                block, send, recv)["grid"]):
        raise ValueError("deliver_rounds: stamps must be a contiguous int64 "
                         "tensor of grid * (2 + 2 * n_rounds) on the "
                         "arenas' device")
    _launched(_c_lib()[1](
        ctypes.byref(block), send.data_ptr(), recv.data_ptr(),
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), n_rounds)
    return recv


def rounds_launcher(tabs: RoundTables, n_rounds: int, zero: ZeroRuns | None,
                    *, send_shape: tuple, recv_shape: tuple,
                    dtype: torch.dtype):
    """``issue(send, recv)``: :func:`deliver_rounds` of the first
    ``n_rounds`` rounds of ``tabs`` and ``zero``, bound once for arenas
    of ``send_shape`` and ``recv_shape`` in ``dtype`` on the tables'
    device (what a rep of many rounds issues). On the card the launch's
    arguments are packed once into a :class:`RoundsBlock`, so a call on
    such arenas, contiguous, is a key compare and one C call on
    PyTorch's current stream; any other arenas take :func:`deliver_rounds`
    with its checks. On the CPU every call is :func:`deliver_rounds`."""
    zero = zero or NO_ZERO
    device = tabs.src_dev.device

    def checked(send: torch.Tensor, recv: torch.Tensor) -> None:
        deliver_rounds(send, recv, tabs, n_rounds, zero)

    if device.type == "cpu":
        return checked
    _check_count(tabs, n_rounds)
    _check_tables(device, send_shape[0], recv_shape[0], tabs, zero)
    send_shape, recv_shape = torch.Size(send_shape), torch.Size(recv_shape)
    if send_shape[1:] != recv_shape[1:] or len(send_shape) != 2:
        raise ValueError(f"deliver_rounds: send {tuple(send_shape)} and "
                         f"recv {tuple(recv_shape)} must share their row")
    index = _dev_index(device)
    block = _rounds_block(tabs, n_rounds, zero,
                          recv_shape[1] * dtype.itemsize, index)
    ref, launch = ctypes.byref(block), _c_lib()[1]
    stream = torch._C._cuda_getCurrentRawStream
    empty = tabs.round_ptr[n_rounds] == 0 and zero.rows == 0

    def issue(send: torch.Tensor, recv: torch.Tensor) -> None:
        if not (send.shape == send_shape and recv.shape == recv_shape
                and send.dtype is dtype and recv.dtype is dtype
                and send.get_device() == index == recv.get_device()
                and send.is_contiguous() and recv.is_contiguous()):
            checked(send, recv)
            return
        if empty:
            return
        _launched(launch(ref, send.data_ptr(), recv.data_ptr(), None,
                         stream(index)), n_rounds)

    issue.block = block           # keeps the packed arguments alive
    return issue


def _plan(block: RoundsBlock, send: torch.Tensor, recv: torch.Tensor
          ) -> dict:
    out = (ctypes.c_int * 4)()
    rc = _c_lib()[2](ctypes.byref(block), send.data_ptr(), recv.data_ptr(),
                     out)
    if rc != 0:
        raise RuntimeError(f"deliver_rounds plan query failed: cudaError "
                           f"{rc}")
    return dict(grid=out[0], copy_ctas=out[1], threads=out[2],
                lane_bytes=out[3])


def rounds_plan(send: torch.Tensor, recv: torch.Tensor, tabs: RoundTables,
                n_rounds: int | None = None,
                zero: ZeroRuns | None = None) -> dict:
    """What :func:`deliver_rounds` launches for these CUDA arenas:
    ``grid``, ``copy_ctas`` (the CTAs that copy and fence; the rest
    zero), ``threads`` a CTA and the lane width in bytes."""
    n_rounds = tabs.n_rounds if n_rounds is None else n_rounds
    return _plan(_rounds_block(tabs, n_rounds, zero or NO_ZERO,
                               recv.shape[1] * recv.element_size(),
                               _dev_index(send.device)), send, recv)


def check_fence(tabs: RoundTables) -> None:
    """Wait for the device and raise :class:`DeliverFenceError` if a CTA
    of an earlier launch on these tables timed out at a round fence (the
    words are cleared; until then every launch on them writes nothing)."""
    cta1, rnd, got = tabs.sync[1:].tolist()
    if cta1:
        tabs.sync.zero_()
        raise DeliverFenceError(
            f"deliver_rounds: CTA {cta1 - 1} waited over {TIMEOUT_S} s at "
            f"the fence after round {rnd} ({got} arrivals); the rep did "
            f"not complete")
