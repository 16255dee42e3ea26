"""Adapter: ``torch_shard`` on one device with no process group, through
the rep its plain ``run`` times (``TorchShardBackend._compiled(schedule)
.rep``; the backend has no public ``one_rep``).

Its arenas are compacted: send ``(Fs, w)`` holds only the senders' rows,
each sender's slots together in rank order, and receive ``(F, w)`` only
the receivers' rows, placed by the program's row map ``recv_base`` (a
receiver's first row, -1 for a rank that receives nothing); the last
row of each is trash. The send layout is laid out here by that rule and
checked against the program's ``send_base``; the receive side is read
through ``recv_base``, so a receiver the program leaves out reads as
wrong slabs and rows it gives a non-receiver count as stray.
"""

from __future__ import annotations

import numpy as np
import torch

from aggbench.backends.torch_sim import build_schedule


class LayoutError(RuntimeError):
    """The program's send layout is not the compact one this adapter
    writes."""


class Adapter:
    backend = "torch_shard"

    def __init__(self, config: dict, traffic: dict, roles, device):
        self.config, self.traffic, self.roles = config, traffic, roles
        self.device = torch.device(device)
        self.rep = None
        from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
        self.program_class = TorchShardBackend

    def library(self) -> None:
        return None

    def build(self) -> None:
        self.program = self.program_class(device=self.device)
        self.built = self.program._compiled(
            build_schedule(self.config, self.traffic))
        self.rep = self.built.rep
        senders, receivers = self.roles.senders, self.roles.receivers
        nsend, nrecv = len(senders), len(receivers)
        order = np.argsort(senders, kind="stable")
        base = np.empty(nsend, dtype=np.int64)
        base[order] = np.arange(nsend) * nrecv
        got = np.asarray(self.built.send_base)[list(senders)]
        if not np.array_equal(got, base) or self.built.Fs != nsend * nrecv + 1:
            raise LayoutError(
                "torch_shard's send layout is not the compact rank-order "
                "one (send_base or Fs differ)")
        self._send_rows = self._rows(base, nrecv)
        rb = np.asarray(self.built.recv_base)
        self._missing = [k for k, r in enumerate(receivers) if rb[r] < 0]
        self._recv_rows = self._rows(np.maximum(rb[list(receivers)], 0),
                                     nsend)
        extra = sorted(set(np.flatnonzero(rb >= 0)) - set(receivers))
        counts = np.asarray(self.built.counts)
        self._stray_rows = (torch.as_tensor(np.concatenate(
            [rb[r] + np.arange(counts[r]) for r in extra]),
            device=self.device) if extra else None)

    def _rows(self, base: np.ndarray, slots: int):
        """Row indices ``(len(base), slots)`` of each entity's slots, or
        None when they are simply rows ``0 .. len(base) * slots - 1`` in
        order (then a view serves)."""
        if np.array_equal(base, np.arange(len(base)) * slots):
            return None
        return torch.as_tensor(base[:, None] + np.arange(slots),
                               device=self.device)

    def _bytes(self, lanes: torch.Tensor) -> torch.Tensor:
        return lanes.view(torch.uint8)

    def new_send(self) -> torch.Tensor:
        from tpu_aggcomm_torch.backends.lanes import lane_layout
        _, dt, w = lane_layout(self.config["data_size"])
        return torch.zeros((self.built.Fs, w), dtype=dt, device=self.device)

    def put_send(self, arena, i0: int, i1: int, block) -> None:
        flat = self._bytes(arena)
        nrecv = len(self.roles.receivers)
        if self._send_rows is None:
            flat[i0 * nrecv:i1 * nrecv] = block.reshape(-1, block.shape[-1])
        else:
            flat[self._send_rows[i0:i1]] = block

    def recv_view(self, out) -> torch.Tensor:
        flat = self._bytes(out)
        nsend, nrecv = len(self.roles.senders), len(self.roles.receivers)
        if self._recv_rows is None:
            view = flat[:nrecv * nsend].view(nrecv, nsend, -1)
        else:
            view = flat[self._recv_rows]
        if self._missing:
            view = view.clone()
            view[self._missing] = 0
        return view

    def stray_bytes(self, out) -> int:
        if self._stray_rows is None:
            return 0
        return int(self._bytes(out)[self._stray_rows].count_nonzero())

    def health(self) -> dict:
        return {}

    def close(self) -> None:
        self.rep = self.program = self.built = None
