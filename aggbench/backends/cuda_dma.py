"""Adapter: ``cuda_dma``, the lockstep remote-DMA step program, one launch
of kernel K3 a rep with every rank one co-resident CTA, through the port's
public ``one_rep(schedule)``.

Its arenas are dense and rank-major, in bytes: send ``(n, S + 1, d)``
and receive ``(n, R + 1, d)`` uint8, slot ``k`` of a rank's send rows
addressed to receiver ``k``, slot ``i`` of a receiver's rows holding
sender ``i``, and last the zero dummy send row and the trash receive row
that only the steps' signals name. The kernel library is loaded (built at
the first run in a checkout, into ``build/torch_kernels/``) and K3's
co-resident cap read before the tables; after the window the protocol's
timeout record is read: a CTA that timed out waiting for an arrival left
its rep unfinished.
"""

from __future__ import annotations

import numpy as np
import torch

from aggbench.backends.torch_sim import build_schedule


class Adapter:
    backend = "cuda_dma"

    def __init__(self, config: dict, traffic: dict, roles, device):
        self.config, self.traffic, self.roles = config, traffic, roles
        self.device = torch.device(device)
        self.rep = None
        from tpu_aggcomm_torch.backends.cuda_dma import CudaDmaBackend
        self.program_class = CudaDmaBackend

    def library(self) -> None:
        if self.device.type == "cuda":
            from tpu_aggcomm_torch.backends.cuda_dma import capacity
            self.capacity = capacity(self.device)

    def build(self) -> None:
        self.program = self.program_class(device=self.device)
        self.rep = self.program.one_rep(build_schedule(self.config,
                                                       self.traffic))
        self.tables = self.rep.tables
        receivers = set(self.roles.receivers)
        self._send_rows = torch.tensor(self.roles.senders,
                                       device=self.device)
        self._recv_rows = torch.tensor(self.roles.receivers,
                                       device=self.device)
        # ranks that receive nothing, as runs of consecutive ranks, so
        # their rows are read as views
        idle = np.array([r for r in range(self.roles.nprocs)
                         if r not in receivers], dtype=np.int64)
        cut = np.flatnonzero(np.diff(idle) != 1) + 1
        self._idle_runs = [(int(run[0]), int(run[-1]) + 1)
                           for run in np.split(idle, cut) if len(run)]

    def new_send(self) -> torch.Tensor:
        return torch.zeros((self.roles.nprocs, self.tables.n_send_rows,
                            self.roles.data_size), dtype=torch.uint8,
                           device=self.device)

    def put_send(self, arena, i0: int, i1: int, block) -> None:
        nrecv = len(self.roles.receivers)
        arena[self._send_rows[i0:i1], :nrecv] = block

    def recv_view(self, out) -> torch.Tensor:
        nsend = len(self.roles.senders)
        return out[self._recv_rows, :nsend]

    def stray_bytes(self, out) -> int:
        """Non-zero bytes in the rows of ranks that receive nothing and in
        the receivers' rows past their slots (the trash row)."""
        nsend = len(self.roles.senders)
        stray = int(out[self._recv_rows, nsend:].count_nonzero())
        for a, b in self._idle_runs:
            stray += int(out[a:b].count_nonzero())
        return stray

    def health(self) -> dict:
        from tpu_aggcomm_torch.backends.cuda_dma import (DmaProtocolError,
                                                         check_protocol)
        try:
            check_protocol(self.tables)
        except DmaProtocolError:
            return {"dma_protocol_timeouts": 1}
        return {"dma_protocol_timeouts": 0}

    def close(self) -> None:
        self.rep = self.program = self.tables = None
