"""Adapter: ``torch_sim``, every rank on one device, through the port's
public ``one_rep(schedule)``.

The port's arenas are rank-major: send ``(n, S, w)`` and receive ``(n,
R + 1, w)`` lanes (int32 lanes of 4 bytes, or bytes when ``d % 4``),
slot ``k`` of a rank's send rows addressed to receiver ``k``, slot ``i``
of a receiver's rows holding sender ``i``, and a last trash row that the
barrier tokens write and nothing judges.
"""

from __future__ import annotations

import torch


def build_schedule(config: dict, traffic: dict):
    """The port's schedule of the traffic's method on the configuration."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    pattern = AggregatorPattern(
        nprocs=config["nprocs"], cb_nodes=config["cb_nodes"],
        data_size=config["data_size"], placement=config["placement"],
        proc_node=config["proc_node"], comm_size=traffic["comm_size"])
    return compile_method(traffic["method"], pattern)


class Adapter:
    backend = "torch_sim"

    def __init__(self, config: dict, traffic: dict, roles, device):
        self.config, self.traffic, self.roles = config, traffic, roles
        self.device = torch.device(device)
        self.rep = None
        self.program_class = self._program_class()

    def _program_class(self):
        from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
        return TorchSimBackend

    def library(self) -> None:
        return None

    def build(self) -> None:
        self.program = self.program_class(device=self.device)
        self.sched = build_schedule(self.config, self.traffic)
        self.rep = self.program.one_rep(self.sched)
        n = self.roles.nprocs
        receivers = set(self.roles.receivers)
        self._send_rows = torch.tensor(self.roles.senders,
                                       device=self.device)
        self._recv_rows = torch.tensor(self.roles.receivers,
                                       device=self.device)
        self._idle_rows = torch.tensor(
            [r for r in range(n) if r not in receivers], dtype=torch.int64,
            device=self.device)

    def _bytes(self, lanes: torch.Tensor) -> torch.Tensor:
        return lanes.view(torch.uint8)

    def new_send(self) -> torch.Tensor:
        from tpu_aggcomm_torch.backends.lanes import lane_layout
        from tpu_aggcomm_torch.harness.verify import slot_shapes
        n_send_slots, _ = slot_shapes(self.sched.pattern)
        _, dt, w = lane_layout(self.config["data_size"])
        return torch.zeros((self.roles.nprocs, n_send_slots, w), dtype=dt,
                           device=self.device)

    def put_send(self, arena, i0: int, i1: int, block) -> None:
        nrecv = len(self.roles.receivers)
        self._bytes(arena)[self._send_rows[i0:i1], :nrecv] = block

    def recv_view(self, out) -> torch.Tensor:
        nsend = len(self.roles.senders)
        return self._bytes(out)[self._recv_rows, :nsend]

    def stray_bytes(self, out) -> int:
        nsend = len(self.roles.senders)
        return int(self._bytes(out)[self._idle_rows, :nsend]
                   .count_nonzero())

    def health(self) -> dict:
        return {}

    def close(self) -> None:
        self.rep = self.program = self.sched = None
