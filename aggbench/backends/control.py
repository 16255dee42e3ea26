"""The control: the plain reference exchange in the program's place, with
one guarantee of the configurations broken.

The configurations state that every slab reaches its receiver's slot,
self slabs included (``AggregatorPattern.total_bytes`` counts them, as
the reference does). The control leaves each rank's slab to itself
undelivered (zero), the shortcut that would tempt a later change since a
rank "sending to itself" looks like no work. No cell runs it; the
readings helper (``python3 -m aggbench.tests.readings``) and the tests do, to
show that ``correct`` comes out false for it.
"""

from __future__ import annotations

import torch

from aggbench.reference.exchange import exchange


class Adapter:
    backend = "control"

    def __init__(self, config: dict, traffic: dict, roles, device):
        self.config, self.traffic, self.roles = config, traffic, roles
        self.device = torch.device(device)
        self.rep = None

    def library(self) -> None:
        return None

    def build(self) -> None:
        pos = {r: i for i, r in enumerate(self.roles.senders)}
        pairs = [(k, pos[r]) for k, r in enumerate(self.roles.receivers)
                 if r in pos]
        ks = torch.tensor([k for k, _ in pairs], dtype=torch.int64,
                          device=self.device)
        iis = torch.tensor([i for _, i in pairs], dtype=torch.int64,
                           device=self.device)

        def rep(send):
            recv = exchange(send)
            recv[ks, iis] = 0
            return recv

        self.rep = rep

    def new_send(self) -> torch.Tensor:
        r = self.roles
        return torch.zeros((len(r.senders), len(r.receivers), r.data_size),
                           dtype=torch.uint8, device=self.device)

    def put_send(self, arena, i0: int, i1: int, block) -> None:
        arena[i0:i1] = block

    def recv_view(self, out) -> torch.Tensor:
        return out

    def stray_bytes(self, out) -> int:
        return 0

    def health(self) -> dict:
        return {}

    def close(self) -> None:
        self.rep = None
