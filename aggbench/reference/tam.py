"""The plain TAM relay: the proxy engine's three hops as the reference
walks them, in plain PyTorch.

``collective_write`` (the reference's ``lustre_driver_test.c:944-1309``,
run by m=15 ``all_to_many_tam`` and m=16, ``mpi_test.c:366-419``) moves
every slab through its node's proxy:

- P2 (``l_d_t.c:1069-1105``): every rank packs its slabs, slot by slot,
  and the proxy of its node receives them into its aggregate buffer, the
  node's ranks in turn;
- P3 (``l_d_t.c:1121-1194``): each proxy reorders what it holds into one
  run a destination node, in the order it holds them, and the runs are
  exchanged; a node's incoming buffer is the runs of the nodes in turn;
- P4/P5 (``l_d_t.c:1219-1285``): the destination proxy hands each local
  rank its slabs, which land in the receiver's slot of their sender.

The node map is the reference wrappers' (``static_node_assignment`` type
0, ``mpi_test.c:395``): ``rank // proc_node``, unless ``node_of`` names
one. Senders and receivers are numbered as :mod:`.roles` numbers them,
so the delivered arena is :func:`aggbench.reference.exchange.exchange`'s.
"""

from __future__ import annotations

import torch

from aggbench.reference.roles import roles


def relay(send: torch.Tensor, config: dict, direction: str,
          node_of=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The relay of ``send`` (senders, receivers, bytes; uint8): the
    proxies' buffers after P2 and after P3, each ``(slabs, bytes)`` in
    the buffers' order, and the delivered ``(receivers, senders, bytes)``
    arena."""
    r = roles(config, direction)
    nsend, nrecv, d = len(r.senders), len(r.receivers), r.data_size
    if tuple(send.shape) != (nsend, nrecv, d):
        raise ValueError(f"send {tuple(send.shape)} is not "
                         f"{(nsend, nrecv, d)}")
    if node_of is None:
        node_of = [rank // config["proc_node"] for rank in range(r.nprocs)]
    nnodes = max(node_of) + 1

    held = [[] for _ in range(nnodes)]              # P2: at each proxy
    for i, rank in enumerate(r.senders):
        held[node_of[rank]].extend((i, k) for k in range(nrecv))
    staged = [slab for node in held for slab in node]

    runs = [[] for _ in range(nnodes)]              # P3: by destination
    for j, (_i, k) in enumerate(staged):
        runs[node_of[r.receivers[k]]].append(j)
    order = [j for run in runs for j in run]

    def index(values):
        return torch.tensor(values, dtype=torch.int64, device=send.device)

    flat = send.reshape(nsend * nrecv, d)
    after_p2 = flat[index([i * nrecv + k for i, k in staged])]
    after_p3 = after_p2[index(order)]
    recv = torch.zeros((nrecv, nsend, d), dtype=torch.uint8,
                       device=send.device)
    recv[index([staged[j][1] for j in order]),
         index([staged[j][0] for j in order])] = after_p3      # P4/P5
    return after_p2, after_p3, recv
