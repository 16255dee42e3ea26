"""Node topology: simulated and discovered rank→node maps.

The reference runs its hierarchical engine either on a *simulated* topology
(``static_node_assignment``, lustre_driver_test.c:359-429 — node structure
fabricated arithmetically so multi-node behavior is testable on any
launcher) or a *discovered* one (``gather_node_information``,
lustre_driver_test.c:267-344 — hostname Allgather + sort).

Equivalents here:

- :func:`static_node_assignment` — same arithmetic fabrication, used for
  tests and for mapping logical ranks onto a 2-axis (node × local) mesh.
- ``mesh_node_assignment`` (discovery from live devices) belongs to the
  multi-device tier and is not copied yet (ROADMAP.md, queue A item 8).

Unlike the reference (per-rank output views), we compute the global
assignment once; per-rank views are cheap numpy slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["NodeAssignment", "static_node_assignment"]


@dataclass(frozen=True)
class NodeAssignment:
    """Global rank→node structure.

    Fields mirror the reference's six outputs (lustre_driver_test.c:359):
    ``nnodes`` = nrecvs, ``node_of`` = process_node_list, ``proxies`` =
    global_receivers (one designated rank per node, the lowest-numbered),
    ``node_sizes`` = node_size, and ``local_ranks(node)`` replaces the
    per-rank local_ranks array.
    """

    nprocs: int
    nnodes: int
    node_of: np.ndarray     # shape (nprocs,): rank -> node id
    proxies: np.ndarray     # shape (nnodes,): node -> proxy rank (lowest on node)
    node_sizes: np.ndarray  # shape (nnodes,): ranks per node

    def __post_init__(self):
        if len(self.node_of) != self.nprocs:
            raise ValueError("node_of must have nprocs entries")
        if int(self.node_sizes.sum()) != self.nprocs:
            raise ValueError("node_sizes must sum to nprocs")

    def local_ranks(self, node: int) -> np.ndarray:
        """Sorted ranks living on ``node`` (reference: local_ranks array)."""
        return np.nonzero(self.node_of == node)[0]

    def proxy_of(self, rank: int) -> int:
        """The proxy (lowest local rank) of ``rank``'s node."""
        return int(self.proxies[int(self.node_of[rank])])

    def is_proxy(self, rank: int) -> bool:
        return self.proxy_of(rank) == rank


def static_node_assignment(nprocs: int, nprocs_node: int,
                           kind: int = 0) -> NodeAssignment:
    """Fabricate a node map from (nprocs, ranks-per-node) arithmetically.

    kind 0: contiguous blocks — node = rank // nprocs_node (the reference's
    ``else`` branch). kind 1: round-robin — the first ``remainder * nnodes``
    ranks cycle over all nodes, the rest cycle over the first
    ``nprocs // nprocs_node`` nodes (reference: lustre_driver_test.c:365-402).
    The last node may be smaller when nprocs_node does not divide nprocs.
    """
    if nprocs_node < 1 or nprocs_node > nprocs:
        raise ValueError("nprocs_node must be in [1, nprocs]")
    nnodes = (nprocs + nprocs_node - 1) // nprocs_node
    node_of = np.empty(nprocs, dtype=np.int64)
    if kind == 1:
        remainder = nprocs % nprocs_node
        temp = nprocs // nprocs_node
        for i in range(nprocs):
            if i < remainder * nnodes:
                node_of[i] = i % nnodes
            else:
                node_of[i] = (i - remainder * nnodes) % temp
    else:
        node_of[:] = np.arange(nprocs) // nprocs_node
    node_sizes = np.bincount(node_of, minlength=nnodes).astype(np.int64)
    proxies = np.array(
        [np.nonzero(node_of == n)[0][0] for n in range(nnodes)],
        dtype=np.int64)
    return NodeAssignment(nprocs=nprocs, nnodes=nnodes, node_of=node_of,
                          proxies=proxies, node_sizes=node_sizes)
