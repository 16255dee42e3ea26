"""Two-level (TAM) hierarchical exchange engine, the half without a mesh.

The reference's runtime core is ``collective_write`` and its two sibling
engines (lustre_driver_test.c:944-1309, 754-926, 604-728): all ranks funnel
their aggregator traffic through one *proxy* per node (intra-node gather →
proxy↔proxy inter-node exchange → local delivery). m=15/16 wrap that engine
behind the method registry (mpi_test.c:313-419).

This module is the port's copy of the device-free half of
``tpu_aggcomm/tam/engine.py`` (import paths rewritten): the compiled
:class:`TamMethod`, its simulated contiguous node map, the proxy engine's
per-phase byte volumes and the numpy proxy-path oracle. On one device the
route runs as three gather hops over the rank axis
(:meth:`tpu_aggcomm_torch.backends.torch_sim.TorchSimBackend._tam_rep`).
The two-level mesh engines (``tam_two_level_*``) need one device per rank
and belong to the multi-device tier (ROADMAP.md, queue A item 8).

- **proxy oracle**: the faithful 5-phase structure — P1 size exchange is
  static here (the reference's runtime size handshake, l_d_t.c:996-1041,
  carries no information in the uniform span=1 pattern), P2 pack+gather to
  the proxy, P3 proxy↔proxy runs, P4 local delivery, P5 scatter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.topology import (NodeAssignment,
                                             static_node_assignment)

__all__ = ["TamMethod", "gen_tam_schedule", "padded_mesh_size",
           "tam_oracle", "tam_phase_bytes"]


def _alloc_recv(p: AggregatorPattern) -> list[np.ndarray | None]:
    """Zeroed per-rank recv slab matrices (None for a rank that receives
    nothing), as the reference's ``local`` backend allocates them."""
    from tpu_aggcomm_torch.harness.verify import recv_slot_counts
    return [np.zeros((c, p.data_size), dtype=np.uint8) if c else None
            for c in recv_slot_counts(p)]


def padded_mesh_size(na: NodeAssignment) -> int:
    """Devices the two-level mesh engine needs: N*L coordinates, where a
    ragged last node is padded with phantom ranks. The single source of
    truth for both the engine and jax_ici's fallback pre-check."""
    return na.nnodes * int(na.node_sizes[0])


@dataclass
class TamMethod:
    """Compiled TAM method — the object compile_method returns for m=15/16.

    Not a generic Schedule: like the reference, TAM is a separate engine
    behind the same registry (mpi_test.c:34-38 extern boundary)."""

    pattern: AggregatorPattern
    method_id: int
    name: str
    assignment: NodeAssignment
    collective = False

    @property
    def nprocs(self) -> int:
        return self.pattern.nprocs


def gen_tam_schedule(p: AggregatorPattern) -> TamMethod:
    """m=15 (all_to_many) / m=16 (many_to_all): simulated contiguous node
    map from proc_node, exactly like the reference wrappers
    (mpi_test.c:395: static_node_assignment type 0)."""
    assignment = static_node_assignment(p.nprocs, p.proc_node, 0)
    if p.direction is Direction.ALL_TO_MANY:
        return TamMethod(p, 15, "All to many TAM", assignment)
    return TamMethod(p, 16, "Many to all TAM", assignment)


# ---------------------------------------------------------------------------
# proxy-path oracle (numpy): faithful 5-phase structure + per-phase volumes

def tam_phase_bytes(p: AggregatorPattern, na: NodeAssignment) -> dict:
    """Byte volumes each phase moves in the proxy engine — the quantities
    the reference's phase timers bracket (l_d_t.c:996-1309). Used by tests
    to pin the schedule *shape* (intra vs inter traffic) independent of
    timing."""
    ds = p.data_size
    node_of = na.node_of
    agg_nodes = node_of[np.asarray(p.rank_list)]
    if p.direction is Direction.ALL_TO_MANY:
        senders, receivers = np.arange(p.nprocs), np.asarray(p.rank_list)
    else:
        senders, receivers = np.asarray(p.rank_list), np.arange(p.nprocs)

    p2 = 0  # non-proxy rank -> its proxy (pack of all its slabs)
    for s in senders:
        if not na.is_proxy(int(s)):
            p2 += len(receivers) * ds if p.direction is Direction.ALL_TO_MANY \
                else p.nprocs * ds
    p3 = 0  # proxy -> proxy (slabs whose destination lives on another node)
    for s in senders:
        for r in receivers:
            if node_of[int(s)] != node_of[int(r)]:
                p3 += ds
    p4 = 0  # proxy -> final non-proxy destination
    for s in senders:
        for r in receivers:
            if not na.is_proxy(int(r)):
                p4 += ds
    return {"intra_gather": p2, "inter_exchange": p3, "local_delivery": p4}


def tam_oracle(tam: TamMethod, iter_: int = 0):
    """Single-process proxy-path execution: pack → gather-at-proxy →
    inter-node runs → local delivery → scatter. Data-identical to the dense
    exchange (the engine only changes the route), so delivery is computed
    through the explicit relay structure and then verified by the caller."""
    from tpu_aggcomm_torch.harness.verify import make_send_slabs

    p = tam.pattern
    na = tam.assignment
    send = make_send_slabs(p, iter_)
    agg_index = p.agg_index

    # staging: per node, the proxy's aggregate buffer of (origin, slot) slabs
    proxy_hold: list[list[tuple[int, int]]] = [[] for _ in range(na.nnodes)]
    if p.direction is Direction.ALL_TO_MANY:
        senders = range(p.nprocs)
        slots = lambda s: range(p.cb_nodes)                  # noqa: E731
        dest_of = lambda s, i: int(p.rank_list[i])           # noqa: E731
    else:
        senders = [int(r) for r in p.rank_list]
        slots = lambda s: range(p.nprocs)                    # noqa: E731
        dest_of = lambda s, i: i                             # noqa: E731

    # P2: every sender's slabs arrive at its node proxy (self-pack for the
    # proxy itself; one packed Issend otherwise — l_d_t.c:1069-1105)
    for s in senders:
        proxy_hold[int(na.node_of[s])].extend((s, i) for i in slots(s))

    # P3: proxies exchange per-destination-node runs (l_d_t.c:1121-1194)
    node_in: list[list[tuple[int, int]]] = [[] for _ in range(na.nnodes)]
    for node, held in enumerate(proxy_hold):
        for (s, i) in held:
            node_in[int(na.node_of[dest_of(s, i)])].append((s, i))

    # P4/P5: destination proxy re-packs per local rank and delivers
    recv = _alloc_recv(p)
    for node, incoming in enumerate(node_in):
        for (s, i) in incoming:
            d = dest_of(s, i)
            if p.direction is Direction.ALL_TO_MANY:
                recv[d][s] = send[s][i]
            else:
                recv[d][int(agg_index[s])] = send[s][i]
    return recv
