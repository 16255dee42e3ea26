"""TAM's relay orders, built from the node map in numpy.

The proxy engine (``collective_write``, lustre_driver_test.c:944-1309)
moves every slab in three hops, and each hop puts the slabs in an order
of its own:

- P2, ``proxy_hold`` order (l_d_t.c:1069-1105): per node in turn, each
  sender resident there (in sender order) packs its slabs, slot by slot,
  into its node proxy's aggregate buffer;
- P3, ``node_in`` order (l_d_t.c:1121-1194): per destination node in
  turn, the slabs bound there, in the order the P2 buffers hold them;
- P4/P5 (l_d_t.c:1219-1285): each slab into its receiver's slot.

These are the walks of ``tam_oracle`` (:mod:`tpu_aggcomm_torch.tam.engine`)
made two stable sorts: of the senders by their node, then of the staged
slabs by their destination's node. So a Theta job's 4,194,304 slabs take
a sort each, not a Python loop over nodes times slabs. Both one-device
programs read them: ``torch_sim``'s three gathers over dense arenas and
``torch_shard``'s three row deliveries over compacted ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.topology import NodeAssignment

__all__ = ["RelayOrders", "relay_orders"]


@dataclass(frozen=True)
class RelayOrders:
    """One TAM exchange's ``E = senders x nslots`` slabs in each hop's
    order, every array int32 of length E:

    - ``stage_src``, ``stage_slot``: the k-th slab after P2 is slot
      ``stage_slot[k]`` of sender rank ``stage_src[k]``;
    - ``exch``: the j-th slab after P3 is the ``exch[j]``-th after P2;
    - ``dst``, ``dst_slot``: the receiver rank and receive slot of the
      j-th slab after P3, where P4/P5 lands it.

    ``nslots`` is a sender's send slots (``cb_nodes`` all-to-many,
    ``nprocs`` many-to-all)."""

    stage_src: np.ndarray
    stage_slot: np.ndarray
    exch: np.ndarray
    dst: np.ndarray
    dst_slot: np.ndarray
    nslots: int

    @property
    def n_slabs(self) -> int:
        return len(self.exch)


def _stable_order(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """The stable argsort of ``keys`` (each in ``[0, nkeys)``), on keys
    narrowed to 16 bits where they fit (numpy then sorts by radix)."""
    if nkeys <= np.iinfo(np.uint16).max:
        keys = keys.astype(np.uint16)
    return np.argsort(keys, kind="stable")


def relay_orders(p: AggregatorPattern, na: NodeAssignment) -> RelayOrders:
    """The relay's orders of pattern ``p`` over node map ``na``."""
    node_of = np.asarray(na.node_of, dtype=np.int64)
    ranks = np.asarray(p.rank_list, dtype=np.int64)
    if p.direction is Direction.ALL_TO_MANY:
        senders, nslots = np.arange(p.nprocs, dtype=np.int64), p.cb_nodes
    else:
        senders, nslots = ranks, p.nprocs
    held = senders[_stable_order(node_of[senders], na.nnodes)]
    stage_src = np.repeat(held, nslots)
    stage_slot = np.tile(np.arange(nslots, dtype=np.int64), len(held))
    if p.direction is Direction.ALL_TO_MANY:
        dest, slot = ranks[stage_slot], stage_src
    else:
        dest = stage_slot
        slot = np.asarray(p.agg_index, dtype=np.int64)[stage_src]
    exch = _stable_order(node_of[dest], na.nnodes)

    def i32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    return RelayOrders(stage_src=i32(stage_src), stage_slot=i32(stage_slot),
                       exch=i32(exch), dst=i32(dest[exch]),
                       dst_slot=i32(slot[exch]), nslots=int(nslots))
