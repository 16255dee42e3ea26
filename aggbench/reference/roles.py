"""Who sends and who receives, from the reference's own rules.

The aggregator list follows ``create_aggregator_list`` of the reference's
``mpi_test.c:1952-2006`` (the ``-t`` placement policies), quirks kept:
policy 1 sets the remainder to ``procs / cb_nodes`` (an integer
division, not ``procs % cb_nodes``), which decides which blocks take the
ceiling size.

All-to-many (``-m 1``): every rank sends one slab to each aggregator;
slot ``k`` of a sender goes to aggregator ``k``, and lands in that
aggregator's slot numbered by the sender's rank (``mpi_test.c:193-198,
213-217``). Many-to-all (``-m 2``): each aggregator sends one slab to
every rank; slot ``k`` of aggregator ``i`` goes to rank ``k`` and lands
in its slot ``i`` (``mpi_test.c:106-110, 138-141``). In both, with
senders and receivers numbered in these orders, the slab that sender
``i`` addresses to receiver ``k`` arrives at ``recv[k, i]``.
"""

from __future__ import annotations

from dataclasses import dataclass

DIRECTIONS = ("all_to_many", "many_to_all")


def aggregator_ranks(nprocs: int, cb_nodes: int, placement: int,
                     proc_node: int) -> list[int]:
    """The ``cb_nodes`` aggregator ranks of placement policy 0-3."""
    if not 1 <= cb_nodes <= nprocs:
        raise ValueError(f"cb_nodes {cb_nodes} not in [1, {nprocs}]")
    if placement == 0:
        return list(range(cb_nodes))
    if placement in (1, 2):
        remainder = nprocs // cb_nodes
        ceiling = -(-nprocs // cb_nodes)
        floor = nprocs // cb_nodes
        out = []
        for i in range(cb_nodes):
            if i < remainder:
                r = ceiling * i
            else:
                r = ceiling * remainder + floor * (i - remainder)
            if placement == 2:
                r = (r - 16 + nprocs * 16) % nprocs
            out.append(r)
        return out
    if placement == 3:
        out, pos = [], 0
        for _ in range(cb_nodes):
            out.append(pos)
            pos += proc_node
            if pos >= nprocs:
                pos = pos % proc_node + 1
        return out
    raise ValueError(f"placement {placement} is not one of 0-3")


@dataclass(frozen=True)
class Roles:
    """Senders and receivers of one exchange, in slot order."""

    senders: tuple[int, ...]
    receivers: tuple[int, ...]
    nprocs: int
    data_size: int

    @property
    def payload_bytes(self) -> int:
        return len(self.senders) * len(self.receivers) * self.data_size


def roles(config: dict, direction: str) -> Roles:
    """The cell's :class:`Roles` from its configuration and direction."""
    n = config["nprocs"]
    aggs = tuple(aggregator_ranks(n, config["cb_nodes"],
                                  config["placement"], config["proc_node"]))
    everyone = tuple(range(n))
    if direction == "all_to_many":
        return Roles(everyone, aggs, n, config["data_size"])
    if direction == "many_to_all":
        return Roles(aggs, everyone, n, config["data_size"])
    raise ValueError(f"direction {direction!r} is not one of {DIRECTIONS}")
