"""Two-level aggregator metadata.

Reproduces ``aggregator_meta_information`` (lustre_driver_test.c:88-252):
given a node map and the *global* aggregator list, choose up to ``co``
*local* aggregators per node and bind every rank to exactly one local
aggregator on its node. This is the metadata that drives the two-level
exchange engines (collective_write2/3) and, in the TPU build, the
inner-axis grouping of the TAM mesh program.

Selection modes (reference ``mode`` argument):

- mode 0: ignore global-aggregator placement; pick ``co`` local aggregators
  evenly spread over the node's sorted rank list (ceiling/floor blocks).
- mode 1: local aggregators are a superset of the node's global aggregators,
  topped up with the node's lowest non-aggregator ranks until ``co`` are
  chosen.

Binding rule (both modes, reference comment at l_d_t.c:193-198): local
aggregator j on a node owns a contiguous run of ceiling-or-floor size of the
node's sorted ranks — skipping other local aggregators — and always owns
itself (inserted in its run's last slot if not encountered while scanning).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_aggcomm_torch.core.topology import NodeAssignment

__all__ = ["AggregatorMeta", "aggregator_meta_information"]


@dataclass(frozen=True)
class AggregatorMeta:
    """Global two-level aggregator structure.

    ``local_aggregators`` concatenates each node's chosen local aggregators
    in node order (reference output of the same name); ``owner_of`` maps each
    rank to its local aggregator (reference: process_aggregator_list);
    ``owned_ranks(agg)`` lists the ranks bound to a local aggregator
    (reference: aggregator_local_ranks, computed per-rank there).
    """

    nprocs: int
    local_aggregators: np.ndarray  # concatenated per-node local aggregator ranks
    owner_of: np.ndarray           # shape (nprocs,): rank -> owning local aggregator

    @property
    def is_local_aggregator(self) -> np.ndarray:
        mask = np.zeros(self.nprocs, dtype=bool)
        mask[self.local_aggregators] = True
        return mask

    def owned_ranks(self, agg: int) -> np.ndarray:
        return np.nonzero(self.owner_of == agg)[0]


def aggregator_meta_information(
    assignment: NodeAssignment,
    global_aggregators: np.ndarray,
    co: int,
    mode: int = 0,
) -> AggregatorMeta:
    """Choose local aggregators per node and bind every rank to one.

    See module docstring; faithful to lustre_driver_test.c:88-252 including
    the scan-with-skip binding order, so layouts are comparable with the
    reference.
    """
    if co < 1:
        raise ValueError("co must be >= 1")
    nprocs = assignment.nprocs
    is_global = np.zeros(nprocs, dtype=bool)
    is_global[np.asarray(global_aggregators, dtype=np.int64)] = True

    all_local: list[int] = []
    per_node_local: list[np.ndarray] = []
    for node in range(assignment.nnodes):
        ranks = assignment.local_ranks(node)  # sorted
        lnp = len(ranks)
        co2 = min(co, lnp)
        if mode:
            # superset of the node's global aggregators, topped up in rank order
            chosen = [int(r) for r in ranks if is_global[r]]
            if len(chosen) < co2:
                for r in ranks:
                    if int(r) not in chosen:
                        chosen.append(int(r))
                    if len(chosen) == co2:
                        break
            else:
                chosen = chosen[:co2]
        else:
            # even ceiling/floor spread over the node's sorted ranks
            remainder = lnp % co2
            ceil_ = (lnp + co2 - 1) // co2
            floor_ = lnp // co2
            chosen = []
            for j in range(co2):
                if j < remainder:
                    chosen.append(int(ranks[ceil_ * j]))
                else:
                    chosen.append(int(ranks[ceil_ * remainder + floor_ * (j - remainder)]))
        per_node_local.append(np.array(chosen, dtype=np.int64))
        all_local.extend(chosen)

    is_local = np.zeros(nprocs, dtype=bool)
    is_local[np.array(all_local, dtype=np.int64)] = True

    owner_of = np.full(nprocs, -1, dtype=np.int64)
    for node in range(assignment.nnodes):
        ranks = assignment.local_ranks(node)
        chosen = per_node_local[node]
        lnp, lna = len(ranks), len(chosen)
        if lna == 0:
            continue
        remainder = lnp % lna
        ceil_ = (lnp + lna - 1) // lna
        floor_ = lnp // lna
        base = 0  # scan cursor over the node's sorted ranks
        for j, agg in enumerate(chosen):
            group = ceil_ if j < remainder else floor_
            seen_self = False
            for k in range(group):
                if k == group - 1 and not seen_self:
                    owner_of[agg] = agg  # reserve the last slot for the aggregator itself
                    break
                # skip ranks that are OTHER local aggregators
                while base < lnp and is_local[ranks[base]] and int(ranks[base]) != int(agg):
                    base += 1
                if base >= lnp:
                    break
                if is_local[ranks[base]]:
                    seen_self = True
                owner_of[int(ranks[base])] = int(agg)
                base += 1

    return AggregatorMeta(nprocs=nprocs,
                          local_aggregators=np.array(all_local, dtype=np.int64),
                          owner_of=owner_of)
