"""The host half of the mesh lowering: schedule edges as color steps.

A copy of ``tpu_aggcomm/backends/jax_ici.py:74-155`` (``color_rounds``,
``_Lowered``, ``lower_schedule``), numpy only, with the import paths
rewritten. The reference module imports jax at ``:40-43``, so the port
keeps its own copy; ``tests/test_torch_dma.py`` pins that both produce the
same lowering field for field. The rest of ``jax_ici`` (the mesh backend,
one device per rank) is not ported yet (ROADMAP.md, queue A).

Each round's (src, dst) edges are split by a greedy bipartite edge
coloring into partial permutations, one color step each: the unit one
permutation step of the remote-DMA transport (:mod:`cuda_dma`) carries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_aggcomm_torch.core.pattern import Direction
from tpu_aggcomm_torch.core.schedule import Schedule, barrier_rounds_of

__all__ = ["color_rounds", "lower_schedule"]


def color_rounds(edges: np.ndarray) -> list[list[tuple[int, int]]]:
    """Greedy bipartite edge coloring of one round's (src, dst) edge list.

    Each color class is a partial permutation (no repeated src, no repeated
    dst) — the unit a single ppermute can carry. Greedy needs at most
    2Δ-1 colors; the reference's structured rounds typically hit Δ.
    """
    src_used: list[set[int]] = []
    dst_used: list[set[int]] = []
    colors: list[list[tuple[int, int]]] = []
    for s, d in edges:
        s, d = int(s), int(d)
        for c in range(len(colors)):
            if s not in src_used[c] and d not in dst_used[c]:
                colors[c].append((s, d))
                src_used[c].add(s)
                dst_used[c].add(d)
                break
        else:
            colors.append([(s, d)])
            src_used.append({s})
            dst_used.append({d})
    return colors


@dataclass
class _Lowered:
    """Static lowering artifacts for one schedule."""
    perms: list[list[tuple[int, int]]]      # ppermute perm per color step
    round_of_color: list[int]               # color step -> round index
    sslot_tab: np.ndarray                   # (nprocs, C) send slot or -1
    rslot_tab: np.ndarray                   # (nprocs, C) recv slot or trash row
    barrier_rounds: dict[int, int]          # round -> number of MPI_Barriers
    n_send_slots: int
    n_recv_slots: int                       # excludes the trash row

    @property
    def n_colors(self) -> int:
        return len(self.perms)


def lower_schedule(schedule: Schedule) -> _Lowered:
    p = schedule.pattern
    n = p.nprocs
    edges = schedule.data_edges()
    rtable = schedule.recv_slot_table()
    n_send_slots = p.cb_nodes if p.direction is Direction.ALL_TO_MANY else n
    n_recv_slots = n if p.direction is Direction.ALL_TO_MANY else p.cb_nodes

    perms: list[list[tuple[int, int]]] = []
    round_of_color: list[int] = []
    sslots: list[np.ndarray] = []
    rslots: list[np.ndarray] = []
    n_rounds = int(edges[:, 4].max()) + 1 if len(edges) else 0
    for r in range(n_rounds):
        sel = edges[edges[:, 4] == r]
        if len(sel) == 0:
            continue
        slot_of = {(int(e[0]), int(e[1])): int(e[2]) for e in sel}
        for color in color_rounds(sel[:, :2]):
            ss = np.full(n, -1, dtype=np.int32)
            rs = np.full(n, n_recv_slots, dtype=np.int32)  # trash row default
            for (s, d) in color:
                ss[s] = slot_of[(s, d)]
                rs[d] = rtable[(s, d)]
            perms.append(color)
            round_of_color.append(r)
            sslots.append(ss)
            rslots.append(rs)

    barrier_rounds = barrier_rounds_of(schedule)

    return _Lowered(
        perms=perms,
        round_of_color=round_of_color,
        sslot_tab=np.stack(sslots, axis=1) if sslots else np.zeros((n, 0), np.int32),
        rslot_tab=np.stack(rslots, axis=1) if rslots else np.zeros((n, 0), np.int32),
        barrier_rounds=barrier_rounds,
        n_send_slots=n_send_slots,
        n_recv_slots=n_recv_slots,
    )
