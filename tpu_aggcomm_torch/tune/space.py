"""Tuner search space: the candidate grid and its validity guards.

A tuning run races candidates over one FIXED traffic shape — ``(nprocs,
data_size, proc_node)`` on one backend — varying only the knobs the
reference sweeps by hand: the method id (``-m``), the aggregator count
(``-a``), the throttle (``-c``) and the placement policy (``-t``).
Everything here is pure index bookkeeping (no jax): the grid must be
constructible and re-parsable on the jax-free replay path.

Guards (SpaceError, named ids — the ``inspect compare``
TraceCompareError discipline):

- **direction consistency** — an all-to-many grid never mixes
  many-to-all methods: their max-over-ranks times answer different
  questions (write funnel vs read fan-out), so a "winner" across them
  is not a winner of anything. The error names the offending ids per
  direction.
- **dead methods** — m=21/22 are registered but not dispatched
  (``core/methods.py``); racing them would crown an algorithm the
  reference never runs. Refused by id via
  ``method_ids(include_dead=False)``.
- **TAM methods** — m=15/16 ride the hierarchical engine, whose
  per-rep chain has a different scaffold; excluded unless explicitly
  opted in (``include_tam``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Candidate", "SpaceError", "build_space", "parse_cid",
           "space_direction"]


class SpaceError(ValueError):
    """Invalid tuning grid (mixed directions, dead/unknown/TAM ids,
    out-of-range axes). Always names the offending values."""


@dataclass(frozen=True)
class Candidate:
    """One point of the grid. ``cid`` is the canonical string id used as
    the JSON key in TUNE artifacts (JSON object keys must be strings)
    and in every race/elimination record."""

    method: int
    cb_nodes: int
    comm_size: int
    agg_type: int

    @property
    def cid(self) -> str:
        return (f"m{self.method}:a{self.cb_nodes}:"
                f"c{self.comm_size}:t{self.agg_type}")


def parse_cid(cid: str) -> Candidate:
    """Inverse of :attr:`Candidate.cid` — the replay path rebuilds
    candidates from recorded artifact keys with this, never via a
    backend."""
    try:
        parts = dict((p[0], int(p[1:])) for p in cid.split(":"))
        return Candidate(method=parts["m"], cb_nodes=parts["a"],
                         comm_size=parts["c"], agg_type=parts["t"])
    except (KeyError, ValueError, IndexError):
        raise SpaceError(f"malformed candidate id {cid!r} "
                         f"(expected 'mM:aA:cC:tT')")


def build_space(methods, cb_nodes_list, comm_sizes, agg_types, *,
                nprocs: int, include_tam: bool = False) -> list[Candidate]:
    """The validated candidate grid, in deterministic (input) order —
    the racing loop's tie-breaks depend on this order, so it is part of
    the reproducibility contract."""
    from tpu_aggcomm_torch.core.methods import METHODS, method_ids

    methods = [int(m) for m in methods]
    cb_nodes_list = [int(a) for a in cb_nodes_list]
    comm_sizes = [int(c) for c in comm_sizes]
    agg_types = [int(t) for t in agg_types]
    if not (methods and cb_nodes_list and comm_sizes and agg_types):
        raise SpaceError("empty tuning grid: every axis needs at least "
                         "one value")

    unknown = sorted(m for m in methods if m not in METHODS)
    if unknown:
        raise SpaceError(f"unknown method id(s) {unknown}; valid ids: "
                         f"{sorted(METHODS)}")
    live = set(method_ids(include_dead=False))
    dead = sorted(m for m in methods if not METHODS[m].dispatched)
    if dead:
        raise SpaceError(
            f"dead method id(s) {dead} in the tuning grid: "
            f"{', '.join(f'm={m} ({METHODS[m].name})' for m in dead)} "
            f"are registered for parity but never dispatched — a tuned "
            f"winner must be a runnable method")
    tam = sorted(m for m in methods if METHODS[m].tam)
    if tam and not include_tam:
        raise SpaceError(
            f"TAM method id(s) {tam} in the tuning grid: the "
            f"hierarchical engine's rep has a different chain scaffold; "
            f"pass --include-tam to race them anyway")
    missing = sorted(m for m in methods if m not in live and m not in dead)
    if missing:
        # e.g. TAM ids when tam.engine is absent from the build
        raise SpaceError(f"method id(s) {missing} are not dispatchable "
                         f"in this build")

    by_dir: dict[str, list[int]] = {}
    for m in sorted(set(methods)):
        by_dir.setdefault(METHODS[m].direction.value, []).append(m)
    if len(by_dir) > 1:
        detail = "; ".join(f"{d}: {ids}" for d, ids in sorted(by_dir.items()))
        raise SpaceError(
            f"tuning grid mixes traffic directions ({detail}) — an "
            f"all-to-many winner and a many-to-all winner answer "
            f"different questions; tune each direction separately")

    bad_a = sorted(a for a in cb_nodes_list if not 1 <= a <= nprocs)
    if bad_a:
        raise SpaceError(f"cb_nodes value(s) {bad_a} outside "
                         f"[1, nprocs={nprocs}]")
    bad_c = sorted(c for c in comm_sizes if c < 1)
    if bad_c:
        raise SpaceError(f"comm_size value(s) {bad_c} must be >= 1")
    bad_t = sorted(t for t in agg_types if not 0 <= t <= 3)
    if bad_t:
        raise SpaceError(f"agg_type value(s) {bad_t} outside the "
                         f"reference's 0..3 placement policies")

    return [Candidate(method=m, cb_nodes=a, comm_size=c, agg_type=t)
            for m in methods for a in cb_nodes_list
            for c in comm_sizes for t in agg_types]


def space_direction(methods) -> str:
    """The (single, already-validated) direction of a method list — the
    cache-key field."""
    from tpu_aggcomm_torch.core.methods import METHODS
    return METHODS[int(list(methods)[0])].direction.value
