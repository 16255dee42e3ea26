"""Target folding: measured traffic -> concrete improvement targets.

The planner's input is evidence other subsystems already record — the
workload profiler's seeded hot-shape/burstiness proposals
(``obs/workload.py:_detect``) and the serve layer's per-shape_key
counters (the ``stats`` op) — and its output is a deterministic,
ranked list of (shape, incumbent method) campaign targets.
:func:`fold_targets` is a PURE function of (proposals, per_shape): the
same profile + the same stats snapshot fold to the byte-identical
target list, which is what lets ``pilot --replay`` and
``obs/regress.validate_pilot`` re-derive it from the artifact's own
rows. torch-free (core + serve/protocol only).

The copy of ``tpu_aggcomm/pilot/plan.py`` (import paths rewritten), with
one change: a proposal that names no backend folds to ``torch_sim``, the
port's serve default, where the reference folds it to ``jax_sim``.
"""

from __future__ import annotations

__all__ = ["PilotError", "shape_stats_key", "fold_targets"]


class PilotError(ValueError):
    """Unusable pilot input (malformed proposal shape, unknown method),
    with the offending field named."""


def _require_shape(shape, where: str) -> dict:
    if not isinstance(shape, dict):
        raise PilotError(f"{where}: proposal shape must be the serve "
                         f"journal's shape-fields dict, got {shape!r}")
    for f in ("method", "nprocs", "cb_nodes", "comm_size"):
        if not isinstance(shape.get(f), int):
            raise PilotError(f"{where}: proposal shape is missing an "
                             f"integer {f!r} field ({shape!r})")
    return shape


def shape_stats_key(shape: dict, backend: str) -> str | None:
    """The per-shape stats key the server uses — ``repr(shape_key)`` of
    the compiled (and, under a fault spec, repaired) schedule. Built
    through the SAME ``request_schedule`` path as the server
    (serve/protocol.py), so the planner joins stats rows by identity,
    never by guesswork. None when the shape no longer compiles (a
    stats row we cannot join is skipped, not fabricated)."""
    from tpu_aggcomm_torch.core.schedule import schedule_shape_key
    from tpu_aggcomm_torch.serve.protocol import parse_request, request_schedule
    try:
        req = parse_request(dict(shape))
        return repr(schedule_shape_key(request_schedule(req)))
    except Exception:  # lint: broad-ok (stats join is advisory: an uncompilable recorded shape means no stats row, never a planner death)
        return None


def _direction_of(method: int) -> str:
    from tpu_aggcomm_torch.core.methods import METHODS
    spec = METHODS.get(method)
    if spec is None:
        raise PilotError(
            f"proposal names method {method}, which is not registered "
            f"(a synthesized id needs --synth-root to re-register the "
            f"committed winner first)")
    return spec.direction.value


def fold_targets(profile: dict, per_shape: dict | None = None
                 ) -> list[dict]:
    """Fold the profile's proposals (+ optional per-shape serve stats)
    into ranked campaign targets.

    One target per (kind, shape signature) — a shape that is both hot
    and bursty gets BOTH a tune-field target and a synth-augmented
    target (different campaign recipes). Ranking: measured latency mass
    first (the per-shape ``latency_sum`` from serve ``stats``, largest
    first — time spent is time winnable), proposal order as the
    deterministic tie-break."""
    import json as _json

    from tpu_aggcomm_torch.tune.space import Candidate

    proposals = profile.get("proposals") or []
    per_shape = per_shape or {}
    targets: list[dict] = []
    seen: set[tuple] = set()
    for i, p in enumerate(proposals):
        shape = _require_shape(p.get("shape"), f"proposal[{i}]")
        kind = p.get("kind")
        dedup = (kind, _json.dumps(shape, sort_keys=True),
                 p.get("backend"))
        if dedup in seen:
            continue
        seen.add(dedup)
        backend = p.get("backend") or "torch_sim"
        incumbent = Candidate(method=shape["method"],
                              cb_nodes=shape["cb_nodes"],
                              comm_size=shape["comm_size"],
                              agg_type=shape.get("agg_type", 0))
        key = shape_stats_key(shape, backend)
        stats = per_shape.get(key) if key is not None else None
        if stats is not None and not isinstance(stats, dict):
            raise PilotError(f"per_shape[{key!r}] must be a counter "
                             f"dict, got {stats!r}")
        targets.append({
            "index": i, "kind": kind, "shape": dict(shape),
            "backend": backend,
            "incumbent_cid": incumbent.cid,
            "direction": _direction_of(shape["method"]),
            "reason": p.get("reason"),
            "stats_key": key,
            "stats": dict(stats) if stats else None,
        })
    # largest measured latency mass first; proposal order breaks ties
    targets.sort(key=lambda t: (-(t["stats"] or {}).get("latency_sum",
                                                        0.0),
                                t["index"]))
    for rank, t in enumerate(targets):
        t["rank"] = rank
    return targets
