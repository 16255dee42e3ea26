"""Seeded enumeration + local search over schedule compositions.

The search is jax-free and fully deterministic given its seed: the
enumeration order, the seeded sample of the initial population, the
beam-mutation neighborhoods, and every verdict (checker, auditor,
dominance, pricing) are pure functions of (config, seed, params) — the
same discipline as the tuner's racing and the regression gate, which is
what lets ``synth --replay`` re-derive the whole search trace
byte-for-byte from the committed artifact on a machine where jax may
not even import.

Pruning pipeline per composition:

1. **build** — :class:`~tpu_aggcomm_torch.synth.primitives.CompositionError`
   refusals (e.g. relay on the m2a mirror) are recorded INVALID.
2. **check** — ``analysis/check.py`` verdicts are hard pruning: a
   named refutation (the waits-for cycle, the racing slot) kills the
   branch and the property name lands in ``pruned_by``.
3. **traffic** — ``obs/traffic.py``'s in-flight audit against the
   documented ``-c`` bound; an over-posting composition is REFUTED
   statically, with peak/bound recorded.
4. **dominance** — a survivor strictly worse on every static axis
   (rounds, bytes, bottleneck, peak, staging) than some other survivor
   is pruned as dominated; ties survive (the race arbitrates).
5. **price** — ``model/predict.py``'s calibrated floor ranks the
   survivors (the multi-fidelity prior); without parameters the
   structural key ranks instead and the artifact says so.

Predictions never gate alone (the model invariant): pricing only
ORDERS the finalists — the measured race in synth/artifact.py decides.
"""

from __future__ import annotations

import random
from dataclasses import replace as _replace

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.synth.primitives import (ORDERS, SELFEDGES, SYNCS, WAITS,
                                          WINDOWS, Composition,
                                          CompositionError, build_schedule,
                                          parse_composition)

__all__ = ["SearchError", "UNREGISTERED_ID", "enumerate_space",
           "evaluate_composition", "search"]

#: Placeholder method id for search-phase schedules (the base of the
#: reserved synthesized range; registration assigns BASE+1, BASE+2, …).
#: Never registered itself, and ``Schedule.variant`` carries the
#: canonical composition, so two candidates sharing this id can never
#: alias a shape-keyed cache entry.
UNREGISTERED_ID = 100


class SearchError(ValueError):
    """Unusable search input (empty space, malformed config)."""


_DIRECTIONS = {"a2m": Direction.ALL_TO_MANY, "m2a": Direction.MANY_TO_ALL,
               Direction.ALL_TO_MANY.value: Direction.ALL_TO_MANY,
               Direction.MANY_TO_ALL.value: Direction.MANY_TO_ALL}


def _direction(text: str) -> Direction:
    try:
        return _DIRECTIONS[str(text)]
    except KeyError:
        raise SearchError(f"unknown direction {text!r} "
                          f"(want one of {sorted(_DIRECTIONS)})") from None


def make_pattern(cfg: dict) -> AggregatorPattern:
    """The one pattern constructor every synth phase shares (search,
    pricing, registration smoke, artifact replay) — mirrors
    tune/measure.py so the search evaluates the very schedule the race
    would measure."""
    return AggregatorPattern(
        nprocs=int(cfg["nprocs"]), cb_nodes=int(cfg["cb_nodes"]),
        data_size=max(int(cfg.get("data_size", 2048)), 1),
        proc_node=int(cfg.get("proc_node", 1)),
        comm_size=int(cfg["comm_size"]),
        placement=int(cfg.get("agg_type", 1)),
        direction=_direction(cfg.get("direction", "a2m")))


def enumerate_space(*, fanins=(2, 4), relays=(0, 2)) -> list[Composition]:
    """The full valid composition grid, sorted by canonical string —
    the deterministic universe the seeded sample draws from."""
    out = []
    for order in ORDERS:
        for fanin in (tuple(fanins) if order == "tree" else (0,)):
            for sync in SYNCS:
                for wait in (("round",) if sync == "crossed" else WAITS):
                    for selfedge in SELFEDGES:
                        for relay in relays:
                            windows = (WINDOWS if (order != "tree"
                                                   and wait == "round"
                                                   and relay == 0)
                                       else ("chunk",))
                            for window in windows:
                                out.append(Composition(
                                    order=order, sync=sync,
                                    selfedge=selfedge, wait=wait,
                                    fanin=fanin, relay=relay,
                                    window=window))
    return sorted(set(out), key=lambda c: c.canonical())


def evaluate_composition(comp: Composition, pattern: AggregatorPattern,
                         params: dict | None = None) -> dict:
    """One composition through build → check → traffic → features →
    price. Returns the artifact row; ``pruned_by`` is None iff the
    composition survives the hard filters (dominance is cross-row and
    applied later)."""
    from tpu_aggcomm_torch.analysis.check import check_schedule
    from tpu_aggcomm_torch.model.features import schedule_features
    from tpu_aggcomm_torch.model.predict import floor_from_features
    from tpu_aggcomm_torch.obs.traffic import audit_schedule

    row = {"composition": comp.canonical(), "verdict": "PROVEN",
           "pruned_by": None, "rounds": None, "bytes": None,
           "bottleneck": None, "peak": None, "bound": None,
           "staging": 0, "price_s": None, "rank": None}
    try:
        sched = build_schedule(comp, pattern, method_id=UNREGISTERED_ID)
    except CompositionError as e:
        row["verdict"] = "INVALID"
        row["pruned_by"] = f"build:{e}"
        return row

    rep = check_schedule(sched)
    if rep["verdict"] != "PROVEN":
        bad = [k for k, v in rep["properties"].items()
               if v.get("verdict") == "REFUTED"]
        prop = bad[0] if bad else "unknown"
        row["verdict"] = "REFUTED"
        row["pruned_by"] = f"check:{prop}"
        row["check_detail"] = rep["properties"].get(prop, {}).get("detail")
        return row

    audit = audit_schedule(sched)
    conf = audit["conformance"]
    row["peak"], row["bound"] = conf["peak"], conf["bound"]
    if conf["verdict"] != "CONFORMS":
        row["verdict"] = "REFUTED"
        row["pruned_by"] = (f"traffic:peak {conf['peak']} > bound "
                            f"{conf['bound']} ({conf['bound_formula']})")
        return row

    feats = schedule_features(sched)
    row["rounds"] = feats["rounds"]
    row["bytes"] = feats["bytes"]
    row["bottleneck"] = feats["bottleneck"]
    row["staging"] = sched.n_staging
    if params:
        row["price_s"] = floor_from_features(feats, params)
    return row


def _static_key(row: dict) -> tuple:
    return (row["rounds"], row["bytes"], row["bottleneck"], row["peak"],
            row["staging"])


def _dominates(a: dict, b: dict) -> bool:
    ka, kb = _static_key(a), _static_key(b)
    return all(x <= y for x, y in zip(ka, kb)) and ka != kb


def _rank_key(row: dict) -> tuple:
    if row["price_s"] is not None:
        return (0, row["price_s"], row["composition"])
    return (1, row["rounds"], row["bytes"], row["bottleneck"],
            row["composition"])


def _neighbors(comp: Composition, fanins, relays) -> list[Composition]:
    """All single-field mutations of one composition, canonical-sorted;
    invalid combinations are silently not neighbors."""
    out = []
    axes = {
        "order": [(o, f) for o in ORDERS
                  for f in (tuple(fanins) if o == "tree" else (0,))],
        "sync": list(SYNCS), "selfedge": list(SELFEDGES),
        "wait": list(WAITS), "relay": list(relays),
        "window": list(WINDOWS)}
    for field, values in axes.items():
        for v in values:
            try:
                if field == "order":
                    cand = _replace(comp, order=v[0], fanin=v[1])
                else:
                    cand = _replace(comp, **{field: v})
            except CompositionError:
                continue
            if cand != comp:
                out.append(cand)
    return sorted(set(out), key=lambda c: c.canonical())


def search(*, nprocs: int, cb_nodes: int, comm_size: int,
           data_size: int = 2048, proc_node: int = 1, agg_type: int = 1,
           direction: str = "a2m", seed: int = 0,
           params: dict | None = None, params_source: str | None = None,
           init: int = 32, mutate_rounds: int = 3, beam: int = 4,
           top_k: int = 3, fanins=(2, 4), relays=(0, 2)) -> dict:
    """Run the seeded search at one pattern shape → the ``search`` block
    of the synth-v1 artifact (rows in evaluation order, prune counters,
    ranked survivors, ``top_k`` finalists)."""
    cfg = {"nprocs": int(nprocs), "cb_nodes": int(cb_nodes),
           "comm_size": int(comm_size), "data_size": int(data_size),
           "proc_node": int(proc_node), "agg_type": int(agg_type),
           "direction": direction}
    pattern = make_pattern(cfg)
    space = enumerate_space(fanins=fanins, relays=relays)
    if not space:
        raise SearchError("empty composition space")

    rng = random.Random(int(seed))
    if init >= len(space):
        frontier = list(space)
    else:
        frontier = rng.sample(space, int(init))

    rows: list[dict] = []
    seen: set[str] = set()

    def consider(comps) -> None:
        for comp in comps:
            canon = comp.canonical()
            if canon in seen:
                continue
            seen.add(canon)
            rows.append(evaluate_composition(comp, pattern, params))

    consider(frontier)
    for _ in range(int(mutate_rounds)):
        alive = sorted((r for r in rows if r["pruned_by"] is None),
                       key=_rank_key)
        if not alive:
            break
        nxt: list[Composition] = []
        for r in alive[:int(beam)]:
            nxt.extend(_neighbors(parse_composition(r["composition"]),
                                  fanins, relays))
        consider(nxt)

    # cross-row dominance over everything that survived the hard filters
    alive = [r for r in rows if r["pruned_by"] is None]
    for r in alive:
        for other in alive:
            if other is not r and _dominates(other, r):
                r["pruned_by"] = f"dominated:{other['composition']}"
                break
    survivors = sorted((r for r in alive if r["pruned_by"] is None),
                       key=_rank_key)
    for i, r in enumerate(survivors):
        r["rank"] = i + 1

    def _count(prefix: str) -> int:
        return sum(1 for r in rows
                   if (r["pruned_by"] or "").startswith(prefix))

    pruned = {"invalid": _count("build:"), "check": _count("check:"),
              "traffic": _count("traffic:"),
              "dominated": _count("dominated:")}

    return {"seed": int(seed), "config": cfg,
            "space_size": len(space), "evaluated": len(rows),
            "init": int(init), "mutate_rounds": int(mutate_rounds),
            "beam": int(beam), "top_k": int(top_k),
            "fanins": list(fanins), "relays": list(relays),
            "priced": bool(params), "params_source": params_source,
            "pruned": pruned, "rows": rows,
            "survivors": [r["composition"] for r in survivors],
            "finalists": [r["composition"]
                          for r in survivors[:int(top_k)]]}
