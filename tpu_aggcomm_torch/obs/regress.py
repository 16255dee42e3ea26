"""Schema validation of the tuner's and the synthesizer's artifacts.

The part of ``tpu_aggcomm/obs/regress.py`` that ``cli tune`` and
``cli synth`` need, copied (import paths rewritten): :func:`validate_tune`
(``TUNE_*.json``; ``tune/cache.lookup`` and ``tune --replay`` reject a
corrupt or inconsistent artifact by name) and :func:`validate_synth`
(``SYNTH_r*.json``, ``synth --replay``), with their helpers and schema
tags. The bench-history gate, the other artifact validators and the
OpenMetrics parser come with the ``inspect`` slice (ROADMAP.md queue A).

No torch anywhere here: the replay paths import this module.
"""

from __future__ import annotations

__all__ = ["validate_tune", "validate_synth", "TUNE_SCHEMAS",
           "SYNTH_SCHEMAS"]


def _require(obj: dict, key: str, types, errors: list[str],
             where: str, *, nullable: bool = False) -> None:
    if key not in obj:
        errors.append(f"{where}: missing required key {key!r}")
        return
    v = obj[key]
    if v is None and nullable:
        return
    if not isinstance(v, types):
        tn = types.__name__ if isinstance(types, type) else \
            "/".join(t.__name__ for t in types)
        errors.append(f"{where}: key {key!r} must be {tn}, "
                      f"got {type(v).__name__}")


#: Accepted TUNE artifact schema tags (versioned like the bench
#: parsed-schema generations: a new tag is a new entry here, old tags
#: stay valid forever).
TUNE_SCHEMAS = ("tune-v1",)


def _is_num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_tune(obj, where: str = "TUNE") -> list[str]:
    """Schema errors (empty list = valid) for one ``TUNE_*.json``
    tuned-schedule cache artifact (tune/cache.py). A corrupt or stale
    artifact must FAIL here so ``--auto`` falls back loudly instead of
    being silently steered by garbage: the winner must be a recorded
    candidate, every sample batch must be a non-empty list of numbers,
    and every elimination must name candidate + leader present in the
    sample record."""
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"{where}: top level must be an object"]
    schema = obj.get("schema")
    if schema not in TUNE_SCHEMAS:
        errors.append(f"{where}: unknown schema tag {schema!r} "
                      f"(expected one of {list(TUNE_SCHEMAS)})")
        return errors
    key = obj.get("key")
    if not isinstance(key, dict):
        errors.append(f"{where}: missing/invalid 'key' object")
    else:
        for k, types in (("nprocs", int), ("data_size", int),
                         ("proc_node", int), ("direction", str),
                         ("backend", str), ("fingerprint", str)):
            _require(key, k, types, errors, f"{where}.key")
        if key.get("direction") not in ("all_to_many", "many_to_all",
                                        None):
            errors.append(f"{where}.key: direction must be "
                          f"'all_to_many' or 'many_to_all', got "
                          f"{key.get('direction')!r}")
    if "manifest" in obj and obj["manifest"] is not None \
            and not isinstance(obj["manifest"], dict):
        errors.append(f"{where}: 'manifest' must be null or an object")
    race = obj.get("race")
    if not isinstance(race, dict):
        errors.append(f"{where}: missing/invalid 'race' object")
        return errors
    w = f"{where}.race"
    for k, types in (("seed", int), ("alpha", float), ("n_boot", int),
                     ("max_batches", int), ("winner", str),
                     ("batches_run", int)):
        _require(race, k, types, errors, w)
    samples = race.get("samples")
    if not isinstance(samples, dict) or not samples:
        errors.append(f"{w}: 'samples' must be a non-empty object "
                      f"(cid -> list of batches)")
        samples = {}
    for cid, batches in samples.items():
        if not isinstance(batches, list) or not all(
                isinstance(b, list) and b and all(_is_num(x) for x in b)
                for b in batches):
            errors.append(f"{w}.samples[{cid!r}]: every batch must be "
                          f"a non-empty list of numbers")
    order = race.get("order")
    if order is not None:
        if not isinstance(order, list) \
                or sorted(order) != sorted(samples):
            errors.append(f"{w}: 'order' must list exactly the sampled "
                          f"candidate ids")
    winner = race.get("winner")
    if samples and isinstance(winner, str) and winner not in samples:
        errors.append(f"{w}: winner {winner!r} has no recorded samples")
    elims = race.get("eliminations")
    if not isinstance(elims, list):
        errors.append(f"{w}: 'eliminations' must be a list")
    else:
        for i, e in enumerate(elims):
            if not isinstance(e, dict):
                errors.append(f"{w}.eliminations[{i}]: must be an object")
                continue
            for k in ("batch", "candidate", "leader", "ci_pct"):
                if k not in e:
                    errors.append(f"{w}.eliminations[{i}]: missing {k!r}")
            for k in ("candidate", "leader"):
                if samples and e.get(k) is not None \
                        and e.get(k) not in samples:
                    errors.append(f"{w}.eliminations[{i}]: {k} "
                                  f"{e.get(k)!r} has no recorded samples")
            ci = e.get("ci_pct")
            if ci is not None and (not isinstance(ci, list)
                                   or len(ci) != 2
                                   or not all(_is_num(x) for x in ci)):
                errors.append(f"{w}.eliminations[{i}]: ci_pct must be "
                              f"[lo, hi]")
    win = obj.get("winner")
    if not isinstance(win, dict):
        errors.append(f"{where}: missing/invalid 'winner' object")
    else:
        for k in ("method", "cb_nodes", "comm_size", "agg_type"):
            _require(win, k, int, errors, f"{where}.winner")
        if isinstance(race.get("winner"), str) \
                and all(isinstance(win.get(k), int)
                        for k in ("method", "cb_nodes", "comm_size",
                                  "agg_type")):
            cid = (f"m{win['method']}:a{win['cb_nodes']}:"
                   f"c{win['comm_size']}:t{win['agg_type']}")
            if cid != race["winner"]:
                errors.append(f"{where}: winner object {cid} disagrees "
                              f"with race.winner {race['winner']!r}")
    if "synthetic" in obj and not isinstance(obj["synthetic"], bool):
        errors.append(f"{where}: 'synthetic' must be a bool")
    mp = obj.get("model_prune")
    if mp is not None:
        # optional --model-prune record (cli._model_prune): the split
        # must be internally consistent — raced order == kept, pruned
        # candidates priced, nothing both kept and pruned — because
        # tune --replay re-derives it from these fields alone
        w = f"{where}.model_prune"
        if not isinstance(mp, dict):
            errors.append(f"{w}: must be an object")
        else:
            for k, types in (("artifact", str), ("platform", str),
                             ("margin", (int, float)), ("best", str)):
                _require(mp, k, types, errors, w)
            preds = mp.get("predictions")
            if not isinstance(preds, dict) or not preds or not all(
                    v is None or _is_num(v) for v in preds.values()):
                errors.append(f"{w}: 'predictions' must be a non-empty "
                              f"object (cid -> seconds or null)")
                preds = {}
            kept, pruned = mp.get("kept"), mp.get("pruned")
            if not isinstance(kept, list) or not isinstance(pruned, list):
                errors.append(f"{w}: 'kept' and 'pruned' must be lists")
            else:
                if set(kept) & set(pruned):
                    errors.append(f"{w}: candidates both kept and "
                                  f"pruned: "
                                  f"{sorted(set(kept) & set(pruned))}")
                if preds and sorted(set(kept) | set(pruned)) \
                        != sorted(preds):
                    errors.append(f"{w}: kept+pruned must partition "
                                  f"the predicted candidates")
                if isinstance(race.get("order"), list) \
                        and race["order"] != kept:
                    errors.append(f"{w}: race.order must be exactly "
                                  f"the kept list — the race must run "
                                  f"precisely the survivors the prune "
                                  f"recorded")
                for cid in pruned:
                    if preds and not _is_num(preds.get(cid)):
                        errors.append(f"{w}: pruned candidate {cid!r} "
                                      f"has no recorded prediction — "
                                      f"an unpriced candidate must be "
                                      f"raced, never pruned")
    return errors


#: Accepted SYNTH artifact schema tags (tpu_aggcomm/synth/artifact.py,
#: the ``cli synth`` output) — versioned like TUNE_SCHEMAS.
SYNTH_SCHEMAS = ("synth-v1",)

_SYNTH_ROW_VERDICTS = ("PROVEN", "REFUTED", "INVALID")


def validate_synth(obj, where: str = "SYNTH") -> list[str]:
    """Schema errors (empty list = valid) for one ``SYNTH_r*.json``
    synthesis artifact (tpu_aggcomm/synth/). The internal-consistency
    rule is the traffic/predict one, applied three times over: the
    finalists must be the top of the PROVEN survivor ranking, the
    registration block must bind exactly the finalists, and the winner
    must be SYNTHESIZED, carry PROVEN/CONFORMS verdicts, match
    ``race.winner``, and have the smallest pooled sample median among
    the non-eliminated survivors — a winner whose own recorded race
    contradicts it is schema-invalid."""
    import statistics

    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"{where}: top level must be an object"]
    schema = obj.get("schema")
    if schema not in SYNTH_SCHEMAS:
        errors.append(f"{where}: unknown schema tag {schema!r} "
                      f"(expected one of {list(SYNTH_SCHEMAS)})")
        return errors
    for k, types in (("seed", int), ("backend", str)):
        _require(obj, k, types, errors, where)
    if "synthetic" in obj and obj["synthetic"] is not None \
            and not isinstance(obj["synthetic"], str):
        errors.append(f"{where}: 'synthetic' must be null or the spec "
                      f"string")
    cfg = obj.get("config")
    if not isinstance(cfg, dict):
        errors.append(f"{where}: missing/invalid 'config' object")
    else:
        for k in ("nprocs", "cb_nodes", "comm_size", "data_size",
                  "proc_node", "agg_type"):
            _require(cfg, k, int, errors, f"{where}.config")
        _require(cfg, "direction", str, errors, f"{where}.config")
    if "manifest" in obj and obj["manifest"] is not None \
            and not isinstance(obj["manifest"], dict):
        errors.append(f"{where}: 'manifest' must be null or an object")

    # --- search block: rows, prune accounting, survivor ranking -------
    sr = obj.get("search")
    if not isinstance(sr, dict):
        errors.append(f"{where}: missing/invalid 'search' object")
        return errors
    w = f"{where}.search"
    for k in ("seed", "space_size", "evaluated", "init", "mutate_rounds",
              "beam", "top_k"):
        _require(sr, k, int, errors, w)
    rows = sr.get("rows")
    if not isinstance(rows, list) or not rows:
        errors.append(f"{w}: 'rows' must be a non-empty list")
        rows = []
    by_comp: dict = {}
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            errors.append(f"{w}.rows[{i}]: must be an object")
            continue
        comp = r.get("composition")
        if not isinstance(comp, str) or not comp:
            errors.append(f"{w}.rows[{i}]: missing composition string")
            continue
        by_comp[comp] = r
        if r.get("verdict") not in _SYNTH_ROW_VERDICTS:
            errors.append(f"{w}.rows[{i}]: verdict must be one of "
                          f"{_SYNTH_ROW_VERDICTS}, got "
                          f"{r.get('verdict')!r}")
        pruned_by = r.get("pruned_by")
        if pruned_by is not None and not isinstance(pruned_by, str):
            errors.append(f"{w}.rows[{i}]: pruned_by must be null or "
                          f"a named reason")
        if r.get("verdict") in ("REFUTED", "INVALID") and not pruned_by:
            errors.append(f"{w}.rows[{i}]: a {r.get('verdict')} row "
                          f"must name its prune reason")
    survivors = sr.get("survivors")
    finalists = sr.get("finalists")
    if not isinstance(survivors, list) or not isinstance(finalists, list):
        errors.append(f"{w}: 'survivors' and 'finalists' must be lists")
        survivors, finalists = [], []
    for comp in survivors:
        r = by_comp.get(comp)
        if r is None:
            errors.append(f"{w}: survivor {comp!r} has no row")
        elif r.get("verdict") != "PROVEN" or r.get("pruned_by"):
            errors.append(f"{w}: survivor {comp!r} is not an unpruned "
                          f"PROVEN row — the ranking contradicts the "
                          f"rows")
    top_k = sr.get("top_k")
    if isinstance(top_k, int) and finalists != survivors[:top_k]:
        errors.append(f"{w}: finalists must be survivors[:top_k] "
                      f"(ranked prefix), got {finalists}")
    pruned = sr.get("pruned")
    if not isinstance(pruned, dict):
        errors.append(f"{w}: missing/invalid 'pruned' counters")
    elif rows and all(isinstance(r, dict) for r in rows):
        for kind, prefix in (("invalid", "build:"), ("check", "check:"),
                             ("traffic", "traffic:"),
                             ("dominated", "dominated:")):
            n = sum(1 for r in rows
                    if isinstance(r.get("pruned_by"), str)
                    and r["pruned_by"].startswith(prefix))
            if pruned.get(kind) != n:
                errors.append(f"{w}.pruned[{kind!r}]: counter "
                              f"{pruned.get(kind)!r} != {n} rows with "
                              f"'{prefix}' reasons")

    # --- registration block: exactly the finalists, ids > 100 ---------
    reg = obj.get("registration")
    if not isinstance(reg, dict) or not reg:
        errors.append(f"{where}: missing/invalid 'registration' object")
        reg = {}
    mids = []
    for mid_text, entry in reg.items():
        try:
            mid = int(mid_text)
        except (TypeError, ValueError):
            errors.append(f"{where}.registration: id {mid_text!r} is "
                          f"not an int")
            continue
        mids.append(mid)
        if mid <= 100:
            errors.append(f"{where}.registration: id {mid} is outside "
                          f"the reserved synthesized range (> 100)")
        if not isinstance(entry, dict) \
                or not isinstance(entry.get("composition"), str):
            errors.append(f"{where}.registration[{mid_text}]: missing "
                          f"composition")
    reg_comps = [reg[str(m)].get("composition") for m in sorted(mids)
                 if isinstance(reg.get(str(m)), dict)]
    if finalists and reg_comps != finalists:
        errors.append(f"{where}: registration compositions {reg_comps} "
                      f"!= search finalists {finalists}")

    # --- race block: the tune-v1 discipline ---------------------------
    race = obj.get("race")
    if not isinstance(race, dict):
        errors.append(f"{where}: missing/invalid 'race' object")
        return errors
    w = f"{where}.race"
    for k, types in (("seed", int), ("alpha", float), ("n_boot", int),
                     ("max_batches", int), ("winner", str),
                     ("batches_run", int)):
        _require(race, k, types, errors, w)
    samples = race.get("samples")
    if not isinstance(samples, dict) or not samples:
        errors.append(f"{w}: 'samples' must be a non-empty object "
                      f"(cid -> list of batches)")
        samples = {}
    for cid, batches in samples.items():
        if not isinstance(batches, list) or not all(
                isinstance(b, list) and b and all(_is_num(x) for x in b)
                for b in batches):
            errors.append(f"{w}.samples[{cid!r}]: every batch must be "
                          f"a non-empty list of numbers")
    order = race.get("order")
    if order is not None:
        if not isinstance(order, list) \
                or sorted(order) != sorted(samples):
            errors.append(f"{w}: 'order' must list exactly the sampled "
                          f"candidate ids")
    winner_cid = race.get("winner")
    if samples and isinstance(winner_cid, str) \
            and winner_cid not in samples:
        errors.append(f"{w}: winner {winner_cid!r} has no recorded "
                      f"samples")
    elims = race.get("eliminations")
    eliminated: set = set()
    if not isinstance(elims, list):
        errors.append(f"{w}: 'eliminations' must be a list")
        elims = []
    for i, e in enumerate(elims):
        if not isinstance(e, dict):
            errors.append(f"{w}.eliminations[{i}]: must be an object")
            continue
        for k in ("batch", "candidate", "leader", "ci_pct"):
            if k not in e:
                errors.append(f"{w}.eliminations[{i}]: missing {k!r}")
        eliminated.add(e.get("candidate"))
        for k in ("candidate", "leader"):
            if samples and e.get(k) is not None \
                    and e.get(k) not in samples:
                errors.append(f"{w}.eliminations[{i}]: {k} "
                              f"{e.get(k)!r} has no recorded samples")

    # --- winner: synthesized, verdicts carried, race-consistent -------
    win = obj.get("winner")
    if not isinstance(win, dict):
        errors.append(f"{where}: missing/invalid 'winner' object")
        return errors
    w = f"{where}.winner"
    for k, types in (("cid", str), ("method_id", int),
                     ("median_s", (int, float)), ("synthesized", bool)):
        _require(win, k, types, errors, w)
    if isinstance(win.get("cid"), str) and isinstance(winner_cid, str) \
            and win["cid"] != winner_cid:
        errors.append(f"{w}: cid {win['cid']!r} disagrees with "
                      f"race.winner {winner_cid!r}")
    if win.get("synthesized") is not True:
        errors.append(f"{w}: a committed artifact's winner must be "
                      f"synthesized — a reference-method win is not an "
                      f"artifact")
    else:
        mid = win.get("method_id")
        entry = reg.get(str(mid)) if isinstance(mid, int) else None
        if not isinstance(entry, dict):
            errors.append(f"{w}: method_id {mid!r} is not in the "
                          f"registration block")
        elif entry.get("composition") != win.get("composition"):
            errors.append(f"{w}: composition {win.get('composition')!r} "
                          f"!= registration[{mid}] "
                          f"{entry.get('composition')!r}")
        if win.get("check_verdict") != "PROVEN":
            errors.append(f"{w}: check_verdict must be 'PROVEN', got "
                          f"{win.get('check_verdict')!r}")
        if win.get("traffic_verdict") != "CONFORMS":
            errors.append(f"{w}: traffic_verdict must be 'CONFORMS', "
                          f"got {win.get('traffic_verdict')!r}")
    # the race must actually support the winner: smallest pooled median
    # among the non-eliminated candidates, and median_s must BE that
    # pooled median of its own samples
    if isinstance(winner_cid, str) and winner_cid in samples:
        try:
            meds = {cid: statistics.median(
                        [x for b in batches for x in b])
                    for cid, batches in samples.items()
                    if isinstance(batches, list) and any(
                        isinstance(b, list) and b for b in batches)}
        except (TypeError, statistics.StatisticsError):
            meds = {}
        if meds:
            if winner_cid in meds and _is_num(win.get("median_s")) \
                    and abs(win["median_s"] - meds[winner_cid]) \
                    > 1e-12 * max(1.0, abs(meds[winner_cid])):
                errors.append(f"{w}: median_s {win.get('median_s')!r} "
                              f"!= pooled sample median "
                              f"{meds[winner_cid]!r}")
            for cid, m in meds.items():
                if cid in eliminated or cid == winner_cid:
                    continue
                if winner_cid in meds and m < meds[winner_cid]:
                    errors.append(
                        f"{w}: non-eliminated candidate {cid!r} has a "
                        f"smaller pooled median ({m!r}) than the "
                        f"winner ({meds[winner_cid]!r}) — the verdict "
                        f"contradicts its own samples")
    return errors
