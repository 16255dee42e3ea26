"""Schema validation of the port's artifacts and its OpenMetrics text.

The part of ``tpu_aggcomm/obs/regress.py`` that the port's commands
need, copied (import paths rewritten): :func:`validate_tune`
(``TUNE_*.json``; ``tune/cache.lookup`` and ``tune --replay`` reject a
corrupt or inconsistent artifact by name), :func:`validate_synth`
(``SYNTH_r*.json``, ``synth --replay``), :func:`validate_watch`
(``WATCH_r*.json``, re-deriving its SLO evaluation, changepoints and
verdicts), :func:`validate_pilot` (``PILOT_r*.json``, ``pilot
--replay``) and :func:`parse_openmetrics` / :func:`validate_openmetrics`
(the ``/metrics`` text of ``serve`` and ``sweep --metrics-port``), with
their helpers and schema tags. The bench-history gate and the other
artifact validators come with the ``inspect`` slice (ROADMAP.md queue
A).

No torch anywhere here: the replay paths import this module.
"""

from __future__ import annotations

import re

__all__ = ["validate_tune", "validate_synth", "TUNE_SCHEMAS",
           "SYNTH_SCHEMAS", "parse_openmetrics", "validate_openmetrics",
           "validate_watch", "WATCH_SCHEMAS", "validate_pilot",
           "PILOT_SCHEMAS"]


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


# ---------------------------------------------------------------------------
# OpenMetrics text parsing — the CI telemetry gate's validator for what
# obs/export.py renders. Deliberately small: it understands the subset
# this repo emits (TYPE lines; counter/gauge/histogram/summary samples
# with optional labels), not the full exposition grammar.

_SAMPLE_RE = re.compile(
    r'^([A-Za-z_:][A-Za-z0-9_:]*)(\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse_openmetrics(text: str) -> dict:
    """Parse OpenMetrics text into ``{"families": {name: type},
    "samples": [{"name", "labels", "value"}], "eof": bool}``.

    Raises ``ValueError`` on a line that is neither a comment, blank,
    TYPE declaration nor a well-formed sample — a torn or hand-mangled
    exposition must fail loudly, not half-parse."""
    families: dict[str, str] = {}
    samples: list[dict] = []
    eof = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if eof:
            raise ValueError(f"line {lineno}: content after # EOF")
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if parts[:2] == ["#", "EOF"] and len(parts) == 2:
                eof = True
            elif parts[:2] == ["#", "TYPE"]:
                if len(parts) != 4:
                    raise ValueError(f"line {lineno}: malformed TYPE "
                                     f"line {line!r}")
                families[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: not a metric sample: "
                             f"{line!r}")
        name, _, rawlabels, rawvalue = m.groups()
        labels = {k: v.replace('\\"', '"').replace("\\n", "\n")
                  .replace("\\\\", "\\")
                  for k, v in _LABEL_RE.findall(rawlabels or "")}
        try:
            value = _parse_value(rawvalue)
        except ValueError:
            raise ValueError(f"line {lineno}: unparseable value "
                             f"{rawvalue!r}")
        samples.append({"name": name, "labels": labels, "value": value})
    return {"families": families, "samples": samples, "eof": eof}


_SUFFIXES = ("_bucket", "_count", "_sum", "_total")


def _family_of(name: str, families: dict) -> str | None:
    """The declared family a sample belongs to (longest match wins:
    ``x_exact`` summary samples must bind to the ``x_exact`` family,
    not to histogram ``x`` via a bogus suffix split)."""
    candidates = [name] + [name[:-len(s)] for s in _SUFFIXES
                           if name.endswith(s)]
    for cand in sorted(candidates, key=len, reverse=True):
        if cand in families:
            return cand
    return None


def validate_openmetrics(text: str) -> list[str]:
    """Schema errors (empty list = valid) for an OpenMetrics exposition
    as obs/export.py renders it: must end with ``# EOF``; every sample
    must belong to a declared TYPE family; histogram buckets must be
    cumulative (non-decreasing in ``le`` order) with the ``+Inf``
    bucket equal to ``_count``; summary quantile labels must lie in
    [0, 1]. A parse failure is a single-error verdict."""
    try:
        parsed = parse_openmetrics(text)
    except ValueError as e:
        return [f"openmetrics: {e}"]
    errors: list[str] = []
    if not parsed["eof"]:
        errors.append("openmetrics: missing # EOF terminator")
    families = parsed["families"]
    hists: dict[tuple, dict] = {}
    for s in parsed["samples"]:
        fam = _family_of(s["name"], families)
        if fam is None:
            errors.append(f"openmetrics: sample {s['name']!r} has no "
                          f"TYPE declaration")
            continue
        ftype = families[fam]
        if ftype == "summary" and "quantile" in s["labels"]:
            try:
                q = float(s["labels"]["quantile"])
            except ValueError:
                q = -1.0
            if not 0.0 <= q <= 1.0:
                errors.append(f"openmetrics: {fam}: quantile label "
                              f"{s['labels']['quantile']!r} outside "
                              f"[0, 1]")
        if ftype != "histogram":
            continue
        key = (fam, tuple(sorted((k, v) for k, v in s["labels"].items()
                                 if k != "le")))
        h = hists.setdefault(key, {"buckets": [], "count": None,
                                   "sum_seen": False})
        if s["name"] == fam + "_bucket":
            le = s["labels"].get("le")
            if le is None:
                errors.append(f"openmetrics: {fam}: bucket without an "
                              f"'le' label")
                continue
            h["buckets"].append((_parse_value(le), s["value"]))
        elif s["name"] == fam + "_count":
            h["count"] = s["value"]
        elif s["name"] == fam + "_sum":
            h["sum_seen"] = True
    for (fam, labels), h in sorted(hists.items()):
        where = f"openmetrics: {fam}{dict(labels) if labels else ''}"
        buckets = sorted(h["buckets"])
        if not buckets:
            errors.append(f"{where}: histogram with no buckets")
            continue
        counts = [c for _le, c in buckets]
        if any(b > a for a, b in zip(counts[1:], counts)):
            errors.append(f"{where}: bucket counts not cumulative")
        if buckets[-1][0] != float("inf"):
            errors.append(f"{where}: missing le=+Inf bucket")
        elif h["count"] is not None and buckets[-1][1] != h["count"]:
            errors.append(f"{where}: +Inf bucket {buckets[-1][1]} != "
                          f"_count {h['count']}")
        if h["count"] is None:
            errors.append(f"{where}: missing _count sample")
        if not h["sum_seen"]:
            errors.append(f"{where}: missing _sum sample")
    return errors


WATCH_SCHEMAS = ("watch-v1",)

_WATCH_STATUSES = ("done", "fail", "shed", "lost")


def validate_watch(obj, where: str = "WATCH") -> list[str]:
    """Schema errors (empty list = valid) for one ``WATCH_r*.json``
    watchtower artifact (obs/watch.py).

    The validate_workload discipline applied to verdicts: every
    request's ``wall_s`` must equal its canonical phase sum, the whole
    SLO evaluation must re-derive from the artifact's own ``per_request``
    rows + embedded spec through the same ``evaluate_slo`` arithmetic
    (float-exact by identical computation), the request-walls
    changepoint must re-derive from the rows + seed, and EVERY anomaly's
    root-cause verdict must re-derive from the blob's own rows +
    evidence blocks through the same ``attribute_anomaly`` chain —
    naming an evidence stream the blob does not support, or a bare
    unquantified UNEXPLAINED, is schema-invalid. Freshness against the
    source streams is the separate ``replay_watch`` gate."""
    import json as _json

    from tpu_aggcomm_torch.obs import watch as _watch
    from tpu_aggcomm_torch.obs.slo import validate_slo as _validate_slo

    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"{where}: top level must be an object"]
    schema = obj.get("schema")
    if schema not in WATCH_SCHEMAS:
        errors.append(f"{where}: unknown schema tag {schema!r} "
                      f"(expected one of {list(WATCH_SCHEMAS)})")
        return errors
    _require(obj, "created_unix", (int, float), errors, where)
    _require(obj, "seed", int, errors, where)
    man = obj.get("manifest")
    if man is not None and not isinstance(man, dict):
        errors.append(f"{where}: 'manifest' must be an object or null")
    journals = obj.get("journals")
    if not isinstance(journals, list) or not journals \
            or not all(isinstance(j, str) for j in journals):
        errors.append(f"{where}: 'journals' must be a non-empty list of "
                      f"journal basenames")
    traces = obj.get("traces")
    if not isinstance(traces, list) \
            or not all(isinstance(t, str) for t in traces):
        errors.append(f"{where}: 'traces' must be a list of trace "
                      f"basenames")
    probs = obj.get("problems")
    if not isinstance(probs, list):
        errors.append(f"{where}: 'problems' must be a list")
    elif probs:
        errors.append(f"{where}: artifact carries {len(probs)} "
                      f"problem(s) (first: {probs[0]!r}) — a journal "
                      f"that disagrees with itself must not be "
                      f"committed as an artifact")
    slo = obj.get("slo")
    slo_errs = _validate_slo(slo, where=f"{where}.slo")
    errors.extend(slo_errs)

    rows = obj.get("per_request")
    if not isinstance(rows, list):
        return errors + [f"{where}: 'per_request' must be a list"]
    counts = {"done": 0, "fail": 0, "shed": 0}
    lost_rows: list = []
    prev_rid = None
    from tpu_aggcomm_torch.obs.workload import BOUNDARIES as _BOUNDS
    for i, r in enumerate(rows):
        w = f"{where}.per_request[{i}]"
        if not isinstance(r, dict):
            errors.append(f"{w}: must be an object")
            continue
        rid = r.get("rid")
        if prev_rid is not None and isinstance(rid, int) \
                and rid <= prev_rid:
            errors.append(f"{w}: rows must be sorted by rid "
                          f"({rid} after {prev_rid})")
        prev_rid = rid if isinstance(rid, int) else prev_rid
        status = r.get("status")
        if status not in _WATCH_STATUSES:
            errors.append(f"{w}: status {status!r} not in "
                          f"{_WATCH_STATUSES}")
        elif status == "lost":
            lost_rows.append(rid)
        else:
            counts[status] += 1
        phases = r.get("phases")
        if not isinstance(phases, dict):
            errors.append(f"{w}: 'phases' must be an object")
            continue
        # wall_s is DEFINED as the canonical-order sum (the
        # validate_workload discipline — identical computation)
        want_wall = [phases[b] for b in _BOUNDS if b in phases]
        want_wall = sum(want_wall) if want_wall else None
        if r.get("wall_s") != want_wall:
            errors.append(f"{w}: wall_s {r.get('wall_s')!r} != sum of "
                          f"phase durations in canonical order "
                          f"== {want_wall!r}")

    req = obj.get("requests")
    if not isinstance(req, dict):
        errors.append(f"{where}: 'requests' must be an object")
    else:
        for k, have in (("completed", counts["done"]),
                        ("failed", counts["fail"]),
                        ("shed", counts["shed"])):
            want = req.get(k)
            if isinstance(want, int) and want != have:
                errors.append(f"{where}: requests.{k} claims {want} but "
                              f"the per_request rows re-derive {have}")
        lost = req.get("lost")
        if not isinstance(lost, list):
            errors.append(f"{where}.requests: 'lost' must be a list")
        elif sorted(lost, key=repr) != sorted(lost_rows, key=repr):
            errors.append(f"{where}: requests.lost claims {lost} but "
                          f"the per_request rows re-derive "
                          f"{sorted(lost_rows, key=repr)}")
    integ = obj.get("integrity")
    if not isinstance(integ, dict):
        errors.append(f"{where}: 'integrity' must be an object")
    else:
        for k in ("journal_torn_lines", "trace_torn_lines"):
            v = integ.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                errors.append(f"{where}.integrity: {k!r} must be a "
                              f"non-negative int, got {v!r}")
        if isinstance(req, dict) and isinstance(req.get("lost"), list) \
                and integ.get("lost_requests") != req["lost"]:
            errors.append(f"{where}: integrity.lost_requests "
                          f"{integ.get('lost_requests')!r} != "
                          f"requests.lost {req['lost']!r}")

    # -- the SLO evaluation must re-derive from rows + embedded spec -------
    if not slo_errs:
        try:
            want_eval = _watch.evaluate_slo(rows, slo)
        except Exception as e:  # lint: broad-ok (validation must report malformed rows as schema errors, not crash the checker)
            return errors + [f"{where}: per_request rows do not "
                             f"evaluate: {type(e).__name__}: {e}"]
        if _json.dumps(obj.get("evaluation"), sort_keys=True) \
                != _json.dumps(want_eval, sort_keys=True):
            errors.append(f"{where}: 'evaluation' does not re-derive "
                          f"from per_request rows + the embedded SLO "
                          f"spec float-exactly (the evaluate_slo "
                          f"arithmetic) — burn rates and compliance "
                          f"flags its own rows contradict")

    # -- anomalies: detection + attribution must re-derive -----------------
    anomalies = obj.get("anomalies")
    evidence = obj.get("evidence")
    if not isinstance(anomalies, list):
        errors.append(f"{where}: 'anomalies' must be a list")
        anomalies = []
    if not isinstance(evidence, dict):
        errors.append(f"{where}: 'evidence' must be an object")
        evidence = {}
    seed = obj.get("seed", 0)
    walls_rows = [r for r in rows if isinstance(r, dict)
                  and isinstance(r.get("wall_s"), (int, float))]
    want_det = None
    if isinstance(seed, int):
        try:
            want_det = _watch.detect_changepoint(
                [r["wall_s"] for r in walls_rows], seed=seed)
        except Exception as e:  # lint: broad-ok (validation must report malformed rows as schema errors, not crash the checker)
            errors.append(f"{where}: request walls do not scan: "
                          f"{type(e).__name__}: {e}")
    req_anoms = [a for a in anomalies if isinstance(a, dict)
                 and a.get("stream") == "request-walls"]
    if want_det is None and req_anoms:
        errors.append(f"{where}: a request-walls anomaly is recorded "
                      f"but the rows + seed re-derive no confirmed "
                      f"changepoint")
    if want_det is not None and not req_anoms and not probs:
        errors.append(f"{where}: the rows + seed re-derive a confirmed "
                      f"request-walls changepoint (index "
                      f"{want_det['index']}) the artifact omits")
    for i, a in enumerate(anomalies):
        w = f"{where}.anomalies[{i}]"
        if not isinstance(a, dict):
            errors.append(f"{w}: must be an object")
            continue
        det = a.get("detection")
        if not isinstance(det, dict):
            errors.append(f"{w}: 'detection' must be an object")
            continue
        if a.get("evidence") not in _watch.EVIDENCE_STREAMS:
            errors.append(f"{w}: evidence {a.get('evidence')!r} not in "
                          f"{_watch.EVIDENCE_STREAMS} — every verdict "
                          f"must name its evidence stream")
        if not isinstance(a.get("cause"), str) or not a.get("cause"):
            errors.append(f"{w}: 'cause' must be a non-empty string — "
                          f"a bare ANOMALY is a regression")
        if a.get("cause") == "UNEXPLAINED" \
                and "%" not in str(a.get("detail", "")):
            errors.append(f"{w}: an UNEXPLAINED verdict must quantify "
                          f"the residual")
        if a.get("stream") == "request-walls":
            if want_det is not None and _json.dumps(det, sort_keys=True) \
                    != _json.dumps(want_det, sort_keys=True):
                errors.append(f"{w}: detection does not re-derive from "
                              f"the rows + seed (seeded changepoint "
                              f"verdicts must be reproducible)")
            split_rid, expl = a.get("at_rid"), None
        else:
            stream = str(a.get("stream", ""))
            key = stream.split(":", 1)[1] if ":" in stream else None
            split_rid = None
            expl = (evidence.get("explain") or {}).get(key)
        try:
            want_v = _watch.attribute_anomaly(
                det, rows=rows, evidence=evidence, split_rid=split_rid,
                explain_rounds=expl)
        except Exception as e:  # lint: broad-ok (validation must report malformed evidence as schema errors, not crash the checker)
            errors.append(f"{w}: evidence does not attribute: "
                          f"{type(e).__name__}: {e}")
            continue
        got_v = {k: a.get(k) for k in ("cause", "evidence", "detail")}
        if _json.dumps(got_v, sort_keys=True) \
                != _json.dumps(want_v, sort_keys=True):
            errors.append(f"{w}: the root-cause verdict does not "
                          f"re-derive from the blob's own rows + "
                          f"evidence blocks (attribute_anomaly): "
                          f"artifact {got_v} vs re-derived {want_v}")
    return errors


#: Valid ``schema`` tags for PILOT_r*.json (tpu_aggcomm/pilot/ — the
#: ``cli pilot`` output) — versioned like TUNE_SCHEMAS.
PILOT_SCHEMAS = ("pilot-v1",)


def validate_pilot(obj, where: str = "PILOT") -> list[str]:
    """Validate one PILOT_r*.json blob (pilot-v1) and re-derive every
    claim re-derivable from the artifact ALONE: each campaign's race
    verdict from its recorded samples, the win CI and improvement flag
    from the recorded numbers (pilot/campaign.replay_campaign with the
    search left to ``pilot --replay`` — re-running the seeded search
    per artifact is the stream-level gate's job), every decision from
    the one decision arithmetic over the recorded swap evidence, every
    promotion record through validate_promotion_record, and each
    demotion action against its own recorded detection. An artifact
    whose own rows contradict a promotion it claims is schema-invalid —
    the zero-silent-method-changes contract, enforced at validation
    time. jax-free."""
    import json as _json

    from tpu_aggcomm_torch.pilot.artifact import derive_decision
    from tpu_aggcomm_torch.pilot.campaign import replay_campaign
    from tpu_aggcomm_torch.pilot.promote import validate_promotion_record

    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"{where}: artifact must be a JSON object, got "
                f"{type(obj).__name__}"]
    w = where
    schema = obj.get("schema")
    if schema not in PILOT_SCHEMAS:
        errors.append(f"{w}: unknown schema {schema!r} "
                      f"(expected one of {list(PILOT_SCHEMAS)})")
        return errors
    _require(obj, "manifest", dict, errors, w)
    _require(obj, "created_unix", (int, float), errors, w)
    _require(obj, "seed", int, errors, w)
    _require(obj, "mode", str, errors, w)
    _require(obj, "journals", list, errors, w)
    _require(obj, "fingerprint", str, errors, w)
    _require(obj, "requests", dict, errors, w)
    _require(obj, "proposals", list, errors, w)
    _require(obj, "targets", list, errors, w)
    _require(obj, "demotions", list, errors, w)
    _require(obj, "campaigns", list, errors, w)
    _require(obj, "decisions", list, errors, w)
    _require(obj, "promotions", list, errors, w)
    _require(obj, "race_opts", dict, errors, w)
    _require(obj, "per_shape", dict, errors, w, nullable=True)
    if errors:
        return errors
    if obj["mode"] not in ("live", "dry-run"):
        errors.append(f"{w}: mode must be 'live' or 'dry-run', got "
                      f"{obj['mode']!r}")
    for i, ent in enumerate(obj["journals"]):
        if not isinstance(ent, dict) or not isinstance(
                ent.get("name"), str) or not isinstance(
                ent.get("lines"), int):
            errors.append(f"{w}: journals[{i}] must be "
                          f"{{name: str, lines: int}}, got {ent!r}")

    inputs = obj.get("inputs") or {}
    for i, c in enumerate(obj["campaigns"]):
        for p in replay_campaign(c, params=inputs.get("params"),
                                 params_source=inputs.get("params_source"),
                                 rerun_search=False):
            errors.append(f"{w}: campaigns[{i}]: {p}")

    # the decision arithmetic over the artifact's own evidence
    active = [t for t in obj["targets"]
              if isinstance(t, dict) and t.get("skipped") is None]
    if len(active) != len(obj["campaigns"]) \
            or len(obj["campaigns"]) != len(obj["decisions"]):
        errors.append(f"{w}: {len(active)} active target(s) vs "
                      f"{len(obj['campaigns'])} campaign(s) vs "
                      f"{len(obj['decisions'])} decision(s) — the "
                      f"decision trace is truncated")
    else:
        for t, c, d_rec in zip(active, obj["campaigns"],
                               obj["decisions"]):
            try:
                want = derive_decision(
                    t, c, mode=obj["mode"],
                    fingerprint=obj["fingerprint"],
                    swap=(d_rec or {}).get("swap"))
            except Exception as e:  # lint: broad-ok (validation must report a malformed campaign as a schema error, not crash the checker)
                errors.append(f"{w}: decision for "
                              f"{c.get('incumbent_cid')} does not "
                              f"re-derive: {type(e).__name__}: {e}")
                continue
            if _json.dumps(want, sort_keys=True) \
                    != _json.dumps(d_rec, sort_keys=True):
                errors.append(
                    f"{w}: decision for {c.get('incumbent_cid')} "
                    f"contradicts the one decision arithmetic over its "
                    f"own campaign + swap evidence (recorded "
                    f"{(d_rec or {}).get('action')!r})")
        want_promos = [d["record"] for d in obj["decisions"]
                       if isinstance(d, dict)
                       and d.get("action") == "promote"]
        if _json.dumps(want_promos, sort_keys=True) \
                != _json.dumps(obj["promotions"], sort_keys=True):
            errors.append(f"{w}: promotions must be exactly the "
                          f"promote-decision records")

    for i, rec in enumerate(obj["promotions"]):
        for p in validate_promotion_record(rec):
            errors.append(f"{w}: promotions[{i}]: {p}")

    for i, row in enumerate(obj["demotions"]):
        if not isinstance(row, dict):
            errors.append(f"{w}: demotions[{i}] must be an object")
            continue
        det = row.get("detection")
        regressed = isinstance(det, dict) \
            and det.get("direction") == "up"
        want_action = "demote" if regressed else "hold"
        if row.get("action") != want_action:
            errors.append(
                f"{w}: demotions[{i}] action {row.get('action')!r} "
                f"contradicts its own recorded detection "
                f"({'confirmed up-step' if regressed else 'no confirmed regression'})")
        for p in validate_promotion_record(row.get("record")):
            errors.append(f"{w}: demotions[{i}].record: {p}")
    return errors
