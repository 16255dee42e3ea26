"""Straggler analytics over flight-recorder event logs — jax-free.

The reference benchmark's headline metric is the max-over-ranks
completion time (the per-phase ``MPI_Reduce`` MAX, mpi_test.c:2184), so
the scientifically interesting question is always *which rank/round is
the straggler and by how much*. This module answers it from the trace
stream the flight recorder already captures:

- :func:`round_stats` — per-round distributions over ranks (p50/p95/max,
  skew = max/mean, imbalance share = the fraction of the round's wall
  time attributable to rank skew);
- :func:`critical_path` — attributes the max-over-ranks critical path to
  concrete (rank, round, phase) cells, with the run's column-accurate
  ``PHASE_SOURCES`` provenance label carried through so an attributed
  decomposition can never be read as a measured one;
- :func:`summarize_traces` — the ``cli inspect trace`` view over one or
  MANY trace files (a sweep's per-cell artifacts merge into one
  straggler table instead of erroring on the second file);
- :func:`bootstrap_ci` / :func:`bootstrap_delta_ci` / :func:`sign_test`
  — the statistical kernel shared with the regression gate
  (obs/regress.py) and trace diffing (obs/compare.py). Pure python,
  deterministic (seeded), so verdicts are reproducible byte-for-byte.

Everything here consumes the JSONL event vocabulary of obs/trace.py
(span ``dur_s`` is the EXACT attributed seconds; aggregation replays the
Timer arithmetic via :func:`tpu_aggcomm_torch.obs.trace.aggregate_run`).
Nothing imports jax — bench.py's supervisor may import this freely.
"""

from __future__ import annotations

import math
import random
import statistics

from tpu_aggcomm_torch.obs.trace import (BUCKET_FIELDS, aggregate_run, load_events,
                                   round_key, summarize_events)

__all__ = ["percentile", "bootstrap_ci", "bootstrap_delta_ci", "sign_test",
           "run_events", "bucket_cells", "cell_means", "round_stats",
           "critical_path", "summarize_run", "render_run_analytics",
           "summarize_traces", "PHASE_ORDER"]

#: Phase (bucket) display order — the Timer-column vocabulary in the
#: order obs/trace.py defines it (post, send_wait, recv_wait,
#: recv+send_wait, barrier).
PHASE_ORDER = tuple(BUCKET_FIELDS)


# ---------------------------------------------------------------------------
# Statistical kernel (pure python, deterministic).

def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) of a non-empty
    sequence — the numpy 'linear' method, without numpy."""
    vs = sorted(values)
    if not vs:
        raise ValueError("percentile of empty sequence")
    if len(vs) == 1:
        return float(vs[0])
    pos = (len(vs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return float(vs[lo]) * (1.0 - frac) + float(vs[hi]) * frac


def bootstrap_ci(samples, stat=statistics.median, *, n_boot: int = 2000,
                 alpha: float = 0.05, seed: int = 0) -> tuple[float, float]:
    """Percentile-bootstrap ``1 - alpha`` confidence interval for
    ``stat(samples)``. Seeded — the regression gate's verdict must be
    reproducible from the same artifacts."""
    xs = list(samples)
    if not xs:
        raise ValueError("bootstrap_ci of empty sample")
    rng = random.Random(seed)
    n = len(xs)
    stats = sorted(stat([xs[rng.randrange(n)] for _ in range(n)])
                   for _ in range(n_boot))
    return (percentile(stats, 100.0 * (alpha / 2)),
            percentile(stats, 100.0 * (1 - alpha / 2)))


def bootstrap_delta_ci(baseline, current, stat=statistics.median, *,
                       relative: bool = True, n_boot: int = 2000,
                       alpha: float = 0.05, seed: int = 0
                       ) -> tuple[float, float]:
    """Percentile-bootstrap CI on ``stat(current) - stat(baseline)``
    (independent resampling of the two trial sets — bench trials are
    unpaired across rounds). With ``relative`` the delta is divided by
    ``stat(baseline)``, i.e. the CI is on the relative slowdown the
    regression gate thresholds. Positive = current slower."""
    xs, ys = list(baseline), list(current)
    if not xs or not ys:
        raise ValueError("bootstrap_delta_ci needs non-empty samples")
    rng = random.Random(seed)
    nx, ny = len(xs), len(ys)
    deltas = []
    for _ in range(n_boot):
        bx = stat([xs[rng.randrange(nx)] for _ in range(nx)])
        by = stat([ys[rng.randrange(ny)] for _ in range(ny)])
        d = by - bx
        deltas.append(d / bx if relative else d)
    deltas.sort()
    return (percentile(deltas, 100.0 * (alpha / 2)),
            percentile(deltas, 100.0 * (1 - alpha / 2)))


def sign_test(deltas) -> dict:
    """Two-sided exact sign test over paired deltas (zeros dropped).

    Returns ``{"n": usable pairs, "pos": #positive, "neg": #negative,
    "p": two-sided p-value | None}`` — ``p`` is None when fewer than two
    usable pairs exist (a chained trace has one combined rep; no
    repeated trials means no test, not a fake certainty)."""
    pos = sum(1 for d in deltas if d > 0)
    neg = sum(1 for d in deltas if d < 0)
    n = pos + neg
    if n < 2:
        return {"n": n, "pos": pos, "neg": neg, "p": None}
    k = min(pos, neg)
    # two-sided exact binomial(n, 0.5) tail, doubled and clamped
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return {"n": n, "pos": pos, "neg": neg, "p": min(1.0, 2.0 * tail)}


# ---------------------------------------------------------------------------
# Trace tables.

def run_events(events: list[dict]) -> list[dict]:
    """The run records of an event log, in recording order."""
    return [e for e in events if e["ev"] == "run"]


def bucket_cells(events: list[dict], run_id: int
                 ) -> dict[int, dict[tuple, float]]:
    """``{rep: {(rank, round, bucket): seconds}}`` from one run's
    reconstructed bucket slices (rep envelopes excluded). ``dur_s`` is
    the exact attributed seconds, so sums here stay float-faithful to
    the Timer columns."""
    out: dict[int, dict[tuple, float]] = {}
    for e in events:
        if e["ev"] != "span" or e["run"] != run_id \
                or e["bucket"] == "total":
            continue
        per = out.setdefault(e["rep"], {})
        key = (e["rank"], e["round"], e["bucket"])
        per[key] = per.get(key, 0.0) + e["dur_s"]
    return out


def cell_means(events: list[dict], run_id: int) -> dict[tuple, float]:
    """``{(rank, round): mean seconds across recorded reps}`` — the
    bucket-summed straggler grid one run induces."""
    per_rep = bucket_cells(events, run_id)
    acc: dict[tuple, list[float]] = {}
    for cells in per_rep.values():
        rep_acc: dict[tuple, float] = {}
        for (rank, rnd, _bucket), secs in cells.items():
            rep_acc[(rank, rnd)] = rep_acc.get((rank, rnd), 0.0) + secs
        for key, secs in rep_acc.items():
            acc.setdefault(key, []).append(secs)
    return {k: sum(v) / len(v) for k, v in acc.items()}


def round_stats(events: list[dict], run_id: int) -> list[dict]:
    """Per-round distribution over ranks of the mean-across-reps cell
    grid, in program order. Each entry::

        {"round", "ranks", "wall", "mean", "p50", "p95", "max",
         "skew", "imbalance", "critical_rank"}

    ``wall`` (= ``max``) is the round's wall time under the recorder's
    geometry (each round as wide as its slowest rank); ``skew`` is
    max/mean; ``imbalance`` = (max - mean) / max, the share of the
    round's wall time that pure rank balance would reclaim."""
    grid = cell_means(events, run_id)
    by_round: dict = {}
    for (rank, rnd), secs in grid.items():
        by_round.setdefault(rnd, {})[rank] = secs
    out = []
    for rnd in sorted(by_round, key=round_key):
        per_rank = by_round[rnd]
        vals = list(per_rank.values())
        mx = max(vals)
        mean = sum(vals) / len(vals)
        crit = max(per_rank, key=per_rank.get)
        out.append({
            "round": rnd, "ranks": len(vals), "wall": mx, "mean": mean,
            "p50": percentile(vals, 50), "p95": percentile(vals, 95),
            "max": mx,
            "skew": (mx / mean) if mean > 0 else None,
            "imbalance": ((mx - mean) / mx) if mx > 0 else 0.0,
            "critical_rank": crit})
    return out


def critical_path(events: list[dict], run_id: int) -> dict | None:
    """Attribute the max-over-ranks critical path of one run.

    The critical rank is the arg-max of the re-aggregated Timer totals
    (exactly the rank the reference's MAX-reduce reports); its time is
    then decomposed into (round, phase) cells (mean across reps),
    largest first. Returns None when the run recorded no slices.
    ``phase_source`` is the run's column-accurate PHASE_SOURCES label —
    the provenance of every cell below it."""
    run = next((e for e in events
                if e["ev"] == "run" and e["id"] == run_id), None)
    agg = aggregate_run(events, run_id)
    if run is None or not agg:
        return None
    crit = max(agg, key=lambda r: agg[r]["total"])
    total = agg[crit]["total"]
    per_rep = bucket_cells(events, run_id)
    acc: dict[tuple, list[float]] = {}
    for cells in per_rep.values():
        for (rank, rnd, bucket), secs in cells.items():
            if rank == crit:
                acc.setdefault((rnd, bucket), []).append(secs)
    cells_out = sorted(
        ({"round": rnd, "bucket": bucket,
          "seconds": sum(v) / len(v),
          "share": (sum(v) / len(v)) / total if total > 0 else None}
         for (rnd, bucket), v in acc.items()),
        key=lambda c: -c["seconds"])
    return {"rank": crit, "total": total,
            "phase_source": run["phase_source"],
            "method": run["method"], "name": run["name"],
            "dominant": cells_out[0] if cells_out else None,
            "cells": cells_out}


def summarize_run(events: list[dict], run_id: int) -> dict:
    """One run's full analytics bundle: the run record, per-round
    distributions, and the critical-path attribution."""
    run = next(e for e in events
               if e["ev"] == "run" and e["id"] == run_id)
    return {"run": run, "rounds": round_stats(events, run_id),
            "critical": critical_path(events, run_id)}


def _fmt_round(rnd) -> str:
    from tpu_aggcomm_torch.obs.trace import WHOLE_REP
    if rnd == WHOLE_REP:
        return "whole-rep"
    return f"round {rnd}" if isinstance(rnd, int) else str(rnd)


def render_run_analytics(events: list[dict], run_id: int) -> str:
    """Per-round skew table + critical-path attribution, as text lines
    (appended under each run's base summary by ``inspect trace``)."""
    lines = []
    for rs in round_stats(events, run_id):
        skew = f"{rs['skew']:.2f}" if rs["skew"] is not None else "-"
        lines.append(
            f"    {_fmt_round(rs['round']):>10}: "
            f"p50 {rs['p50'] * 1e3:9.3f}  p95 {rs['p95'] * 1e3:9.3f}  "
            f"max {rs['max'] * 1e3:9.3f} ms  skew {skew}  "
            f"imbalance {rs['imbalance'] * 100:4.1f}%  "
            f"critical rank {rs['critical_rank']}")
    cp = critical_path(events, run_id)
    if cp is not None and cp["dominant"] is not None:
        d = cp["dominant"]
        lines.append(
            f"  critical path: rank {cp['rank']} "
            f"({cp['total'] * 1e3:.3f} ms total), dominant cell "
            f"{_fmt_round(d['round'])} [{d['bucket']}] = "
            f"{d['seconds'] * 1e3:.3f} ms "
            f"({d['share'] * 100:.0f}% of total)  "
            f"[src: {cp['phase_source']}]")
    return "\n".join(lines)


def summarize_traces(paths: list[str]) -> str:
    """``cli inspect trace`` over one or many trace files.

    One file reproduces the single-file summary plus the skew/critical-
    path analytics. Many files (a sweep's per-cell artifacts) get one
    section per file and a merged straggler table across every run of
    every file — the cross-cell view a sweep exists to produce."""
    sections = []
    merged: list[tuple] = []            # (file, run_id, critical dict)
    for path in paths:
        events = load_events(path)
        body = summarize_events(events).rstrip("\n")
        extra = []
        for run in run_events(events):
            block = render_run_analytics(events, run["id"])
            if block:
                extra.append(f"run {run['id']} straggler analytics "
                             f"(over ranks, mean across reps):")
                extra.append(block)
            cp = critical_path(events, run["id"])
            if cp is not None:
                merged.append((path, run["id"], cp))
        head = f"== {path} ==" if len(paths) > 1 else None
        sections.append("\n".join(
            ([head] if head else []) + [body] + extra))
    if len(paths) > 1:
        lines = [f"== merged straggler summary: {len(paths)} files, "
                 f"{len(merged)} runs =="]
        for path, rid, cp in merged:
            d = cp["dominant"]
            dom = (f"{_fmt_round(d['round'])} [{d['bucket']}] "
                   f"{d['seconds'] * 1e3:.3f} ms "
                   f"({d['share'] * 100:.0f}%)"
                   if d is not None else "-")
            lines.append(
                f"  {path}: run {rid} m={cp['method']} "
                f"\"{cp['name']}\"  critical rank {cp['rank']} "
                f"total {cp['total'] * 1e3:.3f} ms  dominant {dom}")
        if merged:
            worst = max(merged, key=lambda t: t[2]["total"])
            lines.append(
                f"  slowest critical path: {worst[0]} run {worst[1]} "
                f"(rank {worst[2]['rank']}, "
                f"{worst[2]['total'] * 1e3:.3f} ms)")
        sections.append("\n".join(lines))
    return "\n".join(sections) + "\n"
