"""The statistical racing loop — jax-free, deterministic, replayable.

Successive elimination against a running leader: every surviving
candidate gets one batch of chained differenced trials per round, and a
candidate is dropped only when the seeded percentile-bootstrap CI on
the relative median delta of its POOLED samples vs the current
leader's excludes zero on the slow side
(``obs/metrics.bootstrap_delta_ci`` — the exact kernel the regression
gate uses, same seed discipline). No p-hacking knobs: the CI seed, the
alpha, and the candidate order are all recorded in the artifact, so
feeding the recorded samples back through :func:`race` reproduces the
elimination sequence and winner byte for byte. That replay
(:func:`replay_record`) is what ``cli tune --replay`` and the tier-1 CI
step run — on a machine where jax may not even import.

Sampler contract: ``sampler(cid, batch_index) -> list[float]`` returns
that batch's per-trial seconds for one candidate. The real sampler
(tune/measure.py) runs fresh chained trials; the synthetic sampler
(:func:`make_synthetic_sampler`) draws from a seeded injected-skew
model; the replay sampler replays the recorded lists. All three drive
the SAME loop.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

from tpu_aggcomm_torch.obs.metrics import bootstrap_delta_ci

__all__ = ["RaceResult", "RaceError", "race", "replay_record",
           "make_synthetic_sampler"]


class RaceError(ValueError):
    """Unusable racing input (no candidates, empty batch, truncated
    replay record)."""


@dataclass
class RaceResult:
    """Everything the TUNE artifact persists about one race."""

    winner: str
    eliminations: list[dict]
    #: cid -> per-batch sample lists; a candidate has exactly as many
    #: batches as rounds it survived, which is what makes the record
    #: replayable without a backend.
    samples: dict[str, list[list[float]]] = field(default_factory=dict)
    batches_run: int = 0
    survivors: list[str] = field(default_factory=list)

    def medians(self) -> dict[str, float]:
        return {cid: statistics.median([x for b in batches for x in b])
                for cid, batches in self.samples.items() if any(batches)}


def race(cids, sampler, *, max_batches: int = 6, alpha: float = 0.05,
         seed: int = 0, n_boot: int = 2000) -> RaceResult:
    """Run the racing loop over candidate ids in the given order.

    Per batch: every survivor samples once; the leader is the survivor
    with the smallest pooled median (ties broken by input order — part
    of the determinism contract); every other survivor whose delta-CI
    vs the leader excludes zero on the slow side is eliminated, in
    input order, against the leader chosen at the START of the batch
    (re-electing mid-batch would make the elimination order depend on
    dict iteration details instead of the recorded sample lists). The
    race ends when one survivor remains or ``max_batches`` is
    exhausted; the final leader is the winner either way.
    """
    order = [str(c) for c in cids]
    if not order:
        raise RaceError("race needs at least one candidate")
    if len(set(order)) != len(order):
        raise RaceError("duplicate candidate ids in the race")
    samples: dict[str, list[list[float]]] = {c: [] for c in order}
    survivors = list(order)
    eliminations: list[dict] = []
    batches_run = 0

    def pooled(cid: str) -> list[float]:
        return [x for b in samples[cid] for x in b]

    for batch in range(max_batches):
        if len(survivors) <= 1:
            break
        for cid in survivors:
            got = [float(x) for x in sampler(cid, batch)]
            if not got:
                raise RaceError(f"sampler returned an empty batch for "
                                f"{cid} (batch {batch})")
            samples[cid].append(got)
        batches_run = batch + 1
        meds = {c: statistics.median(pooled(c)) for c in survivors}
        leader = min(survivors, key=lambda c: (meds[c], order.index(c)))
        still = []
        for cid in survivors:
            if cid == leader:
                still.append(cid)
                continue
            lo, hi = bootstrap_delta_ci(pooled(leader), pooled(cid),
                                        relative=True, alpha=alpha,
                                        seed=seed, n_boot=n_boot)
            if lo > 0:
                eliminations.append({
                    "batch": batch, "candidate": cid, "leader": leader,
                    "ci_pct": [lo * 100.0, hi * 100.0],
                    "median_candidate": meds[cid],
                    "median_leader": meds[leader]})
            else:
                still.append(cid)
        survivors = still

    meds = {c: statistics.median(pooled(c)) for c in survivors}
    winner = min(survivors, key=lambda c: (meds[c], order.index(c)))
    return RaceResult(winner=winner, eliminations=eliminations,
                      samples=samples, batches_run=batches_run,
                      survivors=survivors)


def replay_record(race_rec: dict) -> RaceResult:
    """Re-derive the race verdict from a recorded ``race`` block
    (artifact schema tune-v1): the recorded per-candidate batch lists
    drive the identical loop with the recorded seed/alpha/n_boot — the
    bootstrap is seeded, so the eliminations and winner come out byte
    for byte or the artifact is inconsistent. Raises RaceError on a
    truncated record (a candidate asked for a batch it never stored)."""
    recorded = race_rec.get("samples") or {}
    order = race_rec.get("order") or list(recorded)

    def sampler(cid: str, batch: int) -> list[float]:
        batches = recorded.get(cid, [])
        if batch >= len(batches):
            raise RaceError(f"replay: {cid} has no recorded batch "
                            f"{batch} (record truncated?)")
        return batches[batch]

    return race(order, sampler,
                max_batches=int(race_rec.get("max_batches", 6)),
                alpha=float(race_rec.get("alpha", 0.05)),
                seed=int(race_rec.get("seed", 0)),
                n_boot=int(race_rec.get("n_boot", 2000)))


def make_synthetic_sampler(spec: str, *, batch_trials: int = 3,
                           seed: int = 0, jitter: float = 0.03):
    """A deterministic injected-skew sampler for tests and jax-free
    smoke runs: ``spec`` is ``"BASE_US[,mID*FACTOR]..."`` — every
    candidate's latency is gaussian around BASE_US microseconds, scaled
    by its method's FACTOR (default 1.0). ``"100,m3*0.5"`` makes every
    m=3 candidate the 2x-faster oracle winner the convergence test
    checks for. Samples are seeded per (seed, cid, batch): the same
    spec always yields the same race."""
    import random

    from tpu_aggcomm_torch.faults.spec import FaultSpecError, parse_synthetic

    # the grammar parser lives with the fault grammar (faults/spec.py) so
    # both injected-skew surfaces share one parser; re-wrap its error in
    # the tuner's exception type
    try:
        base_s, factors = parse_synthetic(spec)
    except FaultSpecError as e:
        raise RaceError(str(e)) from None

    from tpu_aggcomm_torch.tune.space import parse_cid

    def sampler(cid: str, batch: int) -> list[float]:
        mean = base_s * factors.get(parse_cid(cid).method, 1.0)
        rng = random.Random(f"{seed}:{cid}:{batch}")
        return [max(mean * 0.1, rng.gauss(mean, jitter * mean))
                for _ in range(batch_trials)]

    return sampler
