"""One campaign: candidates -> race -> measured win vs the incumbent.

A campaign takes one folded target (pilot/plan.py) and produces the
evidence a promotion needs, under the synthesis discipline unchanged:

- **Candidates** — the dispatched reference field of the incumbent's
  direction, references first (ties break toward the field, so a
  challenger never wins on order). A ``bursty-arrivals`` target
  additionally runs the seeded synth search at the target cell
  (checker refutations = hard pruning, static ``-c`` conformance, cost
  model only ORDERS — synth/search.py verbatim) and registers the
  finalists into the reserved id range before racing them.
- **Race** — ``tune.race.race`` on FRESH samples (the caller supplies
  the sampler: tune/measure.py's torch_sim sampler for measured runs —
  the one torch door — or the seeded synthetic sampler for smoke), with
  seeded-bootstrap eliminations.
- **Win CI** — the promotion evidence is a DIRECT seeded-bootstrap CI
  of the winner's pooled samples vs the incumbent's
  (``obs.metrics.bootstrap_delta_ci``, the regression-gate kernel) —
  never an elimination side-effect. ``improved`` is True only when the
  winner differs from the incumbent AND the CI excludes zero.

Everything lands in the campaign row; :func:`replay_campaign`
re-derives the search block from (config, seed, params), the race
verdict from the recorded samples and the win CI + improved flag from
the recorded numbers — byte-for-byte, torch-free.

The copy of ``tpu_aggcomm/pilot/campaign.py`` (import paths rewritten,
nothing else changed).
"""

from __future__ import annotations

import json

from tpu_aggcomm_torch.tune import race as race_mod
from tpu_aggcomm_torch.tune.space import Candidate, parse_cid

__all__ = ["CampaignError", "run_campaign", "replay_campaign"]

#: Search knobs for campaign-embedded synthesis — smaller than the
#: offline `cli synth` defaults (a campaign prices many targets per
#: pilot pass), recorded in the search block so replay re-runs the
#: same search.
SEARCH_OPTS = {"init": 16, "mutate_rounds": 2, "beam": 3, "top_k": 2}


class CampaignError(ValueError):
    """Unusable campaign input (no candidates, a target whose incumbent
    cannot be raced), with the field named."""


def _pooled(samples: dict, cid: str) -> list[float]:
    return [x for b in samples.get(cid) or [] for x in b]


def _win_ci(samples: dict, winner: str, incumbent: str, *,
            alpha: float, seed: int, n_boot: int) -> list[float] | None:
    """The promotion evidence: CI on the incumbent's relative slowdown
    vs the winner (positive = incumbent slower = winner's win), in
    percent. None when the winner IS the incumbent."""
    from tpu_aggcomm_torch.obs.metrics import bootstrap_delta_ci
    if winner == incumbent:
        return None
    lo, hi = bootstrap_delta_ci(_pooled(samples, winner),
                                _pooled(samples, incumbent),
                                relative=True, alpha=alpha, seed=seed,
                                n_boot=n_boot)
    return [lo * 100.0, hi * 100.0]


def _candidates(target: dict, registration: dict) -> list[str]:
    """Race order: reference field first (method-id order), synthesized
    finalists last, and the incumbent prepended when it is in neither
    (a TAM or an unregistered-synth incumbent must still be raced —
    a win over an absent incumbent is not a win)."""
    from tpu_aggcomm_torch.synth.artifact import reference_methods

    inc = parse_cid(target["incumbent_cid"])
    cell = dict(cb_nodes=inc.cb_nodes, comm_size=inc.comm_size,
                agg_type=inc.agg_type)
    methods = reference_methods(target["direction"])
    methods += sorted(int(k) for k in registration)
    cids = [Candidate(method=m, **cell).cid for m in methods]
    if target["incumbent_cid"] not in cids:
        cids.insert(0, target["incumbent_cid"])
    if len(cids) < 2:
        raise CampaignError(
            f"target {target['incumbent_cid']}: only {len(cids)} "
            f"candidate(s) at this cell — nothing to race")
    return cids


def run_campaign(target: dict, sampler, *, seed: int = 0,
                 max_batches: int = 6, batch_trials: int = 3,
                 alpha: float = 0.05, n_boot: int = 2000,
                 params: dict | None = None,
                 params_source: str | None = None,
                 id_base: int | None = None, log=None) -> dict:
    """Run one campaign and return its artifact row. ``sampler`` follows
    the tuner contract (``sampler(cid, batch) -> [seconds]``)."""
    from tpu_aggcomm_torch.synth.register import (SYNTH_ID_BASE,
                                            register_composition,
                                            registered_synth_ids)
    from tpu_aggcomm_torch.synth.search import search

    say = log or (lambda *_: None)
    shape = target["shape"]
    sr = None
    registration: dict[str, dict] = {}
    base = None
    if target.get("kind") == "bursty-arrivals":
        sr = search(nprocs=shape["nprocs"], cb_nodes=shape["cb_nodes"],
                    comm_size=shape["comm_size"],
                    data_size=shape.get("data_size", 2048),
                    proc_node=shape.get("proc_node", 1),
                    agg_type=shape.get("agg_type", 0),
                    direction=target["direction"], seed=seed,
                    params=params, params_source=params_source,
                    **SEARCH_OPTS)
        say(f"pilot: campaign {target['incumbent_cid']}: searched "
            f"{sr['evaluated']}/{sr['space_size']} compositions, "
            f"{len(sr['finalists'])} finalist(s)")
        base = id_base if id_base is not None else \
            max([SYNTH_ID_BASE] + registered_synth_ids()) + 1
        for i, canon in enumerate(sr["finalists"]):
            spec = register_composition(canon, method_id=base + i,
                                        direction=target["direction"])
            registration[str(spec.method_id)] = {
                "composition": canon,
                "direction": target["direction"], "name": spec.name}

    cids = _candidates(target, registration)
    say(f"pilot: campaign {target['incumbent_cid']}: racing "
        f"{len(cids)} candidate(s), seed {seed}")
    res = race_mod.race(cids, sampler, max_batches=max_batches,
                        alpha=alpha, seed=seed, n_boot=n_boot)
    race_rec = {"seed": int(seed), "alpha": float(alpha),
                "n_boot": int(n_boot), "max_batches": int(max_batches),
                "batch_trials": int(batch_trials), "order": cids,
                "samples": res.samples,
                "eliminations": res.eliminations, "winner": res.winner,
                "batches_run": res.batches_run,
                "survivors": res.survivors}
    win_ci = _win_ci(res.samples, res.winner, target["incumbent_cid"],
                     alpha=alpha, seed=seed, n_boot=n_boot)
    improved = win_ci is not None and win_ci[0] > 0
    win_mid = parse_cid(res.winner).method
    meds = res.medians()
    winner = {"cid": res.winner, "method_id": win_mid,
              "median_s": meds[res.winner],
              "synthesized": win_mid > SYNTH_ID_BASE}
    if winner["synthesized"] and str(win_mid) in registration:
        winner["composition"] = registration[str(win_mid)]["composition"]
    return {"target_index": target["index"], "seed": int(seed),
            "incumbent_cid": target["incumbent_cid"],
            "direction": target["direction"],
            "search": sr, "registration": registration or None,
            "id_base": base, "race": race_rec, "winner": winner,
            "win_ci_pct": win_ci, "improved": improved}


def replay_campaign(campaign: dict, *, params: dict | None = None,
                    params_source: str | None = None,
                    rerun_search: bool = True) -> list[str]:
    """Re-derive one campaign row from its own record. Returns the
    named problems (empty = REPRODUCED): the search block from
    (config, seed, params) when ``rerun_search``, the race verdict from
    the recorded samples, the win CI from the recorded samples and the
    improvement flag from the recorded CI — the tune/SYNTH replay
    discipline, jax-free."""
    from tpu_aggcomm_torch.synth.search import SearchError, search

    problems: list[str] = []
    sr_rec = campaign.get("search")
    if sr_rec is not None and rerun_search:
        cfg = dict(sr_rec.get("config") or {})
        try:
            sr_new = search(
                nprocs=cfg["nprocs"], cb_nodes=cfg["cb_nodes"],
                comm_size=cfg["comm_size"], data_size=cfg["data_size"],
                proc_node=cfg["proc_node"], agg_type=cfg["agg_type"],
                direction=cfg["direction"],
                seed=campaign.get("seed", 0), params=params,
                params_source=params_source,
                init=sr_rec.get("init", 32),
                mutate_rounds=sr_rec.get("mutate_rounds", 3),
                beam=sr_rec.get("beam", 4),
                top_k=sr_rec.get("top_k", 3),
                fanins=sr_rec.get("fanins", (2, 4)),
                relays=sr_rec.get("relays", (0, 2)))
            if json.loads(json.dumps(sr_new)) != sr_rec:
                for key in sr_new:
                    if json.loads(json.dumps(sr_new[key])) \
                            != sr_rec.get(key):
                        problems.append(f"search.{key} does not "
                                        f"re-derive")
        except (KeyError, SearchError) as e:
            problems.append(f"search replay failed: {e}")
        reg = campaign.get("registration") or {}
        mids = sorted(int(k) for k in reg)
        got = [reg[str(m)]["composition"] for m in mids]
        if got != (sr_rec.get("finalists") or []):
            problems.append(f"registration compositions {got} != "
                            f"search finalists {sr_rec.get('finalists')}")

    rec = campaign.get("race") or {}
    try:
        res = race_mod.replay_record(rec)
        if res.winner != rec.get("winner"):
            problems.append(f"race winner re-derives to {res.winner}, "
                            f"recorded {rec.get('winner')}")
        if json.loads(json.dumps(res.eliminations)) \
                != rec.get("eliminations"):
            problems.append("race eliminations do not re-derive")
    except (KeyError, race_mod.RaceError) as e:
        problems.append(f"race replay failed: {e}")
        return problems

    win_ci = _win_ci(rec.get("samples") or {}, rec.get("winner"),
                     campaign.get("incumbent_cid"),
                     alpha=float(rec.get("alpha", 0.05)),
                     seed=int(rec.get("seed", 0)),
                     n_boot=int(rec.get("n_boot", 2000)))
    if json.loads(json.dumps(win_ci)) != campaign.get("win_ci_pct"):
        problems.append(f"win_ci_pct re-derives to {win_ci}, recorded "
                        f"{campaign.get('win_ci_pct')}")
    improved = win_ci is not None and win_ci[0] > 0
    if improved != bool(campaign.get("improved")):
        problems.append(f"improved re-derives to {improved}, recorded "
                        f"{campaign.get('improved')} — the artifact "
                        f"contradicts its own win CI")
    return problems
