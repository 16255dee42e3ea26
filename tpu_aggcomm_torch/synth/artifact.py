"""SYNTH_r*.json — the committed synthesis artifact (schema synth-v1).

One artifact is one complete, replayable synthesis run at one n=32-class
grid cell: the seeded search trace (every composition evaluated, every
prune named), the registration block (method id -> canonical
composition — what :func:`tpu_aggcomm_torch.synth.register.ensure_registered`
re-installs in a later process), the measured race of the registered
finalists against every dispatched reference method of the same
direction (the tuner's race record verbatim, seeded and
sample-complete), and the winner with its PROVEN/CONFORMS verdicts.

Determinism contract (the tune/PREDICT discipline): same config + seed
+ embedded model parameters ⟹ the same search block byte-for-byte, and
the recorded race samples ⟹ the same eliminations and winner
byte-for-byte (`tune.race.replay_record`). :func:`replay_artifact`
re-derives BOTH jax-free — that is the ci_tier1.sh gate. Writes go
through ``obs.atomic_write`` (one-shot artifact writer rule).
"""

from __future__ import annotations

import glob
import json
import os
import time

from tpu_aggcomm_torch.synth.register import (SYNTH_ID_BASE,
                                        register_composition,
                                        registered_synth_ids)
from tpu_aggcomm_torch.synth.search import SearchError, search

__all__ = ["SYNTH_SCHEMA", "next_artifact_path", "reference_methods",
           "run_synth", "save_artifact", "load_artifact",
           "replay_artifact"]

SYNTH_SCHEMA = "synth-v1"


def next_artifact_path(root: str = ".") -> str:
    """First unused ``SYNTH_rNN.json`` under ``root`` (NN = 01, 02, …)."""
    taken = set(os.path.basename(p)
                for p in glob.glob(os.path.join(root, "SYNTH_r*.json")))
    n = 1
    while f"SYNTH_r{n:02d}.json" in taken:
        n += 1
    return os.path.join(root, f"SYNTH_r{n:02d}.json")


def reference_methods(direction: str = "a2m") -> list[int]:
    """Every dispatched, non-TAM reference method of one direction — the
    field the synthesized finalists must beat."""
    from tpu_aggcomm_torch.core.methods import METHODS, method_ids
    from tpu_aggcomm_torch.synth.search import _direction

    d = _direction(direction)
    return [m for m in method_ids(include_dead=False)
            if m < SYNTH_ID_BASE and not METHODS[m].tam
            and METHODS[m].direction is d]


def run_synth(*, nprocs: int, cb_nodes: int, comm_size: int,
              data_size: int = 2048, proc_node: int = 1, agg_type: int = 1,
              direction: str = "a2m", seed: int = 0,
              params: dict | None = None, params_source: str | None = None,
              init: int = 32, mutate_rounds: int = 3, beam: int = 4,
              top_k: int = 3, fanins=(2, 4), relays=(0, 2),
              id_base: int | None = None, sampler=None,
              backend: str = "torch_sim", synthetic: str | None = None,
              max_batches: int = 6, batch_trials: int = 3,
              alpha: float = 0.05, log=None) -> dict:
    """The whole pipeline: search -> register finalists -> race them
    against the reference field at the same cell -> artifact dict.

    ``sampler`` follows the tuner's contract (``sampler(cid, batch) ->
    [seconds]``); the CLI passes tune/measure.py's torch_sim sampler for
    measured runs or ``tune.race.make_synthetic_sampler`` for the
    jax-free smoke path (recorded in ``synthetic``). The race order is
    reference ids first, finalists last — ties break toward the
    reference, so a synthesized winner never wins on order."""
    from tpu_aggcomm_torch.obs.ledger import manifest
    from tpu_aggcomm_torch.tune import race as race_mod
    from tpu_aggcomm_torch.tune.space import Candidate

    say = log or (lambda *_: None)
    sr = search(nprocs=nprocs, cb_nodes=cb_nodes, comm_size=comm_size,
                data_size=data_size, proc_node=proc_node,
                agg_type=agg_type, direction=direction, seed=seed,
                params=params, params_source=params_source, init=init,
                mutate_rounds=mutate_rounds, beam=beam, top_k=top_k,
                fanins=fanins, relays=relays)
    say(f"synth: searched {sr['evaluated']}/{sr['space_size']} "
        f"compositions (pruned: {sr['pruned']}), "
        f"{len(sr['finalists'])} finalist(s)")
    if not sr["finalists"]:
        raise SearchError(
            "search left no finalists: every composition was pruned "
            "(see the rows' pruned_by fields)")

    base = id_base if id_base is not None else \
        max([SYNTH_ID_BASE] + registered_synth_ids()) + 1
    registration: dict[str, dict] = {}
    for i, canon in enumerate(sr["finalists"]):
        spec = register_composition(canon, method_id=base + i,
                                    direction=direction)
        registration[str(spec.method_id)] = {
            "composition": canon, "direction": direction,
            "name": spec.name}

    refs = reference_methods(direction)
    cell = dict(cb_nodes=cb_nodes, comm_size=comm_size, agg_type=agg_type)
    cids = [Candidate(method=m, **cell).cid
            for m in refs + sorted(int(k) for k in registration)]
    say(f"synth: racing {len(cids)} candidate(s) "
        f"({len(refs)} reference + {len(registration)} synthesized), "
        f"seed {seed}")
    res = race_mod.race(cids, sampler, max_batches=max_batches,
                        alpha=alpha, seed=seed)
    race_rec = {"seed": int(seed), "alpha": float(alpha), "n_boot": 2000,
                "max_batches": int(max_batches),
                "batch_trials": int(batch_trials), "order": cids,
                "samples": res.samples, "eliminations": res.eliminations,
                "winner": res.winner, "batches_run": res.batches_run,
                "survivors": res.survivors}

    win_mid = int(res.winner.split(":", 1)[0][1:])
    meds = res.medians()
    winner = {"cid": res.winner, "method_id": win_mid,
              "median_s": meds[res.winner],
              "synthesized": win_mid > SYNTH_ID_BASE}
    if winner["synthesized"]:
        entry = registration[str(win_mid)]
        row = next(r for r in sr["rows"]
                   if r["composition"] == entry["composition"])
        winner.update(composition=entry["composition"],
                      check_verdict="PROVEN", traffic_verdict="CONFORMS",
                      predicted_rank=row["rank"], price_s=row["price_s"])
    return {"schema": SYNTH_SCHEMA, "created_unix": time.time(),
            "seed": int(seed), "backend": backend,
            "synthetic": synthetic, "config": sr["config"],
            "inputs": {"params": params, "params_source": params_source},
            "search": sr, "registration": registration,
            "race": race_rec, "winner": winner, "manifest": manifest()}


def save_artifact(path: str, artifact: dict) -> str:
    from tpu_aggcomm_torch.obs import atomic_write
    with atomic_write(path) as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_artifact(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def replay_artifact(path: str) -> tuple[bool, list[str]]:
    """Re-derive a committed artifact jax-free: the search block from
    (config, seed, embedded params) and the race verdict from the
    recorded samples. Returns ``(reproduced, diffs)`` — any diff names
    the block that failed, the tune/PREDICT replay discipline."""
    from tpu_aggcomm_torch.tune import race as race_mod

    blob = load_artifact(path)
    diffs: list[str] = []
    sr_rec = blob.get("search") or {}
    cfg = dict(sr_rec.get("config") or {})
    try:
        sr_new = search(
            nprocs=cfg["nprocs"], cb_nodes=cfg["cb_nodes"],
            comm_size=cfg["comm_size"], data_size=cfg["data_size"],
            proc_node=cfg["proc_node"], agg_type=cfg["agg_type"],
            direction=cfg["direction"], seed=blob.get("seed", 0),
            params=(blob.get("inputs") or {}).get("params"),
            params_source=(blob.get("inputs") or {}).get("params_source"),
            init=sr_rec.get("init", 32),
            mutate_rounds=sr_rec.get("mutate_rounds", 3),
            beam=sr_rec.get("beam", 4), top_k=sr_rec.get("top_k", 3),
            fanins=sr_rec.get("fanins", (2, 4)),
            relays=sr_rec.get("relays", (0, 2)))
    except (KeyError, SearchError) as e:
        return False, [f"search replay failed: {e}"]
    if json.loads(json.dumps(sr_new)) != sr_rec:
        for key in sr_new:
            if json.loads(json.dumps(sr_new[key])) != sr_rec.get(key):
                diffs.append(f"search.{key} does not re-derive")

    # registration must be exactly the finalists, ids in finalist order
    reg = blob.get("registration") or {}
    mids = sorted(int(k) for k in reg)
    expect = sr_rec.get("finalists") or []
    got = [reg[str(m)]["composition"] for m in mids]
    if got != expect:
        diffs.append(f"registration compositions {got} != search "
                     f"finalists {expect}")

    try:
        res = race_mod.replay_record(blob.get("race") or {})
        rec = blob["race"]
        if res.winner != rec.get("winner"):
            diffs.append(f"race winner re-derives to {res.winner}, "
                         f"recorded {rec.get('winner')}")
        if json.loads(json.dumps(res.eliminations)) \
                != rec.get("eliminations"):
            diffs.append("race eliminations do not re-derive")
    except (KeyError, race_mod.RaceError) as e:
        diffs.append(f"race replay failed: {e}")

    win = blob.get("winner") or {}
    if win.get("synthesized"):
        mid = str(win.get("method_id"))
        if reg.get(mid, {}).get("composition") != win.get("composition"):
            diffs.append(f"winner composition is not registration[{mid}]")
    return not diffs, diffs
