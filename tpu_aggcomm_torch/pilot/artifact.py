"""PILOT_r*.json — the committed autopilot artifact (schema pilot-v1).

One artifact is one complete control-loop pass: the journal basenames
tailed, the workload profile's proposals, the serve layer's per-shape
stats snapshot (the ranking evidence), the folded targets, every
campaign (search + race + win CI, sample-complete), every promotion/
demotion DECISION with the server's response recorded as evidence, and
the promotion records that were actually applied.

Determinism contract (the tune/SYNTH/WORKLOAD/WATCH discipline): the
journals + the recorded evidence blocks (per-shape snapshot, installed
promotions, swap/demote responses) + the seed re-derive the ENTIRE
decision trace — profile, targets, search, race verdicts, win CIs and
every action — byte-for-byte, torch-free (:func:`replay_pilot`). The server's responses are EVIDENCE (they happened;
a replay cannot re-contact a dead server), but the decision LOGIC over
that evidence re-derives — so a promotion the artifact's own numbers
contradict is a MISMATCH, never quietly cited.

The copy of ``tpu_aggcomm/pilot/artifact.py`` (import paths rewritten),
with three changes:

- the measured sampler is the port's ``tune.measure.
  make_torch_sim_sampler`` on :func:`run_pilot`'s ``device`` (the
  reference races ``jax_sim``); the ``synthetic`` path imports no torch;
- an offline pass (no serve port) fingerprints
  ``ledger.manifest(device=...)``, the call every fingerprinting site of
  the port makes, so a record made on the card names the card as the
  card's server does (a ``synthetic`` pass names no device, as ``tune
  --synthetic`` does);
- the profile's proposals are recorded with their ``cli`` hint in the
  reference's spelling (:func:`wire_proposals`): the hint is the one
  field of a profile that names the package that computed it, and
  pilot-v1 is replayed by both packages, so an artifact either one
  writes re-derives under the other.
"""

from __future__ import annotations

import glob
import json
import os
import time

from tpu_aggcomm_torch.pilot.campaign import replay_campaign, run_campaign
from tpu_aggcomm_torch.pilot.plan import PilotError, fold_targets
from tpu_aggcomm_torch.pilot.promote import make_promotion_record

__all__ = ["PILOT_SCHEMA", "next_pilot_path", "mark_skips",
           "demotion_rows", "derive_decision", "run_pilot",
           "write_pilot", "load_pilot", "replay_pilot", "render_pilot",
           "wire_proposals"]

PILOT_SCHEMA = "pilot-v1"

#: Envelope keys excluded from the replay comparison (environment-
#: dependent by design; everything else must re-derive byte-for-byte).
_ENVELOPE = ("schema", "manifest", "created_unix")


def next_pilot_path(root: str = ".") -> str:
    """First unused ``PILOT_rNN.json`` under ``root`` (NN = 01, 02, …)."""
    taken = set(os.path.basename(p)
                for p in glob.glob(os.path.join(root, "PILOT_r*.json")))
    n = 1
    while f"PILOT_r{n:02d}.json" in taken:
        n += 1
    return os.path.join(root, f"PILOT_r{n:02d}.json")


#: A proposal's ``cli`` hint as the port's profiler spells it, and as
#: pilot-v1 records it (the reference's spelling).
_PORT_CLI = "python -m tpu_aggcomm_torch.cli "
_WIRE_CLI = "python -m tpu_aggcomm.cli "


def wire_proposals(profile: dict) -> dict:
    """``profile`` with each proposal's ``cli`` hint in pilot-v1's
    spelling: the reference's module name, whichever package profiled.
    Nothing else of a proposal changes."""
    out = dict(profile)
    out["proposals"] = [
        dict(p, cli=_WIRE_CLI + p["cli"][len(_PORT_CLI):])
        if str(p.get("cli", "")).startswith(_PORT_CLI) else p
        for p in profile.get("proposals") or []]
    return out


def _shape_json(shape) -> str:
    return json.dumps(shape, sort_keys=True)


def mark_skips(targets: list[dict], installed: list[dict]) -> list[dict]:
    """Mark targets whose shape already carries an installed promotion
    (campaigning a shape mid-promotion would race against a method that
    no longer serves it). Pure function of (targets, installed) — part
    of the replayable decision trace."""
    promoted = {_shape_json((p.get("record") or {}).get("shape"))
                for p in installed}
    out = []
    for t in targets:
        t = dict(t)
        t["skipped"] = ("already-promoted"
                        if _shape_json(t["shape"]) in promoted else None)
        out.append(t)
    return out


def demotion_rows(installed: list[dict], rows: list[dict], *,
                  seed: int = 0) -> list[dict]:
    """The demotion half of the loop, derived (no server contact): for
    every installed promotion, a seeded changepoint detection
    (``obs/watch.py:detect_changepoint`` — the watchtower verdict
    kernel) over the promoted shape's completed request walls in rid
    order. A CONFIRMED step UP after the promotion is a regression
    verdict and the action is ``demote`` with the watch evidence named;
    anything else holds. Pure function of (installed, rows, seed)."""
    from tpu_aggcomm_torch.obs.watch import detect_changepoint

    out: list[dict] = []
    for p in installed:
        record = p.get("record") or {}
        sig = _shape_json(record.get("shape"))
        walls = [r["wall_s"] for r in rows
                 if r.get("status") == "done"
                 and _shape_json(r.get("shape")) == sig
                 and isinstance(r.get("wall_s"), (int, float))]
        det = detect_changepoint(walls, seed=seed)
        if det is not None and det["direction"] == "up":
            action = "demote"
            reason = (f"watch: confirmed request-wall step up "
                      f"{det['delta_rel'] * 100.0:+.1f}% at index "
                      f"{det['index']}/{det['n']} (seeded changepoint, "
                      f"CI [{det['ci_rel'][0] * 100.0:.1f}%, "
                      f"{det['ci_rel'][1] * 100.0:.1f}%]) after "
                      f"promotion m{record.get('old_method')} -> "
                      f"m{record.get('new_method')}")
        else:
            action = "hold"
            reason = ("watch: no confirmed request-wall regression on "
                      "the promoted shape"
                      if det is None else
                      f"watch: confirmed step is DOWN "
                      f"({det['delta_rel'] * 100.0:+.1f}%) — the "
                      f"promotion is helping")
        out.append({"seq": p.get("seq"), "record": record,
                    "n_walls": len(walls), "detection": det,
                    "action": action, "reason": reason})
    return out


def derive_decision(target: dict, campaign: dict, *, mode: str,
                    fingerprint: str, swap: dict | None) -> dict:
    """The one decision arithmetic — run_pilot applies it live and
    replay/validate re-run it over the recorded evidence. ``swap`` is
    the server's recorded response (None when nothing was attempted)."""
    winner = campaign["winner"]["cid"]
    d = {"target_index": target["index"],
         "incumbent_cid": campaign["incumbent_cid"],
         "winner_cid": winner,
         "win_ci_pct": campaign["win_ci_pct"],
         "improved": campaign["improved"],
         "record": None, "swap": swap}
    if winner == campaign["incumbent_cid"]:
        d["action"] = "keep-incumbent"
    elif not campaign["improved"]:
        d["action"] = "no-win"
    else:
        d["record"] = make_promotion_record(target, campaign,
                                            fingerprint=fingerprint)
        if mode != "live":
            d["action"] = "would-promote"
        elif swap is None:
            d["action"] = "swap-unattempted"
        elif swap.get("ok") and swap.get("verified") is True:
            d["action"] = "promote"
        elif swap.get("ok"):
            d["action"] = "verify-failed"
        else:
            d["action"] = "swap-refused"
    return d


def _default_sampler_factory(*, synthetic: str | None, seed: int,
                             batch_trials: int, device="cuda"):
    """Per-target sampler: the seeded synthetic model when a spec is
    given (torch-free smoke), else tune/measure.py's fresh-sample
    torch_sim sampler on ``device`` — the one torch door, guarded
    against serve contention. Every target races on ``torch_sim``, a
    ``cuda_fused`` one too, as the reference races every target on
    ``jax_sim``."""
    def factory(target: dict):
        if synthetic is not None:
            from tpu_aggcomm_torch.tune.race import make_synthetic_sampler
            return make_synthetic_sampler(synthetic, seed=seed,
                                          batch_trials=batch_trials)
        from tpu_aggcomm_torch.tune.measure import make_torch_sim_sampler
        shape = target["shape"]
        return make_torch_sim_sampler(
            nprocs=shape["nprocs"],
            data_size=shape.get("data_size", 2048),
            proc_node=shape.get("proc_node", 1), device=device,
            batch_trials=batch_trials)
    return factory


def _snapshot_journals(journals: list[str]):
    """Freeze the tailed journal lines before profiling. The pilot's
    decisions must re-derive from EXACTLY the bytes it read, but the
    serve journal keeps growing underneath it — the swap op's verify
    leg itself appends records. So: read each journal once, drop an
    in-flight torn final line (it would complete by commit time and
    poison the replay), and profile the frozen copy; the artifact
    records the basename + consumed line count and :func:`replay_pilot`
    truncates the committed journal to the same prefix. Returns
    ``(meta, tmpdir, paths)`` — caller removes ``tmpdir``."""
    import tempfile
    names = [os.path.basename(p) for p in journals]
    if len(set(names)) != len(names):
        raise PilotError(f"journal basenames must be distinct (replay "
                         f"resolves by basename): {names}")
    tmp = tempfile.mkdtemp(prefix="tpu-aggcomm-pilot-")
    meta, paths = [], []
    for p, name in zip(journals, names):
        with open(p, encoding="utf-8") as fh:
            lines = fh.readlines()
        if lines and not lines[-1].endswith("\n"):
            lines = lines[:-1]
        sp = os.path.join(tmp, name)
        with open(sp, "w", encoding="utf-8") as fh:
            fh.writelines(lines)
        meta.append({"name": name, "lines": len(lines)})
        paths.append(sp)
    return meta, tmp, paths


def run_pilot(journals, *, seed: int = 0, serve_port: int | None = None,
              serve_host: str = "127.0.0.1", dry_run: bool = False,
              synthetic: str | None = None, sampler_factory=None,
              params: dict | None = None,
              params_source: str | None = None, max_batches: int = 6,
              batch_trials: int = 3, alpha: float = 0.05,
              n_boot: int = 2000, id_base: int | None = None,
              device="cuda", log=None) -> dict:
    """One control-loop pass: profile -> (demote?) -> fold ->
    campaigns -> decisions (-> swap). Returns the pilot-v1 body (no
    envelope — :func:`write_pilot` adds it). ``device`` is where a
    measured race runs and whose card an offline fingerprint names."""
    from tpu_aggcomm_torch.obs.workload import profile_journal

    say = log or (lambda *_: None)
    journals = list(journals)
    if not journals:
        raise PilotError("pilot needs at least one serve journal to tail")
    journals_meta, snap_dir, snap_paths = _snapshot_journals(journals)
    try:
        profile = wire_proposals(profile_journal(snap_paths, seed=seed))
    finally:
        import shutil
        shutil.rmtree(snap_dir, ignore_errors=True)
    say(f"pilot: profiled {profile['requests']['admitted']} request(s) "
        f"from {len(journals)} journal(s), "
        f"{len(profile['proposals'])} proposal(s)")

    mode = "live" if serve_port is not None and not dry_run else "dry-run"
    per_shape = None
    installed: list[dict] = []
    client = None
    if serve_port is not None:
        from tpu_aggcomm_torch.serve.protocol import ServeClient
        client = ServeClient(serve_port, host=serve_host)
        stats = client.stats()
        fingerprint = str(stats.get("fingerprint"))
        per_shape = stats.get("per_shape") or {}
        installed = stats.get("promotions") or []
    else:
        from tpu_aggcomm_torch.obs import ledger
        from tpu_aggcomm_torch.tune.cache import manifest_fingerprint
        fingerprint = manifest_fingerprint(ledger.manifest(
            device=None if synthetic is not None else device))

    try:
        demotions = demotion_rows(installed, profile["per_request"],
                                  seed=seed)
        for row in demotions:
            if row["action"] == "demote" and mode == "live":
                say(f"pilot: demoting promotion seq {row['seq']} — "
                    f"{row['reason']}")
                row["outcome"] = client.demote(row["record"],
                                               row["reason"])
            else:
                row["outcome"] = None

        targets = mark_skips(fold_targets(profile, per_shape), installed)
        active = [t for t in targets if t["skipped"] is None]
        say(f"pilot: {len(targets)} target(s), {len(active)} active "
            f"({mode})")
        factory = sampler_factory or _default_sampler_factory(
            synthetic=synthetic, seed=seed, batch_trials=batch_trials,
            device=device)
        campaigns: list[dict] = []
        decisions: list[dict] = []
        for t in active:
            c = run_campaign(t, factory(t), seed=seed,
                             max_batches=max_batches,
                             batch_trials=batch_trials, alpha=alpha,
                             n_boot=n_boot, params=params,
                             params_source=params_source,
                             id_base=id_base, log=log)
            campaigns.append(c)
            swap = None
            if (mode == "live" and c["improved"]
                    and c["winner"]["cid"] != c["incumbent_cid"]):
                record = make_promotion_record(t, c,
                                               fingerprint=fingerprint)
                say(f"pilot: promoting {record['old_cid']} -> "
                    f"{record['new_cid']} (win CI "
                    f"[{record['win_ci_pct'][0]:.1f}%, "
                    f"{record['win_ci_pct'][1]:.1f}%])")
                swap = client.swap(record)
            d = derive_decision(t, c, mode=mode,
                                fingerprint=fingerprint, swap=swap)
            decisions.append(d)
            say(f"pilot: decision for {d['incumbent_cid']}: "
                f"{d['action']}")
    finally:
        if client is not None:
            client.close()

    return {
        "seed": int(seed), "mode": mode,
        "journals": journals_meta,
        "synthetic": synthetic, "fingerprint": fingerprint,
        "requests": profile["requests"],
        "proposals": profile["proposals"],
        "per_shape": per_shape,
        "installed_promotions": installed,
        "demotions": demotions,
        "targets": targets,
        "campaigns": campaigns,
        "decisions": decisions,
        "promotions": [d["record"] for d in decisions
                       if d["action"] == "promote"],
        "inputs": {"params": params, "params_source": params_source},
        "race_opts": {"max_batches": int(max_batches),
                      "batch_trials": int(batch_trials),
                      "alpha": float(alpha), "n_boot": int(n_boot)},
        "problems": profile["problems"],
    }


def write_pilot(path: str, body: dict) -> dict:
    """Write one pilot-v1 artifact atomically (manifest records env var
    NAMES only, the ledger discipline) and return the blob."""
    from tpu_aggcomm_torch.obs import atomic_write, ledger
    blob = dict(body)
    blob["schema"] = PILOT_SCHEMA
    blob["manifest"] = ledger.manifest()
    blob["created_unix"] = time.time()
    with atomic_write(path) as fh:
        json.dump(blob, fh, indent=1)
        fh.write("\n")
    return blob


def load_pilot(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _jeq(a, b) -> bool:
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def replay_pilot(path: str) -> dict:
    """Re-derive a committed PILOT_r*.json from the journal basenames it
    records (resolved next to the artifact) + its recorded evidence
    blocks + seed, and byte-compare minus the envelope. ``{"verdict":
    "REPRODUCED" | "MISMATCH", "problems": [...]}`` — torch-free."""
    from tpu_aggcomm_torch.obs.workload import profile_journal

    blob = load_pilot(path)
    problems: list[str] = []
    if blob.get("schema") != PILOT_SCHEMA:
        return {"verdict": "MISMATCH",
                "problems": [f"schema {blob.get('schema')!r} != "
                             f"{PILOT_SCHEMA!r}"]}
    root = os.path.dirname(os.path.abspath(path))
    import shutil
    import tempfile
    snap_dir = tempfile.mkdtemp(prefix="tpu-aggcomm-pilot-")
    journals = []
    try:
        for ent in blob.get("journals") or []:
            if not isinstance(ent, dict) or "name" not in ent \
                    or "lines" not in ent:
                problems.append(f"journal entry {ent!r} must be "
                                f"{{name, lines}}")
                continue
            name, n = ent["name"], int(ent["lines"])
            p = os.path.join(root, name)
            if not os.path.exists(p):
                problems.append(f"recorded journal {name!r} not found "
                                f"next to the artifact ({root})")
                continue
            with open(p, encoding="utf-8") as fh:
                lines = fh.readlines()
            if len(lines) < n:
                problems.append(
                    f"journal {name!r} has {len(lines)} line(s) but the "
                    f"artifact consumed {n} — the journal shrank after "
                    f"the pilot pass")
                continue
            sp = os.path.join(snap_dir, name)
            with open(sp, "w", encoding="utf-8") as fh:
                fh.writelines(lines[:n])
            journals.append(sp)
        if problems:
            return {"verdict": "MISMATCH", "problems": problems}

        seed = int(blob.get("seed", 0))
        profile = wire_proposals(profile_journal(journals, seed=seed))
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    installed = blob.get("installed_promotions") or []
    inputs = blob.get("inputs") or {}

    # pure derivations re-run from streams + recorded evidence
    try:
        targets = mark_skips(fold_targets(profile,
                                          blob.get("per_shape")),
                             installed)
    except PilotError as e:
        return {"verdict": "MISMATCH",
                "problems": [f"target fold replay failed: {e}"]}
    demos = demotion_rows(installed, profile["per_request"], seed=seed)
    for i, row in enumerate(demos):
        rec = (blob.get("demotions") or [])
        row["outcome"] = rec[i].get("outcome") if i < len(rec) else None

    rederived = {
        "requests": profile["requests"],
        "proposals": profile["proposals"],
        "targets": targets,
        "demotions": demos,
        "problems": profile["problems"],
    }
    for k, v in rederived.items():
        if not _jeq(v, blob.get(k)):
            problems.append(f"key {k!r} does not re-derive from the "
                            f"recorded streams")

    # campaigns: internal consistency (search from config+seed, race
    # from samples, win CI + improved from the recorded numbers)
    campaigns = blob.get("campaigns") or []
    for i, c in enumerate(campaigns):
        for p in replay_campaign(c, params=inputs.get("params"),
                                 params_source=inputs.get(
                                     "params_source")):
            problems.append(f"campaign[{i}]: {p}")

    # decisions: the one decision arithmetic over recorded evidence
    active = [t for t in targets if t["skipped"] is None]
    decisions_rec = blob.get("decisions") or []
    if len(active) != len(campaigns) or len(campaigns) \
            != len(decisions_rec):
        problems.append(
            f"{len(active)} active target(s) vs {len(campaigns)} "
            f"campaign(s) vs {len(decisions_rec)} decision(s) — the "
            f"trace is truncated")
    else:
        decisions = []
        broken = False
        for t, c, d_rec in zip(active, campaigns, decisions_rec):
            try:
                decisions.append(derive_decision(
                    t, c, mode=blob.get("mode", "dry-run"),
                    fingerprint=str(blob.get("fingerprint")),
                    swap=(d_rec or {}).get("swap")))
            except Exception as e:  # lint: broad-ok (replay must name a malformed decision, not die on it)
                broken = True
                problems.append(f"decision for {c.get('incumbent_cid')} "
                                f"does not re-derive: "
                                f"{type(e).__name__}: {e}")
        if not broken:
            if not _jeq(decisions, decisions_rec):
                problems.append("key 'decisions' does not re-derive "
                                "from the campaigns + recorded swap "
                                "evidence")
            promoted = [d["record"] for d in decisions
                        if d["action"] == "promote"]
            if not _jeq(promoted, blob.get("promotions")):
                problems.append("key 'promotions' is not exactly the "
                                "promote-decision records")

    return {"verdict": "REPRODUCED" if not problems else "MISMATCH",
            "problems": problems}


def render_pilot(body: dict) -> str:
    """Human summary (stderr/stdout; the artifact carries the machine
    form)."""
    req = body.get("requests") or {}
    lines = [f"pilot pass ({body.get('mode')}): "
             f"{req.get('admitted', '?')} request(s) profiled, "
             f"{len(body.get('proposals') or [])} proposal(s), "
             f"{len(body.get('targets') or [])} target(s)"]
    for row in body.get("demotions") or []:
        lines.append(f"  demotion check seq {row.get('seq')}: "
                     f"{row['action']} — {row['reason']}")
    for d in body.get("decisions") or []:
        ci = d.get("win_ci_pct")
        ci_txt = (f", win CI [{ci[0]:.1f}%, {ci[1]:.1f}%]"
                  if ci else "")
        lines.append(f"  {d['incumbent_cid']} -> {d['winner_cid']}: "
                     f"{d['action']}{ci_txt}")
    if not body.get("decisions"):
        lines.append("  no campaigns ran (no active targets)")
    return "\n".join(lines)
