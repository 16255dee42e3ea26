"""The autopilot of the port (``tpu_aggcomm_torch/pilot`` and the server's
``swap``/``demote`` ops) against the reference's, on the CPU at n=8 a=4
d=256 c=2.

- **Parity**: ``fold_targets``, ``run_campaign``/``replay_campaign``,
  ``mark_skips``, ``demotion_rows``, ``derive_decision`` and
  ``validate_promotion_record`` give the reference's results field for
  field on the same profile, stats snapshot and seeded samples; backend
  names are rewritten ``torch_sim`` -> ``jax_sim`` before comparing, and
  nothing else.
- **Replay both ways**: the committed ``PILOT_r01.json`` replays
  REPRODUCED in place under the port's ``cli pilot --replay`` (a tampered
  copy exits 1); a live synthetic pass against the port's server
  promotes m3, validates under both packages' ``validate_pilot`` and
  replays under both CLIs; the reference's own live pass replays under
  the port's CLI.
- **The lifecycle**: every ``swap`` refusal by name (a reference record
  names ``jax_sim`` and the reference's manifest, and is never
  installed), demote refusing a lookalike and restoring the old method
  with the same record, and an engineered regression giving a live
  ``demote`` row.
- **No silent fallback**: a campaign that crowns the dense m=8 for a
  ``cuda_fused`` target ends ``verify-failed``, with
  ``UnfusableScheduleError`` in the swap's error and nothing installed
  (on the CPU ``cuda_fused`` runs K2's plain version, which refuses the
  schedule as K2 does).
- **No torch on the control plane**: the pilot, ``obs/{export,watch,
  slo}`` and the server import under a poisoned torch, and ``pilot
  --replay`` and ``pilot --synthetic`` run there.

The serve executor is faked (instant, verified), as the reference's
tests fake theirs, except in the ``verify-failed`` pin. No test reads a
time.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")

from tpu_aggcomm.core.methods import METHODS as REF_METHODS  # noqa: E402
from tpu_aggcomm.obs.regress import \
    validate_pilot as ref_validate_pilot  # noqa: E402
from tpu_aggcomm.obs.workload import \
    profile_journal as ref_profile_journal  # noqa: E402
from tpu_aggcomm.pilot import artifact as ref_artifact  # noqa: E402
from tpu_aggcomm.pilot import campaign as ref_campaign  # noqa: E402
from tpu_aggcomm.pilot import plan as ref_plan  # noqa: E402
from tpu_aggcomm.pilot import promote as ref_promote  # noqa: E402
from tpu_aggcomm.tune.race import \
    make_synthetic_sampler as ref_sampler  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.core.methods import METHODS  # noqa: E402
from tpu_aggcomm_torch.obs.regress import validate_pilot  # noqa: E402
from tpu_aggcomm_torch.obs.workload import profile_journal  # noqa: E402
from tpu_aggcomm_torch.pilot import (PilotError, PromotionError,  # noqa: E402
                                     fold_targets, make_promotion_record,
                                     render_pilot, replay_pilot,
                                     run_campaign, run_pilot,
                                     validate_promotion_record, write_pilot)
from tpu_aggcomm_torch.pilot.artifact import (demotion_rows,  # noqa: E402
                                              derive_decision, mark_skips,
                                              next_pilot_path,
                                              wire_proposals)
from tpu_aggcomm_torch.pilot.campaign import replay_campaign  # noqa: E402
from tpu_aggcomm_torch.pilot.plan import shape_stats_key  # noqa: E402
from tpu_aggcomm_torch.pilot.promote import records_equal  # noqa: E402
from tpu_aggcomm_torch.serve.protocol import ServeClient  # noqa: E402
from tpu_aggcomm_torch.serve.server import ScheduleServer  # noqa: E402
from tpu_aggcomm_torch.tune.race import make_synthetic_sampler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The hot request shape (m=1, a2m); "120,m3*0.6" makes m=3 the provable
#: winner at this cell, "100,m8*0.5" the dense m=8 (which K2 cannot run).
SHAPE = {"method": 1, "nprocs": 8, "cb_nodes": 4, "comm_size": 2,
         "data_size": 256}
SPEC = "120,m3*0.6"
JOURNAL = "serve_pilot.journal.jsonl"


@pytest.fixture(autouse=True)
def _registry_guard():
    """Campaigns and swaps register synthesized ids into both packages'
    global method tables; every test leaves both as it found them."""
    before, ref_before = set(METHODS), set(REF_METHODS)
    yield
    for mid in set(METHODS) - before:
        del METHODS[mid]
    for mid in set(REF_METHODS) - ref_before:
        del REF_METHODS[mid]


def _fake(monkeypatch, executor):
    delay = {"s": 0.0}

    def fake_build(schedule, backend_name, **kw):
        return object(), 1e-3

    def fake_exec(chain, reqs):
        if delay["s"]:
            time.sleep(delay["s"])
        return [{"verified": True if r.verify else None, "error": None}
                for r in reqs]

    monkeypatch.setattr(executor, "build_chain", fake_build)
    monkeypatch.setattr(executor, "execute_batch", fake_exec)
    return delay


@pytest.fixture
def fake_executor(monkeypatch):
    """The port's serve control plane with instant, verified execution;
    ``delay`` engineers a wall-clock regression mid-run."""
    from tpu_aggcomm_torch.serve import executor
    return _fake(monkeypatch, executor)


def _server(tmp_path, backend="torch_sim", **kw):
    srv = ScheduleServer(backend=backend, port=0, max_batch=4,
                         batch_window_s=0.01, device="cpu",
                         journal_path=str(tmp_path / JOURNAL), **kw)
    srv.start()
    return srv


def _drive(port, payloads):
    out = []
    with ServeClient(port, timeout=300.0) as c:
        for p in payloads:
            out.append(c.run(**p))
    assert all(r["ok"] for r in out), out
    return out


def _skewed_traffic(port, **extra):
    """10x the hot shape + 2x a minority shape, as the reference's tests
    and its committed exemplar drive."""
    return _drive(port, [dict(SHAPE, verify=True, iter=i, **extra)
                         for i in range(10)]
                  + [dict(SHAPE, method=3, verify=True, iter=i, **extra)
                     for i in range(2)])


def _as_ref(obj):
    """``obj`` with the port's backend names spelled as the reference's."""
    text = json.dumps(obj, sort_keys=True)
    return json.loads(text.replace('"torch_sim"', '"jax_sim"')
                      .replace('"cuda_fused"', '"pallas_fused"'))


def _record(fingerprint, **over):
    rec = {"shape": dict(SHAPE), "backend": "torch_sim",
           "old_method": 1, "old_cid": "m1:a4:c2:t0",
           "new_method": 3, "new_cid": "m3:a4:c2:t0",
           "composition": None, "win_ci_pct": [5.0, 10.0],
           "seed": 0, "alpha": 0.05, "n_boot": 200,
           "fingerprint": fingerprint, "artifact": None}
    rec.update(over)
    return rec


def _full_shape(**over):
    from tpu_aggcomm_torch.serve.protocol import parse_request
    req = parse_request(dict(SHAPE, **over))
    return {f: getattr(req, f) for f in req.shape_fields}


def _hot_target(kind="hot-shape"):
    return {"index": 0, "kind": kind, "shape": dict(SHAPE),
            "backend": "torch_sim", "incumbent_cid": "m1:a4:c2:t0",
            "direction": "all_to_many", "reason": "test", "stats_key": None,
            "stats": None, "rank": 0, "skipped": None}


def _records(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()
            if ln.strip()]


# ---------------------------------------------------------------------------
# Parity of the pure functions


def test_fold_targets_equals_the_reference(fake_executor, tmp_path):
    srv = _server(tmp_path)
    try:
        _skewed_traffic(srv.port)
        st = srv.stats()
    finally:
        srv.stop()
        srv.close()
    journal = str(tmp_path / JOURNAL)
    profile = profile_journal([journal], seed=0)
    ref_profile = ref_profile_journal([journal], seed=0)
    assert wire_proposals(profile)["proposals"] == ref_profile["proposals"]
    key = shape_stats_key(SHAPE, "torch_sim")
    assert key == ref_plan.shape_stats_key(SHAPE, "jax_sim")
    assert key in st["per_shape"] and st["per_shape"][key]["requests"] == 10
    for per_shape in (None, st["per_shape"]):
        got = fold_targets(profile, per_shape)
        assert got and got == fold_targets(profile, per_shape)
        assert _as_ref(got) == _as_ref(ref_plan.fold_targets(ref_profile,
                                                             per_shape))
        assert all(t["backend"] == "torch_sim" for t in got)
    assert got[0]["stats"] == st["per_shape"][key]

    # a proposal that names no backend folds to each package's default
    bare = {"proposals": [dict(p, backend=None)
                          for p in profile["proposals"]]}
    got = fold_targets(bare)
    assert {t["backend"] for t in got} == {"torch_sim"}
    assert {t["backend"] for t in ref_plan.fold_targets(bare)} == {"jax_sim"}
    assert _as_ref(got) == _as_ref(ref_plan.fold_targets(bare))

    # the reference's committed exemplar journal folds alike
    exemplar = os.path.join(REPO, "serve_pilot_exemplar.journal.jsonl")
    ex = wire_proposals(profile_journal([exemplar], seed=0))
    ref_ex = ref_profile_journal([exemplar], seed=0)
    assert ex["proposals"] == ref_ex["proposals"]
    assert fold_targets(ex) == ref_plan.fold_targets(ref_ex)

    # malformed proposals are refused by name, as the reference refuses
    for bad, needle in (
            ({"proposals": [{"kind": "hot-shape",
                             "shape": {"method": 1, "nprocs": 8,
                                       "comm_size": 2}}]},
             "integer 'cb_nodes'"),
            ({"proposals": [{"kind": "hot-shape",
                             "shape": dict(SHAPE, method=999)}]},
             "synth-root")):
        with pytest.raises(PilotError, match=needle):
            fold_targets(bad)
        with pytest.raises(ref_plan.PilotError, match=needle):
            ref_plan.fold_targets(bad)


@pytest.mark.parametrize("kind", ["hot-shape", "bursty-arrivals"])
def test_campaign_and_replay_equal_the_reference(kind):
    """The same target and seeded samples race to the same row (a bursty
    target searches and registers its finalists in both method tables),
    and ``replay_campaign`` names the same problems for the same
    tampering."""
    t = _hot_target(kind)
    got = run_campaign(t, make_synthetic_sampler(SPEC, seed=0,
                                                 batch_trials=3),
                       seed=0, max_batches=4, id_base=900)
    want = ref_campaign.run_campaign(_as_ref(t), ref_sampler(
        SPEC, seed=0, batch_trials=3), seed=0, max_batches=4, id_base=900)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["winner"]["cid"] == "m3:a4:c2:t0" and got["improved"]
    assert (got["search"] is None) == (kind == "hot-shape")
    if kind == "bursty-arrivals":
        for mid in got["registration"]:
            assert int(mid) in METHODS and int(mid) in REF_METHODS
    assert replay_campaign(got) == ref_campaign.replay_campaign(want) == []

    bad = copy.deepcopy(got)
    bad["race"]["samples"]["m3:a4:c2:t0"][0][0] *= 100.0
    lie = copy.deepcopy(got)
    lie["improved"] = False
    for tampered in (bad, lie):
        problems = replay_campaign(tampered)
        assert problems
        assert problems == ref_campaign.replay_campaign(
            json.loads(json.dumps(tampered)))
    assert any("contradicts its own win CI" in p
               for p in replay_campaign(lie))

    from tpu_aggcomm_torch.pilot import CampaignError
    from tpu_aggcomm_torch.synth.search import SearchError
    with pytest.raises((CampaignError, SearchError),
                       match="unknown direction"):
        run_campaign(dict(t, direction="nope"),
                     make_synthetic_sampler(SPEC, seed=0), seed=0,
                     max_batches=2)


def test_id_base_defaults_past_the_committed_synthesized_ids():
    """``--id-base`` defaults to one past the highest registered
    synthesized id: 104 once ``SYNTH_r01.json`` (m=101-103) is
    registered."""
    from tpu_aggcomm_torch.synth import ensure_registered
    ensure_registered(REPO)
    c = run_campaign(_hot_target("bursty-arrivals"),
                     make_synthetic_sampler(SPEC, seed=0), seed=0,
                     max_batches=2)
    assert c["id_base"] == 104
    assert sorted(int(m) for m in c["registration"]) == [104, 105]


def test_skips_demotions_and_decisions_equal_the_reference():
    rec = _record("fp")
    installed = [{"seq": 1, "record": rec}]
    t = _hot_target()
    assert mark_skips([t], installed)[0]["skipped"] == "already-promoted"
    assert mark_skips([t], [])[0]["skipped"] is None
    assert _as_ref(mark_skips([t], installed)) == _as_ref(
        ref_artifact.mark_skips(_as_ref([t]), _as_ref(installed)))

    flat = [{"status": "done", "shape": dict(SHAPE), "wall_s": w}
            for w in [0.010, 0.011, 0.010, 0.012, 0.011, 0.010, 0.011,
                      0.010]]
    step = flat + [{"status": "done", "shape": dict(SHAPE), "wall_s": w}
                   for w in [0.30, 0.31, 0.30, 0.32, 0.31, 0.30, 0.31,
                             0.30]]
    other = [{"status": "done", "shape": dict(SHAPE, method=3),
              "wall_s": 9.9}] * 16
    for rows, action, n in ((flat, "hold", 8), (step, "demote", 16),
                            (other, "hold", 0)):
        got = demotion_rows(installed, rows, seed=0)
        assert got[0]["action"] == action and got[0]["n_walls"] == n
        assert _as_ref(got) == _as_ref(ref_artifact.demotion_rows(
            _as_ref(installed), rows, seed=0))
    assert "watch: confirmed" in demotion_rows(installed, step)[0]["reason"]

    c = run_campaign(t, make_synthetic_sampler(SPEC, seed=0,
                                               batch_trials=3),
                     seed=0, max_batches=4)
    for mode, swap, action in (
            ("dry-run", None, "would-promote"),
            ("live", None, "swap-unattempted"),
            ("live", {"ok": True, "installed": True, "verified": True},
             "promote"),
            ("live", {"ok": True, "verified": False}, "verify-failed"),
            ("live", {"ok": False, "error": "nope"}, "swap-refused")):
        got = derive_decision(t, c, mode=mode, fingerprint="fp", swap=swap)
        assert got["action"] == action
        assert _as_ref(got) == _as_ref(ref_artifact.derive_decision(
            _as_ref(t), c, mode=mode, fingerprint="fp", swap=swap))
    flat_c = dict(c, improved=False)
    assert derive_decision(t, flat_c, mode="live", fingerprint="fp",
                           swap=None)["action"] == "no-win"


def test_promotion_record_refusals_equal_the_reference():
    c = run_campaign(_hot_target(), make_synthetic_sampler(
        SPEC, seed=0, batch_trials=3), seed=0, max_batches=4)
    rec = make_promotion_record(_hot_target(), c, fingerprint="fp")
    assert validate_promotion_record(rec) == []
    assert rec["old_method"] == 1 and rec["new_method"] == 3
    with pytest.raises(PromotionError, match="not an improvement"):
        make_promotion_record(_hot_target(), dict(c, improved=False),
                              fingerprint="fp")
    cases = [
        (dict(rec, win_ci_pct=[-0.1, 4.0]), "seeded-bootstrap gate"),
        (dict(rec, new_method=1, new_cid="m1:a4:c2:t0"), "no-op swap"),
        (dict(rec, new_method=901, new_cid="m901:a4:c2:t0"),
         "no canonical composition"),
        (dict(rec, composition="fanin=2|order=flat"), "reference id"),
        ({"old_method": 1}, "record field 'shape' must be dict"),
        ("not a record", "must be a JSON object"),
    ]
    for bad, needle in cases:
        got = validate_promotion_record(bad)
        assert any(needle in p for p in got), (needle, got)
        assert got == ref_promote.validate_promotion_record(bad)
    assert records_equal(rec, json.loads(json.dumps(rec)))
    assert not records_equal(rec, dict(rec, win_ci_pct=[6.0, 9.0]))


# ---------------------------------------------------------------------------
# Replay, both ways


def test_committed_pilot_replays_in_place_and_a_tampered_copy_fails(
        tmp_path, capsys):
    assert cli.main(["pilot", "--replay",
                     os.path.join(REPO, "PILOT_r01.json")]) == 0
    out = capsys.readouterr().out
    assert "PILOT_r01.json: 2 campaign(s), 1 promotion(s) -> REPRODUCED" \
        in out
    blob = json.load(open(os.path.join(REPO, "PILOT_r01.json")))
    blob["requests"]["admitted"] += 1
    with open(tmp_path / "PILOT_r01.json", "w") as fh:
        json.dump(blob, fh)
    shutil.copy(os.path.join(REPO, "serve_pilot_exemplar.journal.jsonl"),
                tmp_path)
    assert cli.main(["pilot", "--replay",
                     str(tmp_path / "PILOT_r01.json")]) == 1
    out = capsys.readouterr().out
    assert "-> MISMATCH" in out and "key 'requests'" in out


def test_live_synthetic_pass_promotes_and_replays_under_both(
        fake_executor, tmp_path, capsys):
    from tpu_aggcomm import cli as ref_cli
    srv = _server(tmp_path)
    try:
        _skewed_traffic(srv.port)
        body = run_pilot([str(tmp_path / JOURNAL)], seed=0,
                         serve_port=srv.port, synthetic=SPEC,
                         max_batches=4, device="cpu")
        promoted = [d["record"] for d in body["decisions"]
                    if d["action"] == "promote"]
        assert promoted == body["promotions"] and promoted
        assert promoted[0]["new_method"] == 3
        assert promoted[0]["backend"] == "torch_sim"
        assert body["requests"]["admitted"] == 12
        after = _drive(srv.port, [dict(SHAPE, verify=True)])[0]
        assert after["served_method"] == 3 and after["verified"] is True
        assert srv.stats()["promotions"][0]["record"] == promoted[0]
    finally:
        srv.stop()
        srv.close()
    verify_leg = [r for r in _records(tmp_path / JOURNAL)
                  if r.get("purpose") == "swap-verify"]
    assert len(verify_leg) == 1 and verify_leg[0]["served_method"] == 3

    out = next_pilot_path(str(tmp_path))
    blob = write_pilot(out, body)
    assert validate_pilot(blob, "PILOT_r01.json") == []
    assert ref_validate_pilot(blob, "PILOT_r01.json") == []
    assert replay_pilot(out)["verdict"] == "REPRODUCED"
    assert "promote" in render_pilot(body)
    capsys.readouterr()
    assert cli.main(["pilot", "--replay", out]) == 0
    assert ref_cli.main(["pilot", "--replay", out]) == 0
    text = capsys.readouterr().out
    assert text.count("1 promotion(s) -> REPRODUCED") == 2

    lie = copy.deepcopy(blob)
    lie["promotions"] = []
    assert any("promote" in e for e in validate_pilot(lie))
    sub = tmp_path / "short"
    sub.mkdir()
    shutil.copy(out, sub / "PILOT_r77.json")
    lines = (tmp_path / JOURNAL).read_text().splitlines(keepends=True)
    (sub / JOURNAL).write_text("".join(lines[:3]))
    short = replay_pilot(str(sub / "PILOT_r77.json"))
    assert short["verdict"] == "MISMATCH"
    assert any("shrank" in p for p in short["problems"])


def test_reference_live_pass_replays_under_the_port(monkeypatch, tmp_path,
                                                    capsys):
    from tpu_aggcomm.serve import executor as ref_executor
    from tpu_aggcomm.serve.protocol import ServeClient as RefClient
    from tpu_aggcomm.serve.server import ScheduleServer as RefServer
    _fake(monkeypatch, ref_executor)
    srv = RefServer(backend="jax_sim", port=0, max_batch=4,
                    batch_window_s=0.01,
                    journal_path=str(tmp_path / JOURNAL))
    srv.start()
    try:
        with RefClient(srv.port, timeout=300.0) as c:
            for i in range(10):
                assert c.run(**dict(SHAPE, verify=True, iter=i))["ok"]
            for i in range(2):
                assert c.run(**dict(SHAPE, method=3, verify=True,
                                    iter=i))["ok"]
        body = ref_artifact.run_pilot([str(tmp_path / JOURNAL)], seed=0,
                                      serve_port=srv.port, synthetic=SPEC,
                                      max_batches=4)
    finally:
        srv.stop()
        srv.close()
    assert [d["action"] for d in body["decisions"]][0] == "promote"
    out = str(tmp_path / "PILOT_r01.json")
    ref_artifact.write_pilot(out, body)
    capsys.readouterr()
    assert cli.main(["pilot", "--replay", out]) == 0
    assert "-> REPRODUCED" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The serve ops


def test_swap_and_demote_lifecycle(fake_executor, tmp_path):
    srv = _server(tmp_path)
    try:
        fp = srv.stats()["fingerprint"]
        refusals = [
            (_record("somebody-elses-fingerprint"), "does not transfer"),
            (_record(fp, win_ci_pct=[-1.0, 3.0]), "seeded-bootstrap gate"),
            (_record(fp, backend="jax_sim"),
             "backend 'jax_sim' is not servable"),
        ]
        # the reference's committed record names jax_sim and the
        # reference's manifest: refused by name either way, never installed
        ref_rec = json.load(open(os.path.join(
            REPO, "PILOT_r01.json")))["promotions"][0]
        refusals += [(ref_rec, "does not transfer"),
                     (dict(ref_rec, fingerprint=fp),
                      "backend 'jax_sim' is not servable")]
        for rec, needle in refusals:
            res = srv.swap(rec)
            assert res["ok"] is False and needle in res["error"], res
        none_yet = srv.demote(_record(fp), "watch: regression")
        assert "no promotion is installed" in none_yet["error"]
        assert srv.stats()["promotions"] == []

        rec = _record(fp)
        assert _drive(srv.port, [dict(SHAPE, verify=True)])[0][
            "served_method"] == 1
        res = srv.swap(rec)
        assert res["ok"] and res["installed"] and res["verified"] is True
        assert res["seq"] == 1 and res["verify_rid"]
        assert _drive(srv.port, [dict(SHAPE, verify=True)])[0][
            "served_method"] == 3
        assert srv.stats()["promotions"] == [{"seq": 1, "record": rec}]
        assert "demote it first" in srv.swap(_record(fp))["error"]

        assert "name the regression verdict" in srv.demote(rec, "  ")[
            "error"]
        lookalike = srv.demote(_record(fp, win_ci_pct=[6.0, 10.0]),
                               "watch: regression")
        assert lookalike["ok"] is False
        assert "never a lookalike" in lookalike["error"]
        down = srv.demote(rec, "watch: confirmed request-wall step up")
        assert down["ok"] and down["restored_method"] == 1
        assert _drive(srv.port, [dict(SHAPE, verify=True)])[0][
            "served_method"] == 1
        assert srv.stats()["promotions"] == []
    finally:
        srv.stop()
        srv.close()
    recs = _records(tmp_path / JOURNAL)
    promo = [r for r in recs
             if isinstance(r.get("key"), dict) and "promotion" in r["key"]]
    assert [r["status"] for r in promo] == ["swap", "demote"]
    assert promo[0]["record"] == promo[1]["record"]
    verify_leg = [r for r in recs if r.get("purpose") == "swap-verify"]
    assert len(verify_leg) == 1 and verify_leg[0]["served_method"] == 3


def test_rollback_demotes_on_engineered_regression(fake_executor, tmp_path):
    delay = fake_executor
    srv = _server(tmp_path)
    try:
        fp = srv.stats()["fingerprint"]
        _drive(srv.port, [dict(SHAPE, verify=True, iter=i)
                          for i in range(10)])
        rec = _record(fp, shape=_full_shape())
        assert srv.swap(rec)["installed"] is True
        delay["s"] = 0.35
        _drive(srv.port, [dict(SHAPE, verify=True, iter=i)
                          for i in range(8)])
        delay["s"] = 0.0
        body = run_pilot([str(tmp_path / JOURNAL)], seed=0,
                         serve_port=srv.port, synthetic=SPEC,
                         max_batches=4, device="cpu")
        [row] = body["demotions"]
        assert row["action"] == "demote" and row["seq"] == 1
        assert "confirmed request-wall step up" in row["reason"]
        assert row["outcome"]["ok"] is True
        assert row["outcome"]["restored_method"] == 1
        assert all(t["skipped"] == "already-promoted"
                   for t in body["targets"])
        assert body["campaigns"] == [] and body["promotions"] == []
        assert _drive(srv.port, [dict(SHAPE, verify=True)])[0][
            "served_method"] == 1
    finally:
        srv.stop()
        srv.close()
    out = next_pilot_path(str(tmp_path))
    blob = write_pilot(out, body)
    assert validate_pilot(blob) == [] and ref_validate_pilot(blob) == []
    assert replay_pilot(out)["verdict"] == "REPRODUCED"
    lie = copy.deepcopy(blob)
    lie["demotions"][0]["action"] = "hold"
    assert any("contradicts its own recorded detection" in e
               for e in validate_pilot(lie))


def test_unfusable_winner_on_cuda_fused_ends_verify_failed(tmp_path):
    """The campaign races on torch_sim whatever the target's backend, so
    it may crown the dense m=8 for a cuda_fused target. The swap's verify
    request runs through the normal queue on cuda_fused (the real
    executor: K2's plain version on the CPU), which refuses the schedule
    as K2 does: ``verify-failed``, the refusal named, nothing installed,
    m=1 still served on cuda_fused."""
    srv = _server(tmp_path, backend="cuda_fused")
    try:
        _skewed_traffic(srv.port)
        body = run_pilot([str(tmp_path / JOURNAL)], seed=0,
                         serve_port=srv.port, synthetic="100,m8*0.5",
                         max_batches=4, device="cpu")
        [d] = body["decisions"]
        assert d["winner_cid"] == "m8:a4:c2:t0"
        assert d["action"] == "verify-failed"
        assert d["swap"]["ok"] is True and d["swap"]["installed"] is False
        assert "UnfusableScheduleError" in d["swap"]["error"]
        assert body["promotions"] == [] and srv.stats()["promotions"] == []
        again = _drive(srv.port, [dict(SHAPE, verify=True)])[0]
        assert again["served_method"] == 1 and again["verified"] is True
        assert again["backend"] == "cuda_fused"
    finally:
        srv.stop()
        srv.close()
    verify_leg = [r for r in _records(tmp_path / JOURNAL)
                  if r.get("purpose") == "swap-verify"]
    assert len(verify_leg) == 1 and verify_leg[0]["backend"] == "cuda_fused"
    blob = write_pilot(next_pilot_path(str(tmp_path)), body)
    assert validate_pilot(blob) == [] and ref_validate_pilot(blob) == []


# ---------------------------------------------------------------------------
# No torch on the control plane


def test_pilot_host_paths_import_no_torch(tmp_path):
    """Under a poisoned torch (and jax, and the reference package): the
    pilot, the telemetry modules and the server import; ``pilot --replay``
    of the committed artifact reproduces; ``pilot --device cuda
    --synthetic`` names the missing gpu calibration once, writes an
    artifact that validates and replays."""
    for name in ("torch", "jax", "tpu_aggcomm"):
        pkg = tmp_path / "poison" / name
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(
            f"raise ImportError('poisoned {name}: the control plane must "
            f"not import it')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "poison"), REPO]))
    work = tmp_path / "work"
    work.mkdir()
    shutil.copy(os.path.join(REPO, "serve_pilot_exemplar.journal.jsonl"),
                work)

    def run(args):
        return subprocess.run([sys.executable, *args], env=env,
                              cwd=str(work), capture_output=True,
                              text=True, timeout=240)

    mods = ["tpu_aggcomm_torch.pilot", "tpu_aggcomm_torch.obs.export",
            "tpu_aggcomm_torch.obs.watch", "tpu_aggcomm_torch.obs.slo",
            "tpu_aggcomm_torch.obs.regress",
            "tpu_aggcomm_torch.serve.server"]
    r = run(["-c", "import " + ", ".join(mods) + ", sys; "
             "assert 'torch' not in sys.modules"])
    assert r.returncode == 0, r.stderr[-3000:]
    r = run(["-m", "tpu_aggcomm_torch.cli", "pilot", "--replay",
             os.path.join(REPO, "PILOT_r01.json")])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "-> REPRODUCED" in r.stdout
    r = run(["-m", "tpu_aggcomm_torch.cli", "pilot",
             "serve_pilot_exemplar.journal.jsonl", "--synthetic", SPEC,
             "--device", "cuda", "--predict-root", REPO, "--max-batches",
             "4", "--synth-root", "."])
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.count("has no 'gpu' calibration — ranking finalists "
                          "structurally") == 1
    assert "pilot artifact written: ./PILOT_r01.json" in r.stdout
    r = run(["-m", "tpu_aggcomm_torch.cli", "pilot", "--replay",
             "PILOT_r01.json"])
    assert r.returncode == 0 and "-> REPRODUCED" in r.stdout, r.stderr
    blob = json.load(open(work / "PILOT_r01.json"))
    assert blob["mode"] == "dry-run" and blob["manifest"]["device_kind"] \
        is None
    assert validate_pilot(blob) == [] and ref_validate_pilot(blob) == []
