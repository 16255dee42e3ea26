"""The tuner of the port (``tpu_aggcomm_torch/tune``, ``cli tune``,
``--auto``) against the reference's (``tpu_aggcomm/tune``), on the CPU.

- ``build_space`` (every ``SpaceError`` text), ``race`` on seeded sample
  sets and ``replay_record`` give the reference's results field for field;
  the cost model's candidate pricing and the schema validator agree too.
- ``tune --synthetic '100,m3*0.5' --backend local`` through both CLIs
  gives artifacts equal but for ``created_unix``, ``manifest`` and
  ``key.fingerprint``; each package replays the other's ``REPRODUCED``
  and validates it. The committed ``TUNE_local_n8_d64_p1_a2m.json``
  replays in place; a tampered copy is a ``MISMATCH``.
- ``--model-prune --device cpu`` writes the reference's block; with a
  CUDA ``--device`` the committed model has no ``gpu`` entry, which is
  said once on stderr, and the full space races.
- A measured ``tune --backend torch_sim --device cpu`` writes an artifact
  that replays; ``run --auto`` in ANOTHER process resolves its winner
  (the fingerprints agree) and verifies; an entry tuned under another
  torch is a named drift fallback. ``sweep --auto``/``--tune-root``.
- The samplers hand out fresh samples, refuse an unfusable candidate by
  name and refuse under serve load; ``tune --synthetic``/``--replay``
  import no torch (a poisoned torch).

No test reads a time. Every artifact is written under ``tmp_path``.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from tpu_aggcomm import cli as ref_cli  # noqa: E402
from tpu_aggcomm.model import predict as ref_predict  # noqa: E402
from tpu_aggcomm.obs import regress as ref_regress  # noqa: E402
from tpu_aggcomm.tune import cache as ref_cache  # noqa: E402
from tpu_aggcomm.tune import race as ref_race  # noqa: E402
from tpu_aggcomm.tune import space as ref_space  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.model import predict  # noqa: E402
from tpu_aggcomm_torch.obs import ledger, regress  # noqa: E402
from tpu_aggcomm_torch.tune import cache, measure, race, space  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_TUNE = os.path.join(REPO, "TUNE_local_n8_d64_p1_a2m.json")
SYNTH = ["--synthetic", "100,m3*0.5", "--backend", "local", "-n", "8",
         "-d", "64", "-p", "1", "--methods", "1,3,7"]
MEASURED = ["--backend", "torch_sim", "--device", "cpu", "-n", "8", "-d",
            "64", "--methods", "1,3", "--cb-nodes", "2,3", "--comm-sizes",
            "2", "--iters-small", "2", "--iters-big", "12",
            "--batch-trials", "2", "--max-batches", "2"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def _run(args, cwd, env=None, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], cwd=str(cwd),
                          env=env or _env(), capture_output=True, text=True,
                          timeout=timeout)


def _strip(blob):
    out = json.loads(json.dumps(blob))
    out.pop("created_unix")
    out.pop("manifest")
    out["key"].pop("fingerprint")
    return out


# ---------------------------------------------------------------------------
# the copied pieces against the reference's


@pytest.mark.parametrize("grid", [
    ([1, 3, 7], [2, 4], [2, 8], [1]),
    ([2, 4], [3], [1], [0, 3]),
    ([1, 21], [2], [2], [1]),                     # a dead id
    ([1, 15], [2], [2], [1]),                     # TAM without opt-in
    ([1, 2], [2], [2], [1]),                      # mixed directions
    ([1, 99], [2], [2], [1]),                     # unknown id
    ([1], [0, 9], [2], [1]),                      # cb_nodes out of range
    ([1], [2], [0], [4]),                         # comm / agg_type range
    ([], [2], [2], [1]),                          # empty axis
])
def test_build_space_matches_the_reference(grid):
    def attempt(mod):
        try:
            return [c.cid for c in mod.build_space(*grid, nprocs=8)]
        except (space.SpaceError, ref_space.SpaceError) as e:
            return ("SpaceError", str(e))
    assert attempt(space) == attempt(ref_space)
    assert space.space_direction([3, 7]) == ref_space.space_direction([3, 7])
    for bad in ("m1:a2", "x1:a2:c3:t1", "m1:a2:c3:tz"):
        with pytest.raises(space.SpaceError) as got:
            space.parse_cid(bad)
        with pytest.raises(ref_space.SpaceError) as want:
            ref_space.parse_cid(bad)
        assert str(got.value) == str(want.value)


def _seeded_sets(seed: int, k: int = 5, batches: int = 6):
    rng = np.random.default_rng(seed)
    base = rng.uniform(50e-6, 60e-6, size=k)
    return {f"m{m}:a4:c8:t1": [list(rng.normal(base[i], base[i] * 0.05,
                                               size=3).astype(float))
                               for _ in range(batches)]
            for i, m in enumerate((1, 3, 6, 7, 9)[:k])}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("alpha", [0.05, 0.2])
def test_race_and_replay_match_the_reference(seed, alpha):
    sets = _seeded_sets(seed)
    order = list(sets)

    def sampler(cid, batch):
        return sets[cid][batch]

    got = race.race(order, sampler, max_batches=6, alpha=alpha, seed=seed)
    want = ref_race.race(order, sampler, max_batches=6, alpha=alpha,
                         seed=seed)
    assert got.__dict__ == want.__dict__
    assert got.medians() == want.medians()
    rec = {"seed": seed, "alpha": alpha, "n_boot": 2000, "max_batches": 6,
           "order": order, "samples": got.samples}
    assert race.replay_record(rec).__dict__ == \
        ref_race.replay_record(rec).__dict__
    # the synthetic sampler and its grammar errors, too
    s1 = race.make_synthetic_sampler("100,m3*0.5", seed=seed)
    s2 = ref_race.make_synthetic_sampler("100,m3*0.5", seed=seed)
    assert [s1(c, b) for c in order for b in range(3)] == \
        [s2(c, b) for c in order for b in range(3)]
    with pytest.raises(race.RaceError) as e1:
        race.make_synthetic_sampler("fast")
    with pytest.raises(ref_race.RaceError) as e2:
        ref_race.make_synthetic_sampler("fast")
    assert str(e1.value) == str(e2.value)


def test_committed_record_replays_and_validates_like_the_reference():
    entry = cache.load_tune(COMMITTED_TUNE)
    assert race.replay_record(entry["race"]).__dict__ == \
        ref_race.replay_record(entry["race"]).__dict__
    assert regress.validate_tune(entry) == ref_regress.validate_tune(entry) \
        == []
    # corruptions the validator names, in the reference's words
    for mutate in (lambda b: b["race"].update(winner="m9:a4:c8:t1"),
                   lambda b: b["race"]["samples"].update({"m1:a4:c8:t1":
                                                          [[]]}),
                   lambda b: b["key"].update(direction="sideways"),
                   lambda b: b["winner"].update(method=7),
                   lambda b: b.update(schema="tune-v0")):
        bad = json.loads(json.dumps(entry))
        mutate(bad)
        assert regress.validate_tune(bad) == ref_regress.validate_tune(bad)
        assert regress.validate_tune(bad)


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
def test_candidate_and_schedule_pricing_match_the_reference(platform):
    params = json.load(open(os.path.join(
        REPO, "PREDICT_r11.json")))["platforms"][platform]["params"]
    grid = ([1, 3, 7, 15], [2, 4], [2, 8], [1])
    cands = space.build_space(*grid, nprocs=8, include_tam=True)
    ref_cands = ref_space.build_space(*grid, nprocs=8, include_tam=True)
    got = predict.predict_candidates(cands, params, nprocs=8, data_size=64)
    want = ref_predict.predict_candidates(ref_cands, params, nprocs=8,
                                          data_size=64)
    assert got == want and got["m15:a2:c2:t1"] is None
    from tpu_aggcomm.core.methods import compile_method as ref_compile
    from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern
    for m in (1, 6, 17):
        kw = dict(data_size=64, comm_size=2)
        got = predict.predict_schedule(
            compile_method(m, AggregatorPattern(8, 3, **kw)), params,
            fault="slow:r2*4")
        want = ref_predict.predict_schedule(
            ref_compile(m, RefPattern(8, 3, **kw)), params,
            fault="slow:r2*4")
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_cache_lookup_reasons_match_the_reference(tmp_path):
    man = {"versions": {"torch": "1"}, "device_kind": None}
    key = cache.tune_key(nprocs=8, data_size=64, proc_node=1,
                         direction="all_to_many", backend="local",
                         manifest=man)
    assert key == ref_cache.tune_key(nprocs=8, data_size=64, proc_node=1,
                                     direction="all_to_many",
                                     backend="local", manifest=man)
    root = str(tmp_path)
    assert cache.artifact_path(root, key) == ref_cache.artifact_path(root,
                                                                     key)
    assert cache.lookup(root, key, manifest=man) == \
        ref_cache.lookup(root, key, manifest=man)
    shutil.copy(COMMITTED_TUNE, tmp_path)
    for k in (key, dict(key, nprocs=9)):
        got, want = cache.lookup(root, k, manifest=man), \
            ref_cache.lookup(root, k, manifest=man)
        assert got == want and got[0] is None
    assert "manifest drift" in cache.lookup(root, key, manifest=man)[1]


# ---------------------------------------------------------------------------
# the CLI: synthetic runs across packages, replays, the model prune


def test_synthetic_tune_matches_the_reference_and_cross_replays(tmp_path,
                                                                capsys):
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    mine.mkdir()
    theirs.mkdir()
    assert cli.main(["tune", *SYNTH, "--tune-root", str(mine)]) == 0
    assert ref_cli.main(["tune", *SYNTH, "--tune-root", str(theirs)]) == 0
    name = os.path.basename(COMMITTED_TUNE)
    a = cache.load_tune(str(mine / name))
    b = ref_cache.load_tune(str(theirs / name))
    assert _strip(a) == _strip(b)
    assert a["winner"]["method"] == 3 and a["synthetic"] is True
    assert a["manifest"]["versions"]["torch"] and "jax" not in \
        json.dumps(a["manifest"])
    for blob in (a, b):
        assert regress.validate_tune(blob) == [] == \
            ref_regress.validate_tune(blob)
    capsys.readouterr()
    assert cli.main(["tune", "--replay", str(theirs / name)]) == 0
    assert ref_cli.main(["tune", "--replay", str(mine / name)]) == 0
    out = capsys.readouterr().out
    assert out.count("-> REPRODUCED") == 2
    # the committed reference artifact replays in place
    assert cli.main(["tune", "--replay", COMMITTED_TUNE]) == 0
    assert "winner m3:a4:c8:t1 after 2 elimination(s) over 1 batch(es) -> " \
           "REPRODUCED" in capsys.readouterr().out


def test_tampered_committed_tune_is_a_mismatch(tmp_path, capsys):
    blob = cache.load_tune(COMMITTED_TUNE)
    blob["race"]["eliminations"][0]["ci_pct"][0] += 1.0
    path = tmp_path / os.path.basename(COMMITTED_TUNE)
    path.write_text(json.dumps(blob))
    assert cli.main(["tune", "--replay", str(path)]) == 1
    assert "-> MISMATCH vs stored record" in capsys.readouterr().out
    path.write_text("{not json")
    with pytest.raises(SystemExit, match="cannot read"):
        cli.main(["tune", "--replay", str(path)])


def test_model_prune_cpu_is_the_reference_block_and_gpu_has_none(
        tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)      # the committed PREDICT_r11.json
    grid = ["--cb-nodes", "2,4", "--comm-sizes", "1,8", "--model-prune",
            "1.2"]
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    mine.mkdir()
    theirs.mkdir()
    assert cli.main(["tune", *SYNTH, *grid, "--device", "cpu",
                     "--tune-root", str(mine)]) == 0
    assert ref_cli.main(["tune", *SYNTH, *grid,
                         "--tune-root", str(theirs)]) == 0
    name = os.path.basename(COMMITTED_TUNE)
    a, b = (json.load(open(r / name)) for r in (mine, theirs))
    assert a["model_prune"] == b["model_prune"]
    assert a["model_prune"]["platform"] == "cpu" and a["model_prune"][
        "pruned"]
    assert _strip(a) == _strip(b)
    assert cli.main(["tune", "--replay", str(mine / name)]) == 0
    assert "model-prune: " in capsys.readouterr().out
    # a CUDA device reads the gpu entry, which the committed model lacks
    assert cli.main(["tune", *SYNTH, *grid, "--tune-root", str(mine)]) == 0
    cap = capsys.readouterr()
    assert cap.err.count("tune --model-prune: PREDICT_r11.json has no "
                         "'gpu' calibration — racing the full space") == 1
    assert "tune: racing 12 candidate(s)" in cap.out
    assert "model_prune" not in json.load(open(mine / name))


def test_tune_refusals_are_named(tmp_path):
    base = ["tune", "-n", "8", "-d", "64", "--tune-root", str(tmp_path)]
    for argv, needle in (
            (["--backend", "local"], "pass --backend torch_sim or "
                                     "cuda_fused, or --synthetic SPEC"),
            (["--backend", "cuda_dma"], "(got --backend cuda_dma)"),
            (["--methods", "1,2", "--synthetic", "100"],
             "tune: tuning grid mixes traffic directions"),
            (["--methods", "1,x", "--synthetic", "100"],
             "not a comma-separated int list"),
            (["--synthetic", "100", "--model-prune", "0.5"],
             "margin must be >= 1.0"),
            (["--synthetic", "m3"], "tune --synthetic: ")):
        with pytest.raises(SystemExit) as e:
            cli.main([*base, *argv])
        assert needle in str(e.value.code)
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# measured on the CPU, then --auto in another process


def test_measured_tune_replays_and_auto_hits_from_another_process(
        tmp_path, capsys):
    root = tmp_path / "tune"
    root.mkdir()
    assert cli.main(["tune", *MEASURED, "--tune-root", str(root)]) == 0
    out = capsys.readouterr().out
    assert "tune: racing 4 candidate(s) (measured, chained torch_sim)" \
        in out
    assert "0 CUDA graph capture(s)" in out          # the CPU chain
    path = root / "TUNE_torch_sim_n8_d64_p1_a2m.json"
    blob = json.load(open(path))
    assert regress.validate_tune(blob) == ref_regress.validate_tune(blob) \
        == []
    assert blob["synthetic"] is False and blob["key"]["backend"] == \
        "torch_sim"
    assert all(len(b) == 2 for bl in blob["race"]["samples"].values()
               for b in bl)
    assert cli.main(["tune", "--replay", str(path)]) == 0
    assert ref_cli.main(["tune", "--replay", str(path)]) == 0
    assert capsys.readouterr().out.count("-> REPRODUCED") == 2
    win = blob["winner"]
    run = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "4",
           "--device", "cpu", "--auto", "--tune-root", str(root),
           "--verify", "--results-csv", str(tmp_path / "r.csv")]
    # a separate process computes the same fingerprint: a hit
    r = _run(["tpu_aggcomm_torch.cli", *run], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (f"auto: tuned -m {win['method']} -a {win['cb_nodes']} "
            f"-c {win['comm_size']} -t {win['agg_type']} from ") in r.stdout
    assert f"cb_nodes = {win['cb_nodes']}," in r.stdout
    assert "max total time" in r.stdout
    # tuned under another torch: a named drift, the flags kept
    blob["manifest"]["versions"]["torch"] = "9.9.9+cu999"
    blob["key"]["fingerprint"] = cache.manifest_fingerprint(blob["manifest"])
    path.write_text(json.dumps(blob))
    assert cli.main(run) == 0
    cap = capsys.readouterr()
    assert (f"auto: manifest drift vs tuned entry {path}: versions.torch "
            f"— re-tune in this environment; falling back to -m 1") \
        in cap.err
    assert "cb_nodes = 3," in cap.out


def test_reference_artifact_is_a_named_drift_for_the_port(tmp_path, capsys):
    """The committed TUNE file was tuned under jax: the port's --auto
    names the drift (the two manifests differ) and keeps the flags."""
    argv = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
            "--backend", "local", "--auto", "--tune-root", REPO,
            "--results-csv", str(tmp_path / "r.csv")]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert f"auto: manifest drift vs tuned entry {COMMITTED_TUNE}: " in err
    assert "falling back to -m 1" in err
    # and a synthetic port entry for the same key hits (no device facts
    # on either side)
    assert cli.main(["tune", *SYNTH, "--tune-root", str(tmp_path)]) == 0
    capsys.readouterr()
    assert cli.main([*argv[:-4], "--tune-root", str(tmp_path),
                     "--results-csv", str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert "auto: tuned -m 3 -a 4 -c 8 -t 1 [synthetic tune] from " in out
    assert "comm_size = 8," in out


def test_auto_misses_are_named(tmp_path, capsys):
    base = ["-n", "8", "-a", "3", "-d", "64", "-c", "2", "--device", "cpu",
            "--auto", "--tune-root", str(tmp_path), "--results-csv",
            str(tmp_path / "r.csv")]
    assert cli.main([*base, "-m", "1"]) == 0
    assert ("auto: no tuned entry at "
            f"{tmp_path}/TUNE_torch_sim_n8_d64_p1_a2m.json; falling back "
            "to -m 1") in capsys.readouterr().err
    # -m 0 names no direction
    assert cli.main([*base, "-m", "0", "--backend", "local"]) == 0
    assert "auto: -m 0 does not name a direction" in capsys.readouterr().err


def test_auto_fault_advisory_reads_only_its_platform(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.chdir(REPO)
    base = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
            "--fault", "slow:r2*2", "--auto", "--tune-root", str(tmp_path),
            "--results-csv", str(tmp_path / "r.csv"), "--verify"]
    assert cli.main([*base, "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "the model (./PREDICT_r11.json, cpu) ranks repaired -m " in \
        cap.err
    assert "ADVISORY pick" in cap.err
    ref_args = ref_cli.build_parser().parse_args([*base, "--backend",
                                                  "jax_sim"])
    args = cli.build_parser().parse_args([*base, "--device", "cpu"])
    assert ref_cli._auto_fault_advise(ref_args, 8, "miss") is True
    assert cli._auto_fault_advise(args, 8, "miss") is True
    assert args.method == ref_args.method
    capsys.readouterr()
    args = cli.build_parser().parse_args(base)        # --device cuda
    assert cli._auto_fault_advise(args, 8, "miss") is False
    assert args.method == 1
    assert capsys.readouterr().err.count(
        "auto: ./PREDICT_r11.json has no calibrated 'gpu' parameters; "
        "keeping explicit flags") == 1


@pytest.mark.parametrize("flags", [["--auto"],
                                   ["--auto", "--tune-root", "TMP"]])
def test_sweep_auto_resolves_the_tuned_method(tmp_path, capsys, flags,
                                              monkeypatch):
    """A synthetic torch_sim entry (no device facts) serves a CPU sweep's
    --auto, which sweeps the tuned METHOD over its own throttle grid."""
    root = str(tmp_path) if "TMP" in flags else "."
    flags = [root if f == "TMP" else f for f in flags]
    monkeypatch.chdir(tmp_path)
    assert cli.main(["tune", "--synthetic", "100,m3*0.5", "--backend",
                     "torch_sim", "-n", "8", "-d", "64", "--methods", "1,3",
                     "--cb-nodes", "3", "--comm-sizes", "2",
                     "--tune-root", root]) == 0
    capsys.readouterr()
    assert cli.main(["sweep", "-n", "8", "-a", "3", "-d", "64", "-i", "1",
                     "--comm-sizes", "1,2", "--device", "cpu", "--verify",
                     *flags, "--results-csv", str(tmp_path / "s.csv")]) == 0
    out = capsys.readouterr().out
    assert ("auto: tuned method -m 3 [synthetic tune] from "
            f"{root}/TUNE_torch_sim_n8_d64_p1_a2m.json") in out
    assert out.count("RUN_OPTS: -a 3 -d 64 -c ") == 2
    assert "-m 3 -i 1" in out


# ---------------------------------------------------------------------------
# the samplers


def test_torch_sim_sampler_gives_fresh_samples_and_one_chain_pair(
        monkeypatch):
    from tpu_aggcomm_torch.backends import registry
    made, real = [], registry.get_backend

    def recording(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    monkeypatch.setattr(registry, "get_backend", recording)
    sampler = measure.make_torch_sim_sampler(
        nprocs=8, data_size=64, proc_node=1, device="cpu", iters_small=2,
        iters_big=12, batch_trials=2)
    a = sampler("m1:a2:c2:t1", 0)
    b = sampler("m1:a2:c2:t1", 1)
    assert len(a) == len(b) == 2 and a is not b
    assert all(isinstance(x, float) and x > 0 for x in a + b)
    (backend,) = made
    assert backend.name == "torch_sim"
    keys = [k for k in backend._chain_cache if "tune_chains" in k]
    assert len(keys) == 1


@pytest.mark.parametrize("method,needle", [
    (8, "dense collective"), (15, "TAM")])
def test_cuda_fused_sampler_refuses_unfusable_candidates_by_name(method,
                                                                 needle):
    from tpu_aggcomm_torch.native.fuse import UnfusableScheduleError
    sampler = measure.make_cuda_fused_sampler(
        nprocs=8, data_size=64, proc_node=1, device="cpu", iters_small=2,
        iters_big=12, batch_trials=2)
    assert len(sampler("m1:a2:c2:t1", 0)) == 2
    with pytest.raises(UnfusableScheduleError, match=needle):
        race.race(["m1:a2:c2:t1", f"m{method}:a2:c2:t1"], sampler,
                  max_batches=1)


def test_samplers_refuse_under_serve_load_and_jax_shard_by_name():
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    with measure.serve_dispatch_inflight("cuda_fused"):
        with pytest.raises(measure.PilotContentionError,
                           match="'cuda_fused'"):
            measure.make_cuda_fused_sampler(nprocs=8, data_size=64,
                                            proc_node=1, device="cpu")
        measure.make_torch_sim_sampler(nprocs=8, data_size=64,
                                       proc_node=1, device="cpu")
    with pytest.raises(NotPortedError, match="queue A item 8"):
        measure.make_jax_shard_sampler(nprocs=8)


def test_record_device_facts_fills_the_card_and_skips_the_cpu(monkeypatch):
    import torch
    ledger.reset()
    try:
        measure.record_device_facts("cpu")
        assert ledger.manifest()["device_kind"] is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card")
        fp = cache.manifest_fingerprint(ledger.manifest())
        measure.record_device_facts("cuda")
        assert ledger.manifest()["device_kind"] == "Card"
        assert cache.manifest_fingerprint(ledger.manifest()) != fp
        assert ledger.manifest()["versions"]["torch"] == torch.__version__
        assert ledger.manifest()["versions"]["cuda"] == torch.version.cuda
    finally:
        ledger.reset()


def test_manifest_records_the_card_for_a_cuda_device_only(monkeypatch):
    """``ledger.manifest(device=)`` is the one place that decides whether
    a fingerprint names the card; the CLI passes None for a host
    oracle."""
    import argparse

    import torch
    from tpu_aggcomm_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card")
    ledger.reset()
    try:
        assert ledger.manifest()["device_kind"] is None
        assert ledger.manifest(device="cpu")["device_kind"] is None
        assert ledger.manifest(device=torch.device("cpu"))[
            "device_kind"] is None
        assert ledger.manifest(device="cuda:0")["device_kind"] == "Card"
        assert ledger.manifest()["device_kind"] == "Card"
    finally:
        ledger.reset()
    for backend, device, want in (("local", "cuda", None),
                                  ("native", "cuda", None),
                                  ("torch_sim", "cuda", "cuda"),
                                  ("cuda_fused", "cpu", "cpu")):
        ns = argparse.Namespace(backend=backend, device=device)
        assert cli._fingerprint_device(ns) == want


def test_host_paths_import_no_torch(tmp_path):
    """``tune --synthetic``, ``tune --replay``, ``synth --synthetic`` and
    ``synth --replay`` under a poisoned torch (and jax, and the
    reference package)."""
    for name in ("torch", "jax", "tpu_aggcomm"):
        pkg = tmp_path / "poison" / name
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text(
            f"raise ImportError('poisoned {name}: the host paths must not "
            f"import it')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "poison"), REPO]))
    work = tmp_path / "work"
    work.mkdir()
    for args in (["tune", *SYNTH, "--tune-root", "."],
                 ["tune", "--replay", "TUNE_local_n8_d64_p1_a2m.json"],
                 ["tune", "--replay", COMMITTED_TUNE],
                 ["tune", *SYNTH, "--model-prune", "--tune-root", "."],
                 ["synth", "--synthetic", "100,m101*0.5", "-n", "16", "-a",
                  "4", "-c", "1", "-d", "64", "--init", "8",
                  "--mutate-rounds", "1", "--synth-root", "."],
                 ["synth", "--replay", "SYNTH_r01.json"],
                 ["synth", "--replay", os.path.join(REPO, "SYNTH_r01.json")]):
        r = _run(["tpu_aggcomm_torch.cli", *args], work, env=env)
        assert r.returncode == 0, (args, r.stderr[-3000:])
        assert "poisoned" not in r.stderr
    assert sorted(os.listdir(work)) == ["SYNTH_r01.json",
                                        "TUNE_local_n8_d64_p1_a2m.json"]
