"""The schedule synthesizer of the port (``tpu_aggcomm_torch/synth``,
``cli synth``, ``--synth-root``) against the reference's, on the CPU.

- The committed ``SYNTH_r01.json`` replays ``REPRODUCED`` through the
  port's CLI; a tampered copy is a ``MISMATCH`` naming the block.
- ``synth --synthetic`` at the artifact's cell (n=32 a=4 c=1 d=512, seed
  0) gives, in both packages, the same artifact but for ``created_unix``,
  ``manifest`` and ``backend`` (the port's ``torch_sim`` for the
  reference's ``jax_sim``); each package replays the other's.
- ``build_schedule`` over a seeded sample of 16 compositions gives the
  reference's op programs, round tables and fused plans (the comparison
  of ``tests/test_torch_tables.py``), and the search the reference's rows.
- The registered m=101-103 on ``torch_sim`` (CPU) and ``local`` deliver
  recv arenas byte-equal to the reference's ``jax_sim``; K2's plain
  version equals the reference's ``pallas_fused`` in interpret mode;
  ``run -m 10x --synth-root`` verifies on every one-card backend.

A fixture removes every id a test registers, from both registries.
"""

import copy
import json
import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tpu_aggcomm import cli as ref_cli  # noqa: E402
from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.backends.jax_sim import _round_tables as ref_round_tables  # noqa: E402
from tpu_aggcomm.backends.jax_sim import dense_send_lanes as ref_send  # noqa: E402
from tpu_aggcomm.backends.pallas_fused import PallasFusedBackend  # noqa: E402
from tpu_aggcomm.core.methods import METHODS as REF_METHODS  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.native import fuse as ref_fuse  # noqa: E402
from tpu_aggcomm.obs import regress as ref_regress  # noqa: E402
from tpu_aggcomm import synth as ref_synth  # noqa: E402

from tpu_aggcomm_torch import cli, synth  # noqa: E402
from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import (from_reference,  # noqa: E402
                                              lanes_to_bytes, to_reference)
from tpu_aggcomm_torch.backends.local import LocalBackend  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,  # noqa: E402
                                                  _round_tables)
from tpu_aggcomm_torch.core.methods import METHODS, compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness.verify import slot_shapes  # noqa: E402
from tpu_aggcomm_torch.native import fuse  # noqa: E402
from tpu_aggcomm_torch.obs import regress  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "SYNTH_r01.json")
CELL = ["-n", "32", "-a", "4", "-c", "1", "-d", "512", "--seed", "0"]
SYNTHESIZED = (101, 102, 103)
# (nprocs, cb_nodes, data_size, comm_size): int32 lanes; byte lanes
SHAPES = [(16, 4, 64, 1), (8, 3, 30, 3)]


@pytest.fixture(autouse=True)
def _registry_guard():
    """Registration mutates both packages' METHODS tables; every test
    leaves them exactly as found."""
    before, ref_before = set(METHODS), set(REF_METHODS)
    yield
    for mid in set(METHODS) - before:
        del METHODS[mid]
    for mid in set(REF_METHODS) - ref_before:
        del REF_METHODS[mid]


def _registered_pair():
    got = synth.ensure_registered(REPO)
    want = ref_synth.ensure_registered(REPO)
    assert got == want and sorted(got) == list(SYNTHESIZED)


def _pair(m, shape):
    n, a, d, c = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c)))


# ---------------------------------------------------------------------------
# replay and the synthetic pipeline across packages


def test_committed_artifact_replays_in_place(capsys):
    assert cli.main(["synth", "--replay", COMMITTED]) == 0
    assert ("replay SYNTH_r01.json: 66 composition(s) re-searched, winner "
            "m103:a4:c1:t1 -> REPRODUCED") in capsys.readouterr().out
    blob = synth.load_artifact(COMMITTED)
    assert regress.validate_synth(blob) == \
        ref_regress.validate_synth(blob) == []


@pytest.mark.parametrize("tamper,needle", [
    (lambda b: b["race"]["eliminations"][0].update(batch=5),
     "race eliminations do not re-derive"),
    (lambda b: b["search"]["rows"][0].update(bytes=1),
     "search.rows does not re-derive"),
])
def test_tampered_artifact_is_a_mismatch(tmp_path, capsys, tamper, needle):
    blob = synth.load_artifact(COMMITTED)
    tamper(blob)
    path = tmp_path / "SYNTH_r01.json"
    path.write_text(json.dumps(blob))
    assert cli.main(["synth", "--replay", str(path)]) == 1
    out = capsys.readouterr().out
    assert "-> MISMATCH vs stored record" in out and needle in out


def test_synthetic_synth_matches_the_reference_and_cross_replays(
        tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)           # the committed PREDICT_r11.json
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    mine.mkdir()
    theirs.mkdir()
    spec = ["--synthetic", "100,m101*0.5"]
    assert cli.main(["synth", *CELL, *spec, "--device", "cpu",
                     "--synth-root", str(mine)]) == 0
    assert ref_cli.main(["synth", *CELL, *spec,
                         "--synth-root", str(theirs)]) == 0
    a = synth.load_artifact(str(mine / "SYNTH_r01.json"))
    b = ref_synth.load_artifact(str(theirs / "SYNTH_r01.json"))
    assert (a["backend"], b["backend"]) == ("torch_sim", "jax_sim")
    assert a["inputs"]["params_source"] == "PREDICT_r11.json [cpu]"
    for blob in (a, b):
        for k in ("created_unix", "manifest", "backend"):
            blob.pop(k)
    assert a == b
    assert a["winner"]["method_id"] == 101 and a["winner"]["synthesized"]
    capsys.readouterr()
    assert cli.main(["synth", "--replay", str(theirs / "SYNTH_r01.json")]) \
        == 0
    assert ref_cli.main(["synth", "--replay",
                         str(mine / "SYNTH_r01.json")]) == 0
    assert capsys.readouterr().out.count("-> REPRODUCED") == 2
    blob = json.load(open(mine / "SYNTH_r01.json"))
    assert ref_regress.validate_synth(blob) == regress.validate_synth(blob) \
        == []


def test_synth_on_a_card_device_ranks_structurally(tmp_path, capsys,
                                                   monkeypatch):
    """With a CUDA --device the gpu entry is read; the committed model has
    none, which is said once, and the search ranks structurally."""
    monkeypatch.chdir(REPO)
    assert cli.main(["synth", "-n", "16", "-a", "4", "-c", "1", "-d", "64",
                     "--init", "8", "--mutate-rounds", "1",
                     "--synthetic", "100,m101*0.5",
                     "--synth-root", str(tmp_path)]) == 0
    assert capsys.readouterr().err.count(
        "synth: PREDICT_r11.json has no 'gpu' calibration — ranking "
        "finalists structurally") == 1
    blob = json.load(open(tmp_path / "SYNTH_r01.json"))
    assert blob["inputs"] == {"params": None, "params_source": None}
    assert blob["search"]["priced"] is False


def test_reference_win_writes_no_artifact(tmp_path, capsys):
    assert cli.main(["synth", "-n", "16", "-a", "4", "-c", "1", "-d", "64",
                     "--init", "8", "--mutate-rounds", "1", "--device",
                     "cpu", "--synthetic", "100,m3*0.5",
                     "--synth-root", str(tmp_path)]) == 1
    assert ("synth: the reference method m=3 won the race — no synthesized "
            "schedule beat the field") in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("params", [None, "cpu"])
def test_search_matches_the_reference(params):
    p = None if params is None else json.load(open(os.path.join(
        REPO, "PREDICT_r11.json")))["platforms"][params]["params"]
    kw = dict(nprocs=16, cb_nodes=4, comm_size=2, data_size=64, seed=3,
              params=p, init=12, mutate_rounds=1, top_k=2)
    got = synth.search(**kw)
    want = ref_synth.search(**kw)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert synth.reference_methods("a2m") == ref_synth.reference_methods(
        "a2m")
    assert synth.reference_methods("m2a") == ref_synth.reference_methods(
        "m2a")


# ---------------------------------------------------------------------------
# schedules: op programs and tables


def _op_rows(sched):
    return [[(o.kind.name, o.peer, o.slot, o.peer2, o.slot2, o.round,
              o.token, tuple(o.tokens), o.bucket.name, o.nbytes, o.chan)
             for o in prog] for prog in sched.programs]


SAMPLE = random.Random(0).sample(synth.enumerate_space(), 16)


@pytest.mark.parametrize("comp", SAMPLE, ids=lambda c: c.canonical())
def test_build_schedule_tables_match_the_reference(comp):
    n, a, d, c = SHAPES[0]
    ref_comp = ref_synth.parse_composition(comp.canonical())
    assert ref_comp.canonical() == comp.canonical()
    try:
        want = ref_synth.build_schedule(ref_comp, RefPattern(
            n, a, data_size=d, comm_size=c), method_id=100)
    except ref_synth.CompositionError as e:
        with pytest.raises(synth.CompositionError) as got:
            synth.build_schedule(comp, AggregatorPattern(
                n, a, data_size=d, comm_size=c), method_id=100)
        assert str(got.value) == str(e)
        return
    got = synth.build_schedule(comp, AggregatorPattern(
        n, a, data_size=d, comm_size=c), method_id=100)
    assert (got.name, got.variant, got.collective) == \
        (want.name, want.variant, want.collective)
    assert _op_rows(got) == _op_rows(want)
    if want.n_staging:
        # relay staging: both packages refuse the healthy tables by name
        # and run the faulted lowering; its arenas are compared instead
        with pytest.raises(ValueError) as e_got:
            _round_tables(got)
        with pytest.raises(ValueError) as e_want:
            ref_round_tables(want)
        assert str(e_got.value) == str(e_want.value)
        send = ref_send(want.pattern, 0)
        arena = np.asarray(jax.jit(JaxSimBackend().one_rep(want))(send))
        np.testing.assert_array_equal(to_reference(
            TorchSimBackend("cpu").one_rep(got)(from_reference(send, "cpu"))),
            arena)
        g_tabs = w_tabs = []
        g_bars = w_bars = None
    else:
        g_tabs, g_bars = _round_tables(got)
        w_tabs, w_bars = ref_round_tables(want)
    assert g_bars == w_bars and len(g_tabs) == len(w_tabs)
    for g, w in zip(g_tabs, w_tabs):
        assert g[0] == w[0]
        for ga, wa in zip(g[1:], w[1:]):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
    try:
        want_plan = ref_fuse.fuse_plan(want)
    except ref_fuse.UnfusableScheduleError as e:
        with pytest.raises(fuse.UnfusableScheduleError) as err:
            fuse.fuse_plan(got)
        assert str(err.value) == str(e)
        return
    got_plan = fuse.fuse_plan(got)
    assert fuse.plan_round_matrices(got_plan) == \
        ref_fuse.plan_round_matrices(want_plan)
    assert (got_plan.rounds, got_plan.barriers) == (want_plan.rounds,
                                                    want_plan.barriers)


# ---------------------------------------------------------------------------
# the registered methods on the port's backends


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", SYNTHESIZED)
def test_synthesized_arenas_match_jax_sim(method, shape):
    _registered_pair()
    rs, s = _pair(method, shape)
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(JaxSimBackend().one_rep(rs))(send))
    got = to_reference(TorchSimBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the local oracle's delivery is the same bytes
    _, n_recv = slot_shapes(s.pattern)
    arena = lanes_to_bytes(want[:, :n_recv], s.pattern.data_size)
    recv, _ = LocalBackend().run(s, verify=True)
    for r, rows in enumerate(recv):
        if rows is not None:
            np.testing.assert_array_equal(np.asarray(rows),
                                          arena[r][:len(rows)])
    assert sum(r is not None for r in recv) == shape[1]


@pytest.mark.parametrize("method", SYNTHESIZED)
def test_synthesized_plain_fused_matches_pallas_interpret(method):
    _registered_pair()
    rs, s = _pair(method, (8, 3, 32, 1))
    plan = fuse.fuse_plan(s)
    assert len(plan.rounds) == 1          # window=drain: one incast round
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(
        PallasFusedBackend(interpret=True).one_rep(rs))(send))
    before = fuse.fused_rep.launches
    got = to_reference(CudaFusedBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    assert fuse.fused_rep.launches == before
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["torch_sim", "cuda_fused", "local"])
def test_cli_runs_synthesized_methods_with_synth_root(tmp_path, capsys,
                                                     backend, monkeypatch):
    for m in SYNTHESIZED:
        assert cli.main(["-n", "16", "-m", str(m), "-a", "4", "-d", "64",
                         "-c", "1", "--backend", backend, "--device", "cpu",
                         "--synth-root", REPO, "--verify", "--results-csv",
                         str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines()
                if ln.startswith("| Synthesized fanin=0|order=")
                and "max total time" in ln]) == 3
    # an id in the reserved range implies root '.'
    monkeypatch.chdir(REPO)
    assert cli.main(["-n", "8", "-m", "102", "-a", "3", "-d", "64",
                     "--backend", backend, "--device", "cpu", "--verify",
                     "--results-csv", str(tmp_path / "r.csv")]) == 0


def test_registration_is_idempotent_and_refuses_conflicts(tmp_path, capsys):
    _registered_pair()
    assert synth.registered_synth_ids() == list(SYNTHESIZED)
    assert synth.ensure_registered(REPO) == ref_synth.ensure_registered(REPO)
    other = "fanin=0|order=strided|relay=0|self=copy|sync=eager|wait=round|" \
            "window=drain"
    with pytest.raises(synth.RegisterError) as got:
        synth.register_composition(other, method_id=101)
    with pytest.raises(ref_synth.RegisterError) as want:
        ref_synth.register_composition(other, method_id=101)
    assert str(got.value) == str(want.value)
    with pytest.raises(synth.RegisterError, match="outside the synthesized"):
        synth.register_composition(other, method_id=100)
    # a broken artifact is skipped by name, never silently
    blob = copy.deepcopy(synth.load_artifact(COMMITTED))
    (tmp_path / "SYNTH_r01.json").write_text(json.dumps(blob)[:-40])
    assert synth.ensure_registered(str(tmp_path)) == {}
    assert "synth: skipping unreadable artifact" in capsys.readouterr().err
