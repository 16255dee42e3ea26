"""``analyze`` and ``inspect`` in the port against the reference's, on the
CPU.

The same arguments go to ``tpu_aggcomm.cli.main`` and
``tpu_aggcomm_torch.cli.main`` (in this process), and their stdout,
exit codes and ``--json`` artifacts are compared byte for byte:
``analyze`` (with its provenance join and refusals), the static view
``inspect -m`` (round-structured, TAM and collective methods),
``inspect traffic`` and ``inspect check`` (single, ``-m 0``,
``--fault``, ``--json``, ``--fused-export``), ``inspect trace`` and
``inspect ledger`` over a ``--device cpu`` trace and the committed
``FAULT_*`` traces, and ``inspect workload`` / ``inspect watch`` over
the committed serve journal and their committed artifacts' replays.
Each named departure is pinned by its exact text: ``--waves`` says
``cuda_dma``, the roofline rows are the H100's (``torch_sim``'s and
``torch_shard``'s), the fused export's TAM refusal names ``torch_sim``,
and the ``--ndev`` view prints the reference's block tables under the
name ``torch_shard``; the views ported since (``compare``, ``report``,
``history``, ``live``, ``flow``, ``watch --flow``) print what the
reference prints. ``--json`` artifacts are
written under ``tmp_path`` only. Sizes are n=8 a=3 d=64-256.
"""

import json
import os
import shutil

import pytest

pytest.importorskip("jax")

from tpu_aggcomm import cli as ref_cli  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness import roofline  # noqa: E402
from tpu_aggcomm_torch.harness.report import provenance_path  # noqa: E402
from tpu_aggcomm_torch.obs import ledger  # noqa: E402
from tpu_aggcomm_torch.obs.workload import wire_proposals  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["-n", "8", "-a", "3", "-d", "256", "-c", "2"]


def _call(main, argv, capsys):
    """(exit code or refusal message, stdout) of one in-process run."""
    capsys.readouterr()
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code
    return rc, capsys.readouterr().out


def _both(argv, capsys):
    got = _call(cli.main, argv, capsys)
    want = _call(ref_cli.main, argv, capsys)
    return got, want


def _same(argv, capsys):
    got, want = _both(argv, capsys)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# analyze

@pytest.fixture
def results(tmp_path, capsys):
    """A results.csv and sidecar from port runs on the CPU: two configs,
    three methods, torch_sim and the local oracle; then a truncated row
    and garbled sidecar rows (an unknown backend label, a phase label
    outside the vocabulary, a short row)."""
    csv = str(tmp_path / "results.csv")
    for argv in (["-m", "1", "-a", "3"], ["-m", "2", "-a", "3"],
                 ["-m", "1", "-a", "2", "-c", "1"],
                 ["-m", "3", "-a", "2", "--backend", "local"]):
        assert cli.main(["-n", "8", "-d", "64", *argv, "--device", "cpu",
                         "--results-csv", csv]) == 0
    with open(csv, "a") as fh:
        fh.write("8,3,64,All to many,7\n")
    with open(provenance_path(csv), "a") as fh:
        fh.write("2,torch_sim,bogus-label\n3\n")
    capsys.readouterr()
    return csv


def test_analyze_matches_the_reference(results, capsys):
    rc, out = _same(["analyze", "--results-csv", results], capsys)
    assert rc == 0
    assert out.count("winner: ") == 2
    assert "[local, " in out and "[torch_sim, " in out


@pytest.mark.parametrize("case", ["missing", "header-only", "unparseable"])
def test_analyze_refusals_match_the_reference(case, tmp_path, capsys):
    csv = tmp_path / "results.csv"
    if case == "header-only":
        csv.write_text("# of processes,# of aggregators,data size,Method,"
                       "max total time\n")
    elif case == "unparseable":
        csv.write_text("# of processes,Method\n8,All to many\n")
    rc, out = _same(["analyze", "--results-csv", str(csv)], capsys)
    assert isinstance(rc, str) and out == ""


# ---------------------------------------------------------------------------
# the static view

STATIC = [["-m", "1"], ["-m", "2"], ["-m", "9"], ["-m", "13", "-b", "1"],
          ["-m", "17"], ["-m", "1", "-t", "3", "-p", "2"],
          ["-m", "15", "-p", "4"], ["-m", "16", "-p", "4"], ["-m", "8"],
          ["-m", "5"]]


@pytest.mark.parametrize("argv", STATIC, ids=" ".join)
def test_static_view_matches_the_reference(argv, capsys):
    rc, out = _same(["inspect", *SMALL, *argv], capsys)
    assert rc == 0 and out.startswith(f"method {argv[1]} (")


@pytest.mark.parametrize("argv", [["-m", "1"], ["-m", "13", "-b", "1"],
                                  ["-m", "15", "-p", "4"], ["-m", "8"]],
                         ids=" ".join)
def test_waves_say_cuda_dma(argv, capsys):
    """The named departure: the wave accounting is the port's transport,
    ``cuda_dma.wave_profile``, with the reference's numbers."""
    (rc, got), (_, want) = _both(["inspect", *SMALL, *argv, "--waves"],
                                 capsys)
    assert rc == 0
    want = want.replace("pallas_dma lockstep  :", "cuda_dma lockstep  :")
    want = want.replace("pallas_dma concurrent:", "cuda_dma concurrent:")
    want = want.replace(
        "waves: n/a for TAM (the hierarchical engine rides mesh "
        "collectives, not the pallas_dma transport)",
        "waves: n/a for TAM (the hierarchical engine runs its 3-hop relay "
        "on torch_sim, not the cuda_dma transport)")
    want = want.replace(
        "waves: n/a for dense collectives (they lower to the vendor "
        "all_to_all, not the pallas_dma transport)",
        "waves: n/a for dense collectives (they lower to torch_sim's "
        "dense exchange, not the cuda_dma transport)")
    assert got == want
    assert "pallas_dma" not in got


def test_roofline_rows_are_the_h100_models(capsys):
    (rc, got), (_, want) = _both(["inspect", *SMALL, "-m", "1",
                                  "--roofline"], capsys)
    assert rc == 0
    head = want.split("roofline (floors at 819 GB/s HBM):")[0]
    assert got.startswith(head)
    s = compile_method(1, AggregatorPattern(8, 3, data_size=256,
                                            comm_size=2))
    rb = roofline.rep_bytes(s)
    chained = rb.total() + roofline.chain_overhead_bytes(s)
    f = rb.floor_seconds() * 1e6
    sb = roofline.rep_bytes(s, lowering="torch_shard")
    s_chained = sb.total() + roofline.chain_overhead_bytes(
        s, lowering="torch_shard")
    assert got[len(head):] == (
        "roofline (floors at 3350 GB/s H100 HBM; L2 copy figure 4453 "
        "GB/s):\n"
        f"  torch_sim: {rb.total() / 1e6:.2f} MB optimistic / "
        f"{rb.total() / 1e6:.2f} MB fenced (4 rounds) -> floors "
        f"[{f:.3f}, {f:.3f}] us/rep "
        f"({rb.floor_seconds(4453.0) * 1e6:.3f} us/rep at the L2 figure)\n"
        f"    gather 6144 B, scatter 6144 B, zero 18432 B, intermediate "
        f"12288 B, index 768 B, barrier 0 B, pad 0 B\n"
        f"  torch_sim --chained: {chained / 1e6:.2f} MB a rep with the "
        f"token and XOR -> floor {roofline.floor_seconds(chained) * 1e6:.3f}"
        f" us/rep\n"
        f"  torch_shard(ndev=1): {sb.total() / 1e6:.2f} MB a rep (4 rounds) "
        f"-> floor {sb.floor_seconds() * 1e6:.3f} us/rep\n"
        f"    gather 6144 B, scatter 6144 B, zero 256 B, intermediate "
        f"0 B, index 224 B, barrier 0 B, pad 0 B\n"
        f"  torch_shard --chained: {s_chained / 1e6:.2f} MB a rep with the "
        f"token and XOR -> floor "
        f"{roofline.floor_seconds(s_chained) * 1e6:.3f} us/rep\n")


@pytest.mark.parametrize("argv", [["-m", "15", "-p", "4"],
                                  ["-m", "16", "-p", "2"]], ids=" ".join)
def test_tam_roofline_line_is_torch_sims_route(argv, capsys):
    (rc, got), (_, want) = _both(["inspect", *SMALL, *argv, "--roofline"],
                                 capsys)
    assert rc == 0
    lines, ref_lines = got.splitlines(), want.splitlines()
    assert lines[:-1] == ref_lines[:-1]
    assert ref_lines[-1].startswith("roofline (jax_sim 3-hop route, "
                                    "floors at 819 GB/s HBM): ")
    s = compile_method(int(argv[1]), AggregatorPattern(
        8, 3, data_size=256, comm_size=2, proc_node=int(argv[3])))
    rb = roofline.tam_rep_bytes(s)
    chained = rb.total() + roofline.chain_overhead_bytes(s)
    assert lines[-1] == (
        f"roofline (torch_sim 3-hop route, floors at 3350 GB/s H100 HBM): "
        f"{rb.total() / 1e6:.2f} MB/rep (24 slabs x 2 hops materialized) "
        f"-> floor {rb.floor_seconds() * 1e6:.3f} us/rep; --chained "
        f"{chained / 1e6:.2f} MB -> floor "
        f"{roofline.floor_seconds(chained) * 1e6:.3f} us/rep; measured hop "
        f"times via --measured-phases --backend torch_sim")


@pytest.mark.parametrize("argv", [
    ["inspect", "-m", "1", "--ndev", "4"],
    ["inspect", "-m", "1", "--ndev", "3"],
    ["inspect", "-m", "13", "-b", "1", "--ndev", "2"],
    ["inspect", "-m", "9", "-c", "1", "--ndev", "8"],
    ["inspect", "-m", "8", "--ndev", "4"],
    ["inspect", "-m", "15", "-p", "4", "--ndev", "2"]],
    ids=lambda x: " ".join(x[1:]))
def test_views_not_ported_are_refused_by_name(argv, capsys):
    """The ``--ndev`` view, refused by name until the sharded tier was
    ported: the block tables over --ndev devices, the reference's stdout
    with ``jax_shard`` named ``torch_shard`` (a non-dividing count says
    so; collectives and TAM show no view, as the reference's)."""
    argv = [*argv[:1], *SMALL, *argv[1:]]
    (rc, got), (ref_rc, want) = _both(argv, capsys)
    assert rc == ref_rc == 0
    assert got == want.replace("jax_shard over", "torch_shard over")
    if argv[-4:] == ["-m", "1", "--ndev", "4"]:
        assert "torch_shard over 4 devices (2 ranks/device)" in got


#: the views these cases refused by name until they were ported: each
#: now runs through both packages on CPU inputs (paths under REPO, or
#: ``{tmp}`` for a file the case writes) and must print the same
PORTED_VIEWS = [
    ["inspect", "compare", "FAULT_healthy.trace.jsonl",
     "FAULT_deadlink.trace.jsonl", "--across-faults"],
    ["inspect", "report", "FAULT_healthy.trace.jsonl", "--out",
     "{tmp}/report.html"],
    ["inspect", "history"],
    ["inspect", "live", "--results-csv", "{tmp}/none.csv"],
    ["inspect", "flow", "flow_exemplar.client.journal.jsonl",
     "flow_exemplar.serve.journal.jsonl", "flow_exemplar.trace.jsonl"],
    ["inspect", "watch", "serve_exemplar.journal.jsonl", "--flow",
     "FLOW_r01.json"]]


@pytest.mark.parametrize("argv", PORTED_VIEWS, ids=lambda a: " ".join(a[:2])
                         + (" --flow" if "--flow" in a else ""))
def test_views_ported_match_the_reference(argv, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.chdir(REPO)
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    got, want = _both(argv, capsys)
    assert got == want
    assert not isinstance(got[0], str), got[0]   # no refusal, no usage
    if argv[1] == "report":
        html = (tmp_path / "report.html").read_text()
        _call(cli.main, argv, capsys)
        assert (tmp_path / "report.html").read_text() == html


# ---------------------------------------------------------------------------
# traffic and check

@pytest.mark.parametrize("view", ["traffic", "check"])
@pytest.mark.parametrize("argv", [["-m", "1"], ["-m", "0"],
                                  ["-m", "13", "-b", "1"],
                                  ["-m", "1", "--fault", "deadlink:5>3"],
                                  ["-m", "0", "--fault", "deadlink:5>3"],
                                  ["-m", "1", "--fault", "deadlink:2>1"]],
                         ids=" ".join)
def test_audit_and_checker_match_the_reference(view, argv, capsys):
    if view == "traffic" and argv[1] == "0" and "--fault" in argv:
        argv = argv[:2]       # the -m 0 audit takes no --fault, as the
    rc, out = _same(["inspect", view, *SMALL, *argv], capsys)  # reference
    assert rc in (0, 1) or "--fault" in rc


@pytest.mark.parametrize("view", ["traffic", "check"])
@pytest.mark.parametrize("fault", [None, "deadlink:5>3"])
def test_json_artifacts_match_the_reference(view, fault, tmp_path, capsys):
    base = ["inspect", view, *SMALL, "-m", "1"] + (
        ["--fault", fault] if fault else [])
    got = _call(cli.main, base + ["--json", str(tmp_path / "p.json")],
                capsys)
    want = _call(ref_cli.main, base + ["--json", str(tmp_path / "r.json")],
                 capsys)
    assert got[0] == want[0] == 0
    assert got[1].replace("p.json", "X") == want[1].replace("r.json", "X")
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()


@pytest.mark.parametrize("argv", [
    ["traffic", "-m", "1"], ["traffic", "-m", "0"], ["traffic", "-m", "8"],
    ["check", "-m", "0"], ["check", "-m", "15"],
    ["check", "-m", "1", "--fault", "deadlink:5>3"],
    ["check", "-m", "0", "--fault", "slow:r2*4"]], ids=" ".join)
def test_fused_export_matches_the_reference(argv, capsys):
    """K2's plan tables against the traffic audit. The one named
    departure: a TAM refusal names the port's route, ``torch_sim``."""
    (rc, got), (want_rc, want) = _both(
        ["inspect", argv[0], *SMALL, *argv[1:], "--fused-export"], capsys)
    assert rc == want_rc == 0
    assert got == want.replace("3-hop relay on jax_sim)",
                               "3-hop relay on torch_sim)")
    assert "DRIFT" not in got and "fused" in got


# ---------------------------------------------------------------------------
# trace, ledger, workload, watch

@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two traces of the port on the CPU: m=1 on torch_sim (3 reps) and
    -m 0 on torch_sim, each --verify."""
    d = tmp_path_factory.mktemp("traced")
    paths = []
    for name, m in (("one", "1"), ("all", "0")):
        prefix = str(d / name)
        assert cli.main(["-n", "8", "-m", m, "-a", "3", "-d", "64", "-c",
                         "2", "-k", "3", "--device", "cpu", "--verify",
                         "--trace", prefix, "--results-csv",
                         str(d / "r.csv")]) == 0
        paths.append(prefix + ".trace.jsonl")
    return paths


def test_trace_and_ledger_match_the_reference(traced, capsys):
    rc, out = _same(["inspect", "trace", *traced], capsys)
    assert rc == 0 and all(f"== {p} ==" in out for p in traced)
    # the ledger's manifest lines are the port's by design (obs/ledger
    # names torch, CUDA, nvcc and the card where the reference names jax,
    # jaxlib and libtpu); the blocks, their order and the drift verdicts
    # are the reference's
    (rc, got), (want_rc, want) = _both(["inspect", "ledger", *traced],
                                       capsys)
    assert rc == want_rc == 0
    assert got == ledger.render_ledgers(traced)
    assert "  torch " in got and "  jax " not in got

    def frame(text):
        return [ln for ln in text.splitlines() if not ln.startswith("  ")
                or ln == "  no environment drift"]

    assert frame(got) == frame(want)
    rc, out = _same(["inspect", "traffic", "-n", "8", "-m", "1", "-a", "3",
                     "-d", "64", "-c", "2"], capsys)
    assert rc == 0


@pytest.mark.parametrize("name", ["FAULT_healthy.trace.jsonl",
                                  "FAULT_deadlink.trace.jsonl"])
def test_trace_view_of_the_committed_traces(name, capsys):
    """The reference's own traces: the straggler summary and the advisory
    fault proposals (``resilience/detect``) equal the reference's."""
    rc, out = _same(["inspect", "trace", os.path.join(REPO, name)], capsys)
    assert rc == 0 and "straggler analytics" in out


def test_trace_and_ledger_refusals_match_the_reference(tmp_path, capsys):
    bad = tmp_path / "bad.trace.jsonl"
    bad.write_text("{not json\n")
    for argv in (["inspect", "trace"], ["inspect", "ledger",
                                        "--history-root", str(tmp_path)],
                 ["inspect", "trace", str(tmp_path / "missing.jsonl")]):
        _same(argv, capsys)


@pytest.mark.parametrize("view,artifact", [("workload", "WORKLOAD_r01.json"),
                                           ("watch", "WATCH_r01.json")])
def test_committed_artifacts_replay_reproduced(view, artifact, tmp_path,
                                               capsys):
    for name in (artifact, "serve_exemplar.journal.jsonl"):
        shutil.copy(os.path.join(REPO, name), tmp_path)
    path = str(tmp_path / artifact)
    rc, out = _same(["inspect", view, "--replay", path], capsys)
    assert rc == 0 and out == f"{view} replay: REPRODUCED ({path})\n"


@pytest.mark.parametrize("view", ["workload", "watch"])
def test_journal_views_match_the_reference(view, tmp_path, capsys):
    """The one named departure: a workload proposal's ``cli`` hint names
    the port's CLI (the replay reads it in either spelling)."""
    journal = os.path.join(REPO, "serve_exemplar.journal.jsonl")
    (rc, got), (want_rc, want) = _both(["inspect", view, journal, "--seed",
                                        "3"], capsys)
    assert rc == want_rc == 0
    assert got == want.replace("python -m tpu_aggcomm.cli ",
                               "python -m tpu_aggcomm_torch.cli ")
    got = _call(cli.main, ["inspect", view, journal, "--json",
                           str(tmp_path / "p.json")], capsys)
    want = _call(ref_cli.main, ["inspect", view, journal, "--json",
                                str(tmp_path / "r.json")], capsys)
    assert got[0] == want[0] == 0
    env = ("manifest", "created_unix")
    p, r = (wire_proposals(json.loads((tmp_path / f).read_text()))
            for f in ("p.json", "r.json"))
    assert {k: v for k, v in p.items() if k not in env} == \
        {k: v for k, v in r.items() if k not in env}
    assert p["manifest"]["versions"]["torch"]


def test_watch_replay_of_a_predict_artifact_is_refused(tmp_path, capsys):
    """An artifact that records a predict artifact replays through the
    explain join (``inspect watch --predict`` wrote it), under both
    packages; without the predict artifact next to it the replay is
    refused by name, as the reference's."""
    for name in ("serve_exemplar.journal.jsonl", "H100_PREDICT_r01.json",
                 "FAULT_healthy.trace.jsonl"):
        shutil.copy(os.path.join(REPO, name), tmp_path)
    journal = str(tmp_path / "serve_exemplar.journal.jsonl")
    trace = str(tmp_path / "FAULT_healthy.trace.jsonl")
    art = str(tmp_path / "WATCH_r02.json")
    rc, out = _call(cli.main, ["inspect", "watch", journal, trace,
                               "--predict",
                               str(tmp_path / "H100_PREDICT_r01.json"),
                               "--json", art], capsys)
    assert rc == 0 and f"watch artifact written: {art}" in out
    blob = json.load(open(art))
    assert blob["predict"] == "H100_PREDICT_r01.json" \
        and blob["evidence"]["explain"]
    for main in (cli.main, ref_cli.main):
        rc, out = _call(main, ["inspect", "watch", "--replay", art], capsys)
        assert rc == 0 and out == f"watch replay: REPRODUCED ({art})\n"
    os.remove(tmp_path / "H100_PREDICT_r01.json")
    for main in (cli.main, ref_cli.main):
        rc, out = _call(main, ["inspect", "watch", "--replay", art], capsys)
        assert rc == 1 and out.startswith(f"watch replay: MISMATCH vs {art}")
        assert "recorded predict artifact 'H100_PREDICT_r01.json' not " \
            "found next to the artifact" in out
