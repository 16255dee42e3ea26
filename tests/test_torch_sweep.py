"""``cli sweep`` of the port against the reference's, on the CPU.

The port's sweep and the reference's ``sweep --backend local`` run the
same arguments: the results CSV agrees on every column but the timers,
the resume sidecar's and the run journal's keys are the reference's
(plus ``device`` for a device backend asked to run on the CPU), and
``--resume`` skips every recorded cell, re-runs a cell recorded under
another environment and names the drift. Every named refusal of ``run``
and ``sweep`` is pinned. No test reads a time.
"""

import csv
import json

import pytest
import torch

pytest.importorskip("jax")

from tpu_aggcomm import cli as ref_cli  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.obs import ledger  # noqa: E402
from tpu_aggcomm_torch.resilience import watchdog  # noqa: E402

SMALL = ["-n", "8", "-a", "3", "-d", "256", "--comm-sizes", "1,2,4",
         "-i", "2", "--verify"]
FAULTS = ["--fault", "none", "--fault", "deadlink:5>3"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _sweep(tmp_path, name, argv, *, ref=False):
    path = str(tmp_path / name)
    main = ref_cli.main if ref else cli.main
    assert main(["sweep", *argv, "--results-csv", path]) == 0
    return path


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.parametrize("backend", ["torch_sim", "local"])
def test_sweep_csv_matches_the_reference_local(tmp_path, backend):
    """Six cells (-c 1, 2, 4, healthy and with a repaired dead link), two
    iterations each: the same rows, every non-timer column equal."""
    ref = _sweep(tmp_path, "ref.csv", [*SMALL, *FAULTS, "--backend",
                                       "local"], ref=True)
    got = _sweep(tmp_path, "got.csv", [*SMALL, *FAULTS, "--backend",
                                       backend, "--device", "cpu"])
    want, have = _rows(ref), _rows(got)
    assert have[0] == want[0]
    assert len(have) == len(want) == 1 + 3 * 2 * 2
    assert [r[:7] for r in have] == [r[:7] for r in want]
    assert {r[4] for r in have[1:]} == {"1", "2", "4"}


def test_sidecar_and_journal_keys_are_the_references(tmp_path):
    ref = _sweep(tmp_path, "ref.csv", [*SMALL, *FAULTS, "--backend",
                                       "local"], ref=True)
    got = _sweep(tmp_path, "got.csv", [*SMALL, *FAULTS, "--backend",
                                       "local"])
    assert _lines(got + ".sweep.jsonl") == _lines(ref + ".sweep.jsonl")
    want = [e for e in _lines(ref + ".journal.jsonl") if "key" in e]
    have = [e for e in _lines(got + ".journal.jsonl") if "key" in e]
    assert [e["key"] for e in have] == [e["key"] for e in want]
    assert [e["shape_keys"] for e in have] == [e["shape_keys"]
                                               for e in want]
    assert {e["status"] for e in have} == {"done"}
    faulted = [e["key"] for e in have if "fault" in e["key"]]
    assert len(faulted) == 3 and faulted[0]["fault"] == "deadlink:5>3"
    # a device backend run on the CPU stamps its device, so a CPU
    # rehearsal never counts as a card cell on --resume
    cpu = _sweep(tmp_path, "cpu.csv", [*SMALL, "--device", "cpu"])
    keys = [e["key"] for e in _lines(cpu + ".journal.jsonl") if "key" in e]
    assert keys == [dict(e["key"], backend="torch_sim", device="cpu")
                    for e in want if "fault" not in e["key"]]
    header = _lines(cpu + ".journal.jsonl")[0]
    man = header["manifest"]
    assert set(man["versions"]) == {"torch", "cuda", "nvcc"}
    assert "jax" not in json.dumps(man) and "libtpu" not in json.dumps(man)
    assert man["versions"]["torch"] == torch.__version__


def test_resume_skips_every_recorded_cell(tmp_path, capsys):
    argv = [*SMALL, *FAULTS, "--device", "cpu"]
    path = _sweep(tmp_path, "r.csv", argv)
    n_rows = len(_rows(path))
    capsys.readouterr()
    _sweep(tmp_path, "r.csv", [*argv, "--resume"])
    out = capsys.readouterr().out
    assert "resume: skipping already-recorded comm sizes [1, 2, 4]\n" in out
    assert ("resume: skipping already-recorded comm sizes [1, 2, 4] "
            "[fault deadlink:5>3]") in out
    assert "RUN_OPTS" not in out
    assert len(_rows(path)) == n_rows


def test_resume_reruns_and_names_a_torch_or_card_change(tmp_path, capsys,
                                                        monkeypatch):
    argv = [*SMALL, "--device", "cpu", "--comm-sizes", "2"]
    path = _sweep(tmp_path, "r.csv", argv)
    real = ledger.manifest()
    drifted = dict(real, device_kind="NVIDIA H100 80GB HBM3",
                   versions=dict(real["versions"], torch="9.9.9+cu999"))
    monkeypatch.setattr(ledger, "manifest",
                        lambda device=None: dict(drifted))
    capsys.readouterr()
    _sweep(tmp_path, "r.csv", [*argv, "--resume"])
    out = capsys.readouterr().out
    assert ("resume: comm size 2: manifest drift vs journal entry: "
            "device_kind, versions.torch — re-running") in out
    assert out.count("RUN_OPTS: -a 3 -d 256 -c 2") == 1
    # the re-run is recorded under the new fingerprint: skipped next time
    capsys.readouterr()
    _sweep(tmp_path, "r.csv", [*argv, "--resume"])
    assert "skipping already-recorded comm sizes [2]" in \
        capsys.readouterr().out
    assert len(_rows(path)) == 1 + 2 * 2


def test_resume_falls_back_to_the_sidecar_then_the_csv(tmp_path, capsys):
    """Without the journal the sidecar decides; without both, the CSV
    decides for healthy cells, never for faulted ones (the CSV cannot
    record a fault)."""
    import os
    argv = [*SMALL, *FAULTS, "--device", "cpu"]
    path = _sweep(tmp_path, "r.csv", argv)
    os.remove(path + ".journal.jsonl")
    capsys.readouterr()
    _sweep(tmp_path, "r.csv", [*argv, "--resume"])
    assert "RUN_OPTS" not in capsys.readouterr().out
    os.remove(path + ".journal.jsonl")
    os.remove(path + ".sweep.jsonl")
    _sweep(tmp_path, "r.csv", [*argv, "--resume"])
    out = capsys.readouterr().out
    assert "skipping already-recorded comm sizes [1, 2, 4]\n" in out
    assert out.count("RUN_OPTS") == 3
    assert out.count("--fault deadlink:5>3") == 3


def test_cancellation_lands_at_a_cell_boundary_and_resumes(tmp_path, capsys,
                                                           monkeypatch):
    """A deferred SIGTERM, arriving while the first cell runs, stops the
    sweep at the next boundary with exit 130; --resume runs the rest."""
    from tpu_aggcomm_torch.harness import runner
    real = runner.run_experiment
    calls = []

    def first_cell_then_signal(cfg, **kw):
        out = real(cfg, **kw)
        if not calls:
            watchdog._STATE.update(active=True)
            watchdog._defer_signal(__import__("signal").SIGTERM, None)
        calls.append(cfg.comm_size)
        return out

    monkeypatch.setattr(runner, "run_experiment", first_cell_then_signal)
    path = str(tmp_path / "r.csv")
    argv = ["sweep", *SMALL, "--device", "cpu", "--results-csv", path]
    assert cli.main(argv) == 130
    err = capsys.readouterr().err
    assert "SIGTERM received: deferring cancellation" in err
    assert "cancelled at round boundary sweep:c2 (deferred SIGTERM)" in err
    assert calls == [1] and watchdog.cancellation_pending() is None
    assert cli.main([*argv, "--resume"]) == 0
    assert calls == [1, 2, 4]
    assert len(_rows(path)) == 1 + 3 * 2


def test_theta_grid_and_the_default_backend():
    assert cli.THETA_COMM_SIZES == ref_cli.THETA_COMM_SIZES
    args = cli.build_parser().parse_args(["sweep"])
    assert (args.backend, args.device, args.method, args.cb_nodes,
            args.data_size, args.iters) == ("torch_sim", "cuda", 1, 4, 2048,
                                              5)
    ref = ref_cli.build_parser().parse_args(["sweep"])
    assert ref.backend == "local"          # the named departure
    sub = next(a for a in cli.build_parser()._actions
               if a.dest == "command")
    backend = next(a for a in sub.choices["sweep"]._actions
                   if a.dest == "backend")
    assert "the reference's sweep defaults to --backend local" in \
        backend.help


def test_sweep_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["sweep", *SMALL, "--results-csv", str(tmp_path / "r.csv")])
    assert str(e.value.code).startswith("NoCudaDeviceError: ")


@pytest.mark.parametrize("argv", [["--auto"],
                                  ["--auto", "--tune-root", "TMP"]])
def test_sweep_auto_without_a_cache_names_the_miss_and_runs(tmp_path,
                                                            capsys, argv):
    """``--auto`` (and ``--tune-root``) on a sweep with no tuned entry: a
    named ``auto: no tuned entry at ...`` line, then the sweep of -m runs."""
    path = tmp_path / "r.csv"
    root = str(tmp_path / "tune")
    argv = [root if a == "TMP" else a for a in argv]
    assert cli.main(["sweep", "-n", "8", "-a", "3", "-d", "64", "-i", "1",
                     "--device", "cpu", "--comm-sizes", "2",
                     "--results-csv", str(path), *argv]) == 0
    cap = capsys.readouterr()
    where = root if "--tune-root" in argv else "."
    assert (f"auto: no tuned entry at {where}/TUNE_torch_sim_n8_d64_p1_a2m"
            f".json; falling back to -m 1") in cap.err
    assert "RUN_OPTS: -a 3 -d 64 -c 2 -m 1 -i 1" in cap.out
    assert len(_rows(path)) == 2


@pytest.mark.parametrize("argv,needle", [
    (["--metrics-port", "0"], "# metrics endpoint: http://127.0.0.1:"),
    (["--fault", "bogus"], "sweep --fault: bad fault token 'bogus'"),
    (["--fault", "slow:r1*2", "--measured-phases"],
     "sweep: --measured-phases is not supported with --fault"),
    (["--measured-phases", "-n", "80", "--comm-sizes", "1"],
     "--measured-phases: grid cell c=1 method 1 has 80 throttle rounds"),
    (["--comm-sizes", ","], "--comm-sizes: no valid throttle values"),
    (["-m", "6", "--fault", "deadlink:5>3"],
     "sweep --fault: dead link 5>3: m=6"),
    (["--fault", "slow:r2*4", "--backend", "cuda_dma"],
     "DmaFaultError: --fault slow:r2*4 is refused on --backend cuda_dma"),
])
def test_sweep_refusals_are_named(tmp_path, capsys, argv, needle):
    path = tmp_path / "r.csv"
    base = ["sweep", "-n", "8", "-a", "3", "-d", "64", "-i", "1",
            "--device", "cpu", "--results-csv", str(path)]
    if "--comm-sizes" not in argv:
        base += ["--comm-sizes", "2"]
    if argv[0] == "--metrics-port":
        # no longer refused: the sweep announces its loopback endpoint
        # and runs (tests/test_torch_telemetry.py scrapes one mid-run)
        assert cli.main([*base, *argv]) == 0
        assert needle in capsys.readouterr().err
        assert len(_rows(path)) == 2
        return
    with pytest.raises(SystemExit) as e:
        cli.main([*base, *argv])
    assert needle in str(e.value.code)
    assert not path.exists()                 # nothing ran


@pytest.mark.parametrize("argv,err,needle", [
    (["--fault", "slow:r2*4", "--measured-phases"], ValueError,
     "--measured-phases is not supported with --fault"),
    (["-m", "0", "--fault", "slow:r2*4"], ValueError,
     "--fault does not support methods [5, 8, 15, 16]"),
    (["--backend", "local", "--chained"], ValueError,
     "local is a host oracle"),
])
def test_run_refusals_before_any_method_runs(tmp_path, argv, err, needle):
    path = tmp_path / "r.csv"
    base = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
            "--device", "cpu", "--results-csv", str(path)]
    with pytest.raises(err) as e:
        cli.main([*base, *argv])
    assert needle in str(e.value)
    assert not path.exists()


@pytest.mark.parametrize("argv,needle", [
    (["--fault", "bogus"], "--fault: bad fault token 'bogus'"),
    (["-m", "6", "--fault", "deadlink:5>3"], "--fault: dead link 5>3: m=6"),
    (["--backend", "cuda_fused", "--fault", "slow:r2*4"],
     "UnfusableScheduleError: schedule 'All to many' carries slow-rank"),
    (["--backend", "cuda_fused", "--fault", "deadlink:5>3"],
     "UnfusableScheduleError: repaired schedule (fault='deadlink:5>3')"),
    (["--backend", "cuda_dma_conc", "--fault", "deadlink:5>3"],
     "DmaFaultError: --fault deadlink:5>3 is refused on --backend "
     "cuda_dma_conc"),
    (["--backend", "native", "--fault", "slow:r2*4"],
     "NotPortedError: --fault slow:r2*4 is refused on --backend native"),
])
def test_run_fault_refusals_are_one_line(tmp_path, argv, needle):
    base = ["-n", "8", "-m", "1", "-a", "3", "-d", "64", "-c", "2",
            "--device", "cpu", "--results-csv", str(tmp_path / "r.csv")]
    with pytest.raises(SystemExit) as e:
        cli.main([*base, *argv])
    assert str(e.value.code).startswith(needle)
    assert "\n" not in str(e.value.code)
