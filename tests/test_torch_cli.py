"""The port's CLI ``run``: console block and ``results.csv`` in the
reference's exact format, the provenance sidecar's phase source, and
named refusals, the reference's among them.

The port's output for ``-n 8 -m 1 -a 3 -d 256 -c 2 --backend torch_sim
--device cpu --verify`` must equal the reference runner's on ``jax_sim``
once the timing numbers (``%lf``, six decimals) are masked — the approach
of ``tests/test_golden_format.py``.
"""

import io
import re

import pytest
import torch

pytest.importorskip("jax")

from tpu_aggcomm.harness.runner import ExperimentConfig as RefConfig  # noqa: E402
from tpu_aggcomm.harness.runner import run_experiment as ref_run  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402

_NUM = re.compile(r"\d+\.\d{6}")


def _mask(text: str) -> str:
    return _NUM.sub("<t>", text)


def test_console_block_and_csv_match_reference(tmp_path, capsys):
    ref_csv, got_csv = tmp_path / "ref.csv", tmp_path / "got.csv"
    ref_out = io.StringIO()
    ref_run(RefConfig(nprocs=8, cb_nodes=3, method=1, data_size=256,
                      comm_size=2, backend="jax_sim", verify=True,
                      results_csv=str(ref_csv)), out=ref_out)
    assert cli.main(["-n", "8", "-m", "1", "-a", "3", "-d", "256", "-c", "2",
                     "--backend", "torch_sim", "--device", "cpu",
                     "--verify", "--results-csv", str(got_csv)]) == 0
    got_out = capsys.readouterr().out
    assert "| All to many max total time = " in got_out
    assert _mask(got_out) == _mask(ref_out.getvalue())
    assert _mask(got_csv.read_text()) == _mask(ref_csv.read_text())
    prov = (tmp_path / "got.provenance.csv").read_text().splitlines()
    assert prov[-1].endswith(",torch_sim,torch_sim,attributed")


def test_cuda_fused_run_all_on_cpu(tmp_path, capsys, monkeypatch):
    """-m 0 on cuda_fused is the fusable subset, run through the plain
    version of K2 (m=13 dumps its per-rank CSVs into the working
    directory, as the reference does)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-n", "8", "-m", "0", "-a", "3", "-d", "32", "-c", "3",
                     "--backend", "cuda_fused", "--device", "cpu",
                     "--verify", "--results-csv",
                     str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert out.count("max total time") == 16
    assert "Many to all benchmark" not in out


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("torch_sim", "cuda_fused"):
        with pytest.raises(SystemExit) as e:
            cli.main(["-m", "1", "-a", "14", "-d", "2048", "-c", "3",
                      "--backend", backend, "--results-csv",
                      str(tmp_path / "r.csv")])
        assert re.match(r"(NoCudaDeviceError|FusedBackendError): ",
                        str(e.value.code))


@pytest.mark.parametrize("flags,needle", [
    (["--fault", "slow:r1*2.0", "--backend", "cuda_dma"], "--fault"),
    (["--fault", "slow:r1*2.0", "--backend", "native"], "--fault"),
])
def test_unported_flags_raise_named_errors(flags, needle, tmp_path):
    """--fault runs since the faulted lowering was ported
    (tests/test_torch_faults.py), except on the remote-DMA transport and
    the native runtime, which have no faulted lowering and refuse it by
    name (DmaFaultError, a NotPortedError; NotPortedError) before any
    method runs. --xprof and --trace run (tests/test_torch_obs.py)."""
    argv = ["-n", "8", "-m", "1", "-a", "3", "-d", "256", "--device", "cpu",
            "--results-csv", str(tmp_path / "r.csv")] + flags
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert re.match(r"(NotPortedError|DmaFaultError): ", str(e.value.code))
    assert needle in str(e.value.code)
    assert not (tmp_path / "r.csv").exists()


def _ref_and_port(tmp_path, capsys, ref_kw, argv):
    """The reference runner on jax_sim and the port's CLI on torch_sim
    (``--device cpu``) for one configuration: (reference console,
    reference provenance rows, port console, port provenance rows)."""
    ref_csv, got_csv = tmp_path / "ref.csv", tmp_path / "got.csv"
    ref_out = io.StringIO()
    ref_run(RefConfig(backend="jax_sim", verify=True,
                      results_csv=str(ref_csv), **ref_kw), out=ref_out)
    assert cli.main([*argv, "--backend", "torch_sim", "--device", "cpu",
                     "--verify", "--results-csv", str(got_csv)]) == 0
    got_out = capsys.readouterr().out

    def rows(csv):
        return [ln.split(",", 3)[-1] for ln in (
            tmp_path / csv).read_text().splitlines()[1:]]

    return (ref_out.getvalue(), rows("ref.provenance.csv"), got_out,
            rows("got.provenance.csv"))


@pytest.fixture
def fake_timers(monkeypatch):
    """One seeded sequence of seconds per package, served in call order
    to its chain timer, so both packages print the same numbers."""
    from tpu_aggcomm.backends import jax_sim as ref_sim
    from tpu_aggcomm.harness import chained as ref_chained

    from tpu_aggcomm_torch.backends import torch_sim
    from tpu_aggcomm_torch.harness import chained
    import numpy as np
    for modules, cls in (((ref_sim, ref_chained), ref_sim.JaxSimBackend),
                         ((torch_sim, chained), torch_sim.TorchSimBackend)):
        values = iter(np.random.default_rng(3).uniform(
            1e-6, 1e-4, size=256).tolist())
        for mod in modules:
            monkeypatch.setattr(mod, "differenced_per_rep",
                                lambda *a, _v=values, **k: next(_v))
        monkeypatch.setattr(cls, "measure_per_rep",
                            lambda *a, _v=values, **k: next(_v))


@pytest.mark.parametrize("method,proc_node,phases", [
    (1, 1, "measured-rounds(post,deliver)+attributed(waits)"),
    (2, 2, "measured-rounds(post,deliver)+attributed(waits)"),
    (15, 4, "measured-hops(P2,P3,P4)+attributed(ranks)"),
    (16, 2, "measured-hops(P2,P3,P4)+attributed(ranks)"),
])
def test_measured_phases_match_reference(method, proc_node, phases,
                                         tmp_path, capsys, fake_timers):
    """``--measured-phases`` under one fake chain timer: the console
    block and results.csv equal the reference's digit for digit, and the
    provenance names the same measured phase source."""
    ref_out, ref_prov, got_out, got_prov = _ref_and_port(
        tmp_path, capsys,
        dict(nprocs=8, cb_nodes=3, method=method, data_size=256,
             comm_size=2, proc_node=proc_node, measured_phases=True),
        ["-n", "8", "-m", str(method), "-a", "3", "-d", "256", "-c", "2",
         "-p", str(proc_node), "--measured-phases"])
    assert got_out == ref_out
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "ref.csv").read_text()
    assert got_prov == [f'torch_sim,"{phases}"'] and ref_prov == \
        [f'jax_sim,"{phases}"']


def test_measured_phases_time_the_rounds_on_cpu(tmp_path, capsys):
    """``--measured-phases`` without a fake timer: real chained prefix
    families on the CPU, verified, the measured phase source recorded."""
    assert cli.main(["-n", "8", "-m", "2", "-a", "3", "-d", "256", "-c",
                     "2", "--device", "cpu", "--verify",
                     "--measured-phases", "--results-csv",
                     str(tmp_path / "r.csv")]) == 0
    assert "| Many to all max total time = " in capsys.readouterr().out
    prov = (tmp_path / "r.provenance.csv").read_text().splitlines()
    assert prov[-1].endswith(
        ',torch_sim,torch_sim,"measured-rounds(post,deliver)'
        '+attributed(waits)"')


@pytest.mark.parametrize("method", [1, 19])
def test_profile_rounds_match_reference(method, tmp_path, capsys):
    ref_out, ref_prov, got_out, got_prov = _ref_and_port(
        tmp_path, capsys,
        dict(nprocs=8, cb_nodes=3, method=method, data_size=256,
             comm_size=2, profile_rounds=True),
        ["-n", "8", "-m", str(method), "-a", "3", "-d", "256", "-c", "2",
         "--profile-rounds"])
    assert _mask(got_out) == _mask(ref_out)
    assert got_prov == ["torch_sim,attributed-rounds"]
    assert ref_prov == ["jax_sim,attributed-rounds"]


@pytest.mark.parametrize("method,proc_node", [(15, 1), (15, 4), (16, 2)])
def test_tam_runs_match_reference(method, proc_node, tmp_path, capsys):
    ref_out, ref_prov, got_out, got_prov = _ref_and_port(
        tmp_path, capsys,
        dict(nprocs=8, cb_nodes=3, method=method, data_size=256,
             proc_node=proc_node),
        ["-n", "8", "-m", str(method), "-a", "3", "-d", "256",
         "-p", str(proc_node)])
    assert "TAM max total time = " in got_out
    assert _mask(got_out) == _mask(ref_out)
    assert _mask((tmp_path / "got.csv").read_text()) == \
        _mask((tmp_path / "ref.csv").read_text())
    assert got_prov == ["torch_sim,attributed"]


def test_run_all_on_torch_sim_includes_tam(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-n", "8", "-m", "0", "-a", "3", "-d", "32", "-c", "3",
                     "-p", "2", "--device", "cpu", "--verify",
                     "--results-csv", str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert out.count("max total time") == 20
    assert "All to many TAM max total time" in out
    assert "Many to all TAM max total time" in out


# (port argv, reference config overrides, a phrase both messages hold)
REFUSALS = [
    (["--chained", "--profile-rounds"],
     dict(chained=True, profile_rounds=True), "are exclusive"),
    (["--measured-phases", "--profile-rounds"],
     dict(measured_phases=True, profile_rounds=True), "are exclusive"),
    (["--measured-phases", "--backend", "cuda_fused"],
     dict(measured_phases=True, backend="pallas_fused"),
     "--measured-phases requires --backend"),
    (["--profile-rounds", "--backend", "cuda_dma"],
     dict(profile_rounds=True, backend="pallas_dma"),
     "--profile-rounds requires --backend"),
    (["-m", "15", "--backend", "cuda_fused"],
     dict(method=15, backend="pallas_fused"),
     "does not support methods [15]"),
    (["-m", "5", "--measured-phases"], dict(method=5, measured_phases=True),
     "--measured-phases does not support methods [5]"),
    (["-m", "0", "--measured-phases"], dict(method=0, measured_phases=True),
     "--measured-phases does not support methods [5, 8]"),
    (["-n", "72", "-m", "9", "--measured-phases"],
     dict(nprocs=72, method=9, measured_phases=True),
     "more than 64 throttle rounds"),
]


@pytest.mark.parametrize("argv,ref_kw,phrase", REFUSALS)
def test_refusals_match_reference(argv, ref_kw, phrase, tmp_path):
    """Each configuration the reference runner refuses upfront, the port
    refuses too, before any method runs, with the same reason."""
    cfg = dict(nprocs=8, cb_nodes=3, method=1, data_size=256, comm_size=2,
               backend="jax_sim", results_csv=None)
    cfg.update(ref_kw)
    with pytest.raises(ValueError) as ref_e:
        ref_run(RefConfig(**cfg), out=io.StringIO())
    base = ["-n", "8", "-m", "1", "-a", "3", "-d", "256", "-c", "2",
            "--device", "cpu", "--results-csv", str(tmp_path / "r.csv")]
    with pytest.raises(ValueError) as e:
        cli.main(base + argv)
    assert phrase in str(ref_e.value) and phrase in str(e.value)
    assert not (tmp_path / "r.csv").exists()
