"""The remote-DMA transport of the port (``cuda_dma``, kernel K3) against
the reference ``pallas_dma`` on the CPU.

- Host parity: ``lower_schedule``, the step tables, ``WAVES`` and
  ``wave_profile`` equal the reference's array for array, for every
  non-collective dispatched method in both posting disciplines;
  ``barrier_shifts`` and ``complete_permutation`` agree on n = 1..40 and
  seeded random partial permutations.
- Kernel: ``dma_steps_plain`` (what the wrapper runs for a CPU tensor)
  equals the Pallas K3 kernel in interpret mode on the 8-device CPU mesh
  of ``tests/conftest.py``, the whole recv arena, trash row included; the
  kernel's own contract (dummy steps move no bytes, the never-written
  rows are zeroed) equals ``dma_steps_plain`` for every stepped method.
- Backend, CLI and named refusals.

Tolerance is zero throughout: this is integer data movement.
"""

import io
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from tpu_aggcomm.backends import jax_ici as ref_ici  # noqa: E402
from tpu_aggcomm.backends import pallas_dma as ref_dma  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.harness.runner import ExperimentConfig as RefConfig  # noqa: E402
from tpu_aggcomm.harness.runner import run_experiment as ref_run  # noqa: E402
from tpu_aggcomm.harness.verify import make_send_slabs as ref_slabs  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.backends import cuda_dma, ici_lower  # noqa: E402
from tpu_aggcomm_torch.backends.registry import get_backend  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import NotPortedError  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.device import NoCudaDeviceError  # noqa: E402
from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,  # noqa: E402
                                              run_experiment)

# every dispatched method that is neither TAM nor a dense collective
STEPPED = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]
SMALL, README = (8, 3, 256, 2), (32, 14, 2048, 3)
# (method, shape, barrier_type): every stepped method at both shapes, and
# m=13 with a barrier per rep at the README shape
HOST_CASES = ([(m, s, 0) for s in (SMALL, README) for m in STEPPED]
              + [(13, README, 1)])


def _pair(m, shape, barrier_type=0, proc_node=1):
    n, a, d, c = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c,
                                      proc_node=proc_node),
                        barrier_type=barrier_type),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c,
                                                proc_node=proc_node),
                           barrier_type=barrier_type))


# ---------------------------------------------------------------------------
# host parity


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
@pytest.mark.parametrize("method,shape,barrier_type", HOST_CASES)
def test_host_tables_match_reference(method, shape, barrier_type,
                                     concurrent):
    rs, s = _pair(method, shape, barrier_type)
    got, want = ici_lower.lower_schedule(s), ref_ici.lower_schedule(rs)
    for field in ("perms", "round_of_color", "barrier_rounds",
                  "n_send_slots", "n_recv_slots"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("sslot_tab", "rslot_tab"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

    ref_b = ref_dma.PallasDmaBackend(concurrent=concurrent)
    _low, _pds, rtabs, rwaves, rn = ref_b._build_steps(rs)
    _low, tabs, waves, n_recv = cuda_dma.build_steps(s, concurrent)
    assert waves == rwaves and n_recv == rn
    for g, w in zip(tabs, rtabs):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    prof = cuda_dma.CudaDmaBackend("cpu", concurrent).wave_profile(s)
    assert prof == ref_b.wave_profile(rs)


@pytest.mark.parametrize("n", range(1, 41))
def test_barrier_shifts_and_completion_match_reference(n):
    assert cuda_dma.barrier_shifts(n) == ref_dma.barrier_shifts(n)
    rng = np.random.default_rng(n)
    for _ in range(6):
        k = int(rng.integers(0, n + 1))
        srcs = rng.permutation(n)[:k]
        dsts = rng.permutation(n)[:k]
        pairs = [(int(a), int(b)) for a, b in zip(srcs, dsts)]
        got = cuda_dma.complete_permutation(pairs, n)
        want = ref_dma.complete_permutation(pairs, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(n))


# ---------------------------------------------------------------------------
# kernel K3: plain version against the Pallas kernel in interpret mode


def _pallas_arena(rs, concurrent, iter_):
    """The reference kernel's whole recv arena (n, R+1, d), trash row
    included, run as ``PallasDmaBackend.run`` runs it."""
    p = rs.pattern
    n, d = p.nprocs, p.data_size
    mesh = Mesh(np.array(jax.devices()[:n]), ("ranks",))
    sharding = NamedSharding(mesh, P("ranks"))
    fn, pds, n_send, n_recv, tabs, _w = ref_dma.PallasDmaBackend(
        concurrent=concurrent)._lower(rs, mesh, True)
    send_g = np.zeros((n, n_send + 1, pds), dtype=np.uint8)
    for r, slab in enumerate(ref_slabs(p, iter_)):
        if slab is not None:
            send_g[r, :slab.shape[0], :d] = slab
    out = fn(jax.device_put(send_g.reshape(n, n_send + 1, 4, pds // 4),
                            sharding),
             *[jax.device_put(t, sharding) for t in tabs])
    return np.asarray(out).reshape(n, n_recv + 1, pds)[:, :, :d]


def _kernel_contract(send, tabs):
    """What K3 computes, in plain torch: a recv of any contents, its zero
    runs zeroed, then only the real steps' rows copied, steps in order
    (a dummy step only signals)."""
    n, d = tabs.nprocs, send.shape[2]
    recv = torch.full((n, tabs.n_recv_rows, d), 0xA5, dtype=torch.uint8)
    flat = recv.view(-1, d)
    for a, b in tabs.zero_runs:
        flat[a:b] = 0
    dummy = tabs.n_send_rows - 1
    for st in range(tabs.n_steps):
        ranks = torch.nonzero(tabs.sslot[:, st] != dummy).flatten()
        ss = tabs.sslot[ranks, st].long()
        recv[tabs.dst[ranks, st].long(), tabs.rslot[ranks, st].long()] = \
            send[ranks, ss]
    return recv


# every stepped method at n = 8 and 32, with and without a barrier per rep
INVARIANT_CASES = [(m, shape, bt) for shape in ((8, 3, 16, 3), (32, 14, 16, 3))
                   for m in STEPPED for bt in (0, 1)]


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
@pytest.mark.parametrize("method,shape,barrier_type", INVARIANT_CASES)
def test_dummy_steps_carry_no_bytes(method, shape, barrier_type,
                                    concurrent):
    """The invariant signal-only dummy steps rest on: a step whose send
    slot is the dummy row targets the trash row, no real step writes the
    trash row, and the plain version's trash row is zero. So the kernel's
    contract (skip the dummy copies, zero the never-written rows) gives
    the plain version's arena byte for byte, from any prior contents."""
    _rs, s = _pair(method, shape, barrier_type)
    low, (_dst, _src, sslot, rslot), _w, n_recv = cuda_dma.build_steps(
        s, concurrent)
    dummy = sslot == low.n_send_slots
    assert (rslot[dummy] == n_recv).all()
    assert not (rslot[~dummy] == n_recv).any()
    tabs = cuda_dma.dma_tables(s, concurrent, "cpu")
    send = cuda_dma.send_arena(s.pattern, 1, "cpu")
    plain = cuda_dma.dma_steps_plain(send, tabs)
    assert not plain[:, -1].any()
    assert torch.equal(_kernel_contract(send, tabs), plain)


def test_tables_lay_out_zero_runs_counters_and_base_words():
    """The never-written rows are exactly the rows no real step writes
    (608 of 1056 at the README shape, every trash row among them), in
    run form; one counter per 128-byte line and one base word per rank,
    all zero."""
    _rs, s = _pair(1, README)
    tabs = cuda_dma.dma_tables(s, False, "cpu")
    n, rows = tabs.nprocs, tabs.n_recv_rows
    assert cuda_dma.COUNTER_STRIDE * tabs.arrival.element_size() == 128
    assert tabs.arrival.shape == (n * cuda_dma.COUNTER_STRIDE,)
    assert tabs.base.shape == (n,)
    assert not tabs.arrival.any() and not tabs.base.any()
    real = tabs.sslot != tabs.n_send_rows - 1
    written = set((tabs.dst.long() * rows
                   + tabs.rslot.long())[real].tolist())
    zeroed = [q for a, b in tabs.zero_runs for q in range(a, b)]
    assert len(written) == 448
    assert len(zeroed) == tabs.zero_rows == n * rows - 448 == 608
    assert written.isdisjoint(zeroed)
    assert written | set(zeroed) == set(range(n * rows))
    assert {r * rows + rows - 1 for r in range(n)} <= set(zeroed)
    assert tabs.zero_start.tolist() == [a for a, _b in tabs.zero_runs]
    assert tabs.zero_ptr.tolist() == np.cumsum(
        [0] + [b - a for a, b in tabs.zero_runs]).tolist()


def test_counter_stride_is_the_kernels_constant():
    """The kernel indexes the counters with its compile-time
    ``kCounterStride``, so the layout :func:`make_tables` allocates must
    use the same number; both source files are read here."""
    from tpu_aggcomm_torch.csrc import build
    src = (build.CSRC / "dma_steps.cu").read_text()
    found = re.findall(r"constexpr long long kCounterStride = (\d+);", src)
    assert found == [str(cuda_dma.COUNTER_STRIDE)]
    assert "counter_stride" not in src


@pytest.mark.parametrize("method,concurrent,d", [
    (1, False, 64), (12, False, 64), (17, False, 64), (18, False, 64),
    (1, True, 64), (18, True, 64), (12, False, 100)])
def test_plain_dma_steps_match_pallas_interpret(method, concurrent, d):
    rs, s = _pair(method, (8, 3, d, 2))
    want = _pallas_arena(rs, concurrent, iter_=1)
    tabs = cuda_dma.dma_tables(s, concurrent, "cpu")
    send = cuda_dma.send_arena(s.pattern, 1, "cpu")
    before = cuda_dma.dma_steps.launches
    got = cuda_dma.dma_steps(send, tabs).numpy()
    assert cuda_dma.dma_steps.launches == before   # CPU: no kernel launch
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[:, -1].any()                    # trash row stays zero


# ---------------------------------------------------------------------------
# backend


# the cases of tests/test_pallas_dma.py: (method, shape, barrier_type,
# proc_node)
BACKEND_CASES = (
    [(m, (8, 3, 64, 3), 0, 1) for m in (6, 7, 11, 12, 18)]
    + [(m, (8, 3, 32, 2), 0, 1) for m in (1, 3, 20)]
    + [(17, (8, 3, 32, 4), 0, 1), (13, (8, 3, 32, 4), 1, 1),
       (12, (8, 3, 100, 3), 0, 1), (17, (8, 3, 32, 3), 0, 2)]
    + [(m, (8, 3, 52, 2), 0, 2) for m in (1, 6, 7, 11, 12, 17, 18)])


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
@pytest.mark.parametrize("method,shape,barrier_type,proc_node",
                         BACKEND_CASES)
def test_backend_verifies_on_cpu(method, shape, barrier_type, proc_node,
                                 concurrent):
    _rs, s = _pair(method, shape, barrier_type, proc_node)
    b = cuda_dma.CudaDmaBackend("cpu", concurrent=concurrent)
    recv, timers = b.run(s, verify=True, iter_=3, ntimes=2)
    assert b.last_provenance == (b.name, "attributed")
    assert len(b.last_rep_timers) == 2
    assert timers[0].total_time > 0
    assert any(r is not None for r in recv)


def test_backend_m1_matches_pallas_dma():
    rs, s = _pair(1, (8, 3, 64, 2))
    want, _ = ref_dma.PallasDmaBackend().run(rs, verify=True)
    for concurrent in (False, True):
        got, _ = cuda_dma.CudaDmaBackend("cpu", concurrent).run(s,
                                                                verify=True)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["cuda_dma", "cuda_dma_conc"])
def test_dense_collectives_route_to_torch_sim(name):
    _rs, s = _pair(8, (8, 3, 32, 2))
    b = get_backend(name, device="cpu")
    assert b.name == name and b.concurrent == (name == "cuda_dma_conc")
    recv, _ = b.run(s, verify=True)
    assert b.last_provenance == ("torch_sim", "attributed")
    assert sum(r is not None for r in recv) == 3      # the aggregators


def test_tables_are_built_once_per_schedule():
    _rs, s = _pair(1, SMALL)
    b = cuda_dma.CudaDmaBackend("cpu")
    assert b.tables(s) is b.tables(s)
    tabs = b.tables(s)
    assert tabs.n_steps == b.wave_profile(s)["steps"]
    assert tabs.wave_end.tolist() == [s1 for _s0, s1 in tabs.waves]
    assert (tabs.n_send_rows, tabs.n_recv_rows) == (4, 9)


# ---------------------------------------------------------------------------
# refusals


def test_refuses_without_a_card_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for concurrent in (False, True):
        with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
            cuda_dma.CudaDmaBackend(concurrent=concurrent)
    cuda_dma.CudaDmaBackend(device="cpu")


@pytest.mark.parametrize("name", ["cuda_dma", "cuda_dma_conc"])
def test_chained_is_refused_before_any_method_runs(name, tmp_path):
    cfg = ExperimentConfig(nprocs=8, cb_nodes=3, method=0, data_size=32,
                           comm_size=3, backend=name, device="cpu",
                           chained=True, results_csv=str(tmp_path / "r.csv"))
    out = io.StringIO()
    with pytest.raises(ValueError, match=f"--chained .*{name}"):
        run_experiment(cfg, out=out)
    assert out.getvalue() == ""
    assert not (tmp_path / "r.csv").exists()
    _rs, s = _pair(1, SMALL)
    with pytest.raises(ValueError, match="--chained"):
        cuda_dma.CudaDmaBackend("cpu").run(s, chained=True)


def test_capacity_check_names_the_cap():
    cuda_dma.check_capacity(32, 32)
    with pytest.raises(cuda_dma.DmaCapacityError, match="at most 31"):
        cuda_dma.check_capacity(32, 31)
    with pytest.raises(cuda_dma.DmaCapacityError, match="1024 ranks"):
        cuda_dma.check_capacity(1024, 2 * 132)


def _corrupt(kind, tabs, waves):
    dst, src, sslot, rslot = (t.copy() for t in tabs)
    if kind == "dst":
        dst[0, 5] = dst[1, 5]          # two ranks push to one rank
    elif kind == "src":
        src[:, 5] = np.roll(src[:, 5], 1)
    elif kind == "sslot":
        sslot[2, 0] = 4
    elif kind == "rslot":
        rslot[2, 0] = -1
    elif kind == "waves":
        waves = waves[:-1]
    else:
        dummy, trash = sslot.max(), rslot.max()   # both used by barriers
        real = np.argwhere(sslot != dummy)
        if kind == "dummy-row":
            r, st = np.argwhere(sslot == dummy)[0]
            rslot[r, st] = 0
        elif kind == "real-trash":
            r, st = real[0]
            rslot[r, st] = trash
        elif kind == "twice":          # two senders into one aggregator slot
            (r0, s0), (r1, s1) = [(r, st) for r, st in real
                                  if dst[r, st] == dst[tuple(real[0])]][:2]
            rslot[r1, s1] = rslot[r0, s0]
    return (dst, src, sslot, rslot), waves


@pytest.mark.parametrize("kind,needle", [
    ("dst", "not a permutation"), ("src", "inverse"),
    ("sslot", "send slot"), ("rslot", "recv slot"),
    ("waves", "waves end"), ("dummy-row", "dummy step"),
    ("real-trash", "real step writes the trash row"),
    ("twice", "written by two real steps")])
def test_malformed_step_table_is_refused_on_the_host(kind, needle):
    _rs, s = _pair(1, SMALL)
    low, tabs, waves, n_recv = cuda_dma.build_steps(s)
    bad, bad_waves = _corrupt(kind, tabs, waves)
    with pytest.raises(cuda_dma.DmaTableError, match=needle):
        cuda_dma.make_tables(bad, bad_waves, low.n_send_slots + 1,
                             n_recv + 1, "cpu")


def test_refuses_tam_and_fault_injected_schedules():
    """Fault-injected schedules are refused by name. TAM is no longer
    refused: it is routed to torch_sim on the same device, as the
    reference routes it to jax_sim (tests/test_torch_tam.py)."""
    b = cuda_dma.CudaDmaBackend("cpu")
    tam = compile_method(15, AggregatorPattern(8, 3, data_size=64,
                                               proc_node=2))
    b.run(tam, verify=True)
    assert b.last_provenance == ("torch_sim", "attributed")
    _rs, s = _pair(1, SMALL)
    s.fault = "dead:0-1"
    with pytest.raises(NotPortedError, match="fault"):
        b.run(s)


def test_dma_steps_wrapper_checks_its_inputs():
    _rs, s = _pair(1, SMALL)
    tabs = cuda_dma.dma_tables(s, False, "cpu")
    with pytest.raises(ValueError, match="send must be"):
        cuda_dma.dma_steps(torch.zeros((8, 3, 16), dtype=torch.uint8), tabs)
    with pytest.raises(ValueError, match="send must be"):
        cuda_dma.dma_steps(torch.zeros((8, 4, 16), dtype=torch.int32), tabs)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_dma.dma_steps(torch.zeros((8, 16, 4), dtype=torch.uint8)
                           .transpose(1, 2), tabs)
    send = cuda_dma.send_arena(s.pattern, 0, "cpu")
    with pytest.raises(ValueError, match="out must be"):
        cuda_dma.dma_steps(send, tabs, out=torch.zeros((8, 8, 256),
                                                       dtype=torch.uint8))
    with pytest.raises(ValueError, match="stamps must be"):
        cuda_dma.dma_steps(send, tabs, stamps=torch.zeros(
            (tabs.n_waves, 3), dtype=torch.int64))


def test_dma_steps_overwrites_every_row_of_out():
    _rs, s = _pair(1, SMALL)
    tabs = cuda_dma.dma_tables(s, True, "cpu")
    send = cuda_dma.send_arena(s.pattern, 2, "cpu")
    out = torch.full((8, tabs.n_recv_rows, 256), 0xA5, dtype=torch.uint8)
    got = cuda_dma.dma_steps(send, tabs, out=out)
    assert got is out
    assert torch.equal(out, cuda_dma.dma_steps_plain(send, tabs))


def test_protocol_timeout_record_raises_by_name_and_stays():
    """A timed-out CTA's record (rank + 1, step, arrivals) becomes
    ``DmaProtocolError`` naming them, and stays: the tables are refused
    from then on."""
    _rs, s = _pair(1, SMALL)
    tabs = cuda_dma.dma_tables(s, False, "cpu")
    cuda_dma.check_protocol(tabs)
    tabs.error[:] = torch.tensor([3, 7, 40], dtype=torch.int32)
    for _ in range(2):
        with pytest.raises(cuda_dma.DmaProtocolError,
                           match="rank 2 .* in one wait .* up to step 7 "
                                 "\\(had 40\\)"):
            cuda_dma.check_protocol(tabs)


# ---------------------------------------------------------------------------
# CLI

_NUM = re.compile(r"\d+\.\d{6}")


def _mask(text: str) -> str:
    return _NUM.sub("<t>", text)


def test_console_block_and_csv_match_reference_pallas_dma(tmp_path, capsys):
    ref_csv, got_csv = tmp_path / "ref.csv", tmp_path / "got.csv"
    ref_out = io.StringIO()
    ref_run(RefConfig(nprocs=8, cb_nodes=3, method=1, data_size=256,
                      comm_size=2, backend="pallas_dma", verify=True,
                      results_csv=str(ref_csv)), out=ref_out)
    assert cli.main(["-n", "8", "-m", "1", "-a", "3", "-d", "256", "-c", "2",
                     "--backend", "cuda_dma", "--device", "cpu",
                     "--verify", "--results-csv", str(got_csv)]) == 0
    got_out = capsys.readouterr().out
    assert "| All to many max total time = " in got_out
    assert _mask(got_out) == _mask(ref_out.getvalue())
    assert _mask(got_csv.read_text()) == _mask(ref_csv.read_text())
    prov = (tmp_path / "got.provenance.csv").read_text().splitlines()
    assert prov[-1].endswith(",cuda_dma,cuda_dma,attributed")


def test_cli_run_all_on_cpu_routes_collectives(tmp_path, capsys,
                                               monkeypatch):
    """-m 0 covers all 20 dispatched methods: the 16 stepped ones on the
    transport, m=5/8 and TAM m=15/16 routed to torch_sim (recorded in the
    provenance)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-n", "8", "-m", "0", "-a", "3", "-d", "32", "-c", "3",
                     "--backend", "cuda_dma_conc", "--device", "cpu",
                     "--verify", "--results-csv",
                     str(tmp_path / "r.csv")]) == 0
    assert capsys.readouterr().out.count("max total time") == 20
    prov = (tmp_path / "r.provenance.csv").read_text().splitlines()[1:]
    executed = [ln.split(",")[-2] for ln in prov]
    assert executed.count("torch_sim") == 4
    assert executed.count("cuda_dma_conc") == 16


def test_cli_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda_dma", "cuda_dma_conc"):
        with pytest.raises(SystemExit) as e:
            cli.main(["-m", "1", "-a", "14", "-d", "2048", "-c", "3",
                      "--backend", backend, "--results-csv",
                      str(tmp_path / "r.csv")])
        assert str(e.value.code).startswith("NoCudaDeviceError: ")
