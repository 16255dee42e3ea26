"""Fault injection in the port against the reference, on the CPU.

- ``faults/repair.py``: a repaired schedule's extended edge table, staging
  rows, dead edges and fault stamp equal the reference's, array for
  array, for every round-structured method (or both refuse alike).
- ``torch_sim``'s faulted lowering: the same numpy send lanes go through
  ``jax_sim._one_rep_faulted`` (jitted, on the CPU) and the port's
  ``TorchSimBackend("cpu").one_rep``; the WHOLE ``(n, F+1, w)`` arena,
  staging and trash rows included, is equal byte for byte (tolerance
  zero: integer data movement), for every round-structured method, in
  the unrolled (README shape, ``-c 3``: 11 rounds) and the padded
  (``-c 1``: 32 rounds and more) lowerings, under ``slow``, a repaired
  ``deadlink``, both, and an unrepaired ``deadlink`` reached through the
  library.
- The slow-rank delay's plain version against a numpy transcription of
  ``jax_sim.py:435-446``, on lanes with the sign bit set and near
  ``INT32_MAX``. No test here reads a time: the delay is held by its
  ``acc`` and its bytes on the CPU, its timing only on the card.
- What the reference's remote-DMA lowering does with a faulted schedule
  (it drops the injection or lands relay hops in data slots), and the
  port's upfront refusal.
- The copied ``local`` and ``native`` backends against the reference's,
  and every port backend's recv against ``local``'s.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends.jax_ici import lower_schedule as ref_lower  # noqa: E402
from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.backends.jax_sim import dense_send_lanes as ref_send  # noqa: E402
from tpu_aggcomm.backends.local import LocalBackend as RefLocal  # noqa: E402
from tpu_aggcomm.backends.native import NativeBackend as RefNative  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.faults import RepairError as RefRepairError  # noqa: E402
from tpu_aggcomm.faults import parse_fault as ref_parse  # noqa: E402
from tpu_aggcomm.faults import repair_schedule as ref_repair  # noqa: E402
from tpu_aggcomm.harness.verify import VerificationError as RefVerifyError  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend,  # noqa: E402
                                                 DmaFaultError)
from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.backends.local import LocalBackend  # noqa: E402
from tpu_aggcomm_torch.backends.native import NativeBackend  # noqa: E402
from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,  # noqa: E402
                                                   slow_delay_plain,
                                                   slow_tables)
from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend  # noqa: E402
from tpu_aggcomm_torch.core.methods import METHODS, compile_method, method_ids  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.faults import (RepairError, parse_fault,  # noqa: E402
                                      repair_schedule)
from tpu_aggcomm_torch.faults.inject import slow_iter_table  # noqa: E402
from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,  # noqa: E402
                                              run_experiment)
from tpu_aggcomm_torch.harness.verify import VerificationError  # noqa: E402

#: the README shape at a narrow slab: -c 3 is 11 unrolled rounds, -c 1 is
#: 32 rounds (34 with a detour's relay rounds), the padded lowering
UNROLLED, PADDED = (32, 14, 32, 3), (32, 14, 32, 1)
ROUND_METHODS = [m for m in method_ids() if not METHODS[m].tam
                 and m not in (5, 8)]
#: "unrepaired:" runs the stamp without the repair (the library path)
SPECS = ["slow:r2*4", "deadlink:5>3", "slow:r2*4,deadlink:5>3",
         "unrepaired:deadlink:5>3"]


def _pattern(shape, ref=False):
    n, a, d, c = shape
    return (RefPattern if ref else AggregatorPattern)(
        n, a, data_size=d, comm_size=c)


def _faulted_pair(m, shape, spec):
    """(reference schedule, port schedule), both repaired (or both only
    stamped, for "unrepaired:"); None when both refuse the repair alike."""
    rs, s = ref_compile(m, _pattern(shape, True)), compile_method(
        m, _pattern(shape))
    if spec.startswith("unrepaired:"):
        from dataclasses import replace
        fault = spec.split(":", 1)[1]
        return replace(rs, fault=fault), replace(s, fault=fault)
    try:
        ref = ref_repair(rs, ref_parse(spec))
    except RefRepairError as e:
        with pytest.raises(RepairError) as got:
            repair_schedule(s, parse_fault(spec))
        assert str(got.value) == str(e)
        return None
    return ref, repair_schedule(s, parse_fault(spec))


@pytest.mark.parametrize("spec", SPECS[:3])
@pytest.mark.parametrize("method", ROUND_METHODS)
def test_repair_matches_the_reference(method, spec):
    pair = _faulted_pair(method, UNROLLED, spec)
    if pair is None:
        return
    ref, got = pair
    np.testing.assert_array_equal(got.data_edges_ext(), ref.data_edges_ext())
    assert got.n_staging == ref.n_staging
    assert got.dead_edges == ref.dead_edges
    assert got.fault == ref.fault == parse_fault(spec).canonical()


def _faulted_arenas(method, shape, spec):
    pair = _faulted_pair(method, shape, spec)
    if pair is None:
        return None
    rs, s = pair
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(JaxSimBackend()._one_rep_faulted(rs))(send))
    got = to_reference(TorchSimBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    return s, got, want


@pytest.mark.parametrize("shape", [UNROLLED, PADDED],
                         ids=["unrolled", "padded"])
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("method", ROUND_METHODS)
def test_faulted_arena_matches_jax_sim(method, spec, shape):
    out = _faulted_arenas(method, shape, spec)
    if out is None:
        return
    s, got, want = out
    _, n_recv = torch_sim.slot_shapes(s.pattern)
    assert got.shape == want.shape == (
        32, n_recv + s.n_staging + 1, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", SPECS)
def test_faulted_arena_on_byte_lanes(spec):
    """d % 4 != 0: the arena is bytes, the delay reads a byte row."""
    for method in (1, 2):
        out = _faulted_arenas(method, (8, 3, 30, 2), spec)
        _s, got, want = out
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_lowering_tables_hold_the_readme_depths():
    """-c 3 at the README shape is 11 rounds (+2 relay rounds), -c 1 is
    32 (+2): the two lowerings the reference picks."""
    for shape, depth in ((UNROLLED, 13), (PADDED, 34)):
        s = repair_schedule(compile_method(1, _pattern(shape)),
                            parse_fault("slow:r2*2,deadlink:5>3"))
        _, n_recv = torch_sim.slot_shapes(s.pattern)
        rounds, _b, F, slow = torch_sim._faulted_tables(s, n_recv)
        assert len(rounds) == depth and F == n_recv + 1
        # the delay's depth counts the relay rounds
        assert slow[2] == 32 * depth and slow.sum() == slow[2]


@pytest.mark.parametrize("spec,verifies", [
    ("deadlink:5>3", True), ("unrepaired:deadlink:5>3", False),
    ("slow:r2*4", True)])
def test_verify_passes_repaired_and_fails_unrepaired(spec, verifies):
    """An unrepaired dead link (reachable only through the library: the
    CLI repairs) loses its chan-0 edge, so --verify fails in both
    packages: the injection working. A repaired one verifies."""
    rs, s = _faulted_pair(1, (8, 3, 256, 2), spec)
    if verifies:
        TorchSimBackend("cpu").run(s, verify=True)
        JaxSimBackend().run(rs, verify=True)
        return
    with pytest.raises(VerificationError):
        TorchSimBackend("cpu").run(s, verify=True)
    with pytest.raises(RefVerifyError):
        JaxSimBackend().run(rs, verify=True)


def test_orphan_barrier_round_is_refused_by_name(monkeypatch):
    """A barrier in a round with no data edge cannot be lowered: refused
    by name, as the reference refuses it (jax_sim.py:425-430)."""
    from dataclasses import replace
    s = replace(compile_method(1, _pattern((8, 3, 32, 2))),
                fault="slow:r1*2")
    monkeypatch.setattr(torch_sim, "barrier_rounds_of",
                        lambda sched: {999: 1})
    with pytest.raises(ValueError, match="barrier-only rounds"):
        TorchSimBackend("cpu").one_rep(s)


def test_faulted_chain_keeps_the_data_rows_as_its_token():
    """The chain's token sums only the data rows' lane 0: a faulted rep's
    staging rows never enter it. Five chained reps end byte-equal to the
    reference's chain."""
    rs, s = _faulted_pair(1, UNROLLED, "slow:r2*2,deadlink:5>3")
    send = ref_send(rs.pattern, 0)
    ref_b = JaxSimBackend()
    want = np.asarray(ref_b._chain_factory(ref_b._one_rep_faulted(rs),
                                           rs.pattern)(5)(send))
    b = TorchSimBackend("cpu")
    got = to_reference(b._chain_factory(b.one_rep(s), s.pattern)(5)(
        from_reference(send, "cpu")))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The slow-rank delay: plain version against the numpy transcription.

def _delay_numpy(send, recv, iters):
    """``jax_sim.py:435-446`` in numpy: int32 lanes (or bytes widened),
    ``(row + i) % 251`` a floor modulo of the int32-wrapped sum, the
    per-iteration sum and ``acc`` wrapping as int32."""
    def wrap(x):
        return ((np.asarray(x, dtype=np.int64) + 2**31) % 2**32) - 2**31
    recv = recv.copy()
    accs = []
    for r, it in enumerate(iters):
        if it <= 0:
            continue
        row = send[r, 0].astype(np.int64)
        if send.dtype == np.uint32:
            row = wrap(row)
        acc = 0
        for i in range(it):
            acc = int(wrap(acc + int(wrap(np.sum(wrap(row + i) % 251)))))
        delta = (acc & 1) * ((acc + 1) & 1)
        if recv.dtype == np.uint32:
            recv[r, 0, 0] = np.uint32((int(recv[r, 0, 0]) + delta) % 2**32)
        else:
            recv[r, 0, 0] = np.uint8((int(recv[r, 0, 0]) + delta) % 256)
        accs.append(acc)
    return recv, accs


@pytest.mark.parametrize("lanes", ["int32", "bytes"])
@pytest.mark.parametrize("seed", [0, 1])
def test_delay_plain_matches_the_numpy_transcription(lanes, seed):
    rng = np.random.default_rng(seed)
    n, S, F1, w = 6, 3, 5, (16 if lanes == "int32" else 30)
    if lanes == "int32":
        send = rng.integers(0, 2**32, size=(n, S, w), dtype=np.uint64)
        send = send.astype(np.uint32)
        # sign bit set, near INT32_MAX (row + i wraps), zero, the modulus
        send[1, 0, :6] = [2**31 - 1, 2**31 - 3, 2**31, 2**32 - 1, 0, 251]
        send[4, 0, :4] = [2**31 - 2, 2**31 - 1, 2**31 + 1, 2**32 - 251]
        recv = rng.integers(0, 2**32, size=(n, F1, w),
                            dtype=np.uint64).astype(np.uint32)
    else:
        send = rng.integers(0, 256, size=(n, S, w), dtype=np.uint8)
        recv = rng.integers(0, 256, size=(n, F1, w), dtype=np.uint8)
    iters = np.array([0, 37, 0, 1, 300, 5])
    want_recv, want_acc = _delay_numpy(send, recv, iters)
    tabs = slow_tables(iters, "cpu")
    assert tabs.ranks == (1, 3, 4, 5)
    t_send, t_recv = from_reference(send, "cpu"), from_reference(recv, "cpu")
    acc = slow_delay_plain(t_send, t_recv, tabs)
    assert acc.dtype == torch.int32 and acc.tolist() == want_acc
    np.testing.assert_array_equal(to_reference(t_recv), want_recv)
    np.testing.assert_array_equal(want_recv, recv)    # the delta is 0


def test_delay_plain_chunks_like_one_pass(monkeypatch):
    """The plain version's chunking of the iterations does not change
    acc."""
    rng = np.random.default_rng(5)
    send = from_reference(rng.integers(0, 2**32, size=(3, 2, 8),
                                       dtype=np.uint64).astype(np.uint32),
                          "cpu")
    tabs = slow_tables([50, 0, 71], "cpu")
    one = slow_delay_plain(send, torch.zeros((3, 3, 8), dtype=torch.int32),
                           tabs)
    monkeypatch.setattr("tpu_aggcomm_torch.backends.slow_delay."
                        "_PLAIN_CHUNK_ELEMS", 8)
    many = slow_delay_plain(send, torch.zeros((3, 3, 8), dtype=torch.int32),
                            tabs)
    assert torch.equal(one, many)


def test_delay_wrapper_on_the_cpu_takes_the_plain_version():
    """A CPU tensor takes the plain version and launches nothing; the
    wrapper refuses inputs the kernel does not take."""
    send = torch.ones((4, 2, 8), dtype=torch.int32)
    tabs = slow_tables([0, 3, 0, 0], "cpu")
    before = slow_delay.launches
    acc = slow_delay(send, torch.zeros((4, 3, 8), dtype=torch.int32), tabs)
    assert slow_delay.launches == before
    assert acc.tolist() == [8 * (1 + 2 + 3)]      # sum_i 8 lanes x (1 + i)
    assert slow_tables([0, 0], "cpu") is None
    for bad in (torch.zeros((4, 3, 9), dtype=torch.int32),
                torch.zeros((4, 3, 8), dtype=torch.int64),
                torch.zeros((3, 3, 8), dtype=torch.int32)):
        with pytest.raises(ValueError, match="slow_delay"):
            slow_delay(send, bad, tabs)
    with pytest.raises(ValueError, match="outside"):
        slow_delay(send[:1], torch.zeros((1, 3, 8), dtype=torch.int32),
                   tabs)


def test_delay_iterations_follow_the_masked_depth():
    """``n_rounds`` of the delay is the masked extended table's depth:
    an unrepaired dead link on the last round's only edge shortens it,
    a repair's relay rounds lengthen it."""
    s = compile_method(1, _pattern((8, 3, 32, 2)))
    _, n_recv = torch_sim.slot_shapes(s.pattern)
    healthy = len(torch_sim._round_tables(s)[0])
    rep = repair_schedule(s, parse_fault("slow:r0*3,deadlink:5>3"))
    *_r, slow = torch_sim._faulted_tables(rep, n_recv)
    np.testing.assert_array_equal(
        slow, slow_iter_table(parse_fault("slow:r0*3"), 8, healthy + 2))


# ---------------------------------------------------------------------------
# The remote-DMA transport: what the reference does, and the refusal.

def test_reference_dma_lowering_drops_or_misplaces_faults():
    """What ``jax_ici.lower_schedule`` (the step tables ``pallas_dma``
    runs) does with a faulted schedule. It never raises: a slow rank and
    an unrepaired dead link are silently dropped (the tables are the
    healthy ones); a repaired dead link's relay hops land in pattern data
    slots (no staging row exists), and the forward hop reads a send slot
    instead of the relay's staging row."""
    p = RefPattern(8, 3, data_size=64, comm_size=2)
    healthy = ref_lower(ref_compile(1, p))
    from dataclasses import replace
    for stamped in (ref_repair(ref_compile(1, p), ref_parse("slow:r2*4")),
                    replace(ref_compile(1, p), fault="deadlink:5>3")):
        low = ref_lower(stamped)
        assert low.perms == healthy.perms
        np.testing.assert_array_equal(low.sslot_tab, healthy.sslot_tab)
        np.testing.assert_array_equal(low.rslot_tab, healthy.rslot_tab)
    rep = ref_repair(ref_compile(1, p), ref_parse("deadlink:5>3"))
    assert rep.n_staging == 1
    low = ref_lower(rep)
    ext = rep.data_edges_ext()
    hops = ext[ext[:, 5] != 0]                  # (src, dst, ss, ds, rnd)
    assert len(hops) == 2
    to_stage, from_stage = hops[hops[:, 6] == 2][0], hops[hops[:, 6] == 1][0]
    relay = int(to_stage[1])
    for hop in (to_stage, from_stage):
        c = next(k for k, (perm, r) in enumerate(
            zip(low.perms, low.round_of_color))
            if r == hop[4] and (int(hop[0]), int(hop[1])) in perm)
        # every recv slot is a data slot or the trash row: no staging
        assert low.rslot_tab[int(hop[1]), c] < low.n_recv_slots
        # and the forward hop's source reads the relay's SEND slot
        if hop is from_stage:
            assert int(hop[0]) == relay
            assert low.sslot_tab[relay, c] == int(hop[2])


@pytest.mark.parametrize("backend", ["cuda_dma", "cuda_dma_conc", "native"])
@pytest.mark.parametrize("spec", ["slow:r2*4", "deadlink:5>3"])
def test_fault_is_refused_upfront_where_no_lowering_exists(tmp_path,
                                                           backend, spec):
    """The runner refuses a faulted run on the remote-DMA transport and
    on the native runtime before any method runs: no banner, no CSV."""
    csv = tmp_path / "r.csv"
    cfg = ExperimentConfig(nprocs=8, cb_nodes=3, method=1, data_size=64,
                           comm_size=2, backend=backend, device="cpu",
                           verify=True, results_csv=str(csv), fault=spec)
    err = DmaFaultError if backend.startswith("cuda_dma") else \
        torch_sim.NotPortedError
    with pytest.raises(err, match="silently"):
        run_experiment(cfg)
    assert not csv.exists()
    # ... and the DMA backend itself refuses a stamped schedule by name
    if backend.startswith("cuda_dma"):
        s = repair_schedule(compile_method(1, _pattern((8, 3, 64, 2))),
                            parse_fault(spec))
        with pytest.raises(DmaFaultError, match="fault-injected"):
            CudaDmaBackend("cpu", backend == "cuda_dma_conc").run(s)


# ---------------------------------------------------------------------------
# The local and native oracles, copied; every backend against local.

def _bufs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec", [None, "slow:r2*4", "deadlink:5>3"])
@pytest.mark.parametrize("method", method_ids())
def test_local_matches_the_reference_local(method, spec):
    shape = (8, 3, 64, 2)
    rs, s = ref_compile(method, _pattern(shape, True)), compile_method(
        method, _pattern(shape))
    if spec:
        if METHODS[method].tam or s.collective:
            return
        pair = _faulted_pair(method, shape, spec)
        if pair is None:
            return
        rs, s = pair
    want, _ = RefLocal().run(rs, ntimes=2, iter_=1, verify=True)
    got, timers = LocalBackend().run(s, ntimes=2, iter_=1, verify=True)
    _bufs_equal(got, want)
    assert len(timers) == 8


@pytest.mark.parametrize("method", method_ids())
def test_native_matches_the_reference_native(method):
    shape = (8, 3, 64, 2)
    want, _ = RefNative().run(ref_compile(method, _pattern(shape, True)),
                              ntimes=2, iter_=1, verify=True)
    got, _ = NativeBackend().run(compile_method(method, _pattern(shape)),
                                 ntimes=2, iter_=1, verify=True)
    _bufs_equal(got, want)


def test_native_library_builds_from_the_ports_copy():
    from tpu_aggcomm_torch.backends import native
    assert native._SRC.endswith(
        "tpu_aggcomm_torch/native/aggcomm_runtime.cc")
    assert "/tpu_aggcomm_torch/native/build/" in native.library_path()
    assert open(native._SRC).read() == open(
        native._SRC.replace("tpu_aggcomm_torch", "tpu_aggcomm")).read()


def _port_backends():
    return {"torch_sim": TorchSimBackend("cpu"),
            "cuda_fused": CudaFusedBackend("cpu"),
            "cuda_dma": CudaDmaBackend("cpu"),
            "cuda_dma_conc": CudaDmaBackend("cpu", True),
            "native": NativeBackend()}


@pytest.mark.parametrize("backend", ["torch_sim", "cuda_fused", "cuda_dma",
                                     "cuda_dma_conc", "native"])
def test_every_backend_recv_equals_local_on_m0(backend):
    """-m 0 (every dispatched method; cuda_fused's fusable subset) on each
    port backend: the delivered recv equals the local oracle's, healthy."""
    b = _port_backends()[backend]
    p = _pattern((8, 3, 64, 2))
    for m in method_ids():
        s = compile_method(m, p)
        if backend == "cuda_fused" and (METHODS[m].tam or s.collective):
            continue
        want, _ = LocalBackend().run(s, iter_=1, verify=True)
        got, _ = b.run(s, iter_=1, verify=True)
        _bufs_equal(got, want)


@pytest.mark.parametrize("spec", ["deadlink:5>3", "slow:r2*4,deadlink:5>3"])
def test_torch_sim_recv_equals_local_repaired(spec):
    """Repaired schedules: torch_sim's delivery (staging rows dropped)
    equals the local oracle's for every repairable round-structured
    method; the other backends refuse a faulted schedule by name."""
    p = _pattern((8, 3, 64, 2))
    for m in ROUND_METHODS:
        try:
            s = repair_schedule(compile_method(m, p), parse_fault(spec))
        except RepairError:
            continue
        want, _ = LocalBackend().run(s, iter_=1, verify=True)
        got, _ = TorchSimBackend("cpu").run(s, iter_=1, verify=True)
        _bufs_equal(got, want)
    s = repair_schedule(compile_method(1, p), parse_fault(spec))
    with pytest.raises(ValueError, match="staging"):
        CudaFusedBackend("cpu").run(s)


def test_cli_fault_runs_on_torch_sim_and_local(tmp_path, capsys):
    for backend in ("torch_sim", "local"):
        assert cli.main(["-n", "8", "-m", "1", "-a", "3", "-d", "256",
                         "-c", "2", "--fault", "slow:r2*4,deadlink:5>3",
                         "--backend", backend, "--device", "cpu",
                         "--verify", "--results-csv",
                         str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert out.count("All to many max total time") == 2
