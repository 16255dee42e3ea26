"""TAM (m=15/16) on torch_sim against jax_sim and the proxy oracle.

The port's copies of the node topology and the TAM engine's device-free
half must equal the reference's; ``_tam_tables`` must equal the
reference's array for array; the three-hop rep and its hop prefixes
(``upto_hop`` 1 and 2) must give the reference's recv arena byte for byte
(trash row included; tolerance zero, integer data movement) on the same
``dense_send_lanes`` input; a full rep must pass ``--verify`` and equal
the port's ``tam_oracle``; chains of the full rep and of the prefixes must
end in the reference's state; and ``measure_tam_hops`` must return the
reference's dict under one seeded fake timer. Shapes: n=8 a=3 at ``-p``
1, 2 and 4, a ragged last node (n=10 ``-p 4``) and byte lanes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends import jax_sim as ref_sim  # noqa: E402
from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.core import topology as ref_topology  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.harness import chained as ref_chained  # noqa: E402
from tpu_aggcomm.tam import engine as ref_engine  # noqa: E402

from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.backends.cuda_dma import CudaDmaBackend  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend  # noqa: E402
from tpu_aggcomm_torch.core import topology  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness import chained  # noqa: E402
from tpu_aggcomm_torch.harness.verify import (VerificationError,  # noqa: E402
                                              verify_recv)
from tpu_aggcomm_torch.tam import engine  # noqa: E402

# (nprocs, cb_nodes, data_size, proc_node)
SHAPES = [(8, 3, 256, 1), (8, 3, 256, 2), (8, 3, 256, 4), (10, 3, 256, 4),
          (8, 3, 30, 2)]
TAM = [15, 16]


def _pair(m, shape):
    n, a, d, pn = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, proc_node=pn)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                proc_node=pn)))


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("nprocs,per_node", [(8, 1), (8, 2), (8, 4), (10, 4),
                                             (10, 3), (7, 7)])
def test_static_node_assignment_matches(nprocs, per_node, kind):
    got = topology.static_node_assignment(nprocs, per_node, kind)
    want = ref_topology.static_node_assignment(nprocs, per_node, kind)
    assert got.nnodes == want.nnodes
    for field in ("node_of", "proxies", "node_sizes"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert [got.proxy_of(r) for r in range(nprocs)] == \
        [want.proxy_of(r) for r in range(nprocs)]
    for node in range(got.nnodes):
        np.testing.assert_array_equal(got.local_ranks(node),
                                      want.local_ranks(node))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_tam_method_and_phase_bytes_match(method, shape):
    rs, s = _pair(method, shape)
    assert isinstance(s, engine.TamMethod)
    assert (s.method_id, s.name, s.collective) == \
        (rs.method_id, rs.name, rs.collective)
    assert engine.padded_mesh_size(s.assignment) == \
        ref_engine.padded_mesh_size(rs.assignment)
    assert engine.tam_phase_bytes(s.pattern, s.assignment) == \
        ref_engine.tam_phase_bytes(rs.pattern, rs.assignment)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_tam_tables_match(method, shape):
    rs, s = _pair(method, shape)
    got, want = torch_sim._tam_tables(s), ref_sim._tam_tables(rs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("upto_hop", [None, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_tam_rep_matches_jax_sim(method, shape, upto_hop):
    rs, s = _pair(method, shape)
    send = ref_sim.dense_send_lanes(rs.pattern, 1)
    want = np.asarray(jax.jit(
        JaxSimBackend()._tam_rep(rs, upto_hop=upto_hop))(send))
    got = to_reference(TorchSimBackend("cpu")._tam_rep(s, upto_hop=upto_hop)(
        from_reference(send, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _wrapping_send(p, seed):
    """Lanes near 2**32 (uint32) or random bytes: the hop sinks' sums
    wrap in the lane dtype, as the reference's do."""
    from tpu_aggcomm_torch.harness.verify import slot_shapes
    n_send, _ = slot_shapes(p)
    rng = np.random.default_rng(seed)
    if p.data_size % 4 == 0:
        return rng.integers(2**32 - 2**20, 2**32, dtype=np.uint32,
                            size=(p.nprocs, n_send, p.data_size // 4))
    return rng.integers(0, 256, dtype=np.uint8,
                        size=(p.nprocs, n_send, p.data_size))


@pytest.mark.parametrize("upto_hop", [1, 2])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4]])
@pytest.mark.parametrize("method", TAM)
def test_tam_hop_sinks_wrap_like_the_reference(method, shape, upto_hop):
    rs, s = _pair(method, shape)
    send = _wrapping_send(s.pattern, method)
    want = np.asarray(jax.jit(
        JaxSimBackend()._tam_rep(rs, upto_hop=upto_hop))(send))
    got = to_reference(TorchSimBackend("cpu")._tam_rep(s, upto_hop=upto_hop)(
        from_reference(send, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_tam_full_rep_verifies_and_equals_the_oracle(method, shape):
    rs, s = _pair(method, shape)
    b = TorchSimBackend("cpu")
    recv, timers = b.run(s, ntimes=2, iter_=1, verify=True)
    assert b.last_provenance == ("torch_sim", "attributed")
    oracle = engine.tam_oracle(s, 1)
    ref_oracle = ref_engine.tam_oracle(rs, 1)
    for got, want, ref_want in zip(recv, oracle, ref_oracle):
        assert (got is None) == (want is None) == (ref_want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(want, ref_want)
    verify_recv(s.pattern, oracle, 1)
    assert timers[0].total_time > 0


def test_tam_verify_catches_a_lost_hop(monkeypatch):
    """A P3 exchange that drops one slab fails ``--verify``."""
    _rs, s = _pair(15, SHAPES[2])
    b = TorchSimBackend("cpu")
    real = torch_sim._tam_tables

    def lossy(tam):
        stage, exch, dst, slot = real(tam)
        exch = exch.copy()
        exch[0] = exch[1]
        return stage, exch, dst, slot

    monkeypatch.setattr(torch_sim, "_tam_tables", lossy)
    with pytest.raises(VerificationError):
        b.run(s, verify=True)


@pytest.mark.parametrize("upto_hop", [None, 1, 2])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4]])
@pytest.mark.parametrize("method", TAM)
def test_tam_chain_end_states_match(method, shape, upto_hop):
    rs, s = _pair(method, shape)
    send = ref_sim.dense_send_lanes(rs.pattern, 0)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    want = np.asarray(ref_b._chain_factory(
        ref_b._tam_rep(rs, upto_hop=upto_hop), rs.pattern)(5)(send))
    got = to_reference(b._chain_factory(
        b._tam_rep(s, upto_hop=upto_hop), s.pattern)(5)(
            from_reference(send, "cpu")))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, send)


@pytest.fixture
def fake_timers(monkeypatch):
    """One seeded sequence of seconds per package, served in call order
    to its chain timer (``differenced_per_rep`` and ``measure_per_rep``)."""
    out = []
    for modules, cls in (((ref_sim, ref_chained), JaxSimBackend),
                         ((torch_sim, chained), TorchSimBackend)):
        values = iter(np.random.default_rng(11).uniform(
            1e-6, 1e-4, size=64).tolist())
        calls = []

        def per_rep(chain_factory, send0, _v=values, _c=calls, **kw):
            _c.append("differenced_per_rep")
            return next(_v)

        def measure(self, schedule, _v=values, _c=calls, **kw):
            _c.append("measure_per_rep")
            return next(_v)

        for mod in modules:
            monkeypatch.setattr(mod, "differenced_per_rep", per_rep)
        monkeypatch.setattr(cls, "measure_per_rep", measure)
        out.append(calls)
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", TAM)
def test_tam_hops_arithmetic_matches(method, shape, fake_timers):
    ref_calls, calls = fake_timers
    rs, s = _pair(method, shape)
    want = JaxSimBackend().measure_tam_hops(rs)
    got = TorchSimBackend("cpu").measure_tam_hops(s)
    assert got == want
    assert calls == ref_calls == ["measure_per_rep"] + \
        ["differenced_per_rep"] * 2
    assert got["p2"] + got["p3"] + got["p4"] == pytest.approx(got["total"])


@pytest.mark.parametrize("method", TAM)
def test_tam_measured_phases_run_matches_reference(method, fake_timers):
    rs, s = _pair(method, SHAPES[2])
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    _, want = ref_b.run(rs, ntimes=3, verify=True, measured_phases=True)
    _, got = b.run(s, ntimes=3, verify=True, measured_phases=True)
    assert b.last_provenance == (
        "torch_sim", "measured-hops(P2,P3,P4)+attributed(ranks)")
    assert ref_b.last_provenance[1] == b.last_provenance[1]
    assert b.last_round_times == ref_b.last_round_times
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.as_array(), w.as_array())


def test_tam_hops_sum_to_the_chained_total_on_cpu():
    """A real (timed) hop split on the CPU: non-negative hops summing to
    the full chain's per-rep time."""
    _rs, s = _pair(16, SHAPES[1])
    b = TorchSimBackend("cpu")
    kw = dict(iters_small=2, iters_big=12, trials=1, windows=1)
    hops = b.measure_tam_hops(s, **kw)
    assert min(hops["p2"], hops["p3"], hops["p4"]) >= 0
    assert hops["p2"] + hops["p3"] + hops["p4"] == \
        pytest.approx(hops["total"])
    assert hops["total"] == b.measure_per_rep(s, **kw)


def test_tam_refuses_round_prefixes_and_the_fused_kernel():
    _rs, s = _pair(15, SHAPES[0])
    b = TorchSimBackend("cpu")
    with pytest.raises(ValueError, match="upto_hop"):
        b._one_rep(s, upto=1)
    with pytest.raises(ValueError, match="upto_hop must be"):
        b._tam_rep(s, upto_hop=3)
    with pytest.raises(ValueError, match="round-structured"):
        b.measure_round_times(s)
    with pytest.raises(ValueError, match="round-structured"):
        b._one_rep_scatters(s)
    m1 = compile_method(1, AggregatorPattern(8, 3, data_size=256))
    with pytest.raises(ValueError, match="TAM schedule"):
        b.measure_tam_hops(m1)
    from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
    from tpu_aggcomm_torch.native.fuse import UnfusableScheduleError
    with pytest.raises(UnfusableScheduleError, match="TAM"):
        CudaFusedBackend("cpu").run(s, verify=True)


@pytest.mark.parametrize("concurrent", [False, True])
@pytest.mark.parametrize("method", TAM)
def test_cuda_dma_routes_tam_to_torch_sim(method, concurrent):
    """As the reference's pallas_dma routes TAM to jax_sim: the rank-axis
    lowering on the same device, its provenance recorded."""
    _rs, s = _pair(method, SHAPES[1])
    b = CudaDmaBackend("cpu", concurrent=concurrent)
    recv, _ = b.run(s, ntimes=2, iter_=1, verify=True)
    assert b.last_provenance == ("torch_sim", "attributed")
    assert len(b.last_rep_timers) == 2
    for got, want in zip(recv, engine.tam_oracle(s, 1)):
        if want is not None:
            np.testing.assert_array_equal(got, want)
