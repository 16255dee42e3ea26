"""The port's host-side tables equal the reference's, array for array.

``tpu_aggcomm_torch`` keeps its own copies of the device-free layers
(pattern, schedule, methods, verification fills) and its own
re-implementations of the host tables that sit inside jax-importing
reference modules (``dense_send_lanes``, ``_round_tables``,
``_scan_lowered``). For every dispatched non-TAM method at the three test
shapes, both packages must produce identical patterns, slot shapes, send
lanes, round tables and fused plans.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from tpu_aggcomm.backends import jax_sim as ref_sim  # noqa: E402
from tpu_aggcomm.core.methods import METHODS as REF_METHODS  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.harness import verify as ref_verify  # noqa: E402
from tpu_aggcomm.native import fuse as ref_fuse  # noqa: E402

from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.core.methods import METHODS, compile_method, method_ids  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness import verify  # noqa: E402
from tpu_aggcomm_torch.native import fuse  # noqa: E402

# (nprocs, cb_nodes, data_size, comm_size): unrolled rounds; >= 32 rounds
# (the scan-lowered form); byte lanes (d % 4 != 0)
SHAPES = [(8, 3, 256, 2), (32, 4, 64, 1), (8, 3, 30, 2)]
NON_TAM = [m for m in method_ids() if not METHODS[m].tam]


def _pair(m, shape):
    n, a, d, c = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c)))


def test_registry_matches_reference_minus_tam():
    ref_ids = [m for m in REF_METHODS if REF_METHODS[m].dispatched
               and not REF_METHODS[m].tam]
    assert NON_TAM == ref_ids
    assert len(NON_TAM) == 18
    for m in NON_TAM:
        assert METHODS[m].name == REF_METHODS[m].name
        assert METHODS[m].direction.value == REF_METHODS[m].direction.value


def test_registry_matches_reference():
    """The whole dispatched registry, TAM included now that the port's
    ``tam.engine`` imports: 20 methods, the same ids, names, directions
    and TAM flags, and every undispatched id the same too."""
    ref_ids = [m for m in REF_METHODS if REF_METHODS[m].dispatched]
    assert method_ids() == ref_ids
    assert len(method_ids()) == 20
    assert [m for m in method_ids() if METHODS[m].tam] == [15, 16]
    assert sorted(METHODS) == sorted(REF_METHODS)
    for m in METHODS:
        assert METHODS[m].name == REF_METHODS[m].name
        assert METHODS[m].direction.value == REF_METHODS[m].direction.value
        assert METHODS[m].tam == REF_METHODS[m].tam
        assert METHODS[m].dispatched == REF_METHODS[m].dispatched


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", NON_TAM)
def test_pattern_and_send_lanes_match(method, shape):
    rs, s = _pair(method, shape)
    rp, p = rs.pattern, s.pattern
    np.testing.assert_array_equal(np.asarray(p.rank_list),
                                  np.asarray(rp.rank_list))
    np.testing.assert_array_equal(p.agg_index, rp.agg_index)
    assert verify.slot_shapes(p) == ref_verify.slot_shapes(rp)
    assert verify.recv_slot_counts(p) == ref_verify.recv_slot_counts(rp)
    got = torch_sim.dense_send_lanes(p, 1)
    want = ref_sim.dense_send_lanes(rp, 1)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", NON_TAM)
def test_round_tables_and_fuse_plan_match(method, shape):
    rs, s = _pair(method, shape)
    assert s.collective == rs.collective
    if rs.collective:
        with pytest.raises(fuse.UnfusableScheduleError, match="collective"):
            fuse.fuse_plan(s)
        with pytest.raises(ref_fuse.UnfusableScheduleError):
            ref_fuse.fuse_plan(rs)
        return
    got, got_bars = torch_sim._round_tables(s)
    want, want_bars = ref_sim._round_tables(rs)
    assert got_bars == want_bars
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for ga, wa in zip(g[1:], w[1:]):
            assert ga.dtype == wa.dtype
            np.testing.assert_array_equal(ga, wa)
    assert (torch_sim._scan_lowered(got, got_bars)
            == ref_sim._scan_lowered(want, want_bars))
    got_plan, want_plan = fuse.fuse_plan(s), ref_fuse.fuse_plan(rs)
    for field in ("nprocs", "data_size", "n_send_slots", "n_recv_slots",
                  "rounds", "barriers"):
        assert getattr(got_plan, field) == getattr(want_plan, field), field
    assert fuse.plan_round_matrices(got_plan) == \
        ref_fuse.plan_round_matrices(want_plan)
    assert fuse.semaphore_deps(got_plan) == ref_fuse.semaphore_deps(want_plan)


def test_scan_shape_takes_the_padded_lowering():
    """The n=32 c=1 shape is the one that exercises the scan-lowered form
    in both packages."""
    rs, s = _pair(1, SHAPES[1])
    tabs, bars = torch_sim._round_tables(s)
    assert len(tabs) >= 32 and torch_sim._scan_lowered(tabs, bars)
    assert ref_sim._scan_lowered(*ref_sim._round_tables(rs))


@pytest.mark.parametrize("method", [m for m in NON_TAM if m not in (5, 8)])
def test_plan_tables_flatten_the_plan(method):
    """The kernel's CSR tables list every edge of every round, in order."""
    _rs, s = _pair(method, SHAPES[0])
    plan = fuse.fuse_plan(s)
    tabs = fuse.plan_tables(plan, "cpu")
    assert len(tabs.round_ptr) == len(plan.rounds) + 1
    assert tabs.round_ptr[-1] == plan.n_edges
    assert tabs.max_round_edges == max(len(e) for _r, e in plan.rounds)
    flat = [e for _r, edges in plan.rounds for e in edges]
    cols = np.stack([t.numpy() for t in (tabs.src, tabs.sslot, tabs.dst,
                                         tabs.dslot)], axis=1)
    np.testing.assert_array_equal(cols, np.asarray(flat, dtype=np.int32))
    assert tabs.n_recv_rows == plan.n_recv_slots + 1
