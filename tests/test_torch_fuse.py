"""Kernel K2's plain version against the fused Pallas kernel in interpret
mode, and the cuda_fused backend's named refusals.

``CudaFusedBackend(device="cpu")`` runs the plain version of K2 (a Python
loop over the plan's rounds doing ``recv[dst, ds] = send[src, ss]``); its
whole ``(n, R+1, w)`` recv arena, trash row included (left at zero: the
fused lowering writes no barrier tokens), must equal
``PallasFusedBackend(interpret=True)``'s byte for byte, for the 16
fusable dispatched methods.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends.pallas_fused import PallasFusedBackend  # noqa: E402
from tpu_aggcomm.backends.jax_sim import dense_send_lanes as ref_send  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402

from tpu_aggcomm_torch.backends.cuda_fused import (CudaFusedBackend,  # noqa: E402
                                                   FusedBackendError)
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,  # noqa: E402
                                              run_experiment)
from tpu_aggcomm_torch.native import fuse  # noqa: E402

FUSABLE = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]


def _pair(m, n=8, a=3, d=32, c=3):
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c)))


@pytest.mark.parametrize("method", FUSABLE)
def test_plain_fused_rep_matches_pallas_interpret(method):
    rs, s = _pair(method)
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(
        PallasFusedBackend(interpret=True).one_rep(rs))(send))
    before = fuse.fused_rep.launches
    got = to_reference(CudaFusedBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    assert fuse.fused_rep.launches == before      # CPU: no kernel launch
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[:, -1].any()                   # trash row stays zero
    recv, _ = CudaFusedBackend("cpu").run(s, verify=True)
    assert any(r is not None for r in recv)


def test_plain_fused_rep_byte_lanes():
    rs, s = _pair(1, d=30)
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(
        PallasFusedBackend(interpret=True).one_rep(rs))(send))
    got = to_reference(CudaFusedBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    CudaFusedBackend("cpu").run(s, verify=True)


@pytest.mark.parametrize("method", [5, 8])
def test_refuses_dense_collectives(method):
    _rs, s = _pair(method)
    with pytest.raises(fuse.UnfusableScheduleError, match="collective"):
        CudaFusedBackend("cpu").one_rep(s)


def test_refuses_tam_like_objects():
    with pytest.raises(fuse.UnfusableScheduleError, match="TAM"):
        fuse.fuse_plan(object())


def test_refuses_round_prefix_truncation():
    _rs, s = _pair(1)
    with pytest.raises(ValueError, match="truncation"):
        CudaFusedBackend("cpu")._one_rep(s, upto=1)


@pytest.mark.parametrize("flag", ["profile_rounds", "measured_phases"])
def test_refuses_profile_rounds_and_measured_phases(flag):
    _rs, s = _pair(1)
    with pytest.raises(ValueError, match="cuda_fused"):
        CudaFusedBackend("cpu").run(s, **{flag: True})


def test_refuses_without_a_card_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FusedBackendError, match="device='cpu'"):
        CudaFusedBackend()
    CudaFusedBackend(device="cpu")


def test_edge_ceiling_is_kept(monkeypatch):
    monkeypatch.setattr(fuse, "MAX_FUSED_EDGES", 10)
    _rs, s = _pair(1)
    with pytest.raises(fuse.UnfusableScheduleError, match="ceiling"):
        fuse.fuse_plan(s)


def test_runner_refuses_unfusable_method_before_running(tmp_path):
    cfg = ExperimentConfig(nprocs=8, cb_nodes=3, method=5, data_size=32,
                           comm_size=3, backend="cuda_fused", device="cpu",
                           results_csv=str(tmp_path / "r.csv"))
    with pytest.raises(ValueError, match="cuda_fused does not support"):
        run_experiment(cfg, out=open(tmp_path / "out.txt", "w"))
    assert not (tmp_path / "r.csv").exists()


def test_fused_rep_wrapper_checks_its_inputs():
    _rs, s = _pair(1)
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    bad = torch.zeros((8, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="send must be"):
        fuse.fused_rep(bad, tabs)
    with pytest.raises(ValueError, match="send must be"):
        fuse.fused_rep(torch.zeros((8, 3, 8), dtype=torch.int64), tabs)
    with pytest.raises(ValueError, match="contiguous"):
        fuse.fused_rep(torch.zeros((8, 8, 3), dtype=torch.int32)
                       .transpose(1, 2), tabs)


README_CELLS = ([(m, dict(n=32, a=14, d=2048, c=3)) for m in FUSABLE]
                + [(m, dict(n=256, a=16, d=2048, c=16)) for m in (1, 2)])


@pytest.mark.parametrize("method,cfg", README_CELLS,
                         ids=[f"m{m}-n{c['n']}" for m, c in README_CELLS])
def test_zero_runs_and_written_cells_tile_the_arena(method, cfg):
    """Every recv cell is either in exactly one zero run or written by an
    edge, never both; the trash row of every rank is in a zero run."""
    s = compile_method(method, AggregatorPattern(
        cfg["n"], cfg["a"], data_size=cfg["d"], comm_size=cfg["c"]))
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    rows = tabs.nprocs * tabs.n_recv_rows
    cover = np.zeros(rows, dtype=np.int64)
    for a, b in tabs.zero_runs:
        assert 0 <= a < b <= rows
        cover[a:b] += 1
    written = np.unique(tabs.dst.numpy().astype(np.int64) * tabs.n_recv_rows
                        + tabs.dslot.numpy())
    cover[written] += 1
    assert (cover == 1).all()
    assert tabs.zero_rows == rows - len(written)
    trash = np.arange(tabs.nprocs) * tabs.n_recv_rows + tabs.n_recv_rows - 1
    assert (cover[trash] == 1).all() and not np.isin(trash, written).any()
    np.testing.assert_array_equal(
        tabs.zero_ptr.numpy(),
        np.concatenate([[0], np.cumsum([b - a for a, b in tabs.zero_runs])]))


def test_zero_runs_of_merges_contiguous_rows():
    assert fuse.zero_runs_of(2, 3, [0, 1], [1, 0]) == [(0, 1), (2, 3),
                                                       (4, 6)]
    assert fuse.zero_runs_of(1, 2, [0, 0], [0, 1]) == []


def _two_writer_plans(d=16):
    """One recv cell, (1, 0), written in rounds 0 and 2: the later round's
    row must land."""
    rounds = ((0, ((0, 0, 1, 0),)), (1, ((1, 0, 0, 1),)),
              (2, ((0, 1, 1, 0), (1, 1, 0, 0))))
    kw = dict(nprocs=2, data_size=d, n_send_slots=2, n_recv_slots=2,
              rounds=rounds, barriers=())
    from tpu_aggcomm.native.fuse import FusePlan as RefFusePlan
    return fuse.FusePlan(**kw), RefFusePlan(**kw)


def test_cell_written_in_two_rounds_keeps_the_later_row():
    from tpu_aggcomm.backends.lanes import lane_layout
    from tpu_aggcomm.native.fuse import build_fused_rep as ref_build

    plan, ref_plan = _two_writer_plans()
    send = np.random.default_rng(2).integers(0, 2**32, size=(2, 2, 4),
                                             dtype=np.uint32)
    want = np.asarray(jax.jit(ref_build(ref_plan, lane=lane_layout(16),
                                        interpret=True))(send))
    tabs = fuse.plan_tables(plan, "cpu")
    got = to_reference(fuse.fused_rep_plain(from_reference(send, "cpu"),
                                            tabs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, 0], send[0, 1])    # round 2's row
    np.testing.assert_array_equal(got[0, 1], send[1, 0])
    assert not got[:, 2].any()


@pytest.mark.parametrize("method", FUSABLE + ["two-writer"])
def test_fused_rep_into_poisoned_out_equals_plain(method):
    """With ``out`` the CPU path runs the kernel's contract (zero runs,
    then rounds) over whatever ``out`` held."""
    if method == "two-writer":
        plan = _two_writer_plans()[0]
        send = torch.arange(2 * 2 * 4, dtype=torch.int32).reshape(2, 2, 4)
    else:
        _rs, s = _pair(method)
        plan = fuse.fuse_plan(s)
        send = from_reference(ref_send(_rs.pattern, 0), "cpu")
    tabs = fuse.plan_tables(plan, "cpu")
    out = torch.full((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                     -0x5A5A5A5B, dtype=send.dtype)         # 0xA5A5A5A5
    got = fuse.fused_rep(send, tabs, out=out)
    assert got is out
    assert torch.equal(got, fuse.fused_rep_plain(send, tabs))


def test_fused_rep_refuses_a_mismatched_out():
    _rs, s = _pair(1)
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    send = from_reference(ref_send(_rs.pattern, 0), "cpu")
    with pytest.raises(ValueError, match="out must be"):
        fuse.fused_rep(send, tabs, out=torch.empty(3, dtype=send.dtype))


def test_fence_timeout_record_raises_by_name_and_clears():
    _rs, s = _pair(1)
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    tabs.sync[1:] = torch.tensor([5, 2, 9], dtype=torch.int32)
    with pytest.raises(fuse.FusedFenceError,
                       match="CTA 4 .* after round 2 \\(9 arrivals\\)"):
        fuse.check_fence(tabs)
    assert not tabs.sync.any()
    fuse.check_fence(tabs)
