"""Kernel K2's plain version against the fused Pallas kernel in interpret
mode, and the cuda_fused backend's named refusals.

``CudaFusedBackend(device="cpu")`` runs K2's contract in plain torch: a
``torch.empty`` arena, its zero runs zeroed, then a Python loop over the
plan's rounds doing ``recv[dst, ds] = send[src, ss]``. Under
:mod:`torch_fill` that arena comes back filled, and its whole ``(n, R+1,
w)`` recv arena, trash row included (left at zero: the fused lowering
writes no barrier tokens), must equal
``PallasFusedBackend(interpret=True)``'s byte for byte, for the 16
fusable dispatched methods.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends.pallas_fused import PallasFusedBackend  # noqa: E402
from tpu_aggcomm.backends.jax_sim import dense_send_lanes as ref_send  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402

from torch_fill import filled_empty  # noqa: E402,F401

from tpu_aggcomm_torch.backends.cuda_fused import (CudaFusedBackend,  # noqa: E402
                                                   FusedBackendError)
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,  # noqa: E402
                                              run_experiment)
from tpu_aggcomm_torch.native import fuse  # noqa: E402
from tpu_aggcomm_torch.obs import trace  # noqa: E402

FUSABLE = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]


def _pair(m, n=8, a=3, d=32, c=3):
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c)))


@pytest.mark.parametrize("method", FUSABLE)
def test_plain_fused_rep_matches_pallas_interpret(method, filled_empty):
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


def test_plain_fused_rep_byte_lanes(filled_empty):
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
def test_fused_rep_into_poisoned_out_equals_plain(method, filled_empty):
    """With ``out`` the CPU path runs the kernel's contract (zero runs,
    then rounds) over whatever ``out`` held; without, over the arena
    ``torch.empty`` hands back filled."""
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
    assert torch.equal(fuse.fused_rep(send, tabs), got)


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


class _Entry:
    """A stand-in for one of K2's C entries: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K2's C entries, the current device and the current stream replaced
    by stand-ins, so that binding and both launches run on the CPU:
    returns the 17-argument entry and the bound one."""
    from types import SimpleNamespace
    full, bound = _Entry(), _Entry()
    monkeypatch.setattr(fuse, "_c_lib", lambda: (full, None, bound))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(
                            cuda_stream=0x5000 + device))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0x5000 + device, raising=False)
    return full, bound


BLOCK_CELLS = ([(m, 2048) for m in FUSABLE] + [(1, 36), (1, 30), (2, 6)])


@pytest.mark.parametrize("method,d", BLOCK_CELLS,
                         ids=[f"m{m}-d{d}" for m, d in BLOCK_CELLS])
def test_bound_block_carries_the_full_launch_arguments(fake_card, method, d):
    """The packed block holds exactly what the 17-argument call passes
    besides the arenas, the stamps and the stream; the bound send and
    arena are the plan's lane layout."""
    full, _bound = fake_card
    s = compile_method(method, AggregatorPattern(32, 14, data_size=d,
                                                 comm_size=3))
    plan = fuse.fuse_plan(s)
    tabs = fuse.plan_tables(plan, "cpu")
    assert tabs.bound is None                       # the CPU binds nothing
    b = fuse.bind_rep(tabs, plan.data_size)
    send = torch.zeros(tuple(b.send_shape), dtype=b.dtype)
    out = torch.empty_like(b.arena)
    assert out.is_contiguous() and b.arena.untyped_storage().nbytes() == \
        b.dtype.itemsize
    assert tuple(out.shape) == (tabs.nprocs, tabs.n_recv_rows, send.shape[2])
    assert send.shape[2] * send.element_size() == d
    assert b.dtype == (torch.uint8 if d % 4 else torch.int32)
    fuse._launch(send, tabs, out, None)
    (args,) = full.calls
    blk = b.block
    assert b.ref._obj is blk and b.device_index == 3
    packed = [blk.round_ptr, blk.src_row, blk.dst_row, blk.zero_start,
              blk.zero_ptr, blk.n_rounds, blk.n_zero_runs, blk.zero_rows,
              blk.row_bytes, blk.max_round_edges, blk.sync, blk.timeout_ns,
              blk.device]
    assert [v or 0 for v in packed] == \
        [v or 0 for v in args[2:14] + args[16:]]
    assert args[:2] == (send.data_ptr(), out.data_ptr())
    assert args[14:16] == (None, 0x5003)            # no stamps; the stream
    assert blk.n_rounds == len(plan.rounds) and blk.row_bytes == d


def test_bound_rep_counts_launches_not_full_checks(fake_card):
    """The bound launch is one call of the bound entry (block, send, out,
    the current stream) and one launch; the full one counts a launch and
    a full check; the CPU path counts neither."""
    full, bound = fake_card
    _rs, s = _pair(1)
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    send = from_reference(ref_send(_rs.pattern, 0), "cpu")
    launches, checks = fuse.fused_rep.launches, fuse.fused_rep.full_checks
    fuse.fused_rep(send, tabs)
    fuse.fused_rep(send, tabs, out=torch.empty_like(fuse.fused_rep(send,
                                                                   tabs)))
    assert (fuse.fused_rep.launches, fuse.fused_rep.full_checks) == \
        (launches, checks)
    # bound to the CPU's device number (-1), so that a CPU send is taken
    b = dataclasses.replace(fuse.bind_rep(tabs, 32), device_index=-1)
    on = dataclasses.replace(tabs, bound=b)
    got = fuse.fused_rep(send, on)
    assert bound.calls == [(b.ref, send.data_ptr(), got.data_ptr(),
                            0x5000 - 1)] and not full.calls
    assert got.shape == (8, tabs.n_recv_rows, 8) and got.dtype == send.dtype
    assert (fuse.fused_rep.launches, fuse.fused_rep.full_checks) == \
        (launches + 1, checks)
    fuse._launch(send, tabs, got, None)
    assert (fuse.fused_rep.launches, fuse.fused_rep.full_checks) == \
        (launches + 2, checks + 1)
    # traced: the same call of the bound entry inside the rep's spans
    rec = trace.enable(manifest=False)
    try:
        got = fuse.fused_rep(send, on)
    finally:
        trace.disable()
    assert bound.calls[-1] == (b.ref, send.data_ptr(), got.data_ptr(),
                               0x5000 - 1)
    spans = [e for e in rec.events if e.get("ev") == "host_span"]
    assert [e["name"] for e in spans] == ["rep.arena", "rep.issue", "rep"]
    assert spans[-1]["args"] == {"full_checks": checks + 1}
    assert fuse.fused_rep.launches == launches + 3


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


REFUSED = {
    "shape": lambda send: (send[:, :2].contiguous(), None),
    "dtype": lambda send: (send.to(torch.int64), None),
    "contiguous": lambda send: (send.transpose(0, 1).contiguous()
                                .transpose(0, 1), None),
    "device": lambda send: (send.to("meta"), None),
    "out": lambda send: (send, torch.empty(3, dtype=send.dtype)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("traced", [False, True])
def test_bound_tables_refuse_as_unbound_ones(fake_card, case, traced):
    """A send the bound launch does not take falls to the full check,
    which refuses with the message the unbound tables give. Bound to the
    CPU's device number (-1) but for the device case, which sends from
    another device than the bound one's."""
    _rs, s = _pair(1)
    tabs = fuse.plan_tables(fuse.fuse_plan(s), "cpu")
    b = fuse.bind_rep(tabs, 32)
    if case != "device":
        b = dataclasses.replace(b, device_index=-1)
    on = dataclasses.replace(tabs, bound=b)
    send, out = REFUSED[case](from_reference(ref_send(_rs.pattern, 0),
                                             "cpu"))
    if traced:
        trace.enable(manifest=False)
    try:
        want = _refusal(lambda: fuse.fused_rep(send, tabs, out))
        got = _refusal(lambda: fuse.fused_rep(send, on, out))
    finally:
        trace.disable()
    assert got == want and "fused_rep: " in got
    assert not fake_card[1].calls
