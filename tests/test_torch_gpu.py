"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where torch sees no CUDA device. The decision is
made inside the ``cuda`` fixture, never at import, so every pytest-xdist
worker collects the same tests. This file imports neither jax nor the
reference package, so on a host with the card and without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``tests/conftest.py`` imports jax; ``--noconftest`` skips it there.)
Tolerance is zero throughout: the kernels move integer data.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tpu_aggcomm_torch.backends import cuda_dma, cuda_local
from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend,
                                                 DmaProtocolError, capacity,
                                                 check_protocol, dma_steps,
                                                 dma_steps_plain, dma_tables,
                                                 send_arena)
from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
from tpu_aggcomm_torch.backends.cuda_local import (exchange, exchange_chain,
                                                   exchange_plain,
                                                   host_replay, order_table,
                                                   rep_word)
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference
from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,
                                                  dense_send_lanes)
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.harness import chained
from tpu_aggcomm_torch.harness.verify import slot_shapes
from tpu_aggcomm_torch.native.fuse import (FusePlan, check_fence, fuse_plan,
                                           fused_plan, fused_rep,
                                           fused_rep_plain, plan_tables)

pytestmark = pytest.mark.gpu

FUSABLE = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("iters", [0, 1, 2, 9, 260])
@pytest.mark.parametrize("n,cb,d", [(32, 14, 2048), (8, 3, 64), (6, 6, 48)])
def test_exchange_kernel_matches_plain_and_replay(cuda, n, cb, d, iters):
    """One launch per chain (none for iters = 0), byte-equal to the plain
    chain and the host replay; send0 is left as it was."""
    p = AggregatorPattern(n, cb, data_size=d, comm_size=3)
    rng = np.random.default_rng(n * cb)
    s0 = rng.integers(0, 2**32, size=(n, cb, d // 4), dtype=np.uint32)
    send0 = from_reference(s0, cuda)
    before, reps = exchange.launches, exchange.reps
    got = exchange_chain(p, send0, iters)
    torch.cuda.synchronize()
    assert exchange.launches == before + (iters > 0)
    assert exchange.reps == reps + iters
    plain = exchange_chain(p, send0, iters, step=exchange_plain)
    np.testing.assert_array_equal(to_reference(got), to_reference(plain))
    np.testing.assert_array_equal(to_reference(got), host_replay(p, s0, iters))
    np.testing.assert_array_equal(to_reference(send0), s0)


def test_exchange_kernel_hbm_launch_constants(cuda):
    """An arena past the L2 launch constants (2 x 32 MiB per rep) gives
    the replay's bytes too."""
    p = AggregatorPattern(512, 32, data_size=2048, comm_size=3)
    s0 = np.random.default_rng(7).integers(0, 2**32, size=(512, 32, 512),
                                           dtype=np.uint32)
    got = exchange_chain(p, from_reference(s0, cuda), 9)
    np.testing.assert_array_equal(to_reference(got), host_replay(p, s0, 9))


def test_exchange_long_chain_outlasts_a_short_timeout(cuda, monkeypatch):
    """The timeout bounds each wait at a barrier, not the chain: a chain
    far longer than the timeout completes and equals the plain chain."""
    monkeypatch.setattr(cuda_local, "TIMEOUT_S", 0.005)
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    send0 = from_reference(np.random.default_rng(2).integers(
        0, 2**32, size=(32, 14, 512), dtype=np.uint32), cuda)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got = exchange_chain(p, send0, 20000)
    stop.record()
    stop.synchronize()
    assert start.elapsed_time(stop) > 4 * 0.005 * 1e3
    assert torch.equal(got, exchange_chain(p, send0, 20000,
                                           step=exchange_plain))


@pytest.mark.parametrize("iters", [2**31 - 1, 2**31])
def test_exchange_chain_refuses_a_counter_overflow(cuda, iters):
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    send0 = torch.zeros((32, 14, 512), dtype=torch.int32, device=cuda)
    before = exchange.launches
    with pytest.raises(ValueError, match="32-bit arrival counter|exceed"):
        exchange_chain(p, send0, iters)
    assert exchange.launches == before


def test_exchange_barrier_stamps(cuda):
    """A diagnostic chain's stamps: every CTA arrives at every barrier
    and leaves it after the last arrival."""
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    grid, iters = cuda_local.chain_grid(p, cuda), 9
    stamps = torch.zeros((grid, iters - 1, 2), dtype=torch.int64,
                         device=cuda)
    s0 = np.random.default_rng(4).integers(0, 2**32, size=(32, 14, 512),
                                           dtype=np.uint32)
    got = exchange_chain(p, from_reference(s0, cuda), iters, stamps=stamps)
    np.testing.assert_array_equal(to_reference(got), host_replay(p, s0,
                                                                 iters))
    st = stamps.cpu()
    assert (st > 0).all()
    assert (st[:, :, 1].min(0).values >= st[:, :, 0].max(0).values).all()


def test_exchange_one_rep_through_the_chain_kernel(cuda):
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    s0 = np.random.default_rng(1).integers(0, 2**32, size=(32, 14, 512),
                                           dtype=np.uint32)
    send0 = from_reference(s0, cuda)
    order = order_table(p, cuda)
    got = exchange(send0, order, rep_word(5))
    want = exchange_plain(send0, order, rep_word(5))
    assert torch.equal(got, want)


def _poisoned(tabs, send):
    return torch.full((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                      0xA5 if send.dtype == torch.uint8 else -0x5A5A5A5B,
                      dtype=send.dtype, device=send.device)


@pytest.mark.parametrize("d", [2048, 36, 30])
@pytest.mark.parametrize("method", FUSABLE)
def test_fused_kernel_matches_plain(cuda, method, d):
    """16-byte vectors (d=2048), 4-byte words (d=36) and bytes (d=30), one
    launch into a recv pre-filled with 0xA5."""
    s = compile_method(method, AggregatorPattern(32, 14, data_size=d,
                                                 comm_size=3))
    tabs = plan_tables(fuse_plan(s), cuda)
    send = from_reference(dense_send_lanes(s.pattern, 0), cuda)
    before = fused_rep.launches
    got = fused_rep(send, tabs, out=_poisoned(tabs, send))
    torch.cuda.synchronize()
    assert fused_rep.launches == before + 1
    check_fence(tabs)
    np.testing.assert_array_equal(to_reference(got),
                                  to_reference(fused_rep_plain(send, tabs)))


@pytest.mark.parametrize("d", [2048, 36, 30])
@pytest.mark.parametrize("method", [1, 2])
def test_fused_kernel_at_n256_uses_the_hand_fence(cuda, method, d):
    """Rounds of 256 edges need more copying CTAs than one cluster holds,
    so the hand-rolled fence runs, at every lane width."""
    s = compile_method(method, AggregatorPattern(256, 16, data_size=d,
                                                 comm_size=16))
    tabs = plan_tables(fuse_plan(s), cuda)
    send = from_reference(dense_send_lanes(s.pattern, 0), cuda)
    assert fused_plan(send, tabs)["fence"] == "hand"
    got = fused_rep(send, tabs, out=_poisoned(tabs, send))
    check_fence(tabs)
    assert torch.equal(got, fused_rep_plain(send, tabs))


def test_fused_kernel_two_writer_plan_keeps_the_later_row(cuda):
    rounds = ((0, ((0, 0, 1, 0),)), (1, ((1, 0, 0, 1),)),
              (2, ((0, 1, 1, 0), (1, 1, 0, 0))))
    plan = FusePlan(nprocs=2, data_size=2048, n_send_slots=2, n_recv_slots=2,
                    rounds=rounds, barriers=())
    tabs = plan_tables(plan, cuda)
    send = torch.randint(-2**31, 2**31 - 1, (2, 2, 512), dtype=torch.int32,
                         device=cuda)
    assert fused_plan(send, tabs)["fence"] == "cluster"
    got = fused_rep(send, tabs, out=_poisoned(tabs, send))
    check_fence(tabs)
    want = fused_rep_plain(send, tabs)
    assert torch.equal(got, want) and torch.equal(got[1, 0], send[0, 1])


BOUND_SHAPES = {"readme": (32, 14, 3), "n256": (256, 16, 16)}


def _bound_rep(n, a, c, d, device):
    s = compile_method(1, AggregatorPattern(n, a, data_size=d, comm_size=c))
    rep = CudaFusedBackend(device=device).one_rep(s)
    send = from_reference(dense_send_lanes(s.pattern, 0), device)
    assert rep.tables.bound.takes(send)
    return rep, send


def _counts():
    return fused_rep.launches, fused_rep.full_checks


@pytest.mark.parametrize("d,lane", [(2048, 16), (256, 16), (36, 4), (6, 1)])
@pytest.mark.parametrize("shape,fence", [("readme", "cluster"),
                                         ("n256", "hand")])
def test_bound_rep_equals_plain_in_a_poisoned_arena(cuda, shape, fence, d,
                                                    lane):
    """The bound launch (no full check) into an arena the caching
    allocator hands back filled with 0xA5, at each lane width, under the
    cluster fence (README) and the hand-rolled one (n=256 a=16 c=16)."""
    rep, send = _bound_rep(*BOUND_SHAPES[shape], d, cuda)
    tabs = rep.tables
    launch = fused_plan(send, tabs)
    assert (launch["fence"], launch["lane_bytes"]) == (fence, lane)
    want = fused_rep_plain(send, tabs)
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        poison = _poisoned(tabs, send)
        ptr = poison.data_ptr()
        del poison
        before = _counts()
        got = rep(send)
        torch.cuda.synchronize()
        assert got.data_ptr() == ptr          # the poisoned block, reused
        assert _counts() == (before[0] + 1, before[1])
        check_fence(tabs)
        assert torch.equal(got, want)


def test_out_stamps_and_other_lanes_take_the_full_check(cuda):
    """``out=``, ``stamps=`` and a send outside the bound key (byte lanes
    of an int32 plan) launch as before, each after the full check."""
    rep, send = _bound_rep(*BOUND_SHAPES["readme"], 2048, cuda)
    tabs = rep.tables
    want = fused_rep_plain(send, tabs)
    launch = fused_plan(send, tabs)
    stamps = torch.zeros((launch["grid"], 2 + 2 * max(tabs.n_rounds, 1)),
                         dtype=torch.int64, device=cuda)
    before = _counts()
    out = _poisoned(tabs, send)
    assert fused_rep(send, tabs, out=out) is out
    stamped = fused_rep(send, tabs, stamps=stamps)
    as_bytes = send.view(torch.uint8)
    assert not tabs.bound.takes(as_bytes)
    got_bytes = fused_rep(as_bytes, tabs)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 3, before[1] + 3)
    check_fence(tabs)
    assert torch.equal(out, want) and torch.equal(stamped, want)
    assert torch.equal(got_bytes, fused_rep_plain(as_bytes, tabs))
    assert (stamps[:, 0] > 0).all() and (stamps[:, -1] >= stamps[:, 0]).all()
    with pytest.raises(ValueError, match="out must be"):
        fused_rep(send, tabs, out=torch.empty(3, dtype=send.dtype,
                                              device=cuda))
    with pytest.raises(ValueError, match="send on cpu"):
        fused_rep(send.cpu(), tabs)
    assert _counts() == (before[0] + 3, before[1] + 3)


def test_bound_rep_launches_on_the_current_side_stream(cuda):
    """Under ``torch.cuda.stream(side)`` the bound launch is ordered after
    what ``side`` holds: a copy into the send arena queued behind a long
    sleep there, which a launch on another stream would overtake."""
    rep, fresh = _bound_rep(*BOUND_SHAPES["readme"], 2048, cuda)
    send = torch.zeros_like(fresh)
    want = fused_rep_plain(fresh, rep.tables)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = _counts()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)        # about 0.1 s at 1.98 GHz
        send.copy_(fresh)
        got = rep(send)
    assert not side.query()                   # the launch waits its turn
    side.synchronize()
    assert _counts() == (before[0] + 1, before[1])
    check_fence(rep.tables)
    assert torch.equal(got, want)


def test_closed_loop_takes_no_full_check(cuda):
    """The benchmark's loop: a rep, then a synchronize, 100 times; every
    rep takes the bound launch."""
    rep, send = _bound_rep(*BOUND_SHAPES["readme"], 2048, cuda)
    before = _counts()
    for _ in range(100):
        got = rep(send)
        torch.cuda.synchronize()
    assert _counts() == (before[0] + 100, before[1])
    check_fence(rep.tables)
    assert torch.equal(got, fused_rep_plain(send, rep.tables))


@pytest.mark.parametrize("backend", [TorchSimBackend, CudaFusedBackend])
def test_backends_verify_on_the_card(cuda, backend):
    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    recv, timers = backend(device="cuda").run(s, verify=True)
    assert sum(r is not None for r in recv) == 14
    assert timers[0].total_time > 0


@pytest.mark.parametrize("d", [2048, 36, 30])
@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
@pytest.mark.parametrize("method", FUSABLE)
def test_dma_kernel_matches_plain(cuda, method, concurrent, d):
    """K3 on the whole recv arena, trash row included: 16-byte vectors
    (d=2048), 4-byte words (d=36) and bytes (d=30)."""
    s = compile_method(method, AggregatorPattern(32, 14, data_size=d,
                                                 comm_size=3))
    tabs = dma_tables(s, concurrent, cuda)
    send = send_arena(s.pattern, 1, cuda)
    before = dma_steps.launches
    got = dma_steps(send, tabs)
    torch.cuda.synchronize()
    assert dma_steps.launches == before + 1
    assert torch.equal(got, dma_steps_plain(send, tabs))
    assert not got[:, -1].any()


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
def test_dma_backends_verify_on_the_card(cuda, concurrent):
    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    before = dma_steps.launches
    recv, timers = CudaDmaBackend(device="cuda",
                                  concurrent=concurrent).run(s, verify=True,
                                                             ntimes=3)
    assert dma_steps.launches == before + 4       # warm-up + 3 reps
    assert sum(r is not None for r in recv) == 14
    assert timers[0].total_time > 0


def test_dma_capacity_holds_1024_ranks(cuda):
    assert capacity() >= 1024


def test_dma_runs_ten_rank_ctas_per_sm(cuda):
    """The kernel's launch bounds keep ten rank CTAs co-resident per SM
    (1320 on an H100's 132 SMs), and a program of exactly the cap's ranks
    runs and equals plain."""
    cap = capacity()
    assert cap >= 10 * torch.cuda.get_device_properties(
        cuda).multi_processor_count
    s = compile_method(1, AggregatorPattern(cap, 4, data_size=64,
                                            comm_size=4))
    tabs = dma_tables(s, True, cuda)
    send = send_arena(s.pattern, 1, cuda)
    assert torch.equal(dma_steps(send, tabs), dma_steps_plain(send, tabs))


def _theta_cell_dma():
    """The benchmark cell ``theta_n1280_a2m_c64_dma``'s schedule: 20 whole
    64-rank nodes of the Theta job, m=1 at ``-c 64``."""
    return compile_method(1, AggregatorPattern(
        1280, 20, data_size=2048, comm_size=64, proc_node=64, placement=1))


@pytest.mark.parametrize("it", [0, 3])
def test_dma_bound_rep_at_the_theta_cell_equals_the_checked_launch(cuda, it):
    """At the cell's shape (1280 rank CTAs, 40 under the H100's cap) the
    bound rep equals the checked launch and plain byte for byte; the
    bound launch counts one launch of 2,571 waves and no checked one."""
    s = _theta_cell_dma()
    rep = CudaDmaBackend(device="cuda").one_rep(s)
    tabs = rep.tables
    assert tabs.n_waves == tabs.n_steps == 2571
    send = send_arena(s.pattern, it, cuda)
    before = (dma_steps.launches, dma_steps.waves, dma_steps.full_checks)
    got = rep(send)
    check_protocol(tabs)
    assert (dma_steps.launches - before[0], dma_steps.waves - before[1],
            dma_steps.full_checks - before[2]) == (1, 2571, 0)
    checked = dma_steps(send, tabs, out=_poisoned(tabs, send))
    assert torch.equal(got, checked)
    del checked
    assert torch.equal(got, dma_steps_plain(send, tabs))


def _readme_dma(cuda, concurrent, d=2048):
    s = compile_method(1, AggregatorPattern(32, 14, data_size=d,
                                            comm_size=3))
    tabs = dma_tables(s, concurrent, cuda)
    send = send_arena(s.pattern, 1, cuda)
    return tabs, send, dma_steps_plain(send, tabs)


@pytest.mark.parametrize("d", [2048, 36, 30])
@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
@pytest.mark.parametrize("method", FUSABLE)
def test_dma_kernel_zeroes_a_poisoned_recv(cuda, method, concurrent, d):
    """Into a recv pre-filled with 0xA5, K3 equals plain on every byte,
    trash row included: the zeroing inside the launch covers every row no
    real step writes."""
    s = compile_method(method, AggregatorPattern(32, 14, data_size=d,
                                                 comm_size=3))
    tabs = dma_tables(s, concurrent, cuda)
    send = send_arena(s.pattern, 1, cuda)
    got = dma_steps(send, tabs, out=_poisoned(tabs, send))
    assert torch.equal(got, dma_steps_plain(send, tabs))


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
def test_dma_back_to_back_launches_never_reset_the_counters(cuda,
                                                            concurrent):
    """Three launches on one DmaTables, nothing zeroed between them: each
    equals plain, and every rank's base word has advanced by three
    programs' steps to equal its counter."""
    tabs, send, plain = _readme_dma(cuda, concurrent)
    before = dma_steps.launches
    outs = [dma_steps(send, tabs, out=_poisoned(tabs, send), check=False)
            for _ in range(3)]
    check_protocol(tabs)
    assert dma_steps.launches == before + 3
    for got in outs:
        assert torch.equal(got, plain)
    stride = tabs.arrival.numel() // tabs.nprocs
    assert (tabs.base == 3 * tabs.n_steps).all()
    assert torch.equal(tabs.arrival[::stride], tabs.base)


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
def test_dma_graph_replay_reads_the_base_on_the_device(cuda, concurrent):
    """A CUDA graph of two launches, replayed three times into a poisoned
    recv, equals plain each time: the graph froze the launch arguments,
    so the waits must count from base words read on the device."""
    tabs, send, plain = _readme_dma(cuda, concurrent)
    out = _poisoned(tabs, send)
    dma_steps(send, tabs, out=out)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(2):
            dma_steps(send, tabs, out=out, check=False)
    for _ in range(3):
        out.fill_(0xA5)
        graph.replay()
        torch.cuda.synchronize()
        check_protocol(tabs)
        assert torch.equal(out, plain)
    assert (tabs.base == 7 * tabs.n_steps).all()


def test_dma_long_lockstep_program_outlasts_a_short_timeout(cuda,
                                                            monkeypatch):
    """The timeout bounds each wait, not the program: the n=1024 lockstep
    program (8202 waves) runs longer than a 5 ms timeout and completes."""
    monkeypatch.setattr(cuda_dma, "TIMEOUT_S", 0.005)
    s = compile_method(1, AggregatorPattern(1024, 64, data_size=2048,
                                            comm_size=16))
    tabs = dma_tables(s, False, cuda)
    send = send_arena(s.pattern, 0, cuda)
    dma_steps(send, tabs)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    got = dma_steps(send, tabs, check=False)
    stop.record()
    stop.synchronize()
    check_protocol(tabs)
    assert start.elapsed_time(stop) > 5.0
    assert torch.equal(got, dma_steps_plain(send, tabs))


def test_dma_malformed_program_raises_quickly_and_stays_refused(
        cuda, monkeypatch):
    """Two ranks push to one rank at the last step, so another rank never
    gets its last arrival: its wait times out, DmaProtocolError names it,
    and a later launch on those tables is refused too."""
    monkeypatch.setattr(cuda_dma, "TIMEOUT_S", 0.05)
    tabs, send, _plain = _readme_dma(cuda, False)
    dst = tabs.dst.clone()
    starved = int(dst[0, -1])
    dst[0, -1] = dst[1, -1]
    bad = dataclasses.replace(tabs, dst=dst)
    t0 = time.perf_counter()
    with pytest.raises(DmaProtocolError,
                       match=f"rank {starved} .* up to step "
                             f"{tabs.n_steps - 1} "):
        dma_steps(send, bad)
    assert time.perf_counter() - t0 < 5.0
    with pytest.raises(DmaProtocolError, match=f"rank {starved} "):
        dma_steps(send, bad)


@pytest.mark.parametrize("concurrent", [False, True],
                         ids=["lockstep", "concurrent"])
def test_dma_stamps_order_every_wave(cuda, concurrent):
    """Rank 0's stamps: start <= zeroing done <= each wave's post start <=
    its signals <= its wait end <= the next wave's post start <= exit."""
    tabs, send, plain = _readme_dma(cuda, concurrent)
    stamps = torch.zeros((tabs.n_waves + 1, 3), dtype=torch.int64,
                         device=cuda)
    assert torch.equal(dma_steps(send, tabs, stamps=stamps), plain)
    st = stamps.cpu()
    assert (st > 0).all()
    waves = st[1:].flatten()
    assert st[0, 0] <= st[0, 1] <= waves[0]
    assert (waves[1:] >= waves[:-1]).all()
    assert waves[-1] <= st[0, 2]



# --------------------------------------------------------------------------
# the chain as CUDA graph replays; truncated programs and TAM on the card

def _readme(method=1, **kw):
    return compile_method(method, AggregatorPattern(
        32, 14, data_size=2048, comm_size=3, **kw))


@pytest.mark.parametrize("iters", [5, 50, 53, 1050])
@pytest.mark.parametrize("backend", [TorchSimBackend, CudaFusedBackend])
def test_graph_chain_equals_the_eager_chain(cuda, backend, iters):
    """Blocks of 50 reps replayed (and a 3- or 5-rep remainder graph):
    the end state is byte-equal to the eager chain's, a second chain of
    the same family starts over from send0, and K2's counter counts every
    replayed rep (the warm-up rep is one real launch)."""
    s = _readme()
    b = backend(device="cuda")
    rep, p = b.one_rep(s), s.pattern
    _, n_recv = slot_shapes(p)
    send0 = b._global_send(p, 0)
    want = chained.eager_chain(rep, n_recv)(iters)(send0)
    make_chain = b._chain_factory(rep, p)
    for first in (True, False):
        before, checks = fused_rep.launches, fused_rep.full_checks
        got = make_chain(iters)(send0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if backend is CudaFusedBackend:
            assert fused_rep.launches - before == iters + first
            assert fused_rep.full_checks == checks   # the bound launch
            check_fence(rep.tables)
    assert not torch.equal(got, send0)


def test_eager_chain_on_the_card_equals_the_cpu_chain(cuda):
    """The eager chain on the card and on the CPU (held against the
    reference in tests/test_torch_sim.py) end in the same bytes."""
    s = _readme(1)
    got = TorchSimBackend("cuda")
    cpu = TorchSimBackend("cpu")
    _, n_recv = slot_shapes(s.pattern)
    want = chained.eager_chain(cpu.one_rep(s), n_recv)(7)(
        cpu._global_send(s.pattern, 0))
    out = chained.eager_chain(got.one_rep(s), n_recv)(7)(
        got._global_send(s.pattern, 0))
    np.testing.assert_array_equal(to_reference(out), to_reference(want))


@pytest.mark.parametrize("method", [1, 2, 17])
def test_truncated_reps_on_the_card_equal_the_cpu(cuda, method):
    s = _readme(method)
    g, c = TorchSimBackend("cuda"), TorchSimBackend("cpu")
    sg, sc = g._global_send(s.pattern, 0), c._global_send(s.pattern, 0)
    R = len(c._round_segments(s)[0])
    builds = ([lambda b, k=k: b._one_rep(s, upto=k) for k in range(1, R)]
              + [lambda b, k=k: b._one_rep_hybrid(s, k)
                 for k in range(1, R + 1)]
              + [lambda b: b._one_rep_scatters(s)])
    for build in builds:
        np.testing.assert_array_equal(to_reference(build(g)(sg)),
                                      to_reference(build(c)(sc)))


@pytest.mark.parametrize("upto_hop", [None, 1, 2])
@pytest.mark.parametrize("method,proc_node", [(15, 1), (15, 4), (16, 4)])
def test_tam_rep_on_the_card_equals_the_cpu(cuda, method, proc_node,
                                            upto_hop):
    s = _readme(method, proc_node=proc_node)
    g, c = TorchSimBackend("cuda"), TorchSimBackend("cpu")
    got = g._tam_rep(s, upto_hop=upto_hop)(g._global_send(s.pattern, 1))
    want = c._tam_rep(s, upto_hop=upto_hop)(c._global_send(s.pattern, 1))
    np.testing.assert_array_equal(to_reference(got), to_reference(want))
    if upto_hop is None:
        g.run(s, verify=True)


@pytest.mark.parametrize("method", [1, 15])
def test_measured_phases_sum_to_the_chained_total_on_the_card(cuda,
                                                              method):
    s = _readme(method, proc_node=4)
    b = TorchSimBackend("cuda")
    kw = dict(iters_small=50, iters_big=250, trials=1, windows=1)
    if method == 15:
        parts = b.measure_tam_hops(s, **kw)
        total = parts.pop("total")
        values = list(parts.values())
    else:
        splits = b.measure_round_splits(s, **kw)
        values = [x for pair in splits.values() for x in pair]
        total = b.measure_per_rep(s, **kw)
    assert min(values) >= 0
    assert sum(values) == pytest.approx(total)


def test_chain_capture_failure_is_named(cuda):
    """A rep that reads back to the host cannot be captured: the chain
    raises ChainCaptureError, never falls back to the eager chain."""
    def rep(send):
        int(send.sum().item())
        return send.new_zeros((2, 2, send.shape[2]))

    send0 = torch.zeros((2, 2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(chained.ChainCaptureError, match="CUDA graph"):
        chained.graph_chain(rep, 1)(5)(send0)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The slow-rank delay kernel (csrc/slow_delay.cu) and the faulted rep.

def _faulted_readme(spec, method=1, comm_size=3):
    from tpu_aggcomm_torch.faults import parse_fault, repair_schedule
    return repair_schedule(compile_method(method, AggregatorPattern(
        32, 14, data_size=2048, comm_size=comm_size)), parse_fault(spec))


@pytest.mark.parametrize("lanes", ["int32", "bytes"])
@pytest.mark.parametrize("n", [32, 1024])
def test_slow_delay_kernel_matches_plain(cuda, n, lanes):
    """One launch for every slow rank: acc and the whole recv equal the
    plain version's, on lanes with the sign bit set and near INT32_MAX
    (row + i wraps), iteration counts of the README's slow:r2*8 and of
    n=1024's."""
    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    rng = np.random.default_rng(n)
    w = 512 if lanes == "int32" else 30
    if lanes == "int32":
        send = rng.integers(-2**31, 2**31, size=(n, 3, w), dtype=np.int64)
        send[1, 0, :4] = [2**31 - 1, 2**31 - 2, -2**31, -1]
        send = torch.from_numpy(send.astype(np.int32))
        recv = torch.from_numpy(rng.integers(-2**31, 2**31, size=(
            n, 5, w), dtype=np.int64).astype(np.int32))
    else:
        send = torch.from_numpy(rng.integers(0, 256, size=(n, 3, w),
                                             dtype=np.uint8))
        recv = torch.from_numpy(rng.integers(0, 256, size=(n, 5, w),
                                             dtype=np.uint8))
    iters = np.zeros(n, dtype=np.int64)
    iters[[1, 2, n - 1]] = [2464, 352, 14336]
    want_recv = recv.clone()
    want = slow_delay_plain(send, want_recv, slow_tables(iters, "cpu"))
    tabs = slow_tables(iters, cuda)
    got_recv = recv.to(cuda)
    before = slow_delay.launches
    got = slow_delay(send.to(cuda), got_recv, tabs)
    torch.cuda.synchronize()
    assert slow_delay.launches == before + 1
    assert got.cpu().tolist() == want.tolist()
    assert torch.equal(got_recv.cpu(), want_recv)
    plain = slow_delay_plain(send.to(cuda), recv.to(cuda), tabs)
    assert plain.cpu().tolist() == want.tolist()


@pytest.mark.parametrize("iters", [5, 50, 53])
def test_faulted_graph_chain_equals_the_eager_chain(cuda, iters):
    """A repaired dead link (staging row, relay hops) and a slow rank in
    one schedule: the graph chain ends in the eager chain's bytes and
    counts one delay launch a rep (and one for the warm-up rep)."""
    from tpu_aggcomm_torch.backends.slow_delay import slow_delay
    s = _faulted_readme("slow:r2*4,deadlink:5>3")
    b = TorchSimBackend(device="cuda")
    rep, p = b.one_rep(s), s.pattern
    _, n_recv = slot_shapes(p)
    send0 = b._global_send(p, 0)
    want = chained.eager_chain(rep, n_recv)(iters)(send0)
    make_chain = b._chain_factory(rep, p)
    for first in (True, False):
        before = slow_delay.launches
        got = make_chain(iters)(send0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert slow_delay.launches - before == iters + first
    cpu = TorchSimBackend("cpu")
    ref = chained.eager_chain(cpu.one_rep(s), n_recv)(iters)(
        cpu._global_send(p, 0))
    np.testing.assert_array_equal(to_reference(got), to_reference(ref))


def test_faulted_rep_on_the_card_equals_the_cpu_both_lowerings(cuda):
    """-c 3 (unrolled) and -c 1 (padded): the faulted rep on the card is
    byte-equal to the CPU's, which tests/test_torch_faults.py holds
    against the reference; and it verifies."""
    for c in (3, 1):
        s = _faulted_readme("slow:r2*2,deadlink:5>3", comm_size=c)
        send = dense_send_lanes(s.pattern, 0)
        want = TorchSimBackend("cpu").one_rep(s)(from_reference(send, "cpu"))
        got = TorchSimBackend("cuda").one_rep(s)(from_reference(send, cuda))
        assert torch.equal(got.cpu(), want)
        TorchSimBackend("cuda").run(s, verify=True)


def test_delay_time_rises_with_the_factor(cuda):
    """Chained per-rep time at the README shape rises strictly over slow
    factors 1 (healthy), 2, 4 and 8: the delay runs in every rep."""
    b = TorchSimBackend("cuda")
    kw = dict(iters_small=20, iters_big=220, trials=3, windows=2)
    times = [b.measure_per_rep(_readme(), **kw)]
    for f in (2, 4, 8):
        times.append(b.measure_per_rep(_faulted_readme(f"slow:r2*{f}"),
                                       **kw))
    assert all(a < b_ for a, b_ in zip(times, times[1:])), times


# ---------------------------------------------------------------------------
# the tam driver's proxy route and the profiler cross-check on the card

@pytest.mark.parametrize("iters", [5, 50, 53])
@pytest.mark.parametrize("stripe,n", [(0, 256), (3, 64)])
def test_sim_graph_chain_equals_the_eager_chain(cuda, stripe, n, iters):
    """The proxy route's chain (three gathers, then y ^ (r % 251)) as CUDA
    graph replays ends in the eager chain's bytes on the card and on the
    CPU; every graph capture is a ledger record of its block length."""
    from tpu_aggcomm_torch.core.topology import static_node_assignment
    from tpu_aggcomm_torch.core.workload import initialize_setting
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.tam.workload_engines import proxy_route_program

    na = static_node_assignment(n, 64 if n >= 64 else n, 0)
    wl = initialize_setting(na, 16, stripe)
    x0, _, step = proxy_route_program(wl, na, cuda)
    c0, _, cstep = proxy_route_program(wl, na, "cpu")
    before = len(ledger.compile_records())
    got = chained.graph_chain(None, step=step)(iters)(x0)
    want = chained.eager_chain(None, step=step)(iters)(x0)
    cpu = chained.eager_chain(None, step=cstep)(iters)(c0)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cpu)
    caps = [r for r in ledger.compile_records()[before:]
            if r["kind"] == "graph-capture"]
    full, rest = divmod(iters, chained.GRAPH_BLOCK)
    assert sorted(r["reps"] for r in caps) == sorted(
        ([chained.GRAPH_BLOCK] if full else []) + ([rest] if rest else []))


def test_sim_route_verifies_on_the_card(cuda):
    """The route's flat delivery on the card equals the CPU's byte for
    byte and passes the vectorised check; a flipped byte is named as
    verify_all names it."""
    from tpu_aggcomm_torch.core.topology import static_node_assignment
    from tpu_aggcomm_torch.core.workload import initialize_setting
    from tpu_aggcomm_torch.harness.verify import VerificationError
    from tpu_aggcomm_torch.tam.workload_engines import (proxy_route,
                                                        recv_from_flat,
                                                        verify_recv_flat)

    na = static_node_assignment(256, 64, 0)
    wl = initialize_setting(na, 16, 1)
    flat, times = proxy_route(wl, na, ntimes=2, device=cuda)
    ref, _ = proxy_route(wl, na, device="cpu")
    assert len(times) == 2 and all(t > 0 for t in times)
    assert torch.equal(flat.cpu(), ref)
    verify_recv_flat(wl, flat)
    flat[1000] ^= 0xFF
    with pytest.raises(VerificationError) as got:
        verify_recv_flat(wl, flat)
    with pytest.raises(VerificationError) as want:
        wl.verify_all(recv_from_flat(wl, flat.cpu().numpy()))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("backend", ["torch_sim", "cuda_fused"])
def test_xprof_reads_the_device_span(cuda, backend, tmp_path, capsys):
    """--xprof on the card reports the span of the profiled rep's device
    events from torch.profiler's trace, never the host wall."""
    from tpu_aggcomm_torch import cli
    from tpu_aggcomm_torch.obs import ledger

    assert cli.main(["-n", "32", "-m", "1", "-a", "14", "-d", "2048", "-c",
                     "3", "--backend", backend, "--verify", "--xprof",
                     str(tmp_path / "xp"), "--results-csv",
                     str(tmp_path / "r.csv")]) == 0
    rep = ledger.xprof_reports()[-1]
    assert rep["source"] == "cupti-device-span", rep
    assert rep["device_plane"].startswith("cuda:")
    assert torch.cuda.get_device_name(0) in rep["device_plane"]
    assert 0 < rep["device_span_s"] <= rep["profiled_wall_s"]
    assert "[cupti-device-span]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The serve data plane: the delay kernel's request axis, the batched rep,
# and cuda_fused's per-request execution.


def _readme_faulted(spec):
    from tpu_aggcomm_torch.faults import parse_fault, repair_schedule
    return repair_schedule(compile_method(1, AggregatorPattern(
        32, 14, data_size=2048, comm_size=3)), parse_fault(spec))


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_batched_slow_delay_matches_plain_in_one_launch(cuda, batch):
    """The delay kernel over a (B, n, S, w) batch: acc and arena equal to
    the plain version and to B one-request launches, in ONE launch."""
    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    from tpu_aggcomm_torch.backends.torch_sim import (_faulted_tables,
                                                      dense_send_batch)

    s = _readme_faulted("slow:r2*2,slow:r7*3")
    _, n_recv = slot_shapes(s.pattern)
    *_rest, slow = _faulted_tables(s, n_recv)
    tabs = slow_tables(slow, cuda)
    sends = dense_send_batch(s.pattern, list(range(batch)), batch, cuda)
    recv0 = torch.randint(-2**31, 2**31 - 1, (batch, 32, n_recv + 1, 512),
                          dtype=torch.int32, device=cuda)
    want = recv0.clone()
    acc_plain = slow_delay_plain(sends, want, tabs)
    got = recv0.clone()
    before = slow_delay.launches
    acc = slow_delay(sends, got, tabs)
    torch.cuda.synchronize()
    assert slow_delay.launches == before + 1
    assert acc.shape == (batch, len(tabs.ranks))
    assert torch.equal(acc, acc_plain) and torch.equal(got, want)
    for b in range(batch):
        one = recv0[b].clone()
        assert torch.equal(slow_delay(sends[b], one, tabs), acc[b])
        assert torch.equal(one, got[b])


@pytest.mark.parametrize("spec", [None, "slow:r2*2", "deadlink:5>3"])
def test_batched_readme_rep_equals_single_reps(cuda, spec):
    """The batched torch_sim README rep on the card: each request's arena,
    trash row included, equals its own single rep's."""
    from tpu_aggcomm_torch.backends.torch_sim import dense_send_batch
    from tpu_aggcomm_torch.backends.slow_delay import slow_delay

    s = (compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                             comm_size=3))
         if spec is None else _readme_faulted(spec))
    b = TorchSimBackend(cuda)
    iters = list(range(8))
    before = slow_delay.launches
    out = b.batched_rep(s)(dense_send_batch(s.pattern, iters, 8, cuda))
    torch.cuda.synchronize()
    assert slow_delay.launches - before == (1 if spec and "slow" in spec
                                            else 0)
    for k in iters:
        assert torch.equal(out[k], b.one_rep(s)(b._global_send(s.pattern,
                                                               k)))


def test_cuda_fused_execute_batch_is_one_launch_a_request(cuda):
    from tpu_aggcomm_torch.serve import executor
    from tpu_aggcomm_torch.serve.protocol import parse_request

    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    chain, compile_s = executor.build_chain(s, "cuda_fused", device=cuda)
    assert compile_s > 0 and chain.batched is None
    reqs = [parse_request({"method": 1, "nprocs": 32, "cb_nodes": 14,
                           "comm_size": 3, "iter": i, "verify": True})
            for i in range(4)]
    before = fused_rep.launches
    res = executor.execute_batch(chain, reqs)
    assert fused_rep.launches - before == 4
    assert all(r["verified"] is True and r["error"] is None for r in res)


# ---------------------------------------------------------------------------
# the tuner's samplers and the synthesized methods on the card


@pytest.fixture
def synth_registered():
    """Registers the committed m=101-103 and removes them afterwards."""
    import os

    from tpu_aggcomm_torch.core.methods import METHODS
    from tpu_aggcomm_torch.synth import ensure_registered

    before = set(METHODS)
    ensure_registered(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    yield
    for mid in set(METHODS) - before:
        del METHODS[mid]


@pytest.mark.parametrize("backend", ["torch_sim", "cuda_fused"])
def test_samplers_give_fresh_device_samples(cuda, backend):
    """Each batch is new differenced trials of CUDA graph replays; on
    cuda_fused K2's count grows by the reps each batch replays (a warm-up
    of both chains, then the trials), plus the first eager warm-up rep."""
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.tune import measure

    make = measure.make_cuda_fused_sampler if backend == "cuda_fused" \
        else measure.make_torch_sim_sampler
    small, big = 10, 60
    sampler = make(nprocs=32, data_size=2048, proc_node=1, device="cuda",
                   iters_small=small, iters_big=big, batch_trials=2)
    assert ledger.manifest()["device_kind"] == torch.cuda.get_device_name(0)
    cid = "m1:a14:c3:t1"
    caps = len([r for r in ledger.compile_records()
                if r["kind"] == "graph-capture"])
    deltas, batches = [], []
    for batch in range(3):
        before = fused_rep.launches
        batches.append(sampler(cid, batch))
        deltas.append(fused_rep.launches - before)
    assert all(len(b) == 2 and all(x > 0 for x in b) for b in batches)
    assert batches[0] is not batches[1] and batches[1] != batches[2]
    new_caps = [r for r in ledger.compile_records()
                if r["kind"] == "graph-capture"][caps:]
    # one chain family: a graph of 50 reps and one of the 10 left over,
    # captured in the first batch's warm-up, outside the trials
    assert sorted(r["reps"] for r in new_caps) == [small, 50]
    if backend == "torch_sim":
        assert deltas == [0, 0, 0]
    else:
        assert deltas[0] % (small + big) == 1          # the eager warm-up
        assert all(d % (small + big) == 0 and d >= 3 * (small + big)
                   for d in deltas[1:])


@pytest.mark.parametrize("shape", [(32, 14, 3), (256, 16, 16)])
@pytest.mark.parametrize("method", [101, 102, 103])
def test_synthesized_methods_on_k2_equal_plain(cuda, synth_registered,
                                               method, shape):
    """The committed one-round incasts (window=drain), one K2 launch into
    a poisoned recv, byte-equal to the plain version, and verified."""
    n, a, c = shape
    s = compile_method(method, AggregatorPattern(n, a, data_size=2048,
                                                 comm_size=c))
    plan = fuse_plan(s)
    assert len(plan.rounds) == 1 and plan.n_edges == n * a
    tabs = plan_tables(plan, cuda)
    send = from_reference(dense_send_lanes(s.pattern, 0), cuda)
    before = fused_rep.launches
    got = fused_rep(send, tabs, out=_poisoned(tabs, send))
    torch.cuda.synchronize()
    assert fused_rep.launches == before + 1
    check_fence(tabs)
    assert torch.equal(got, fused_rep_plain(send, tabs))
    recv, _ = CudaFusedBackend(device="cuda").run(s, verify=True)
    assert sum(r is not None for r in recv) == a


def test_tiny_cuda_fused_tune_writes_an_artifact_that_replays(cuda,
                                                               tmp_path,
                                                               capsys):
    from tpu_aggcomm_torch import cli
    root = str(tmp_path)
    before = fused_rep.launches
    assert cli.main(["tune", "--backend", "cuda_fused", "-n", "8", "-d",
                     "64", "--methods", "1,3", "--cb-nodes", "2,3",
                     "--comm-sizes", "2", "--iters-small", "10",
                     "--iters-big", "60", "--batch-trials", "2",
                     "--max-batches", "2", "--tune-root", root]) == 0
    assert fused_rep.launches > before
    out = capsys.readouterr().out
    assert "measured, chained cuda_fused" in out
    assert "CUDA graph capture(s)" in out
    path = f"{root}/TUNE_cuda_fused_n8_d64_p1_a2m.json"
    assert cli.main(["tune", "--replay", path]) == 0
    assert "-> REPRODUCED" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the autopilot's promotions on the card


def test_swap_on_cuda_fused_verifies_with_one_k2_launch(cuda, tmp_path):
    """A swap on a cuda_fused server runs its verify request through the
    normal queue as ONE K2 launch (the m=3 chain warmed first, so no
    warm-up launch), and the promoted shape's next request is one more."""
    from tpu_aggcomm_torch.serve import ScheduleServer, ServeClient

    shape = {"method": 1, "nprocs": 32, "cb_nodes": 14, "comm_size": 3,
             "data_size": 2048, "backend": "cuda_fused"}
    srv = ScheduleServer(backend="cuda_fused", port=0, device="cuda",
                         journal_path=str(tmp_path / "s.journal.jsonl"))
    srv.start()
    try:
        with ServeClient(srv.port, timeout=300.0) as c:
            for fields in (shape, dict(shape, method=3)):
                r = c.run(**dict(fields, verify=True))
                assert r["ok"] and r["verified"] is True
        rec = {"shape": {k: v for k, v in shape.items() if k != "backend"},
               "backend": "cuda_fused", "old_method": 1,
               "old_cid": "m1:a14:c3:t0", "new_method": 3,
               "new_cid": "m3:a14:c3:t0", "composition": None,
               "win_ci_pct": [5.0, 10.0], "seed": 0, "alpha": 0.05,
               "n_boot": 200, "fingerprint": srv.stats()["fingerprint"],
               "artifact": None}
        before = fused_rep.launches
        res = srv.swap(rec)
        assert res["installed"] is True and res["verified"] is True
        assert fused_rep.launches == before + 1
        with ServeClient(srv.port, timeout=300.0) as c:
            r = c.run(**dict(shape, verify=True))
        assert r["served_method"] == 3 and r["verified"] is True
        assert fused_rep.launches == before + 2
    finally:
        srv.stop()
        srv.close()


def test_pilot_sampler_factory_gives_fresh_samples_on_the_card(cuda):
    from tpu_aggcomm_torch.pilot.artifact import _default_sampler_factory

    target = {"shape": {"method": 1, "nprocs": 32, "cb_nodes": 14,
                        "comm_size": 3, "data_size": 2048}}
    sampler = _default_sampler_factory(synthetic=None, seed=0,
                                       batch_trials=2, device="cuda")(target)
    before = fused_rep.launches
    a, b = sampler("m1:a14:c3:t0", 0), sampler("m1:a14:c3:t0", 1)
    assert len(a) == len(b) == 2 and all(x > 0 for x in a + b)
    assert a != b
    assert fused_rep.launches == before        # torch_sim, never K2


def test_traced_cuda_fused_overlay_is_below_every_round_wall(cuda, tmp_path,
                                                            capsys):
    """A traced ``cuda_fused`` run (K2) on the card: ``inspect traffic
    --trace`` joins its round walls with the H100 roofline, and every
    round's HBM floor is positive and below its wall. The soft deadline
    it got is the reference's minimum (no floor model for K2)."""
    import json

    from tpu_aggcomm_torch import cli
    from tpu_aggcomm_torch.harness import runner

    seen = []
    real = runner.derive_deadline
    runner.derive_deadline = lambda **kw: seen.append(kw) or real(**kw)
    before = fused_rep.launches
    try:
        assert cli.main(["-n", "32", "-m", "1", "-a", "14", "-d", "2048",
                         "-c", "3", "--backend", "cuda_fused", "--chained",
                         "--verify", "--trace", str(tmp_path / "k2"),
                         "--results-csv", str(tmp_path / "r.csv")]) == 0
    finally:
        runner.derive_deadline = real
    assert fused_rep.launches > before
    assert [kw["floor_s"] for kw in seen] == [None]
    art = str(tmp_path / "traffic.json")
    assert cli.main(["inspect", "traffic", "-n", "32", "-m", "1", "-a",
                     "14", "-d", "2048", "-c", "3", "--trace",
                     str(tmp_path / "k2.trace.jsonl"), "--json", art,
                     "--fused-export"]) == 0
    out = capsys.readouterr().out
    assert "fused export: MATCH (11 rounds, 448 edges" in out
    overlay = json.load(open(art))["overlay"]
    assert overlay["backend"] == "cuda_fused" and len(overlay["rounds"]) == 11
    for r in overlay["rounds"]:
        floor = r["bytes"] / 3350e9
        assert 0 < floor < r["wall_s"]
        assert r["frac_roofline"] == floor / r["wall_s"]


@pytest.mark.parametrize("backend", ["torch_sim", "cuda_fused"])
def test_card_trace_is_explained_with_the_gpu_block(cuda, backend,
                                                    tmp_path, capsys):
    """A README run traced on the card names the card in its manifest, so
    ``inspect explain`` prices it with the ``gpu`` block of the committed
    ``H100_PREDICT_r01.json``: every round predicted and measured, each
    with a verdict, the tolerance the block's."""
    import json
    import os

    from tpu_aggcomm_torch import cli
    from tpu_aggcomm_torch.model import explain_trace, load_artifact
    from tpu_aggcomm_torch.model.predict import trace_platform
    from tpu_aggcomm_torch.obs.trace import load_events

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prefix = str(tmp_path / backend)
    assert cli.main(["-n", "32", "-m", "1", "-a", "14", "-d", "2048",
                     "-c", "3", "--backend", backend, "--chained",
                     "--verify", "--trace", prefix, "--results-csv",
                     str(tmp_path / "r.csv")]) == 0
    path = prefix + ".trace.jsonl"
    man = next(e["manifest"] for e in load_events(path)
               if e.get("ev") == "ledger")
    assert man["device_kind"] == torch.cuda.get_device_name(0)
    assert trace_platform(man) == "gpu"
    capsys.readouterr()
    assert cli.main(["inspect", "explain", path, "--predict-root",
                     repo]) == 0
    out = capsys.readouterr().out
    assert f"# explain {path}  [platform=gpu]" in out
    art = load_artifact(os.path.join(repo, "H100_PREDICT_r01.json"))
    run = explain_trace(path, art["platforms"])["runs"][0]
    assert run["tolerance_rel"] == \
        art["platforms"]["gpu"]["tolerance_rel"]
    assert len(run["rounds"]) == 11
    assert all(r["measured_s"] and r["verdict"] for r in run["rounds"])
    assert json.loads(json.dumps(run))["total"]["rpc_s"] == \
        art["platforms"]["gpu"]["params"]["rpc_s"]


# ---------------------------------------------------------------------------
# The sharded rank-axis tier (torch_shard) on the card: one process, the
# reference's single-device path, with its slow-rank delay on
# csrc/slow_delay.cu.

@pytest.mark.parametrize("method,c", [(1, 3), (1, 1), (8, 3), (13, 2),
                                      (17, 3), (2, 4)])
def test_torch_shard_on_the_card_equals_the_cpu(cuda, method, c):
    """Every flat recv byte (trash row included) and every chained end
    state on the card (CUDA graph replays) equal the CPU's."""
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=c, proc_node=2)
    s = compile_method(method, p, barrier_type=2 if method == 13 else 0)
    gpu, cpu = TorchShardBackend(cuda), TorchShardBackend("cpu")
    assert np.array_equal(gpu.run_flat(s), cpu.run_flat(s))
    recv, _ = gpu.run(s, verify=True)
    got = [to_reference(gpu._compiled(s).make_chain()(k)(
        gpu._send(s.pattern, 0, gpu._compiled(s)))) for k in (5, 53)]
    want = [to_reference(cpu._compiled(s).make_chain()(k)(
        cpu._send(s.pattern, 0, cpu._compiled(s)))) for k in (5, 53)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("method,proc_node", [(15, 4), (16, 8)])
def test_torch_shard_tam_on_the_card_equals_the_cpu(cuda, method, proc_node):
    """The blocked TAM route on one card: its recv rows and 5 chained
    reps equal the CPU's; the run verifies."""
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    from tpu_aggcomm_torch.tam.engine import tam_two_level_sharded
    s = compile_method(method, AggregatorPattern(32, 14, data_size=2048,
                                                 proc_node=proc_node))
    outs = []
    for dev in (cuda, "cpu"):
        _r, _t, st = tam_two_level_sharded(s, [0], cache={},
                                           return_state=True, device=dev)
        outs.append((to_reference(st["last_out"]), to_reference(
            st["make_chain"](5)(st["last_send_dev"]))))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    TorchShardBackend(cuda).run(s, verify=True, chained=True)


def test_torch_shard_slow_rank_launches_the_delay_kernel(cuda):
    """``slow:r2*2`` on the card: one slow_delay.cu launch a rep (and one
    a chained rep inside the graph replays), its accumulator equal to the
    plain version's, the bytes the healthy rep's."""
    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    from tpu_aggcomm_torch.faults import repair_schedule
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    healthy = compile_method(1, p)
    s = repair_schedule(healthy, "slow:r2*2")
    b = TorchShardBackend(cuda)
    before = slow_delay.launches
    b.run(s, verify=True, ntimes=3)
    assert slow_delay.launches - before == 4       # warm-up + 3 reps
    assert np.array_equal(b.run_flat(s), b.run_flat(healthy))
    built = b._compiled(s)
    send = b._send(s.pattern, 0, built)
    tabs = slow_tables(np.array([8 * 11]), cuda)    # a device's loop
    recv = torch.zeros((built.F, send.shape[1]), dtype=send.dtype,
                       device=cuda)
    acc = slow_delay(send[None], recv[None], tabs)
    plain = slow_delay_plain(send[None], recv.clone()[None], tabs)
    assert torch.equal(acc, plain)
    before = slow_delay.launches
    built.make_chain()(7)(send)
    assert slow_delay.launches - before in (7, 8)   # + one warm-up rep


# ---------------------------------------------------------------------------
# the one-rank-per-device tier on the card: a NCCL world of one process
# (one card holds one rank; the group is made here over a file://
# rendezvous and torn down after each test, so no other test sees it)

def _nccl_world_of_one(tmp_path):
    import contextlib

    import torch.distributed as dist

    from tpu_aggcomm_torch.parallel import distributed_init

    @contextlib.contextmanager
    def world():
        assert distributed_init(f"file://{tmp_path}/nccl", 1, 0,
                                device="cuda", timeout_s=120)
        try:
            yield
        finally:
            dist.destroy_process_group()
    return world()


@pytest.mark.parametrize("method", [1, 8, 13, 17])
def test_torch_ici_world_of_one_on_the_card_equals_the_cpu(cuda, tmp_path,
                                                          method):
    """n=1 d=2048 under a NCCL world of one: the recv arena (trash row
    included) and 5 and 53 chained reps (CUDA graph replays with the
    collectives captured) equal the CPU's with no group; m=1's self edge
    runs no collective, m=8's dense exchange one all_to_all_single, the
    barrier methods their all-reduces; run and run --chained verify."""
    from tpu_aggcomm_torch.backends.torch_ici import TorchIciBackend
    from tpu_aggcomm_torch.parallel import COLLECTIVE_CALLS
    s = compile_method(method, AggregatorPattern(1, 1, data_size=2048,
                                                 comm_size=2),
                       barrier_type=1 if method == 13 else 0)
    cpu = TorchIciBackend("cpu")
    want = cpu.run_arena(s)
    prog = cpu._program(s)
    chains = [to_reference(cpu._make_chain(prog)(k)(
        cpu._send(s.pattern, 0, prog))) for k in (5, 53)]
    with _nccl_world_of_one(tmp_path):
        b = TorchIciBackend(cuda)
        COLLECTIVE_CALLS.clear()
        assert np.array_equal(b.run_arena(s), want)
        calls = dict(COLLECTIVE_CALLS)
        gp = b._program(s)
        got = [to_reference(b._make_chain(gp)(k)(
            b._send(s.pattern, 0, gp))) for k in (5, 53)]
        b.run(s, verify=True, ntimes=2)
        b.run(s, verify=True, chained=True)
        assert b.last_provenance == ("torch_ici", "attributed-chained")
    for g, w in zip(got, chains):
        assert np.array_equal(g, w)
    if method == 1:
        assert calls == {}
    elif method == 8:
        assert calls == {"all_to_all_single": 1}
    else:
        assert calls.get("all_reduce", 0) >= 1


@pytest.mark.parametrize("method", [15, 16])
def test_mesh_tam_and_engines_world_of_one_on_the_card(cuda, tmp_path,
                                                       method):
    """TAM m=15/16 at -p 1 through the two-level mesh engine, and the
    cw2/cw3 mesh engines at n=1, on a NCCL world of one: verified, each
    hop a collective."""
    from tpu_aggcomm_torch.backends.torch_ici import TorchIciBackend
    from tpu_aggcomm_torch.core.meta import aggregator_meta_information
    from tpu_aggcomm_torch.core.topology import static_node_assignment
    from tpu_aggcomm_torch.core.workload import initialize_setting
    from tpu_aggcomm_torch.parallel import COLLECTIVE_CALLS
    from tpu_aggcomm_torch.tam import workload_engines as we
    s = compile_method(method, AggregatorPattern(1, 1, data_size=2048,
                                                 proc_node=1))
    na = static_node_assignment(1, 1, 0)
    wl = initialize_setting(na, 16, 3)
    mt = aggregator_meta_information(na, wl.aggregators, 1, 1)
    with _nccl_world_of_one(tmp_path):
        COLLECTIVE_CALLS.clear()
        b = TorchIciBackend(cuda)
        b.run(s, verify=True, ntimes=2)
        assert b.last_provenance == ("torch_ici", "attributed")
        assert COLLECTIVE_CALLS == {"all_to_all_single": 2 * 3}
        for fn in (we.cw2_local_agg_mesh, we.cw3_shared_mesh):
            recv, _ = fn(wl, na, mt, ntimes=2, device=cuda)
            we.verify_own(wl, recv, device=cuda)


def test_cuda_dma_is_refused_under_a_group_on_the_card(cuda, tmp_path):
    """Under a process group cuda_dma* refuses by name (K3 across
    devices is ROADMAP B1); with the group gone it runs again."""
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    with _nccl_world_of_one(tmp_path):
        for conc in (False, True):
            with pytest.raises(NotPortedError, match="queue B1"):
                CudaDmaBackend(cuda, concurrent=conc)
    CudaDmaBackend(cuda).run(compile_method(1, AggregatorPattern(
        8, 3, data_size=64, comm_size=2)), verify=True)


# ---------------------------------------------------------------------------
# The row-delivery kernel (csrc/deliver_rows.cu): torch_shard's round with
# no process group on the card, its receive arena left unfilled and its
# never-written rows zeroed by the rep's first launch. Before each rep the
# caching allocator is handed a block of 0xFF of the arena's size, so a
# row the launch should have zeroed shows.

def _poison(nbytes: int, device) -> None:
    t = torch.empty(nbytes, dtype=torch.uint8, device=device)
    t.fill_(0xFF)
    del t


def _shard_builds(s, cuda):
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    gpu, cpu = TorchShardBackend(cuda), TorchShardBackend("cpu")
    bg, bc = gpu._compiled(s), cpu._compiled(s)
    return bg, bc, gpu._send(s.pattern, 2, bg), cpu._send(s.pattern, 2, bc)


@pytest.mark.parametrize("method,n,a,d,c,bt", [
    (1, 32, 14, 2048, 999_999_999, 0),         # one round
    (1, 32, 14, 256, 3, 0),                     # throttled
    (1, 100, 7, 100, 3, 0),                     # 34 rounds: scan pads,
                                                # 4-byte lanes
    (13, 32, 14, 6, 2, 2),                      # barrier rounds, bytes
    (17, 32, 14, 2048, 3, 1),
    (2, 32, 14, 256, 4, 0),                     # many-to-all
])
def test_deliver_rows_rep_equals_the_cpu_at_every_prefix(cuda, method, n, a,
                                                         d, c, bt):
    """Every prefix of the rounds (and the whole rep): the card's flat
    receive arena, trash row included, equals the CPU's rep (the same
    tables and zero runs through the kernel's plain version); one launch
    for a prefix of more than one round and no barrier token (its rounds
    counted in ``fused_rounds``), else one launch a round, none of ATen's
    index kernels. Rows of 2048 and 256 bytes take 16-byte lanes, of 100
    bytes 4-byte lanes, of 6 bytes 1-byte lanes."""
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    s = compile_method(method, AggregatorPattern(n, a, data_size=d,
                                                 comm_size=c),
                       barrier_type=bt)
    bg, bc, sg, sc = _shard_builds(s, cuda)
    R = len(bg.rounds)
    assert (bg.fused is not None) == (
        R > 1 and not any(nb for (_r, _t, nb) in bg.rounds))
    nbytes = bg.F * sg.shape[1] * sg.element_size()
    for upto in [*range(R + 1), None]:
        _poison(nbytes, cuda)
        before = deliver_rows.launches
        rounds = deliver_rows.fused_rounds
        got = bg.rep(sg, upto)
        torch.cuda.synchronize()
        k = R if upto is None else upto
        one = bg.fused is not None and k > 1
        assert deliver_rows.launches - before == (1 if one else max(k, 1))
        assert deliver_rows.fused_rounds - rounds == (k if one else 0)
        np.testing.assert_array_equal(to_reference(got),
                                      to_reference(bc.rep(sc, upto)))
    if bg.fused is not None:
        assert bg.fused.sync.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("spec", ["deadlink:5>3", "deadlink:9>0",
                                  "slow:r2*2"])
def test_deliver_rows_faulted_rep_equals_the_cpu(cuda, spec):
    """An unrepaired dead link (its dropped rows must read zero) and a
    slow rank (the delay after the rounds): the card's arena equals the
    CPU's."""
    from tpu_aggcomm_torch.faults import repair_schedule
    healthy = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                                  comm_size=3))
    s = (dataclasses.replace(healthy, fault=spec)
         if spec.startswith("dead") else repair_schedule(healthy, spec))
    bg, bc, sg, sc = _shard_builds(s, cuda)
    _poison(bg.F * sg.shape[1] * 4, cuda)
    got, want = to_reference(bg.rep(sg)), to_reference(bc.rep(sc))
    np.testing.assert_array_equal(got, want)
    if spec.startswith("dead"):
        healthy_rep = to_reference(_shard_builds(healthy, cuda)[0].rep(sg))
        assert not np.array_equal(got, healthy_rep)


@pytest.mark.parametrize("iters", [5, 53])
def test_deliver_rows_graph_chain_equals_the_eager_chain(cuda, iters):
    """torch_shard's chain as CUDA graph replays equals the same chain run
    eagerly on the card; the README's 11 barrier-free rounds are one
    launch a rep, so the counters count one launch and 11 rounds of every
    replayed rep (and of the warm-up rep); the fence's counter is back at
    0 after every replay, with no memset in the graph."""
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    from tpu_aggcomm_torch.parallel import group_sum
    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    bg, _bc, sg, _sc = _shard_builds(s, cuda)
    F, R = bg.F, len(bg.rounds)
    assert R == 11 and bg.fused is not None

    def step(carry, r):
        recv = bg.rep(carry)
        chained.xor_token_(carry, chained.token_from_sum(
            group_sum(recv[:F - 1, 0], None), r))

    want = chained.eager_chain(None, step=step)(iters)(sg)
    make_chain = bg.make_chain()
    for first in (True, False):
        before = deliver_rows.launches
        rounds = deliver_rows.fused_rounds
        got = make_chain(iters)(sg)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert deliver_rows.launches - before == iters + first
        assert deliver_rows.fused_rounds - rounds == (iters + first) * R
        assert bg.fused.sync.tolist() == [0, 0, 0, 0]
    assert not torch.equal(got, sg)


def test_deliver_rows_arena_past_four_gigabytes(cuda):
    """n=4096 a=256 d=4096: 4.29 GB arenas, byte offsets past 2^32. The
    kernel's arena equals ATen's gather and index_put_ of the host block
    tables into a zeroed arena on the card, trash row included."""
    s = compile_method(1, AggregatorPattern(4096, 256, data_size=4096,
                                            comm_size=999_999_999))
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    b = TorchShardBackend(cuda)
    built = b._compiled(s)
    send = b._send(s.pattern, 1, built)
    assert built.F * send.shape[1] * 4 > 2 ** 32
    (_r, pk, sc, _nbar), = b._mesh_layout(s)[1]
    _poison(built.F * send.shape[1] * 4, cuda)
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    wide = deliver_rows.wide_launches
    got = built.rep(send)
    assert deliver_rows.wide_launches - wide == 1     # 1,048,576 rows of 4 KB
    want = torch.zeros_like(got)
    want[torch.as_tensor(sc.reshape(-1), device=cuda).long()] = send[
        torch.as_tensor(np.maximum(pk, 0).reshape(-1), device=cuda).long()]
    assert torch.equal(got, want)


# The one-round launch's wide-row engine (csrc/deliver_rows.cu: the
# one-round kernel on a grid of a warp for every chunk): launches of rows
# of at least 2 KB in 16-byte lanes, by the rule both the C entry and the
# wrapper read (deliver_rows.wide_engine). Each case is held byte for byte
# against deliver_rows_plain on the card, every receive arena filled with
# 0xAB first, so a row the launch should have left or zeroed shows.

def _wide_round(rows: int, row_bytes: int, cuda, seed: int, spare: int = 3):
    """A random send arena of ``rows + 7`` rows and a round copying
    ``rows`` of them, in random order, into a receive arena of ``rows +
    spare`` rows; the arena's unwritten rows (the trash row and ``spare -
    1`` others) as zero runs."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    rng = np.random.default_rng(seed)
    Fs, F = rows + 7, rows + spare
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    send = torch.randint(0, 256, (Fs, row_bytes), dtype=torch.uint8,
                         device=cuda, generator=gen)
    src = rng.permutation(Fs)[:rows]
    dst = rng.permutation(F - 1)[:rows]
    tabs = dr.row_tables(src, dst, F=F, Fs=Fs, device=cuda)
    zero = dr.zero_runs(dr.unwritten_runs(F, [(dst, 0)]), cuda)
    return send, tabs, zero, F


def _filled(rows: int, row_bytes: int, cuda) -> torch.Tensor:
    return torch.full((rows, row_bytes), 0xAB, dtype=torch.uint8,
                      device=cuda)


@pytest.mark.parametrize("zeroed", [True, False])
@pytest.mark.parametrize("rows", [4_096, 8_448, 700_001])
@pytest.mark.parametrize("row_bytes", [2048, 2064, 4096])
def test_wide_engine_equals_plain(cuda, row_bytes, rows, zeroed):
    """Rows of 2048, 2064 (a chunk and one lane) and 4096 bytes; 4,096
    and 8,448 rows (about what the warps an H100 keeps resident copy at
    once, where the two grids are alike or nearly) and 700,001, with and
    without zero runs: the rule's launch, and each grid named, equal the
    plain version; the counter follows the rule."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    send, tabs, zero, F = _wide_round(rows, row_bytes, cuda,
                                      rows + row_bytes)
    z = zero if zeroed else None
    want = dr.deliver_rows_plain(send, _filled(F, row_bytes, cuda), tabs, z)
    recv = _filled(F, row_bytes, cuda)
    assert dr.wide_engine(dr.lane_bytes(send.data_ptr(), recv.data_ptr(),
                                        row_bytes), row_bytes)
    launches, wide = dr.deliver_rows.launches, dr.deliver_rows.wide_launches
    dr.deliver_rows(send, recv, tabs, z)
    torch.cuda.synchronize()
    assert torch.equal(recv, want)
    assert dr.deliver_rows.launches - launches == 1
    assert dr.deliver_rows.wide_launches - wide == 1
    for grid in ("wide", "persistent"):
        recv.fill_(0xAB)
        dr._deliver_rows_on(grid, send, recv, tabs, z)
        torch.cuda.synchronize()
        assert torch.equal(recv, want), grid
    assert dr.deliver_rows.launches - launches == 3
    assert dr.deliver_rows.wide_launches - wide == 2


def test_wide_engine_arena_past_four_gigabytes(cuda):
    """2,200,000 rows of 2048 bytes (4.5 GB arenas, byte offsets past
    2^32), zero runs included: equal to the plain version."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    rows, d = 2_200_000, 2048
    send, tabs, zero, F = _wide_round(rows, d, cuda, 4)
    assert F * d > 2 ** 32
    recv = _filled(F, d, cuda)
    wide = dr.deliver_rows.wide_launches
    dr.deliver_rows(send, recv, tabs, zero)
    assert dr.deliver_rows.wide_launches - wide == 1
    want = dr.deliver_rows_plain(send, _filled(F, d, cuda), tabs, zero)
    assert torch.equal(recv, want)


def test_wide_engine_three_dependent_launches_back_to_back(cuda):
    """Three programmatic dependent launches with no synchronize between
    them, each reading what the one before wrote (wide, persistent, wide):
    the last arena equals the plain version's three rounds."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    rows, d = 300_000, 2048
    rng = np.random.default_rng(3)
    arenas = [torch.randint(0, 256, (rows, d), dtype=torch.uint8,
                            device=cuda)]
    arenas += [_filled(rows, d, cuda) for _ in range(3)]
    hops = [dr.row_tables(np.arange(rows), rng.permutation(rows), F=rows,
                          Fs=rows, device=cuda) for _ in range(3)]
    for k, grid in enumerate(("wide", "persistent", "wide")):
        dr._deliver_rows_on(grid, arenas[k], arenas[k + 1], hops[k])
    torch.cuda.synchronize()
    want = arenas[0]
    for t in hops:
        want = dr.deliver_rows_plain(want, _filled(rows, d, cuda), t)
    assert torch.equal(arenas[3], want)


def test_wide_engine_in_a_cuda_graph_replays(cuda):
    """The rule's launch captured in a CUDA graph (after an eager
    warm-up): each replay into a refilled arena equals the plain version;
    the capture counts one wide launch, the replays none."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    send, tabs, zero, F = _wide_round(200_000, 2048, cuda, 5)
    recv = _filled(F, 2048, cuda)
    want = dr.deliver_rows_plain(send, _filled(F, 2048, cuda), tabs, zero)
    dr.deliver_rows(send, recv, tabs, zero)         # warm-up, eager
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    wide = dr.deliver_rows.wide_launches
    with torch.cuda.stream(side), torch.cuda.graph(graph):
        dr.deliver_rows(send, recv, tabs, zero)
    torch.cuda.current_stream().wait_stream(side)
    assert dr.deliver_rows.wide_launches - wide == 1
    for _ in range(3):
        recv.fill_(0xAB)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(recv, want)
    assert dr.deliver_rows.wide_launches - wide == 1


@pytest.mark.parametrize("case", ["4-byte aligned", "2032-byte rows",
                                  "bound 4-byte aligned",
                                  "bound 2052-byte rows"])
def test_narrow_or_misaligned_rows_take_the_persistent_grid(cuda, case):
    """Arenas 4 bytes off a 16-byte address, rows under 2 KB, and rows of
    2052 bytes (4-byte lanes), through deliver_rows and a bound launch,
    take the persistent grid at 200,000 rows (the counter says so), equal
    to the plain version; the wide-row engine refuses lanes under 16
    bytes by name."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    rows = 200_000
    d = {"2032-byte rows": 2032, "bound 2052-byte rows": 2052}.get(case, 2048)
    send, tabs, zero, F = _wide_round(rows, d, cuda, 6)
    if case.endswith("aligned"):
        block = _filled(F * d + 16, 1, cuda).view(-1)
        recv = block[4:4 + F * d].view(F, d)
    else:
        recv = _filled(F, d, cuda)
    lane = dr.lane_bytes(send.data_ptr(), recv.data_ptr(), d)
    assert lane == (16 if case == "2032-byte rows" else 4)
    assert not dr.wide_engine(lane, d)
    want = dr.deliver_rows_plain(send, _filled(F, d, cuda), tabs, zero)
    launches, wide = dr.deliver_rows.launches, dr.deliver_rows.wide_launches
    if case.startswith("bound"):
        dr.row_launcher(tabs, zero, send_shape=tuple(send.shape),
                        recv_shape=(F, d), dtype=torch.uint8)(send, recv)
    else:
        dr.deliver_rows(send, recv, tabs, zero)
    torch.cuda.synchronize()
    assert torch.equal(recv, want)
    assert dr.deliver_rows.launches - launches == 1
    assert dr.deliver_rows.wide_launches == wide
    if lane != 16:
        with pytest.raises(RuntimeError, match="cudaError"):
            dr._deliver_rows_on("wide", send, recv, tabs, zero)


# The many-round launch (csrc/deliver_rows.cu, aggcomm_deliver_rounds): a
# one-device rep of more than one barrier-free round in one cooperative
# launch, its rounds fenced inside the kernel.

@pytest.mark.parametrize("n,a,c,d", [
    (16384, 256, 64, 256),          # the Theta script's -c 64: 256 rounds
    (32, 14, 3, 2048),              # the README shape: 11 rounds
])
def test_deliver_rounds_equals_the_per_round_launches(cuda, n, a, c, d):
    """The rep's one launch, into an arena the allocator hands back as
    0xFF, equals the same rounds as one launch a round and the plain
    version on the card, byte for byte; the counters add one launch and R
    rounds; the fence's counter is back at 0 and its error record
    empty."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    s = compile_method(1, AggregatorPattern(n, a, data_size=d, comm_size=c))
    b = TorchShardBackend(cuda)
    built = b._compiled(s)
    R, tabs = len(built.rounds), built.fused
    assert R > 1 and tabs is not None
    send = b._send(s.pattern, 4, built)
    nbytes = built.F * send.shape[1] * send.element_size()
    _poison(nbytes, cuda)
    launches, rounds = dr.deliver_rows.launches, dr.deliver_rows.fused_rounds
    got = built.rep(send)
    torch.cuda.synchronize()
    assert dr.deliver_rows.launches - launches == 1
    assert dr.deliver_rows.fused_rounds - rounds == R
    assert tabs.sync.tolist() == [0, 0, 0, 0]
    _poison(nbytes, cuda)
    per = torch.empty_like(got)
    issue = dr.arena_launcher(send, per)
    for i, (_r, t, _nb) in enumerate(built.rounds):
        issue(t.rows, built.zero if i == 0 else None)
    torch.cuda.synchronize()
    assert dr.deliver_rows.launches - launches == 1 + R
    assert torch.equal(got, per)
    del per
    plain = dr.deliver_rounds_plain(send, torch.full_like(got, -1), tabs, R,
                                    built.zero)
    assert torch.equal(got, plain)


def _twice_written(R: int, rows: int, d: int, cuda):
    """R rounds, each writing the same ``rows`` receive rows (a
    permutation a round) from its own block of send rows, and a send of
    distinct bytes."""
    rng = np.random.default_rng(R * rows + d)
    pairs = [(k * rows + np.arange(rows), rng.permutation(rows))
             for k in range(R)]
    send = torch.randint(0, 255, (R * rows, d), dtype=torch.uint8,
                         device=cuda)
    if d % 4 == 0:
        send = send.view(torch.int32)
    return pairs, send


@pytest.mark.parametrize("d", [2048, 64, 6])
def test_deliver_rounds_keeps_the_later_rounds_bytes(cuda, d):
    """Every row written in each of 8 rounds, by CTAs all over the card,
    keeps the last round's bytes (and a prefix its last round's): rows of
    a tile or more, narrower rows and byte lanes."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    R, rows = 8, 20000
    pairs, send = _twice_written(R, rows, d, cuda)
    tabs = dr.round_tables(pairs, F=rows + 1, Fs=R * rows, device=cuda)
    zero = dr.zero_runs([(rows, rows + 1)], cuda)
    for k in (R, 3):
        recv = torch.full((rows + 1, send.shape[1]), -1, dtype=send.dtype,
                          device=cuda)
        dr.deliver_rounds(send, recv, tabs, k, zero)
        want = torch.zeros_like(recv)
        src, dst = pairs[k - 1]
        want[torch.as_tensor(dst, device=cuda)] = send[
            torch.as_tensor(src, device=cuda)]
        assert torch.equal(recv, want), k
    dr.check_fence(tabs)
    assert tabs.sync.tolist() == [0, 0, 0, 0]


def test_deliver_rounds_stamps_order_every_fence(cuda):
    """From the stamps: no copying CTA leaves fence k before every copying
    CTA has finished round k's copies, each CTA's stamps rise, and the
    launch's plan has at least as many CTAs as the stamps name."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    R, rows, d = 6, 40000, 2048
    pairs, send = _twice_written(R, rows, d, cuda)
    tabs = dr.round_tables(pairs, F=rows + 1, Fs=R * rows, device=cuda)
    recv = torch.empty((rows + 1, send.shape[1]), dtype=send.dtype,
                       device=cuda)
    plan = dr.rounds_plan(send, recv, tabs)
    assert plan["copy_ctas"] <= plan["grid"] and plan["lane_bytes"] == 16
    stamps = torch.zeros(plan["grid"] * (2 + 2 * R), dtype=torch.int64,
                         device=cuda)
    with pytest.raises(ValueError, match="stamps"):
        dr.deliver_rounds(send, recv, tabs, stamps=stamps[:-1])
    dr.deliver_rounds(send, recv, tabs, stamps=stamps)
    torch.cuda.synchronize()
    st = stamps.view(plan["grid"], 2 + 2 * R)[:plan["copy_ctas"]].cpu()
    assert (st[:, 1:] >= st[:, :-1]).all()
    copied, fenced = st[:, 1:2 * R:2], st[:, 2:2 * R + 1:2]
    for k in range(R - 1):
        assert fenced[:, k].min() >= copied[:, k].max(), k
    src, dst = pairs[-1]
    assert torch.equal(recv[torch.as_tensor(dst, device=cuda)],
                       send[torch.as_tensor(src, device=cuda)])
    assert tabs.sync.tolist() == [0, 0, 0, 0]


def test_deliver_rounds_after_a_fence_timeout_writes_nothing(cuda):
    """Fence words as a timed-out launch leaves them (its counter where
    the CTAs stood, the error record set): every later launch on them,
    checked or bound, writes nothing, neither rows nor zero runs, and
    counts as launched; check_fence raises and clears the words, and the
    next launch delivers every round."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    R, rows, d = 4, 3000, 64
    pairs, send = _twice_written(R, rows, d, cuda)
    tabs = dr.round_tables(pairs, F=rows + 1, Fs=R * rows, device=cuda)
    zero = dr.zero_runs([(rows, rows + 1)], cuda)
    shape = (rows + 1, send.shape[1])
    bound = dr.rounds_launcher(tabs, R, zero, send_shape=send.shape,
                               recv_shape=shape, dtype=send.dtype)
    failed = torch.tensor([5, 3, 1, 4], dtype=torch.int32)
    for issue in (lambda recv: dr.deliver_rounds(send, recv, tabs, R, zero),
                  lambda recv: bound(send, recv)):
        tabs.sync.copy_(failed)
        recv = torch.full(shape, -1, dtype=send.dtype, device=cuda)
        launches = dr.deliver_rows.launches
        issue(recv)
        torch.cuda.synchronize()
        assert dr.deliver_rows.launches - launches == 1
        assert (recv == -1).all()
        assert tabs.sync.cpu().tolist() == failed.tolist()
        with pytest.raises(dr.DeliverFenceError, match="CTA 2"):
            dr.check_fence(tabs)
        assert tabs.sync.tolist() == [0, 0, 0, 0]
    bound(send, recv)
    want = torch.zeros_like(recv)
    src, dst = pairs[-1]
    want[torch.as_tensor(dst, device=cuda)] = send[
        torch.as_tensor(src, device=cuda)]
    assert torch.equal(recv, want)
    dr.check_fence(tabs)


# TAM's relay on one card (torch_shard with no group, m=15/16): three bound
# row deliveries over m=1/m=2's compacted arenas, into arenas the caching
# allocator hands back filled with 0xFF.

@pytest.mark.parametrize("method,n,a,p,d", [
    (15, 64, 8, 4, 2048), (16, 64, 8, 4, 256),
    (15, 70, 8, 64, 6),                         # ragged node, byte lanes
    (16, 10, 3, 4, 100),                        # 4-byte lanes
])
def test_relay_on_the_card_equals_the_cpu_hop_by_hop(cuda, method, n, a, p,
                                                     d):
    """Each hop's arena on the card equals the CPU's (the same tables
    through the kernel's plain version); a rep is three launches and three
    relay hops; the delivered arena, trash row included, equals m=1's
    (m=2's) rep of the same send on the card."""
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    s = compile_method(method, AggregatorPattern(n, a, data_size=d,
                                                 proc_node=p, placement=3))
    bg, bc, sg, sc = _shard_builds(s, cuda)
    _poison(3 * bg.F * sg.shape[1] * sg.element_size(), cuda)
    launches, hops = deliver_rows.launches, deliver_rows.relay_hops
    got, want = [], []
    recv = bg.rep(sg, stages=got)
    torch.cuda.synchronize()
    assert deliver_rows.launches - launches == 3
    assert deliver_rows.relay_hops - hops == 3
    bc.rep(sc, stages=want)
    assert len(got) == len(want) == 3 and got[-1] is recv
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_reference(g), to_reference(w))
    direct, _bc, _sg, _sc = _shard_builds(
        compile_method(method - 14, s.pattern), cuda)
    np.testing.assert_array_equal(to_reference(recv),
                                  to_reference(direct.rep(sg)))


@pytest.mark.parametrize("iters", [5, 53])
def test_relay_graph_chain_equals_the_eager_chain(cuda, iters):
    """The relay's chain as CUDA graph replays (its three arenas allocated
    inside the capture) equals the same chain run eagerly; three launches
    of every replayed rep and of the warm-up rep."""
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    from tpu_aggcomm_torch.parallel import group_sum
    s = compile_method(15, AggregatorPattern(64, 8, data_size=2048,
                                             proc_node=4))
    bg, _bc, sg, _sc = _shard_builds(s, cuda)
    F = bg.F

    def step(carry, r):
        recv = bg.rep(carry)
        chained.xor_token_(carry, chained.token_from_sum(
            group_sum(recv[:F - 1, 0], None), r))

    want = chained.eager_chain(None, step=step)(iters)(sg)
    make_chain = bg.make_chain()
    for first in (True, False):
        before = deliver_rows.launches
        got = make_chain(iters)(sg)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert deliver_rows.launches - before == 3 * (iters + first)
    assert not torch.equal(got, sg)


def test_row_launcher_binds_once_and_checks_other_arenas(cuda):
    """A bound hop: arenas of its shapes are one launch; arenas of other
    shapes take the checked path (the same bytes, or a named refusal for
    a receive arena too short)."""
    from tpu_aggcomm_torch.backends import deliver_rows as dr
    s = compile_method(16, AggregatorPattern(32, 5, data_size=256,
                                             proc_node=4))
    bg, _bc, sg, _sc = _shard_builds(s, cuda)
    tabs, w = bg.relay[0], sg.shape[1]
    E = tabs.recv_rows
    issue = dr.row_launcher(tabs, None, send_shape=tuple(sg.shape),
                            recv_shape=(E, w), dtype=sg.dtype)
    want = torch.zeros((E, w), dtype=sg.dtype, device=cuda)
    want[tabs.dst_dev.long()] = sg[tabs.src_dev.long()]
    launches = dr.deliver_rows.launches
    got = torch.full((E, w), -1, dtype=sg.dtype, device=cuda)
    issue(sg, got)
    wider = torch.full((E + 7, w), -1, dtype=sg.dtype, device=cuda)
    issue(sg, wider)
    torch.cuda.synchronize()
    assert dr.deliver_rows.launches - launches == 2
    assert torch.equal(got, want) and torch.equal(wider[:E], want)
    assert (wider[E:] == -1).all()
    with pytest.raises(ValueError, match="outside"):
        issue(sg, got[:E - 1])
