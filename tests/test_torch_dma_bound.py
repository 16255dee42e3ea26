"""``cuda_dma``'s bound rep (``CudaDmaBackend.one_rep``, kernel K3's launch
bound once to a step program's tables): the rep ``run`` times and the
benchmark drives.

On the CPU the rep runs the kernel's plain version: its bytes equal
``run``'s and ``dma_steps_plain``'s at the Theta job's structure cut to a
CPU's size (64 ranks a node, an aggregator at each node's first rank,
``-c 64``); its spans are recorded; it refuses what it cannot run by
name. The counters of launches, waves and checked launches move on the
card only (marked ``gpu``, skipped without one). Tolerance is zero: the
rep moves integer data. This file imports no jax.
"""

import numpy as np
import pytest
import torch

from tpu_aggcomm_torch.backends import cuda_dma
from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend,
                                                 DmaCapacityError,
                                                 DmaFaultError,
                                                 check_capacity,
                                                 check_protocol, dma_steps,
                                                 dma_steps_plain, send_arena)
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.faults import parse_fault, repair_schedule
from tpu_aggcomm_torch.harness.verify import recv_slot_counts
from tpu_aggcomm_torch.obs import trace

#: whole 64-rank nodes with one aggregator each, as the Theta cell has
NODES = [(128, 2), (192, 3)]
SEEDS = [1, 2, 3]


def _schedule(n, a, d=64, method=1, **kw):
    return compile_method(method, AggregatorPattern(
        n, a, data_size=d, comm_size=64, proc_node=64, placement=1, **kw))


def _random_send(tabs, d, seed):
    g = torch.Generator().manual_seed(seed)
    send = torch.randint(0, 256, (tabs.nprocs, tabs.n_send_rows, d),
                         dtype=torch.uint8, generator=g)
    send[:, -1] = 0                     # the dummy row
    return send


@pytest.fixture
def no_recorder():
    yield
    trace.disable()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,a", NODES)
def test_bound_rep_equals_run_and_plain(n, a, seed):
    s = _schedule(n, a)
    b = CudaDmaBackend("cpu")
    rep = b.one_rep(s)
    assert b.one_rep(s) is rep and rep.tables is b.tables(s)
    tabs = rep.tables
    assert tabs.n_waves == tabs.n_steps                 # lockstep
    for send in (send_arena(s.pattern, seed, "cpu"),
                 _random_send(tabs, 64, seed)):
        got = rep(send)
        assert torch.equal(got, dma_steps_plain(send, tabs))
        assert torch.equal(got, dma_steps(send, tabs))
        assert not got[:, -1].any()                     # trash row zero
    recv, _timers = b.run(s, verify=True, iter_=seed)
    got = rep(send_arena(s.pattern, seed, "cpu")).numpy()
    counts = recv_slot_counts(s.pattern)
    for r in range(n):
        if counts[r]:
            np.testing.assert_array_equal(recv[r], got[r, :-1])
        else:
            assert recv[r] is None and not got[r].any()


@pytest.mark.parametrize("n,a", NODES)
def test_spans_of_the_build_and_the_rep(n, a, no_recorder):
    s = _schedule(n, a)
    rec = trace.enable(manifest=False)
    rep = CudaDmaBackend("cpu").one_rep(s)
    send = send_arena(s.pattern, 1, "cpu")
    on = rep(send)
    trace.disable()
    assert torch.equal(on, rep(send))
    spans = [e for e in rec.events if e["ev"] == "host_span"]
    (steps,) = [e for e in spans if e["name"] == "tables.steps"]
    (top,) = [e for e in spans if e["name"] == "rep"]
    kids = {e["name"]: e for e in spans if e["parent"] == top["id"]}
    assert sorted(kids) == ["rep.arena", "rep.issue"]
    assert kids["rep.issue"]["args"] == {"waves": rep.tables.n_waves,
                                         "steps": rep.tables.n_steps}
    assert steps["parent"] is None and steps["dur"] > 0
    self_us = trace.span_self_us(rec.events, "rep")
    assert len(self_us) == 1 and 0.0 <= self_us[0] <= top["dur"]


def test_the_counters_move_on_the_card_only():
    s = _schedule(*NODES[0])
    rep = CudaDmaBackend("cpu").one_rep(s)
    before = (dma_steps.launches, dma_steps.waves, dma_steps.full_checks)
    send = send_arena(s.pattern, 0, "cpu")
    rep(send)
    dma_steps(send, rep.tables)
    assert (dma_steps.launches, dma_steps.waves,
            dma_steps.full_checks) == before


def test_a_send_it_was_not_bound_for_is_refused_as_dma_steps_refuses():
    s = _schedule(*NODES[0])
    rep = CudaDmaBackend("cpu").one_rep(s)
    tabs = rep.tables
    for bad in (torch.zeros((tabs.nprocs, tabs.n_send_rows + 1, 64),
                            dtype=torch.uint8),
                torch.zeros((tabs.nprocs, tabs.n_send_rows, 16),
                            dtype=torch.int32),
                torch.zeros((tabs.nprocs, 64, tabs.n_send_rows),
                            dtype=torch.uint8).transpose(1, 2)):
        with pytest.raises(ValueError) as direct:
            dma_steps(bad, tabs)
        with pytest.raises(ValueError) as bound:
            rep(bad)
        assert str(bound.value) == str(direct.value)
    # another slab width is checked, then run: the tables fix no width
    wide = _random_send(tabs, 48, 4)
    assert torch.equal(rep(wide), dma_steps_plain(wide, tabs))


def test_capacity_refusal_names_the_ranks_and_the_cap():
    check_capacity(1320, 1320)
    with pytest.raises(DmaCapacityError,
                       match=r"1321 ranks need 1321 co-resident CTAs .* "
                             r"at most 1320; run at most 1320 ranks"):
        check_capacity(1321, 1320)


def test_one_rep_refuses_what_run_routes_or_refuses():
    b = CudaDmaBackend("cpu")
    for m in (5, 15):
        with pytest.raises(ValueError, match="no permutation steps"):
            b.one_rep(_schedule(*NODES[0], method=m))
    faulted = repair_schedule(_schedule(*NODES[0]), parse_fault("slow:r2*2"))
    with pytest.raises(DmaFaultError, match="fault-injected"):
        b.one_rep(faulted)
    with pytest.raises(DmaFaultError, match="fault-injected"):
        b.run(faulted)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,a", NODES)
def test_card_counts_waves_and_checked_launches(cuda, n, a):
    """A bound rep adds one launch and its program's waves and no checked
    launch; the checked entry adds one of each; both equal plain."""
    s = _schedule(n, a, d=2048)
    rep = CudaDmaBackend("cuda").one_rep(s)
    tabs = rep.tables
    send = send_arena(s.pattern, 1, cuda)
    plain = dma_steps_plain(send, tabs)
    launches, waves, full = (dma_steps.launches, dma_steps.waves,
                             dma_steps.full_checks)
    got = rep(send)
    check_protocol(tabs)
    assert torch.equal(got, plain)
    assert (dma_steps.launches - launches, dma_steps.waves - waves,
            dma_steps.full_checks - full) == (1, tabs.n_waves, 0)
    assert torch.equal(dma_steps(send, tabs), plain)
    assert (dma_steps.launches - launches, dma_steps.waves - waves,
            dma_steps.full_checks - full) == (2, 2 * tabs.n_waves, 1)


@pytest.mark.gpu
def test_card_refuses_more_ranks_than_the_cap_before_launching(cuda):
    cap = cuda_dma.capacity()
    s = compile_method(1, AggregatorPattern(cap + 1, 2, data_size=16,
                                            comm_size=64))
    launches = dma_steps.launches
    with pytest.raises(DmaCapacityError, match=f"{cap + 1} ranks"):
        CudaDmaBackend("cuda").one_rep(s)
    assert dma_steps.launches == launches
