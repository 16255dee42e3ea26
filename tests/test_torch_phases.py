"""Measured phases on torch_sim against jax_sim: the truncated programs
byte for byte, and the decompositions' arithmetic under one fake timer.

The same numpy send lanes (``dense_send_lanes`` of a seeded iteration) go
through the reference's jitted truncations on the CPU and the port's on
``device="cpu"``; whole recv arenas, trash row included, must be equal
byte for byte (tolerance zero: integer data movement). The shapes are
n=8 a=3 at ``-p`` 1, 2 and 4, a ragged n=10 ``-p 4``, the >= 32-round
padded form and byte lanes.

The decompositions (``measure_round_times``, ``measure_round_splits``,
``measure_phase_split``) are pinned without timing anything: the chain
timer of both packages (``differenced_per_rep`` in each backend module
and in each ``harness.chained``, and ``measure_per_rep``) is replaced by
one seeded sequence served in call order, so equal dicts mean equal call
order and equal clamp-and-rescale arithmetic.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends import jax_sim as ref_sim  # noqa: E402
from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402
from tpu_aggcomm.harness import chained as ref_chained  # noqa: E402

from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend  # noqa: E402
from tpu_aggcomm_torch.core.methods import compile_method  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.harness import chained  # noqa: E402

# (nprocs, cb_nodes, data_size, comm_size, proc_node)
SHAPES = [(8, 3, 256, 2, 1), (8, 3, 256, 2, 2), (8, 3, 256, 2, 4),
          (10, 3, 256, 2, 4), (8, 3, 30, 2, 1)]
SCAN = (32, 4, 64, 1, 1)           # 32 rounds: the padded-table lowering
METHODS = [1, 2, 3, 13, 17, 19]    # unrolled; 17 and 19 carry barriers


def _pair(m, shape):
    n, a, d, c, pn = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c,
                                      proc_node=pn)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c, proc_node=pn)))


def _both(ref_rep, rep, rs, iter_=1):
    send = ref_sim.dense_send_lanes(rs.pattern, iter_)
    want = np.asarray(jax.jit(ref_rep)(send))
    got = to_reference(rep(from_reference(send, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def _n_rounds(s):
    return len(torch_sim._round_tables(s)[0])


@pytest.mark.parametrize("method,shape",
                         [(m, sh) for sh in SHAPES for m in METHODS]
                         + [(1, SCAN), (19, SCAN)])
def test_prefix_reps_match_jax_sim(method, shape):
    """``_one_rep(upto=k)`` for every k, the lowering chosen on the full
    round table (padded at the 32-round shape)."""
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    R = _n_rounds(s)
    for k in range(1, R + 1):
        got, want = _both(ref_b._one_rep(rs, upto=k),
                          b._one_rep(s, upto=k), rs)
        np.testing.assert_array_equal(got, want, err_msg=f"upto={k}")
    full, _ = _both(ref_b._one_rep(rs), b._one_rep(s), rs)
    np.testing.assert_array_equal(full, got)


@pytest.mark.parametrize("shape", SHAPES + [SCAN])
@pytest.mark.parametrize("method", METHODS)
def test_scatters_rep_matches_jax_sim(method, shape):
    rs, s = _pair(method, shape)
    got, want = _both(JaxSimBackend()._one_rep_scatters(rs),
                      TorchSimBackend("cpu")._one_rep_scatters(s), rs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", METHODS)
def test_hybrid_reps_match_jax_sim(method, shape):
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    for k in range(1, _n_rounds(s) + 1):
        got, want = _both(ref_b._one_rep_hybrid(rs, k),
                          b._one_rep_hybrid(s, k), rs)
        np.testing.assert_array_equal(got, want, err_msg=f"upto={k}")


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SCAN])
@pytest.mark.parametrize("method", [1, 17])
def test_prefix_chain_end_states_match(method, shape):
    """Five chained reps of a round prefix and of the scatters-only rep
    end in the reference's state."""
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    send = ref_sim.dense_send_lanes(rs.pattern, 0)
    k = max(_n_rounds(s) // 2, 1)
    for ref_rep, rep in ((ref_b._one_rep(rs, upto=k), b._one_rep(s, upto=k)),
                         (ref_b._one_rep_scatters(rs),
                          b._one_rep_scatters(s))):
        want = np.asarray(ref_b._chain_factory(ref_rep, rs.pattern)(5)(send))
        got = to_reference(b._chain_factory(rep, s.pattern)(5)(
            from_reference(send, "cpu")))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SCAN])
@pytest.mark.parametrize("method", [1, 17, 19])
def test_profile_rounds_matches_jax_sim(method, shape):
    """One launch sequence per round: the same round count and arena as
    the reference's segments, ``--verify`` passing, the same provenance."""
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    want, _ = ref_b.run(rs, ntimes=2, iter_=1, verify=True,
                        profile_rounds=True)
    got, timers = b.run(s, ntimes=2, iter_=1, verify=True,
                        profile_rounds=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    assert b.last_provenance == ("torch_sim", ref_b.last_provenance[1])
    assert [len(t) for t in b.last_round_times] == \
        [len(t) for t in ref_b.last_round_times] == [_n_rounds(s)] * 2
    assert timers[0].total_time > 0


def test_round_segments_match_the_rep():
    """The profiled segments, run in order, give the whole rep's arena."""
    _rs, s = _pair(17, SHAPES[0])
    b = TorchSimBackend("cpu")
    segs, round_ids = b._round_segments(s)
    assert round_ids == sorted(round_ids) and len(segs) == _n_rounds(s)
    send = b._global_send(s.pattern, 0)
    recv = b._arena(s.pattern)
    for seg in segs:
        recv = seg(send, recv)
    assert (recv == b.one_rep(s)(send)).all()


# --------------------------------------------------------------------------
# the decompositions' arithmetic, under one seeded fake timer

class _FakeTimer:
    """One seeded sequence of seconds, served in call order to whichever
    timing entry point is called: equal results in both packages mean
    equal call order and equal arithmetic."""

    def __init__(self, seed: int):
        self.values = iter(np.random.default_rng(seed).uniform(
            1e-6, 1e-4, size=4096).tolist())
        self.calls = []

    def per_rep(self, chain_factory, send0, **kw):
        self.calls.append(("differenced_per_rep", kw["iters_small"],
                           kw["iters_big"]))
        return next(self.values)

    def measure(self, backend, schedule, **kw):
        self.calls.append(("measure_per_rep",))
        return next(self.values)


@pytest.fixture
def fake_timers(monkeypatch):
    """(reference timer, port timer), each patched into its package."""
    ref_t, port_t = _FakeTimer(5), _FakeTimer(5)
    for timer, modules, cls in ((ref_t, (ref_sim, ref_chained),
                                 JaxSimBackend),
                                (port_t, (torch_sim, chained),
                                 TorchSimBackend)):
        for mod in modules:
            monkeypatch.setattr(mod, "differenced_per_rep", timer.per_rep)
        monkeypatch.setattr(cls, "measure_per_rep",
                            lambda self, sched, _t=timer, **kw:
                            _t.measure(self, sched, **kw))
    return ref_t, port_t


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3], SHAPES[4]])
@pytest.mark.parametrize("method", METHODS)
def test_round_splits_arithmetic_matches(method, shape, fake_timers):
    ref_t, port_t = fake_timers
    rs, s = _pair(method, shape)
    want = JaxSimBackend().measure_round_splits(rs)
    got = TorchSimBackend("cpu").measure_round_splits(s)
    assert got == want
    assert port_t.calls == ref_t.calls
    assert len(port_t.calls) == 2 * _n_rounds(s)    # 2R-1 families + full


@pytest.mark.parametrize("shape", [SHAPES[0], SCAN])
@pytest.mark.parametrize("method", [1, 17, 19])
def test_round_times_arithmetic_matches(method, shape, fake_timers):
    ref_t, port_t = fake_timers
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    want = ref_b.measure_round_times(rs)
    got = b.measure_round_times(s)
    assert got == want and list(got) == list(want)
    # the increments sum to the full chain's time, the first one served
    assert port_t.calls[0] == ("measure_per_rep",)
    assert sum(got.values()) == pytest.approx(
        np.random.default_rng(5).uniform(1e-6, 1e-4, size=4096)[0])
    assert port_t.calls == ref_t.calls
    # the splits reuse the memoised P prefixes: no prefix is timed twice
    if not torch_sim._scan_lowered(*torch_sim._round_tables(s)):
        assert b.measure_round_splits(s) == ref_b.measure_round_splits(rs)
        assert port_t.calls == ref_t.calls


@pytest.mark.parametrize("shape", [SHAPES[0], SCAN])
@pytest.mark.parametrize("method", [1, 2, 19])
def test_phase_split_arithmetic_matches(method, shape, fake_timers):
    ref_t, port_t = fake_timers
    rs, s = _pair(method, shape)
    want = JaxSimBackend().measure_phase_split(rs)
    got = TorchSimBackend("cpu").measure_phase_split(s)
    assert got == want
    assert got["post"] + got["deliver"] == pytest.approx(got["total"])
    assert port_t.calls == ref_t.calls


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SCAN])
@pytest.mark.parametrize("method", [1, 2, 17, 19])
def test_measured_phases_run_matches_reference(method, shape, fake_timers):
    """``run(measured_phases=True)``: the provenance string, the round
    times and every rank's attributed timers equal the reference's."""
    rs, s = _pair(method, shape)
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    _, want = ref_b.run(rs, ntimes=2, verify=True, measured_phases=True)
    _, got = b.run(s, ntimes=2, verify=True, measured_phases=True)
    assert b.last_provenance == ("torch_sim", ref_b.last_provenance[1])
    assert b.last_provenance[1] in (
        "measured-rounds(post,deliver)+attributed(waits)",
        "measured-rounds+attributed(buckets)")
    assert b.last_round_times == ref_b.last_round_times
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.as_array(), w.as_array())


def test_single_round_schedule_takes_the_measured_split(fake_timers):
    """One round (c large): the post/deliver split, as in the reference."""
    rs, s = _pair(1, (8, 3, 256, 100, 1))
    assert _n_rounds(s) == 1
    ref_b, b = JaxSimBackend(), TorchSimBackend("cpu")
    _, want = ref_b.run(rs, measured_phases=True)
    _, got = b.run(s, measured_phases=True)
    assert b.last_provenance[1] == ref_b.last_provenance[1] == \
        "measured-split(post,deliver)+attributed(waits)"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.as_array(), w.as_array())


def test_decompositions_refuse_what_the_reference_refuses():
    b = TorchSimBackend("cpu")
    _rs, dense = _pair(5, SHAPES[0])
    _rs, scan = _pair(1, SCAN)
    _rs, m1 = _pair(1, SHAPES[0])
    with pytest.raises(ValueError, match="round-structured"):
        b.measure_round_splits(dense)
    with pytest.raises(ValueError, match="round-structured"):
        b.measure_round_times(dense)
    with pytest.raises(ValueError, match="truncation"):
        b._one_rep(dense, upto=1)
    with pytest.raises(ValueError, match="unrolled lowering"):
        b.measure_round_splits(scan)
    with pytest.raises(ValueError, match="unrolled lowering"):
        b._one_rep_hybrid(scan, 1)
    with pytest.raises(ValueError, match="max_rounds"):
        b.measure_round_times(m1, max_rounds=2)
    with pytest.raises(ValueError, match="upto must be"):
        b._one_rep_hybrid(m1, 0)
    with pytest.raises(ValueError, match="exclusive"):
        b.run(m1, measured_phases=True, profile_rounds=True)
    with pytest.raises(ValueError, match="exclusive"):
        b.run(m1, chained=True, profile_rounds=True)
    with pytest.raises(ValueError, match="round-structured"):
        b.run(dense, measured_phases=True)


def test_measured_phases_sum_to_the_chained_total_on_cpu():
    """A real (timed) decomposition on the CPU: each round's post and
    deliver are non-negative and they sum to the full chain's per-rep
    time, the additivity contract."""
    _rs, s = _pair(2, SHAPES[0])
    b = TorchSimBackend("cpu")
    kw = dict(iters_small=2, iters_big=12, trials=1, windows=1)
    splits = b.measure_round_splits(s, **kw)
    total = b.measure_per_rep(s, **kw)
    assert len(splits) == _n_rounds(s)
    assert all(p_ >= 0 and d_ >= 0 for p_, d_ in splits.values())
    assert sum(p_ + d_ for p_, d_ in splits.values()) == pytest.approx(total)
    rt = b.measure_round_times(s, **kw)
    assert sum(rt.values()) == pytest.approx(total)
