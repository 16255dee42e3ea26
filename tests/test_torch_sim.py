"""torch_sim against jax_sim: byte-exact recv arenas and chain states.

The same numpy send lanes go through ``JaxSimBackend().one_rep`` (jitted,
on the CPU) and the port's ``TorchSimBackend(device="cpu").one_rep``; the
whole ``(n, R+1, w)`` recv arena, trash row included, must be equal byte
for byte (tolerance zero: this is integer data movement). The shapes
cover the unrolled rounds, the >= 32-round padded (scan-lowered) form and
the byte-lane layout.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends.jax_sim import JaxSimBackend  # noqa: E402
from tpu_aggcomm.backends.jax_sim import dense_send_lanes as ref_send  # noqa: E402
from tpu_aggcomm.core.methods import compile_method as ref_compile  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402

from tpu_aggcomm_torch.backends import torch_sim  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import (NotPortedError,  # noqa: E402
                                                  TorchSimBackend)
from tpu_aggcomm_torch.core.methods import METHODS, compile_method, method_ids  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402
from tpu_aggcomm_torch.device import NoCudaDeviceError  # noqa: E402
from tpu_aggcomm_torch.harness.verify import (VerificationError,  # noqa: E402
                                              slot_shapes, verify_recv)

SHAPES = [(8, 3, 256, 2), (32, 4, 64, 1), (8, 3, 30, 2)]
NON_TAM = [m for m in method_ids() if not METHODS[m].tam]


def _pair(m, shape):
    n, a, d, c = shape
    return (ref_compile(m, RefPattern(n, a, data_size=d, comm_size=c)),
            compile_method(m, AggregatorPattern(n, a, data_size=d,
                                                comm_size=c)))


def _near_wrap_send(p, seed=0):
    """Seeded send lanes whose int32 view sits just below 2**31 (uint32
    lanes), so every lane-0 sum wraps; random bytes for byte lanes. Slots
    a rank does not send stay zero, as in ``dense_send_lanes``."""
    from tpu_aggcomm_torch.harness.verify import make_send_slabs
    n_send, _ = slot_shapes(p)
    rng = np.random.default_rng(seed)
    if p.data_size % 4 == 0:
        out = rng.integers(2**31 - 2**16, 2**31, size=(
            p.nprocs, n_send, p.data_size // 4), dtype=np.uint32)
    else:
        out = rng.integers(0, 256, size=(p.nprocs, n_send, p.data_size),
                           dtype=np.uint8)
    for r, slab in enumerate(make_send_slabs(p, 0)):
        out[r, 0 if slab is None else slab.shape[0]:] = 0
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", NON_TAM)
def test_one_rep_matches_jax_sim(method, shape):
    rs, s = _pair(method, shape)
    send = ref_send(rs.pattern, 0)
    want = np.asarray(jax.jit(JaxSimBackend().one_rep(rs))(send))
    got = to_reference(TorchSimBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # ... and the verifier accepts the port's delivery
    p = s.pattern
    _, n_recv = slot_shapes(p)
    from tpu_aggcomm_torch.backends.lanes import lanes_to_bytes
    from tpu_aggcomm_torch.harness.verify import recv_slot_counts
    counts = recv_slot_counts(p)
    recv = lanes_to_bytes(got[:, :n_recv], p.data_size)
    verify_recv(p, [recv[r] if counts[r] else None
                    for r in range(p.nprocs)], 0)


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("method", [1, 5, 17, 19])
def test_one_rep_matches_with_wrapping_barrier_tokens(method, shape):
    """Lane values near 2**31: the barrier token's int32 sum wraps in the
    reference (x64 off) and must wrap identically in the port."""
    rs, s = _pair(method, shape)
    send = _near_wrap_send(s.pattern, seed=method)
    want = np.asarray(jax.jit(JaxSimBackend().one_rep(rs))(send))
    got = to_reference(TorchSimBackend("cpu").one_rep(s)(
        from_reference(send, "cpu")))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", [1, 5, 17, 19])
def test_chain_end_state_matches_reference(method, shape):
    """Five chained reps: rep r+1's send is rep r's send XOR the
    byte-replicated ``(int32 sum of recv lane 0 + r) % 251`` token."""
    rs, s = _pair(method, shape)
    send = _near_wrap_send(s.pattern, seed=100 + method)
    ref_b = JaxSimBackend()
    want = np.asarray(ref_b._chain_factory(ref_b.one_rep(rs),
                                           rs.pattern)(5)(send))
    b = TorchSimBackend("cpu")
    got = to_reference(b._chain_factory(b.one_rep(s), s.pattern)(5)(
        from_reference(send, "cpu")))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, send)


def test_chain_token_wraps_at_int32():
    """[2**31 - 1, 5] sums to -2147483644 as int32 (the reference), not
    2147483652 (torch's widened sum)."""
    from tpu_aggcomm_torch.harness.chained import chain_token, xor_word
    recv = torch.tensor([[[2**31 - 1]], [[5]]], dtype=torch.int32)
    assert int(chain_token(recv, 1, 0)) == (-2147483644) % 251
    word = xor_word(torch.tensor(250), torch.int32)
    assert word.dtype == torch.int32
    assert int(word) & 0xFFFFFFFF == 250 * 0x01010101
    assert int(xor_word(torch.tensor(250), torch.uint8)) == 250


def test_differenced_per_rep_cancels_the_fixed_cost():
    """A chain costing 20 ms fixed plus 1 ms a rep reads about 1 ms a rep:
    the fixed cost cancels in the difference of two chain lengths."""
    import time

    from tpu_aggcomm_torch.harness.chained import differenced_per_rep

    def make_chain(iters):
        def chain(send0):
            time.sleep(0.02 + 0.001 * iters)
            return send0
        return chain

    per_rep = differenced_per_rep(make_chain, torch.zeros(4, dtype=torch.int32),
                                  iters_small=1, iters_big=11, trials=3,
                                  windows=1)
    assert 0.0005 < per_rep < 0.005


@pytest.mark.parametrize("method", NON_TAM)
def test_duplicate_scatter_targets_carry_equal_values(method):
    """Duplicate scatter indices occur only in trash-row writes, and they
    carry equal values, so the result does not depend on the order in
    which PyTorch applies them."""
    for shape in SHAPES[:2]:
        _rs, s = _pair(method, shape)
        p = s.pattern
        _, n_recv = slot_shapes(p)
        send = _near_wrap_send(p, seed=7)
        if s.collective:
            sslot, smask, rslot = torch_sim._dense_tables(p, n_recv)
            got = (send[:, sslot] * smask[None, :, None]).transpose(1, 0, 2)
            for slot in np.unique(rslot):
                cols = np.flatnonzero(rslot == slot)
                if len(cols) > 1:
                    assert slot == n_recv
                    assert (got[:, cols] == got[:, cols[:1]]).all()
            continue
        tabs, _nbars = torch_sim._scatter_tables(s, n_recv)
        for srcs, ss, dsts, ds_ in tabs:
            vals = send[srcs, ss]
            targets = dsts * (n_recv + 1) + ds_
            for t in np.unique(targets):
                rows = np.flatnonzero(targets == t)
                if len(rows) > 1:
                    assert t % (n_recv + 1) == n_recv
                    assert (vals[rows] == vals[rows[:1]]).all()


def test_run_verify_and_chained_on_cpu():
    s = compile_method(1, AggregatorPattern(8, 3, data_size=256,
                                            comm_size=2))
    b = TorchSimBackend("cpu")
    recv, timers = b.run(s, ntimes=2, iter_=1, verify=True, chained=True)
    assert b.last_provenance == ("torch_sim", "attributed-chained")
    assert len(b.last_samples) == 3 and all(v > 0 for v in b.last_samples)
    assert timers[0].total_time > 0 and len(b.last_rep_timers) == 2
    assert sum(r is not None for r in recv) == 3


def test_run_verify_catches_corruption(monkeypatch):
    s = compile_method(1, AggregatorPattern(8, 3, data_size=256,
                                            comm_size=2))
    b = TorchSimBackend("cpu")
    rep = b._compiled(s)

    def corrupt(send):
        recv = rep(send)
        recv[int(s.pattern.rank_list[0]), 0, 3] ^= 1
        return recv

    monkeypatch.setitem(b._cache, next(iter(b._cache)), corrupt)
    with pytest.raises(VerificationError):
        b.run(s, verify=True)


def test_default_device_is_cuda_and_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        TorchSimBackend()


def test_unported_features_raise_named_errors():
    """A fault-injected schedule runs since the faulted lowering was
    ported (tests/test_torch_faults.py holds its arena against the
    reference's); what the reference refuses on it stays refused by name:
    its round prefixes and its measured phases. (Round prefixes, measured
    phases, profile_rounds and TAM of healthy schedules run:
    tests/test_torch_phases.py, tests/test_torch_tam.py.)"""
    s = compile_method(1, AggregatorPattern(8, 3, data_size=256,
                                            comm_size=2))
    b = TorchSimBackend("cpu")
    from dataclasses import replace
    faulted = replace(s, fault="slow:r1*2.0")
    assert b.one_rep(faulted) is not None
    b.run(faulted, verify=True)
    assert issubclass(NotPortedError, NotImplementedError)
    with pytest.raises(ValueError, match="truncation"):
        b._one_rep(faulted, upto=1)
    with pytest.raises(ValueError, match="fault-injected"):
        b.run(faulted, measured_phases=True)
    with pytest.raises(TypeError, match="not a schedule"):
        b.one_rep(object())


@pytest.mark.parametrize("iters", [0, 5, 50, 53, 120])
@pytest.mark.parametrize("method,shape", [(1, SHAPES[0]), (17, SHAPES[1]),
                                          (5, SHAPES[2])])
def test_graph_chain_blocks_equal_the_eager_chain(method, shape, iters,
                                                  monkeypatch):
    """The graph chain's bookkeeping, rehearsed on the CPU: with capture
    replaced by a replay of the captured body, whole blocks of 50 reps
    plus a remainder, the device rep counter and the in-place byte XOR
    end in the eager chain's bytes for any chain length, twice over one
    family; the counter is never reset inside a chain."""
    from tpu_aggcomm_torch.harness import chained
    monkeypatch.setattr(chained, "_capture", lambda fn, state: fn)
    _rs, s = _pair(method, shape)
    b = TorchSimBackend("cpu")
    _, n_recv = slot_shapes(s.pattern)
    send0 = from_reference(_near_wrap_send(s.pattern, seed=iters), "cpu")
    want = chained.eager_chain(b.one_rep(s), n_recv)(iters)(send0)
    make_chain = chained.graph_chain(b.one_rep(s), n_recv)
    for _ in range(2):
        assert torch.equal(make_chain(iters)(send0), want)
    monkeypatch.setattr(chained, "GRAPH_BLOCK", 7)
    assert torch.equal(chained.graph_chain(b.one_rep(s), n_recv)(iters)(
        send0), want)
