"""Kernel K1's plain version against the Pallas exchange in interpret mode.

``tpu_aggcomm_torch.backends.cuda_local`` replaces
``tpu_aggcomm.backends.pallas_local.fused_exchange_chain``. On the CPU its
wrapper takes the plain version (transpose + ``index_select`` + xor); the
chain it runs must equal the Pallas kernel's (run as the reference's own
tests run it, ``interpret=True``) and both ``host_replay``s, byte for
byte, on the ``tests/test_pallas_local.py`` shapes.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm.backends import pallas_local as ref  # noqa: E402
from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern  # noqa: E402

from tpu_aggcomm_torch.backends import cuda_local  # noqa: E402
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference  # noqa: E402
from tpu_aggcomm_torch.core.pattern import AggregatorPattern  # noqa: E402


def _send0(n, cb, w):
    return np.arange(n * cb * w, dtype=np.uint32).reshape(n, cb, w)


@pytest.mark.parametrize("nprocs,cb,iters", [(8, 3, 1), (8, 3, 5),
                                             (32, 14, 4), (6, 6, 3)])
def test_plain_chain_matches_pallas_interpret(nprocs, cb, iters):
    rp = RefPattern(nprocs, cb, data_size=256, comm_size=3)
    p = AggregatorPattern(nprocs, cb, data_size=256, comm_size=3)
    s0 = _send0(nprocs, cb, 64)
    want = np.asarray(ref.fused_exchange_chain(rp, iters, interpret=True)(s0))
    before = cuda_local.exchange.launches
    got = to_reference(cuda_local.exchange_chain(
        p, from_reference(s0, "cpu"), iters))
    assert cuda_local.exchange.launches == before   # CPU: no kernel launch
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.host_replay(rp, s0, iters))
    np.testing.assert_array_equal(cuda_local.host_replay(p, s0, iters),
                                  ref.host_replay(rp, s0, iters))


def test_plain_chain_matches_replay_past_255_reps_with_high_bits():
    """Rep words wrap at r & 0xFF and set the sign bit of the int32 view."""
    p = AggregatorPattern(8, 3, data_size=64, comm_size=2)
    rng = np.random.default_rng(3)
    s0 = rng.integers(0, 2**32, size=(8, 3, 16), dtype=np.uint32)
    got = to_reference(cuda_local.exchange_chain(
        p, from_reference(s0, "cpu"), 260))
    np.testing.assert_array_equal(got, cuda_local.host_replay(p, s0, 260))


def test_one_rep_is_the_aggregator_permutation():
    """After one rep (word 0), recv row j holds every rank's slab for the
    j-th aggregator by rank (the bench's correctness check 1)."""
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    s0 = _send0(32, 14, 512)
    recv = to_reference(cuda_local.exchange_chain(
        p, from_reference(s0, "cpu"), 1)).reshape(14, 32, 512)
    for j, a in enumerate(sorted(int(x) for x in p.rank_list)):
        np.testing.assert_array_equal(recv[j], s0[:, p.agg_index[a]])


@pytest.mark.parametrize("entry", ["chain", "make_chain", "replay"])
def test_every_entry_point_refuses_unaligned_data_size(entry):
    p = AggregatorPattern(8, 3, data_size=30)
    with pytest.raises(ValueError, match="multiple of 4"):
        if entry == "chain":
            cuda_local.exchange_chain(p, torch.zeros((8, 3, 7),
                                                     dtype=torch.int32), 1)
        elif entry == "make_chain":
            cuda_local.make_chain(p, 1)
        else:
            cuda_local.host_replay(p, np.zeros((8, 3, 7), np.uint32), 1)


def test_wrapper_checks_its_inputs():
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    x = torch.zeros((8, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cuda_local.exchange(x.to(torch.int64), order, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_local.exchange(x.transpose(0, 1), order, 0)
    with pytest.raises(ValueError, match="order"):
        cuda_local.exchange(x, order.long(), 0)
    with pytest.raises(ValueError, match="alias"):
        cuda_local.exchange(x, order, 0, out=x)
    with pytest.raises(ValueError, match="send0"):
        cuda_local.exchange_chain(AggregatorPattern(8, 3, data_size=64),
                                  x[:, :2].contiguous(), 1)


@pytest.mark.parametrize("iters", [0, 1, 2, 9])
def test_chain_lengths_match_pallas_interpret_and_replay(iters):
    """Every chain length the one-launch kernel special-cases: 0 (send0
    itself), 1 (no barrier), 2 (one barrier, buf0 then buf1), 9."""
    rp = RefPattern(8, 3, data_size=64, comm_size=3)
    p = AggregatorPattern(8, 3, data_size=64, comm_size=3)
    s0 = np.random.default_rng(iters).integers(
        0, 2**32, size=(8, 3, 16), dtype=np.uint32)
    want = np.asarray(ref.fused_exchange_chain(rp, iters, interpret=True)(s0))
    got = to_reference(cuda_local.exchange_chain(
        p, from_reference(s0, "cpu"), iters))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cuda_local.host_replay(p, s0, iters))


def test_chain_leaves_send0_unchanged():
    p = AggregatorPattern(8, 3, data_size=64, comm_size=3)
    s0 = _send0(8, 3, 16)
    send0 = from_reference(s0, "cpu")
    cuda_local.exchange_chain(p, send0, 9)
    np.testing.assert_array_equal(to_reference(send0), s0)


def test_chain_refuses_negative_iters():
    p = AggregatorPattern(8, 3, data_size=64, comm_size=3)
    with pytest.raises(ValueError, match="iters must be >= 0"):
        cuda_local.exchange_chain(p, from_reference(_send0(8, 3, 16), "cpu"),
                                  -1)


def test_one_rep_refuses_a_word_that_is_not_a_rep_word():
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    x = torch.zeros((8, 3, 16), dtype=torch.int32)
    cuda_local.exchange(x, order, cuda_local.rep_word(7))
    with pytest.raises(ValueError, match="not a rep word"):
        cuda_local.exchange(x, order, 0x01020304)


def test_barrier_timeout_record_raises_by_name_and_clears():
    """A CTA's timeout record (cta + 1, rep, arrivals) becomes
    ``ExchangeBarrierError`` naming them; the record is then cleared."""
    words = cuda_local._sync_words(torch.device("cpu"))
    words[1:] = torch.tensor([3, 7, 40], dtype=torch.int32)
    with pytest.raises(cuda_local.ExchangeBarrierError,
                       match="CTA 2 .* after rep 7 \\(40 arrivals\\)"):
        cuda_local.check_barrier("cpu")
    assert not words.any()
    cuda_local.check_barrier("cpu")
