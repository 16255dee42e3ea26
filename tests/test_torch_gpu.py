"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip where torch sees no CUDA device. The decision is
made inside the ``cuda`` fixture, never at import, so every pytest-xdist
worker collects the same tests. This file imports neither jax nor the
reference package, so on a host with the card and without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``tests/conftest.py`` imports jax; ``--noconftest`` skips it there.)
Tolerance is zero throughout: the kernels move integer data.
"""

import numpy as np
import pytest
import torch

from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend, capacity,
                                                 dma_steps, dma_steps_plain,
                                                 dma_tables, send_arena)
from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
from tpu_aggcomm_torch.backends.cuda_local import (exchange, exchange_chain,
                                                   exchange_plain,
                                                   host_replay)
from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference
from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,
                                                  dense_send_lanes)
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.native.fuse import (fuse_plan, fused_rep,
                                           fused_rep_plain, plan_tables)

pytestmark = pytest.mark.gpu

FUSABLE = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,cb,d", [(32, 14, 2048), (8, 3, 64), (6, 6, 48)])
def test_exchange_kernel_matches_plain_and_replay(cuda, n, cb, d):
    p = AggregatorPattern(n, cb, data_size=d, comm_size=3)
    rng = np.random.default_rng(n * cb)
    s0 = rng.integers(0, 2**32, size=(n, cb, d // 4), dtype=np.uint32)
    send0 = from_reference(s0, cuda)
    before = exchange.launches
    got = exchange_chain(p, send0, 9)
    torch.cuda.synchronize()
    assert exchange.launches == before + 9
    plain = exchange_chain(p, send0, 9, step=exchange_plain)
    np.testing.assert_array_equal(to_reference(got), to_reference(plain))
    np.testing.assert_array_equal(to_reference(got), host_replay(p, s0, 9))


@pytest.mark.parametrize("d", [2048, 36, 30])
@pytest.mark.parametrize("method", FUSABLE)
def test_fused_kernel_matches_plain(cuda, method, d):
    """16-byte vectors (d=2048), 4-byte words (d=36) and bytes (d=30)."""
    s = compile_method(method, AggregatorPattern(32, 14, data_size=d,
                                                 comm_size=3))
    tabs = plan_tables(fuse_plan(s), cuda)
    send = from_reference(dense_send_lanes(s.pattern, 0), cuda)
    before = fused_rep.launches
    got = fused_rep(send, tabs)
    torch.cuda.synchronize()
    assert fused_rep.launches == before + 1
    np.testing.assert_array_equal(to_reference(got),
                                  to_reference(fused_rep_plain(send, tabs)))


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
