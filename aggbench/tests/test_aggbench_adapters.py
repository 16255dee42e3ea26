"""Each adapter's rep against the plain reference at small n on the CPU
(``cuda_fused``'s kernel runs on the card only)."""

from __future__ import annotations

import pytest
import torch

from aggbench import payload
from aggbench.harness import Bench
from aggbench.reference.exchange import wrong_slabs
from aggbench.reference.roles import roles
from aggbench.tests.conftest import REPO

CONFIGS = [
    {"nprocs": 8, "cb_nodes": 3, "data_size": 64, "proc_node": 1,
     "placement": 1},
    {"nprocs": 12, "cb_nodes": 5, "data_size": 30, "proc_node": 1,
     "placement": 2},
    {"nprocs": 16, "cb_nodes": 4, "data_size": 256, "proc_node": 4,
     "placement": 3},
]


def _judge(backend, config, method, direction, comm_size, device="cpu"):
    traffic = {"method": method, "direction": direction,
               "comm_size": comm_size}
    r = roles(config, direction)
    ad = Bench(REPO).plugin("backends", backend).Adapter(config, traffic, r,
                                                         device)
    ad.library()
    ad.build()
    results = []
    for arena in (0, 1):
        send = ad.new_send()
        for i0, i1, block in payload.blocks(91, arena, len(r.senders),
                                            len(r.receivers), r.data_size,
                                            device):
            ad.put_send(send, i0, i1, block)
        out = ad.rep(send)
        results.append((wrong_slabs(ad.recv_view(out), 91, arena,
                                    len(r.senders), len(r.receivers),
                                    r.data_size),
                        ad.stray_bytes(out), ad.health()))
    return results


@pytest.mark.parametrize("backend", ["torch_sim", "torch_shard"])
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("method,direction", [(1, "all_to_many"),
                                              (2, "many_to_all")])
@pytest.mark.parametrize("comm_size", [2, 999_999_999])
def test_rep_delivers_what_the_reference_expects(backend, config, method,
                                                 direction, comm_size):
    for bad, stray, health in _judge(backend, config, method, direction,
                                     comm_size):
        assert (bad, stray) == (0, 0)
        assert all(v == 0 for v in health.values())


def test_control_fails_by_its_self_slabs():
    cfg = CONFIGS[0]
    for bad, stray, _ in _judge("control", cfg, 1, "all_to_many", 2):
        assert bad == cfg["cb_nodes"] and stray == 0


@pytest.mark.gpu
@pytest.mark.parametrize("config", CONFIGS)
def test_cuda_fused_on_the_card(config):
    if not torch.cuda.is_available():
        pytest.skip("cuda_fused's kernel K2 runs on a CUDA card only")
    for bad, stray, health in _judge("cuda_fused", config, 1,
                                     "all_to_many", 2, "cuda"):
        assert (bad, stray) == (0, 0) and health == {"fence_timeouts": 0}


def test_cuda_fused_plain_version_on_the_cpu():
    """K2's plain version behind the same adapter: the layouts agree."""
    for bad, stray, health in _judge("cuda_fused", CONFIGS[0], 1,
                                     "all_to_many", 2):
        assert (bad, stray) == (0, 0) and health == {"fence_timeouts": 0}
