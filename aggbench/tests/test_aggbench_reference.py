"""The plain reference: aggregator ranks, roles, seeded payloads, the
slab comparison and the essential-bytes floor."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from aggbench import floors, payload
from aggbench.reference.exchange import exchange, wrong_slabs
from aggbench.reference.roles import aggregator_ranks, roles
from aggbench.tests.conftest import REPO


@pytest.mark.parametrize("placement", [0, 1, 2, 3])
@pytest.mark.parametrize("n,a,p", [(32, 14, 1), (8, 3, 1), (64, 16, 8),
                                   (100, 7, 4), (16384, 256, 1),
                                   (1024, 64, 64), (17, 17, 2)])
def test_aggregator_ranks_match_the_port(placement, n, a, p):
    from tpu_aggcomm_torch.core.pattern import create_aggregator_list
    got = aggregator_ranks(n, a, placement, p)
    assert got == create_aggregator_list(n, a, placement, p).tolist()


def test_readme_aggregators_keep_the_reference_remainder_quirk():
    assert aggregator_ranks(32, 14, 1, 1) == [0, 3, 6, 8, 10, 12, 14, 16,
                                              18, 20, 22, 24, 26, 28]


def test_roles_by_direction():
    cfg = {"nprocs": 8, "cb_nodes": 3, "data_size": 64, "proc_node": 1,
           "placement": 1}
    a2m = roles(cfg, "all_to_many")
    m2a = roles(cfg, "many_to_all")
    assert a2m.senders == tuple(range(8)) == m2a.receivers
    assert a2m.receivers == m2a.senders == (0, 3, 6)
    assert a2m.payload_bytes == m2a.payload_bytes == 8 * 3 * 64
    with pytest.raises(ValueError):
        roles(cfg, "sideways")


@pytest.mark.parametrize("seed", [0, -5, 2**31 + 11, 2**70 + 3])
def test_blocks_regenerate_alone_and_differ_by_arena(seed, monkeypatch):
    monkeypatch.setattr(payload, "BLOCK_BYTES", 3 * 4 * 16)
    whole = list(payload.blocks(seed, 0, 10, 4, 16, "cpu"))
    assert [(i0, i1) for i0, i1, _ in whole] == [(0, 3), (3, 6), (6, 9),
                                                 (9, 10)]
    again = list(payload.blocks(seed, 0, 10, 4, 16, "cpu"))
    for (_, _, x), (_, _, y) in zip(whole, again):
        assert torch.equal(x, y)
    other = list(payload.blocks(seed, 1, 10, 4, 16, "cpu"))
    assert not torch.equal(whole[0][2], other[0][2])
    assert len({payload.block_seed(seed, 0, b) for b in range(4)}) == 4


def _send(seed, arena, ns, nr, d):
    return torch.cat([b for _, _, b in payload.blocks(seed, arena, ns, nr,
                                                      d, "cpu")])


def test_wrong_slabs_counts_each_altered_slab():
    ns, nr, d = 9, 4, 32
    recv = exchange(_send(7, 1, ns, nr, d))
    assert wrong_slabs(recv, 7, 1, ns, nr, d) == 0
    assert wrong_slabs(recv, 7, 0, ns, nr, d) == ns * nr
    recv[2, 5, 31] ^= 1
    recv[0, 0] = 0
    assert wrong_slabs(recv, 7, 1, ns, nr, d) == 2
    with pytest.raises(ValueError):
        wrong_slabs(recv[:, :-1], 7, 1, ns, nr, d)


@pytest.mark.parametrize("name,payload_bytes", [
    ("readme_n32_a14", 917_504), ("theta_n16384_a256", 8_589_934_592)])
def test_essential_bytes_of_both_configurations(name, payload_bytes):
    cfg = json.loads((REPO / "aggbench" / "configs" / f"{name}.json")
                     .read_text())
    assert floors.payload_bytes(cfg) == payload_bytes
    assert cfg["essential_payload_bytes"] == payload_bytes
    assert floors.essential_bytes(cfg) == 2 * payload_bytes
    kind = "NVIDIA H100 80GB HBM3"
    assert floors.floor_seconds(cfg, kind) == 2 * payload_bytes / 3.35e12
    assert floors.floor_seconds(cfg, "some other card") is None


def test_floor_is_independent_of_the_program():
    """The floor reads only n, a and d: no schedule, backend or lowering."""
    cfg = {"nprocs": 32, "cb_nodes": 14, "data_size": 2048}
    assert floors.essential_bytes(cfg) == 2 * 32 * 14 * 2048
    src = (REPO / "aggbench" / "floors.py").read_text()
    assert "tpu_aggcomm" not in src and "roofline" not in src


def test_exchange_is_the_transpose():
    send = torch.arange(2 * 3 * 4, dtype=torch.uint8).view(2, 3, 4)
    recv = exchange(send)
    assert recv.shape == (3, 2, 4) and recv.is_contiguous()
    assert np.array_equal(recv[1, 0].numpy(), send[0, 1].numpy())
