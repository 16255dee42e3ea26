"""The ``cuda_dma`` adapter (kernel K3's step program, through the port's
``one_rep``) judged on the CPU, where the port runs the kernel's plain
version: whole runs of the harness at the new cell's structure cut to a
CPU's size (64 ranks a node, one aggregator at each node's first rank,
``-c 64``), sound for four seeds; each fault the adapter's arenas can
carry makes ``correct`` false, and so does the control at the same
shape."""

from __future__ import annotations

import dataclasses
import sys
import types

import pytest
import torch

from aggbench import harness
from aggbench.tests.conftest import make_root
from aggbench.tests.test_aggbench_adapters import CONFIGS, _judge

#: two of the Theta job's 64-rank nodes, slabs cut to 64 bytes
NODES2 = {"name": "nodes2", "source": "tests", "nprocs": 128,
          "cb_nodes": 2, "data_size": 64, "proc_node": 64, "placement": 1,
          "reduced": []}
CELL = "nodes2.a2m_c64_cuda_dma"


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path, NODES2)


def _run(root, backend=None, seed=77, seconds=0.2):
    bench = harness.Bench(root)
    s = harness.Session(bench, CELL, "cpu", backend=backend)
    return s, s.measure(seed, seconds, False, release=False)


@pytest.mark.parametrize("seed", [1, 2, 3**21, 2**33 + 5])
def test_sound_runs_are_correct(root, seed):
    s, (rec, checks, failed) = _run(root, seed=seed)
    assert harness.passed(checks) and failed == 0
    assert checks["judged"]["value"] >= 1 and rec.exchanges > 0
    assert checks["dma_protocol_timeouts"] == {"value": 0, "limit": 0}
    assert s.adapter.tables.n_waves == s.adapter.tables.n_steps  # lockstep


def _faulty(base_cls, fault: str):
    class Adapter(base_cls):
        def build(self):
            super().build()
            real = self.rep
            if fault == "dropped_step":
                # the last data step moves no bytes: its senders take the
                # dummy row into the trash row, as an idle rank does
                from tpu_aggcomm_torch.backends.cuda_dma import (
                    dma_steps_plain)
                tabs = self.tables
                st = int((tabs.sslot != tabs.n_send_rows - 1).any(0)
                         .nonzero().max())
                sslot, rslot = tabs.sslot.clone(), tabs.rslot.clone()
                sslot[:, st] = tabs.n_send_rows - 1
                rslot[:, st] = tabs.n_recv_rows - 1
                dropped = dataclasses.replace(tabs, sslot=sslot,
                                              rslot=rslot)

                def rep(send):
                    return dma_steps_plain(send, dropped)
            elif fault == "corrupted_slab":
                def rep(send):
                    out = real(send)
                    out[self.roles.receivers[-1], 5, 0] ^= 1
                    return out
            else:                       # a non-receiver's row not zero
                def rep(send):
                    out = real(send)
                    out[1, 0, 3] = 9
                    return out

            self.rep = rep
    return Adapter


@pytest.mark.parametrize("fault", ["corrupted_slab", "dropped_step",
                                   "nonzero_idle_row"])
def test_each_fault_makes_correct_false(root, fault, monkeypatch):
    bench = harness.Bench(root)
    base = bench.plugin("backends", "cuda_dma")
    name = f"faulty_dma_{fault}"
    mod = types.ModuleType(f"aggbench.backends.{name}")
    mod.Adapter = _faulty(base.Adapter, fault)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    _s, (rec, checks, failed) = _run(root, backend=name)
    assert not harness.passed(checks)
    assert failed == checks["judged"]["value"] >= 1
    if fault == "nonzero_idle_row":
        assert checks["wrong_slabs"]["value"] == 0
        assert checks["stray_bytes"]["value"] == checks["judged"]["value"]
    else:
        assert checks["wrong_slabs"]["value"] > 0
    out = harness.result(bench, bench.cell(CELL), rec, checks, failed, False)
    assert out["correct"] is False


def test_the_control_reads_its_upper_count(root):
    _s, (_rec, checks, failed) = _run(root, backend="control")
    judged = checks["judged"]["value"]
    assert not harness.passed(checks) and failed == judged
    assert checks["wrong_slabs"]["value"] == judged * NODES2["cb_nodes"]


def test_arenas_are_rank_major_bytes_with_the_extra_rows_last(root):
    s, _ = _run(root, seconds=0.05)
    ad, n = s.adapter, NODES2["nprocs"]
    send = ad.new_send()
    assert send.shape == (n, NODES2["cb_nodes"] + 1, NODES2["data_size"])
    assert send.dtype == torch.uint8
    out = ad.rep(send)
    assert out.shape == (n, n + 1, NODES2["data_size"])
    assert ad.recv_view(out).shape == (NODES2["cb_nodes"], n,
                                       NODES2["data_size"])
    assert ad._idle_runs == [(1, 64), (65, 128)]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("method,direction", [(1, "all_to_many"),
                                              (2, "many_to_all")])
@pytest.mark.parametrize("comm_size", [2, 999_999_999])
def test_rep_delivers_what_the_reference_expects(config, method, direction,
                                                 comm_size):
    """The adapter's layouts at the other adapters' shapes, both
    directions (every placement policy, ragged slabs)."""
    for bad, stray, health in _judge("cuda_dma", config, method, direction,
                                     comm_size):
        assert (bad, stray) == (0, 0)
        assert health == {"dma_protocol_timeouts": 0}
