"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path: whole runs on the CPU, with the
harness's look for a chip skipped (``Session`` on ``cpu``).

The faults: a step that returns its state unchanged (the receive arena
as it was, nothing delivered); half of the senders left out of the
exchange; an answer altered where it is produced (one byte of the first
receiver's first slab). The exchange between chips has no fault to
plant: every cell takes one chip.
"""

from __future__ import annotations

import sys
import types

import pytest
import torch

from aggbench import harness

CELLS = ["tiny.a2m_c3_torch_sim", "tiny.a2m_unthrottled_torch_shard",
         "tiny.a2m_c64_torch_shard",
         "tiny.a2m_c3_cuda_fused"]


def _first_byte(adapter, out):
    """Where the first receiver's first slab starts in ``out``."""
    flat = out.view(torch.uint8)
    if adapter.backend == "torch_shard":
        return flat[0]
    return flat[adapter.roles.receivers[0], 0]


def _faulty(base_cls, fault: str):
    class Adapter(base_cls):
        def build(self):
            super().build()
            real = self.rep

            def rep(send):
                if fault == "unchanged":
                    return torch.zeros_like(real(send))
                if fault == "half_left_out":
                    send = send.clone()
                    ns, nr = len(self.roles.senders), len(self.roles.receivers)
                    zeros = torch.zeros((ns // 2, nr, self.roles.data_size),
                                        dtype=torch.uint8)
                    self.put_send(send, 0, ns // 2, zeros)
                    return real(send)
                out = real(send)
                _first_byte(self, out)[0] ^= 1
                return out

            self.rep = rep
    return Adapter


def _run(root, cell, backend=None, seed=77):
    bench = harness.Bench(root)
    s = harness.Session(bench, cell, "cpu", backend=backend)
    rec, checks, failed = s.measure(seed, 0.2, False)
    return rec, checks, failed


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tiny_root, cell):
    rec, checks, failed = _run(tiny_root, cell)
    assert harness.passed(checks) and failed == 0
    assert checks["judged"]["value"] >= 1
    assert rec.exchanges > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_each_fault_makes_correct_false(tiny_root, cell, fault, monkeypatch):
    bench = harness.Bench(tiny_root)
    base = bench.plugin("backends", bench.cell(cell).traffic["backend"])
    name = f"faulty_{fault}"
    mod = types.ModuleType(f"aggbench.backends.{name}")
    mod.Adapter = _faulty(base.Adapter, fault)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    rec, checks, failed = _run(tiny_root, cell, backend=name)
    assert not harness.passed(checks)
    assert checks["wrong_slabs"]["value"] > 0
    assert failed == checks["judged"]["value"]
    out = harness.result(bench, bench.cell(cell), rec, checks, failed, False)
    assert out["correct"] is False and list(out)[-1] == "checks"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(tiny_root, seed):
    rec, checks, failed = _run(tiny_root, "tiny.a2m_c3_torch_sim",
                               backend="control", seed=seed)
    assert not harness.passed(checks)
    judged = checks["judged"]["value"]
    assert checks["wrong_slabs"]["value"] == judged * 3   # 3 self slabs
    assert failed == judged
