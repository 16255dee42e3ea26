"""cuda_fused: whole throttled schedules as ONE CUDA kernel launch.

The port of ``tpu_aggcomm/backends/pallas_fused.py``. The torch_sim
lowering launches one gather and one scatter per throttle round; this
backend lowers the SAME schedule data through
:mod:`tpu_aggcomm_torch.native.fuse` instead: one launch of kernel K2 per
rep zeroes the never-written recv rows and copies every round's edge
rows, with a fence between rounds, so rounds remain distinct steps inside
the kernel and the ``-c`` semantics the benchmark studies survive fusion.
A run ends by checking the fence's timeout record (``FusedFenceError``).

Everything else rides the TorchSimBackend harness unchanged: dense
rank-axis send lanes in, ``(n, R+1, w)`` recv lanes out (trash row last,
zero), byte-exact ``--verify``, and the chained differenced timing.
Unfusable schedules (TAM, dense collectives, staged dead-link repairs,
slow-rank injection) refuse with a NAMED error, never a silent fallback
to the per-round lowering.

Without a CUDA device the kernel cannot run: the plain version must be
asked for explicitly (``CudaFusedBackend(device="cpu")``, CLI
``--device cpu``); otherwise construction raises
:class:`FusedBackendError`, so a CPU-only host can never silently
"measure" the plain version.
"""

from __future__ import annotations

import torch

from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
from tpu_aggcomm_torch.native.fuse import (build_fused_rep, check_fence,
                                           fuse_plan)
from tpu_aggcomm_torch.obs import trace

__all__ = ["CudaFusedBackend", "FusedBackendError"]


class FusedBackendError(RuntimeError):
    """cuda_fused cannot run in this environment — named reason (no CUDA
    device and the CPU plain version not requested), never a silent
    fallback."""


class CudaFusedBackend(TorchSimBackend):
    """One fused CUDA kernel per schedule; TorchSimBackend harness."""

    name = "cuda_fused"

    def __init__(self, device="cuda"):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise FusedBackendError(
                "cuda_fused: no CUDA device and the CPU was not requested — "
                "pass CudaFusedBackend(device='cpu') (CLI: --device cpu) "
                "for the plain-version (verify-only) path; the fused "
                "kernel runs on a CUDA card only")
        super().__init__(device=device)

    # ------------------------------------------------------------------
    def _one_rep(self, schedule, upto: int | None = None):
        if upto is not None:
            raise ValueError(
                "cuda_fused: round-prefix truncation decomposes the "
                "per-round program family — the fused kernel is one "
                "launch; measure prefixes on torch_sim")
        with trace.span("tables.edges"):
            plan = fuse_plan(schedule)      # named refusal if unfusable
        return build_fused_rep(plan, device=self.device)

    def batched_rep(self, schedule):
        raise ValueError(
            "cuda_fused does not batch: the fused kernel is one launch "
            "per rep and its in-kernel fences are the round fence; the "
            "serve layer runs cuda_fused requests one launch each")

    def run(self, schedule, *, ntimes: int = 1, iter_: int = 0,
            verify: bool = False, chained: bool = False,
            profile_rounds: bool = False, measured_phases: bool = False):
        if profile_rounds:
            raise ValueError(
                "cuda_fused: per-round dispatch profiling re-fences the "
                "program the fusion removed — the fused rep is ONE "
                "kernel; use profile_rounds on torch_sim")
        if measured_phases:
            raise ValueError(
                "cuda_fused: the measured phase split differences prefix "
                "programs of the per-round lowering; use measured phases "
                "on torch_sim")
        out = super().run(schedule, ntimes=ntimes, iter_=iter_,
                          verify=verify, chained=chained)
        check_fence(self._compiled(schedule).tables)
        return out
