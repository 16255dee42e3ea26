"""Adapter: ``cuda_fused``, the whole throttled schedule as one launch of
kernel K2, through the port's public ``one_rep(schedule)``.

Its arenas are ``torch_sim``'s (:mod:`aggbench.backends.torch_sim`). The
kernel library is loaded (built at the first run in a checkout, into
``build/torch_kernels/``) before the tables, and after the window the
fence's timeout record is read: a CTA that timed out at a round fence
left its rep unfinished.
"""

from __future__ import annotations

from aggbench.backends.torch_sim import Adapter as SimAdapter


class Adapter(SimAdapter):
    backend = "cuda_fused"

    def _program_class(self):
        from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
        return CudaFusedBackend

    def library(self) -> None:
        if self.device.type == "cuda":
            from tpu_aggcomm_torch.csrc.build import load
            load()

    def build(self) -> None:
        super().build()
        self._tables = self.rep.tables

    def health(self) -> dict:
        from tpu_aggcomm_torch.native.fuse import (FusedFenceError,
                                                   check_fence)
        try:
            check_fence(self._tables)
        except FusedFenceError:
            return {"fence_timeouts": 1}
        return {"fence_timeouts": 0}
