"""Schedule executors of the port.

- ``torch_sim``  — every rank on one device as the leading array axis;
  one gather and one scatter launch per throttle round.
- ``cuda_fused`` — the same schedule as one CUDA kernel launch per rep
  (``csrc/fused_rep.cu``), recv zeroing inside, a fence per round.
- ``cuda_dma`` / ``cuda_dma_conc`` — the remote-DMA semaphore transport
  (``csrc/dma_steps.cu``): one co-resident CTA per rank runs the
  permutation-step program, lockstep or a whole round in flight, one
  launch per rep, recv zeroing inside.

``cuda_local`` holds the headline exchange kernel (``csrc/exchange.cu``,
a whole chain of reps in one launch) that the bench drives.
"""

from tpu_aggcomm_torch.backends.registry import BACKENDS, get_backend

__all__ = ["BACKENDS", "get_backend"]
