"""Backend registry — the ``--backend`` plugin boundary of the port."""

from __future__ import annotations

__all__ = ["BACKENDS", "get_backend"]

BACKENDS = ("torch_sim", "cuda_fused", "cuda_dma", "cuda_dma_conc")


def get_backend(name: str, device="cuda"):
    """A backend instance on ``device`` (the CUDA card unless the caller
    passes ``"cpu"``)."""
    if name == "torch_sim":
        from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
        return TorchSimBackend(device=device)
    if name == "cuda_fused":
        # whole throttled schedules as ONE cooperative CUDA launch: the
        # grid barrier between rounds is the fence (native/fuse.py)
        from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
        return CudaFusedBackend(device=device)
    if name in ("cuda_dma", "cuda_dma_conc"):
        # the remote-DMA semaphore transport, one CTA per rank: lockstep
        # (cuda_dma) or the Issend storm posting discipline (cuda_dma_conc)
        from tpu_aggcomm_torch.backends.cuda_dma import CudaDmaBackend
        return CudaDmaBackend(device=device,
                              concurrent=name == "cuda_dma_conc")
    raise ValueError(f"unknown backend {name!r}; available: {BACKENDS}")
