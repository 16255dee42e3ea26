"""Backend registry — the ``--backend`` plugin boundary of the port."""

from __future__ import annotations

__all__ = ["BACKENDS", "HOST_BACKENDS", "get_backend"]

BACKENDS = ("torch_sim", "cuda_fused", "cuda_dma", "cuda_dma_conc", "local",
            "native")
#: the host oracles, copied from the reference: ``device`` does not apply
HOST_BACKENDS = ("local", "native")


def get_backend(name: str, device="cuda"):
    """A backend instance on ``device`` (the CUDA card unless the caller
    passes ``"cpu"``). ``local`` and ``native`` are host oracles by name
    and take no device."""
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
    if name == "local":
        # the event-driven MPI-semantics oracle (deliveries and deadlocks)
        from tpu_aggcomm_torch.backends.local import LocalBackend
        return LocalBackend()
    if name == "native":
        # the C++ threaded rank runtime, built with g++ at first use
        from tpu_aggcomm_torch.backends.native import NativeBackend
        return NativeBackend()
    raise ValueError(f"unknown backend {name!r}; available: {BACKENDS}")
