"""tpu_aggcomm_torch — the aggregator-communication benchmark in PyTorch
and CUDA for one NVIDIA H100.

A port of :mod:`tpu_aggcomm` that shares none of its code: the
device-free layers (pattern, schedule, methods, verification, timers,
reporting, the fused-plan builder) are copies, and the device layers are
rewritten in torch with hand-written CUDA kernels for Hopper.

- :mod:`tpu_aggcomm_torch.core`      pattern / schedule / method registry
- :mod:`tpu_aggcomm_torch.backends`  ``torch_sim`` (rank-axis rounds),
                                     ``cuda_fused`` (one kernel per rep)
                                     and ``cuda_dma`` (one CTA per rank)
- :mod:`tpu_aggcomm_torch.harness`   timing, verification, reporting, runner
- :mod:`tpu_aggcomm_torch.tam`       the TAM engine and the ``tam``
                                     driver's workload engines
- :mod:`tpu_aggcomm_torch.obs`       flight recorder, run ledger,
                                     profiler cross-check
- :mod:`tpu_aggcomm_torch.csrc`      CUDA sources and their build loader
- :mod:`tpu_aggcomm_torch.cli`       the ``./test``-compatible ``run``,
                                     ``sweep`` and ``tam``
- :mod:`tpu_aggcomm_torch.bench`     the headline exchange benchmark

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).
"""

__version__ = "0.1.0"

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction

__all__ = ["AggregatorPattern", "Direction", "__version__"]
