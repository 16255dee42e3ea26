"""The tuner's samplers on the card — the ONLY tune module that touches
torch. The port of ``tpu_aggcomm/tune/measure.py``.

Real tuning batches are fresh serial-chained differenced trials
(``harness/chained.py``): on the card each chain is CUDA graph replays,
so a sample is device time per rep. The backend's ``measure_per_rep``
memoizes per schedule, which is exactly wrong for racing: every batch
must be a NEW measurement or the CI over batches collapses to the first
batch's samples. The samplers therefore drive the cache-bypassing
``TorchSimBackend.measure_trial_samples`` hook, while still reusing the
backend instance so a candidate's chain pair (and on the card its CUDA
graphs, captured once in the first batch's warm-up, outside the timed
trials) is shared across batches of the SAME candidate.

The card's name enters the TUNE artifact's fingerprint through
``ledger.manifest(device=...)``, the call every fingerprinting site
makes (``tune`` and a later ``--auto`` alike), so the two see the same
facts; :func:`record_device_facts` is that call under the reference's
name.

Two samplers have counterparts: :func:`make_torch_sim_sampler` (the
reference's ``make_jax_sim_sampler``) and :func:`make_cuda_fused_sampler`
(``make_pallas_fused_sampler``: every sample is K2 launches replayed
from a CUDA graph). The reference's ``jax_shard`` sampler races the
sharded multi-device tier, which the port has not reached:
:func:`make_jax_shard_sampler` raises ``NotPortedError``.

The serve-dispatch occupancy registry (:func:`serve_dispatch_inflight`,
:class:`PilotContentionError`) is copied as it is: the server wraps every
batch dispatch in it under the port's backend names, and every sampler
refuses to measure while a dispatch is in flight on its backend. This
module imports no torch at its top: the serve control plane imports it.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["record_device_facts", "make_torch_sim_sampler",
           "make_cuda_fused_sampler", "make_jax_shard_sampler",
           "PilotContentionError", "serve_dispatch_inflight"]


class PilotContentionError(RuntimeError):
    """A campaign sampler refused to measure while a serve dispatch is
    in flight on the same backend — the one-CPU-core discipline: two
    concurrent measured workloads inflate each other's differenced
    timings 2-3x, so a race sample taken under serve load is not a
    sample, it is noise with a seed."""


# serve-dispatch occupancy per backend name (module-level: the serve
# executor and any in-process campaign sampler share this registry).
_INFLIGHT: dict[str, int] = {}
_INFLIGHT_LOCK = threading.Lock()


@contextlib.contextmanager
def serve_dispatch_inflight(backend_name: str):
    """Mark one serve dispatch in flight on ``backend_name`` for the
    duration of the with-block (serve/server.py wraps its
    ``execute_batch`` call). jax-free — occupancy accounting only."""
    with _INFLIGHT_LOCK:
        _INFLIGHT[backend_name] = _INFLIGHT.get(backend_name, 0) + 1
    try:
        yield
    finally:
        with _INFLIGHT_LOCK:
            _INFLIGHT[backend_name] -= 1
            if _INFLIGHT[backend_name] <= 0:
                del _INFLIGHT[backend_name]


def _check_contention(backend_name: str) -> None:
    """Refuse by name when a serve dispatch is in flight on the backend
    a sampler is about to measure."""
    with _INFLIGHT_LOCK:
        n = _INFLIGHT.get(backend_name, 0)
    if n > 0:
        raise PilotContentionError(
            f"{n} serve dispatch(es) in flight on backend "
            f"{backend_name!r} — refusing to take race samples under "
            f"serve load (one-CPU-core contention skews differenced "
            f"timings 2-3x); retry when the serve queue drains")


def record_device_facts(device="cuda") -> None:
    """Fill the ledger manifest's ``device_kind`` with the card's name
    when ``device`` names a CUDA device (``ledger.manifest(device=)``,
    the one place that decides it). A CPU device records nothing and
    imports no torch."""
    from tpu_aggcomm_torch.obs import ledger
    ledger.manifest(device=device)


def _make_sampler(backend_name: str, *, device, nprocs: int,
                  data_size: int, proc_node: int, iters_small: int,
                  iters_big: int, batch_trials: int, windows: int):
    """``sampler(cid, batch) -> list[float]`` over one backend instance:
    one compiled schedule per candidate (memoized), fresh differenced
    trials per batch."""
    from tpu_aggcomm_torch.backends.registry import get_backend
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.tune.space import parse_cid

    _check_contention(backend_name)
    record_device_facts(device)     # the artifacts' manifests name the card
    backend = get_backend(backend_name, device=device)
    schedules: dict[str, object] = {}

    def sampler(cid: str, batch: int) -> list[float]:
        _check_contention(backend_name)
        if cid not in schedules:
            c = parse_cid(cid)
            schedules[cid] = compile_method(c.method, AggregatorPattern(
                nprocs=nprocs, cb_nodes=c.cb_nodes,
                data_size=max(data_size, 1), proc_node=proc_node,
                comm_size=c.comm_size, placement=c.agg_type))
        return backend.measure_trial_samples(
            schedules[cid], iters_small=iters_small, iters_big=iters_big,
            trials=batch_trials, windows=windows)

    return sampler


def make_torch_sim_sampler(*, nprocs: int, data_size: int, proc_node: int,
                           device="cuda", iters_small: int = 50,
                           iters_big: int = 1050, batch_trials: int = 3,
                           windows: int = 1):
    """``sampler(cid, batch) -> list[float]`` over the single-device
    rank-axis backend: one compiled schedule per candidate (memoized),
    fresh differenced trials per batch. On the card each trial times
    CUDA graph replays of the candidate's chain."""
    return _make_sampler("torch_sim", device=device, nprocs=nprocs,
                         data_size=data_size, proc_node=proc_node,
                         iters_small=iters_small, iters_big=iters_big,
                         batch_trials=batch_trials, windows=windows)


def make_cuda_fused_sampler(*, nprocs: int, data_size: int, proc_node: int,
                            device="cuda", iters_small: int = 50,
                            iters_big: int = 1050, batch_trials: int = 3,
                            windows: int = 1):
    """``sampler(cid, batch) -> list[float]`` over the fused-kernel
    backend — the same chained differenced scaffold as the torch_sim
    sampler (CudaFusedBackend subclasses it), so the tuner can race
    fused vs fenced under one measurement discipline; on the card every
    rep of a sample is one K2 launch replayed from a CUDA graph. An
    unfusable candidate raises its NAMED refusal
    (``UnfusableScheduleError``) out of the race rather than returning
    fabricated samples."""
    return _make_sampler("cuda_fused", device=device, nprocs=nprocs,
                         data_size=data_size, proc_node=proc_node,
                         iters_small=iters_small, iters_big=iters_big,
                         batch_trials=batch_trials, windows=windows)


def make_jax_shard_sampler(**_kw):
    """The reference's sampler over the XLA-partitioned multi-device
    tier has no counterpart yet: refused by name."""
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    raise NotPortedError(
        "the jax_shard sampler (the sharded multi-device tier) is not "
        "ported to tpu_aggcomm_torch (ROADMAP.md queue A item 8); race "
        "on torch_sim or cuda_fused")
