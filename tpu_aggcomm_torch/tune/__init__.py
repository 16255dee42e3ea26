"""Autotuner: statistical racing search over (method, cb_nodes, -c, -t),
the port of ``tpu_aggcomm/tune/``.

- :mod:`tpu_aggcomm_torch.tune.space` — the candidate grid over
  ``(method_id, cb_nodes, comm_size, agg_type)`` for one fixed
  shape/backend, with the direction and dead-method guards (copied);
- :mod:`tpu_aggcomm_torch.tune.race` — the statistical racing loop:
  successive elimination on the seeded bootstrap CI of the median delta
  vs the current leader (``obs/metrics.bootstrap_delta_ci``; copied —
  same samples in, same eliminations and winner out, byte for byte);
- :mod:`tpu_aggcomm_torch.tune.cache` — the persistent tuned-schedule
  cache: one ``TUNE_*.json`` per ``(shape, direction, backend)`` key,
  stamped with the port's manifest fingerprint, so a change of torch,
  CUDA, nvcc or card invalidates the entry by name (copied);
- :mod:`tpu_aggcomm_torch.tune.measure` — the samplers on the card
  (fresh chained differenced trials per racing batch on ``torch_sim``
  or ``cuda_fused``). The ONLY module here that touches torch;
  everything else stays importable where torch is absent, because
  ``cli tune --replay`` and ``--synthetic`` re-derive or race without a
  device.

Entry points: ``python -m tpu_aggcomm_torch.cli tune`` (search +
persist), ``cli tune --replay TUNE_*.json`` (torch-free re-derivation),
and ``--auto`` on the run/sweep commands (cache-resolved method with an
explicit warning + fallback on miss or drift).
"""

from __future__ import annotations

__all__ = ["space", "race", "cache"]
