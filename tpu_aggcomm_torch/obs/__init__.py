"""Observability of the port: the flight recorder, its exporters and the
run ledger, copied from ``tpu_aggcomm/obs/`` (import paths rewritten).

- :mod:`tpu_aggcomm_torch.obs.trace` — the flight recorder: host spans,
  instants and the reconstructed per-rank timeline of every run
  (``--trace PREFIX`` on ``run`` and ``sweep``). Off unless enabled.
- :mod:`tpu_aggcomm_torch.obs.perfetto` — its Chrome/Perfetto export.
- :mod:`tpu_aggcomm_torch.obs.metrics` — straggler statistics over the
  recorded events (``round_stats``, ``critical_path``, ...).
- :mod:`tpu_aggcomm_torch.obs.traffic` — the static traffic audit of a
  schedule; its measured overlay waits for the ``inspect`` slice.
- :mod:`tpu_aggcomm_torch.obs.atomic` — crash-safe file writes.
- :mod:`tpu_aggcomm_torch.obs.ledger` — the environment manifest (torch,
  CUDA, nvcc, the card), compile and graph-capture records, the HBM
  peak, resilience records and the ``--xprof`` cross-check against a
  ``torch.profiler`` trace.
- :mod:`tpu_aggcomm_torch.obs.workload` — the serve workload profiler:
  phase attribution of the serve journal, the batch-fill arithmetic the
  server's counters share (``padded_slots`` pads ``torch_sim`` batches),
  shape mix and arrivals.
- :mod:`tpu_aggcomm_torch.obs.regress` — the schema validators of the
  tuner's, the synthesizer's, the watchtower's and the autopilot's
  artifacts (``TUNE_*.json``, ``SYNTH_r*.json``, ``WATCH_r*.json``,
  ``PILOT_r*.json``) and of the OpenMetrics text.
- :mod:`tpu_aggcomm_torch.obs.export` — live telemetry: latency
  histograms, OpenMetrics rendering and the loopback ``/metrics``
  endpoint (``serve --metrics-port``, ``sweep --metrics-port``,
  ``TPU_AGGCOMM_METRICS_PORT``; off by default, never imported unless
  armed).
- :mod:`tpu_aggcomm_torch.obs.slo` — declarative SLO specs and the one
  burn-rate arithmetic.
- :mod:`tpu_aggcomm_torch.obs.watch` — the watchtower: the serve
  journal judged against an SLO spec, seeded changepoints, root-cause
  attribution (``WATCH_r*.json``), and the server's live burn-rate
  gauges (``LiveSlo``).

The package re-exports :func:`atomic_write`, as the reference's does.
"""

from tpu_aggcomm_torch.obs.atomic import atomic_write

__all__ = ["atomic_write"]
