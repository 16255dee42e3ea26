"""Observability of the port, as far as its ported layers need it.

- :mod:`tpu_aggcomm_torch.obs.trace` — the flight recorder, copied from
  ``tpu_aggcomm/obs/trace.py``; the ``local`` oracle records its
  deliveries into it. Off unless enabled; ``--trace`` stays refused by
  name until ROADMAP.md queue A item 4.
- :mod:`tpu_aggcomm_torch.obs.ledger` — the environment manifest the
  run journal fingerprints (python, torch, CUDA, nvcc, the card, the git
  sha), its drift diff, and the resilience records.

``perfetto``, ``atomic`` and ``traffic`` hold the names the recorder
imports lazily; each raises :class:`NotPortedError` when called.
"""
