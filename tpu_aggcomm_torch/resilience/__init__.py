"""The resume substrate of ``sweep``, copied from
``tpu_aggcomm/resilience``:

- :mod:`tpu_aggcomm_torch.resilience.journal` — the crash-safe JSONL run
  journal keyed by a cell's config and the manifest fingerprint
  (``sweep --resume``);
- :mod:`tpu_aggcomm_torch.resilience.watchdog` — cancellation only at a
  cell boundary (``CancelledAtBoundary``, exit 130).

The retry policy, the soft deadlines and fault detection are not ported.
"""

from tpu_aggcomm_torch.resilience.journal import RunJournal
from tpu_aggcomm_torch.resilience.watchdog import (CancelledAtBoundary,
                                                   check_boundary,
                                                   safe_cancellation)

__all__ = ["RunJournal", "CancelledAtBoundary", "check_boundary",
           "safe_cancellation"]
