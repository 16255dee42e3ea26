"""The manifest fingerprint of ``tpu_aggcomm/tune/cache.py``.

Only :func:`manifest_fingerprint` is copied: the run journal
(:mod:`tpu_aggcomm_torch.resilience.journal`) stamps every sweep cell
with it. The ``TUNE_*.json`` cache waits for the tuner's port.
"""

from __future__ import annotations

import hashlib
import json

from tpu_aggcomm_torch.obs.ledger import DRIFT_IGNORE, _flatten

__all__ = ["manifest_fingerprint"]


def manifest_fingerprint(manifest: dict | None) -> str:
    """Stable hex digest of the drift-relevant manifest content.

    Flattened keys with a ``DRIFT_IGNORE`` prefix (timestamps, the
    tunnel's per-run RPC probe, the git sha) are excluded — the same
    exclusions ``diff_manifests`` applies, so two manifests share a
    fingerprint exactly when the ledger would report no drift between
    them."""
    flat = _flatten(manifest or {})
    items = sorted((k, v) for k, v in flat.items()
                   if not k.startswith(DRIFT_IGNORE))
    blob = json.dumps(items, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
