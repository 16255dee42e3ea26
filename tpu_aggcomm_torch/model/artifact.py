"""PREDICT_*.json — the committed cost-model artifact (schema
``predict-v1``), the loading half.

The part of ``tpu_aggcomm/model/artifact.py`` that the tuner's
``--model-prune``, the synthesizer's pricing and ``--auto``'s fault
advisory need, copied (import paths rewritten): :func:`load_artifact`
and :func:`newest_artifact`. Building and replaying an artifact
(``build_artifact``, ``replay_artifact``) need the calibration and fit
(``model/{calibrate,fit,explain,validate}``), which are not ported
(ROADMAP.md, "What is still unported").
"""

from __future__ import annotations

import json

__all__ = ["PREDICT_SCHEMA", "load_artifact", "newest_artifact"]

PREDICT_SCHEMA = "predict-v1"


def load_artifact(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def newest_artifact(root: str = ".") -> dict | None:
    """Newest committed PREDICT_*.json under ``root``, loaded — or None
    (callers that can live without a model must keep working)."""
    from tpu_aggcomm_torch.model.predict import newest_predict_path
    path = newest_predict_path(root)
    if path is None:
        return None
    try:
        return load_artifact(path)
    except (OSError, ValueError):
        return None
