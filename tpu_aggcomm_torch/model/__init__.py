"""The analytic cost model's pricing half, as the port uses it.

Copied from ``tpu_aggcomm/model`` (import paths rewritten), what the
``deadline_floor`` pre-shed of :mod:`tpu_aggcomm_torch.serve.server`, the
tuner's ``--model-prune``, the synthesizer's ranking and ``--auto``'s
fault advisory need: the static schedule features (:mod:`~tpu_aggcomm_
torch.model.features`), the predictions over a ``PREDICT_*.json``
platform entry (:mod:`~tpu_aggcomm_torch.model.predict`) and the
artifact's loader (:mod:`~tpu_aggcomm_torch.model.artifact`).
Calibration, fitting, ``inspect explain`` and building an artifact are
not ported. The committed ``PREDICT_*.json`` holds ``cpu`` and ``tpu``
entries only; every consumer in the port reads the entry of its own
platform (``gpu`` on the card, ``cpu`` on the CPU), so on the card the
model stays off, and says so, until a ``gpu`` calibration exists.
"""

from tpu_aggcomm_torch.model.features import (PARAM_NAMES,
                                              SPILL_THRESHOLD_BYTES,
                                              round_features,
                                              schedule_features)
from tpu_aggcomm_torch.model.artifact import (PREDICT_SCHEMA,
                                              load_artifact,
                                              newest_artifact)
from tpu_aggcomm_torch.model.predict import (floor_from_features,
                                             newest_predict_path,
                                             predict_candidates,
                                             predict_schedule)

__all__ = ["PARAM_NAMES", "SPILL_THRESHOLD_BYTES", "round_features",
           "schedule_features", "floor_from_features", "newest_predict_path",
           "predict_schedule", "predict_candidates", "PREDICT_SCHEMA",
           "load_artifact", "newest_artifact"]
