"""Autopilot: the online control loop over the serve layer.

The copy of ``tpu_aggcomm/pilot/`` (import paths rewritten). The pilot
closes the loop the offline tools left open: the workload profiler
(obs/workload.py) *measures* traffic, the watchtower (obs/watch.py)
*judges* it, the synthesizer (synth/) *invents* schedules and the tuner
(tune/) *races* them — the pilot chains those into detection → campaign
→ promotion, every step a recorded, replayable artifact
(``PILOT_r*.json``, pilot-v1).

Discipline:

- **torch-free planner** — tailing, target folding, campaign search,
  promotion records and artifact replay never import torch; only the
  measured race's sampler goes through ``tune/measure.py``'s
  ``torch_sim`` sampler on the pilot's ``device`` (and a synthetic
  sampler covers the smoke path).
- **Advisory until proven** — a campaign winner changes NOTHING until
  (a) its seeded-bootstrap latency win's CI excludes zero and (b) the
  serve layer verified the new method byte-exact against the local
  oracle through its normal queue. Predictions and proposals never
  gate; measured, verified wins do.
- **Named, reversible promotions** — every cache swap traces to a
  validated promotion record (old id, new id, composition, win CI,
  manifest fingerprint) journaled by the server; demotion re-installs
  the old entry by the same record. Zero silent method changes.

The port's departures: a proposal with no backend folds to
``torch_sim`` (plan.py); the measured sampler is the port's
``torch_sim`` sampler on ``run_pilot``'s ``device``, and an offline
pass fingerprints ``ledger.manifest(device=...)`` (artifact.py); and an
artifact records each proposal's ``cli`` hint in the reference's
spelling, the wire form of pilot-v1, so that an artifact replays under
both packages (artifact.py:func:`wire_proposals`).
"""

from tpu_aggcomm_torch.pilot.artifact import (PILOT_SCHEMA, load_pilot,
                                        next_pilot_path, render_pilot,
                                        replay_pilot, run_pilot,
                                        write_pilot)
from tpu_aggcomm_torch.pilot.campaign import CampaignError, run_campaign
from tpu_aggcomm_torch.pilot.plan import PilotError, fold_targets
from tpu_aggcomm_torch.pilot.promote import (PromotionError,
                                       make_promotion_record,
                                       validate_promotion_record)

__all__ = ["PILOT_SCHEMA", "PilotError", "CampaignError",
           "PromotionError", "fold_targets", "run_campaign",
           "make_promotion_record", "validate_promotion_record",
           "run_pilot", "write_pilot", "replay_pilot",
           "load_pilot", "render_pilot", "next_pilot_path"]
