"""Schedule synthesizer: generate, prove, price, and race new
aggregator schedules (the HiCCL-style composition of primitives, arxiv
2408.05962), copied from ``tpu_aggcomm/synth/`` (import paths rewritten).

Primitives emit per-rank op programs in the Schedule IR, the search
prunes with ``analysis/check.py`` verdicts and ``obs/traffic.py`` bounds,
prices with ``model/predict.py``, and the measured arbitration rides the
tuner's seeded racing on ``torch_sim`` (``tune/measure.py`` — the only
torch on the path, and only when a race is measured). The search, the
registration and ``synth --replay`` import no torch; ``run_synth``'s
``backend`` defaults to ``torch_sim``, the port's name for the
reference's ``jax_sim``.
"""

from tpu_aggcomm_torch.synth.artifact import (SYNTH_SCHEMA, load_artifact,
                                        next_artifact_path,
                                        reference_methods, replay_artifact,
                                        run_synth, save_artifact)
from tpu_aggcomm_torch.synth.primitives import (Composition, CompositionError,
                                          build_schedule,
                                          parse_composition)
from tpu_aggcomm_torch.synth.register import (SYNTH_ID_BASE, RegisterError,
                                        ensure_registered,
                                        register_composition,
                                        registered_synth_ids)
from tpu_aggcomm_torch.synth.search import SearchError, enumerate_space, search

__all__ = ["Composition", "CompositionError", "parse_composition",
           "build_schedule", "SearchError", "enumerate_space", "search",
           "SYNTH_ID_BASE", "RegisterError", "register_composition",
           "registered_synth_ids", "ensure_registered", "SYNTH_SCHEMA",
           "run_synth", "save_artifact", "load_artifact",
           "replay_artifact", "next_artifact_path", "reference_methods"]
