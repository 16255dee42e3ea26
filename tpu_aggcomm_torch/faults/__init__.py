"""Fault-injection subsystem: declarative degradation scenarios.

The copy of ``tpu_aggcomm/faults``, in three layers:

- **spec** (``faults/spec.py``): the declarative fault model,
  ``FaultSpec`` parsed from ``--fault "slow:r3*4.0,deadlink:5>2,deadagg:a1"``;
- **repair** (``faults/repair.py``): the schedule-repair pass that
  reroutes traffic around dead links (a detour through a live relay and
  its staging row) and dead aggregators (fallback election);
- **inject** (``faults/inject.py``, numpy only): how backends realize a
  spec at execution time, the slow-rank delay-loop counts and the
  dead-edge masks of unrepaired runs.
"""

from tpu_aggcomm_torch.faults.spec import (FaultSpec, FaultSpecError,
                                           parse_fault, parse_synthetic)
from tpu_aggcomm_torch.faults.repair import RepairError, repair_schedule

__all__ = ["FaultSpec", "FaultSpecError", "parse_fault", "parse_synthetic",
           "RepairError", "repair_schedule"]
