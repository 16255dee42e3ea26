"""Static analysis: the schedule model checker.

:mod:`tpu_aggcomm_torch.analysis.check`, copied from
``tpu_aggcomm/analysis/check.py`` (import paths rewritten), is a symbolic
per-rank executor over ``Schedule.programs`` that builds the waits-for
event graph (blocking SEND/RECV, ISSEND rendezvous coupling, WAITALL
token subsets, BARRIER joins) and PROVES, or REFUTES with a named
witness: deadlock-freedom (the offending cycle is named), recv-slot
race-freedom, byte conservation, barrier SPMD symmetry and round-fence
monotonicity — for healthy AND fault-repaired schedules. The properties
mirror ``backends/local.py`` semantics exactly, so a static REFUTED
agrees with a runtime ``DeadlockError`` / ``VerificationError``. The
schedule synthesizer prunes its search with these verdicts.

The reference's other half, ``analysis/lint.py``, lints the JAX
package's own purity rules and is not part of the port. No torch here.
"""

from tpu_aggcomm_torch.analysis.check import (CheckError, check_schedule,
                                              check_sweep, render_check,
                                              render_check_sweep)

__all__ = ["CheckError", "check_schedule", "check_sweep", "render_check",
           "render_check_sweep"]
