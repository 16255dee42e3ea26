"""TAM — the hierarchical two-level aggregation engine (m=15/16), see
:mod:`tpu_aggcomm_torch.tam.engine`, and the variable-size workload
engines the ``tam`` subcommand drives, see
:mod:`tpu_aggcomm_torch.tam.workload_engines`."""

from tpu_aggcomm_torch.tam.engine import TamMethod, gen_tam_schedule

__all__ = ["TamMethod", "gen_tam_schedule"]
