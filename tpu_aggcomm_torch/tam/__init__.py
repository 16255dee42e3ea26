"""TAM — the hierarchical two-level aggregation engine (m=15/16). See
:mod:`tpu_aggcomm_torch.tam.engine`."""

from tpu_aggcomm_torch.tam.engine import TamMethod, gen_tam_schedule

__all__ = ["TamMethod", "gen_tam_schedule"]
