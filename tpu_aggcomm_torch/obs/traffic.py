"""``tpu_aggcomm/obs/traffic.py`` is not ported yet (ROADMAP.md, queue A
item 4). The flight recorder imports ``round_traffic`` lazily; calling it
raises :class:`NotPortedError` by name rather than an ImportError."""

from __future__ import annotations

__all__ = ["round_traffic"]


def round_traffic(schedule, *args, **kwargs):
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    raise NotPortedError(
        "tpu_aggcomm_torch.obs.traffic.round_traffic is not ported yet "
        "(ROADMAP.md, queue A item 4); run it on the reference package")
