"""``tpu_aggcomm/obs/perfetto.py`` is not ported yet (ROADMAP.md, queue A
item 4). The flight recorder imports ``to_chrome_trace`` lazily; calling it
raises :class:`NotPortedError` by name rather than an ImportError."""

from __future__ import annotations

__all__ = ["to_chrome_trace"]


def to_chrome_trace(events, *args, **kwargs):
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    raise NotPortedError(
        "tpu_aggcomm_torch.obs.perfetto.to_chrome_trace is not ported yet "
        "(ROADMAP.md, queue A item 4); run it on the reference package")
