"""``tpu_aggcomm/obs/atomic.py`` is not ported yet (ROADMAP.md, queue A
item 4). The flight recorder imports ``atomic_write`` lazily; calling it
raises :class:`NotPortedError` by name rather than an ImportError."""

from __future__ import annotations

__all__ = ["atomic_write"]


def atomic_write(path, *args, **kwargs):
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    raise NotPortedError(
        "tpu_aggcomm_torch.obs.atomic.atomic_write is not ported yet "
        "(ROADMAP.md, queue A item 4); run it on the reference package")
