"""The serve workload profiler's phase boundaries, and only those.

``tpu_aggcomm/obs/workload.py`` is the read side of the serve journal.
The port has no serve layer yet, so this module holds just the one name
the Perfetto export imports from it: :data:`BOUNDARIES`, copied
verbatim (``obs/perfetto.to_chrome_trace`` lays ``serve.request``
instants out along it). The rest of the profiler comes with the serve
slice (ROADMAP.md queue A item 5).
"""

from __future__ import annotations

__all__ = ["BOUNDARIES"]

#: Canonical phase-boundary order, as stamped by serve/server.py
#: (_Pending.marks). "admit" is always 0.0 (stamps are relative to the
#: admission monotonic clock read); each later boundary's phase
#: duration is the time since the PREVIOUS RECORDED boundary, so a
#: request shed mid-flight attributes honestly over the prefix it
#: actually traversed.
BOUNDARIES = ("admit", "queue", "batch", "cache", "dispatch", "respond")
