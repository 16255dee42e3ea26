"""Round-boundary-only cancellation, copied from
``tpu_aggcomm/resilience/watchdog.py`` (lines 40-117).

Inside :func:`safe_cancellation`, SIGINT/SIGTERM set a deferred flag
instead of interrupting; the sweep calls :func:`check_boundary` between
cells and the pending cancellation materializes there as
:class:`CancelledAtBoundary`, after the program in flight has finished.
A second SIGINT restores the default handler. The soft deadlines of the
reference module are not ported, and the deferral message names the
boundary without the reference's TPU-tunnel reason.
"""

from __future__ import annotations

import signal
import sys
import threading

from tpu_aggcomm_torch.obs import ledger, trace

__all__ = ["CancelledAtBoundary", "safe_cancellation", "check_boundary",
           "cancellation_pending"]


class CancelledAtBoundary(RuntimeError):
    """A deferred SIGINT/SIGTERM honored at a round boundary."""


# Module-level state: one cancellation scope per process (signal
# handlers are process-global anyway).
_STATE = {"active": False, "pending": None, "sigint_count": 0}


class safe_cancellation:
    """Context manager deferring SIGINT/SIGTERM to round boundaries.

    Only installs handlers on the main thread (signal.signal raises
    elsewhere); off the main thread it is a transparent no-op and
    Python's default delivery applies."""

    def __enter__(self):
        self._installed = []
        if threading.current_thread() is not threading.main_thread():
            return self
        _STATE.update(active=True, pending=None, sigint_count=0)
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                old = signal.signal(sig, _defer_signal)
            except (ValueError, OSError):
                continue
            self._installed.append((sig, old))
        return self

    def __exit__(self, *exc):
        for sig, old in self._installed:
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        _STATE.update(active=False, pending=None, sigint_count=0)
        return False


def _defer_signal(signum, frame) -> None:
    name = signal.Signals(signum).name
    if signum == signal.SIGINT:
        _STATE["sigint_count"] += 1
        if _STATE["sigint_count"] >= 2:
            # the operator insists: restore default delivery and raise —
            # the documented escape hatch for a genuinely hung program
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
    _STATE["pending"] = name
    print(f"# {name} received: deferring cancellation to the next round "
          f"boundary, after the program in flight has finished"
          + ("; press Ctrl-C again to force" if signum == signal.SIGINT
             else ""),
          file=sys.stderr, flush=True)


def cancellation_pending() -> str | None:
    """The deferred signal name, if one arrived inside the scope."""
    return _STATE["pending"] if _STATE["active"] else None


def check_boundary(label: str) -> None:
    """Honor a deferred cancellation HERE (a round/cell boundary: no
    program in flight). No-op — one dict lookup — otherwise."""
    sig = cancellation_pending()
    if sig is None:
        return
    rec = ledger.record_resilience(label, kind="cancel", signal=sig)
    trace.instant("ledger.resilience", **rec)
    _STATE["pending"] = None
    raise CancelledAtBoundary(
        f"cancelled at round boundary {label} (deferred {sig}); "
        f"re-run with --resume to continue from the journal")
