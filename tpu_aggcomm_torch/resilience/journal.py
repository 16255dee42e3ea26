"""Crash-safe JSONL run journal — the resume substrate.

A journal is an append-only JSONL file with two line kinds:

- **session header** — ``{"journal": "resilience-journal-v1",
  "fingerprint": fp, "manifest": {...}, "created_unix": t}``: the v3
  ledger manifest of the process that wrote the following entries, plus
  its :func:`tune.cache.manifest_fingerprint` (so no drift ⟺ same
  fingerprint, the exact lens the tune cache and ``--check-regression``
  use).
- **entry** — ``{"key": {...}, "status": "done"|"fail",
  "fingerprint": fp, ...extras (shape_keys, artifacts, wall_s)}``: one
  completed (or failed) unit of work, keyed by the caller's full config
  dict — for sweeps that includes the fault spec, and the recorded
  ``shape_keys`` carry ``schedule_shape_key`` strings for provenance.

Crash safety is asymmetric by design: writes are append+flush+fsync
(never a whole-file rewrite — concurrent with a kill, the worst case is
one torn final line), and :meth:`RunJournal.entries` silently skips any
line that does not parse — a job killed mid-append loses at most the
entry being written, never the journal.

Resume semantics mirror the tune cache (tune/cache.py lookup): an entry
counts as completed only when its fingerprint matches the CURRENT
manifest's; on mismatch the drifted keys are NAMED (via
``diff_manifests`` against the stored session manifest) and the caller
re-runs the cell. jax-free throughout.
"""

from __future__ import annotations

import json
import os
import time

from tpu_aggcomm_torch.obs.ledger import diff_manifests

__all__ = ["JOURNAL_SCHEMA", "RunJournal"]

JOURNAL_SCHEMA = "resilience-journal-v1"


class RunJournal:
    """One journal file. Stateless between calls: every read re-scans
    the file, so concurrent appenders (a resumed job next to a
    straggling old one) see each other's completed entries."""

    def __init__(self, path: str):
        self.path = path

    # -- reading -----------------------------------------------------------
    def _scan(self) -> tuple[dict, list[dict]]:
        """(headers: fingerprint -> manifest, entries). Torn/corrupt
        lines are skipped — crash-safety is the reader's job."""
        headers: dict = {}
        entries: list[dict] = []
        try:
            fh = open(self.path)
        except OSError:
            return headers, entries
        with fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict):
                    continue
                if rec.get("journal") == JOURNAL_SCHEMA:
                    fp = rec.get("fingerprint")
                    if fp is not None:
                        headers[fp] = rec.get("manifest")
                elif isinstance(rec.get("key"), dict):
                    entries.append(rec)
        return headers, entries

    def entries(self) -> list[dict]:
        return self._scan()[1]

    def sessions(self) -> dict:
        """fingerprint -> manifest for every session header in the file
        — the lens :mod:`tpu_aggcomm.serve.recover` names drift through
        when a ``--recover`` pre-warm meets entries written by a
        different environment."""
        return self._scan()[0]

    # -- writing -----------------------------------------------------------
    def _append(self, rec: dict) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def begin_session(self, manifest: dict | None) -> str:
        """Record this process's manifest (once per fingerprint) and
        return the fingerprint to stamp entries with."""
        from tpu_aggcomm_torch.tune.cache import manifest_fingerprint
        fp = manifest_fingerprint(manifest)
        headers, _ = self._scan()
        if fp not in headers:
            self._append({"journal": JOURNAL_SCHEMA, "fingerprint": fp,
                          "manifest": manifest,
                          "created_unix": time.time()})
        return fp

    def record(self, key: dict, *, fingerprint: str, status: str = "done",
               **extra) -> dict:
        """Append one entry (``extra``: shape_keys, artifacts, wall_s…;
        None values dropped, record_compile discipline)."""
        rec = {"key": dict(key), "status": str(status),
               "fingerprint": str(fingerprint)}
        for k, v in extra.items():
            if v is not None:
                rec[k] = v
        self._append(rec)
        return rec

    # -- resume ------------------------------------------------------------
    def completed(self, key: dict, *, fingerprint: str,
                  manifest: dict | None = None
                  ) -> tuple[bool, str | None]:
        """Is ``key`` done under the CURRENT environment?

        ``(True, None)`` — a ``status="done"`` entry exists with a
        matching fingerprint. ``(False, reason)`` — entries exist only
        under a different fingerprint: ``reason`` names the drifted
        manifest keys (tune-cache semantics; re-run the cell).
        ``(False, None)`` — no entry at all."""
        headers, entries = self._scan()
        stale_fp = None
        for rec in entries:
            if rec.get("key") != key or rec.get("status") != "done":
                continue
            if rec.get("fingerprint") == fingerprint:
                return True, None
            stale_fp = rec.get("fingerprint")
        if stale_fp is None:
            return False, None
        drift = diff_manifests(headers.get(stale_fp), manifest)
        keys = ", ".join(d["key"] for d in drift[:4]) or \
            f"fingerprint {stale_fp} != {fingerprint}"
        more = f" (+{len(drift) - 4} more)" if len(drift) > 4 else ""
        return False, (f"manifest drift vs journal entry: {keys}{more} "
                       f"— re-running")

    def seen(self, key: dict) -> bool:
        """Any entry (any status, any fingerprint) for ``key``? Callers
        use this to decide whether the journal is authoritative over
        legacy completion heuristics for a cell."""
        return any(rec.get("key") == key for rec in self.entries())
