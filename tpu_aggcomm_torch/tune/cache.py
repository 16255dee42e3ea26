"""The tuned-schedule cache: persistent ``TUNE_*.json`` artifacts.

One artifact per ``(shape, direction, backend)`` key, stamped with a
**manifest fingerprint** derived from the v3 run ledger
(obs/ledger.py): sha256 over the flattened manifest minus the
``DRIFT_IGNORE`` prefixes, i.e. exactly the keys ``diff_manifests``
considers drift. By construction: no drift between two manifests ⟺
identical fingerprints — so a jax/libtpu/device-kind change invalidates
the cache entry through the same lens ``--check-regression`` uses to
explain deltas, and :func:`lookup` reports WHICH keys drifted instead
of a bare miss.

Artifact schema (``"tune-v1"``, validated by
``obs/regress.validate_tune`` and ``scripts/check_bench_schema.py``)::

    {"schema": "tune-v1",
     "key": {nprocs, data_size, proc_node, direction, backend,
             fingerprint},
     "manifest": {...v3 ledger manifest...},
     "space": {methods, cb_nodes, comm_sizes, agg_types},
     "race": {seed, alpha, n_boot, max_batches, batch_trials, order,
              samples: {cid: [[trial s, ...], ...]},
              eliminations: [...], winner, batches_run, survivors},
     "winner": {method, cb_nodes, comm_size, agg_type},
     "synthetic": bool, "created_unix": float}

Everything here is jax-free (stdlib + obs/ledger): the ``--auto``
resolution path and ``cli tune --replay`` run where jax may not import.
Like every committed artifact, the stored manifest records arming env
vars by NAME only (harness.hostenv.env_summary) — pool IPs never land
in a TUNE file.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import time

from tpu_aggcomm_torch.obs.ledger import DRIFT_IGNORE, _flatten, diff_manifests

__all__ = ["TUNE_SCHEMA", "manifest_fingerprint", "tune_key",
           "artifact_path", "save_tune", "load_tune", "lookup",
           "tune_paths"]

#: The artifact schema tag (versioned like the bench parsed-schema
#: v2/v3 generations; obs/regress.validate_tune pins the shape).
TUNE_SCHEMA = "tune-v1"


def manifest_fingerprint(manifest: dict | None) -> str:
    """Stable hex digest of the drift-relevant manifest content.

    Flattened keys with a ``DRIFT_IGNORE`` prefix (timestamps, the
    tunnel's per-run RPC probe, the git sha) are excluded — the same
    exclusions ``diff_manifests`` applies, so two manifests share a
    fingerprint exactly when the ledger would report no drift between
    them."""
    flat = _flatten(manifest or {})
    items = sorted((k, v) for k, v in flat.items()
                   if not k.startswith(DRIFT_IGNORE))
    blob = json.dumps(items, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def tune_key(*, nprocs: int, data_size: int, proc_node: int,
             direction: str, backend: str,
             manifest: dict | None = None) -> dict:
    """The cache key for one tuning context. ``fingerprint`` binds the
    entry to the environment that measured it."""
    return {"nprocs": int(nprocs), "data_size": int(data_size),
            "proc_node": int(proc_node), "direction": str(direction),
            "backend": str(backend),
            "fingerprint": manifest_fingerprint(manifest)}


def artifact_path(root: str, key: dict) -> str:
    """Deterministic artifact filename for a key (fingerprint excluded:
    a re-tune after an environment change REPLACES the stale entry for
    the same shape instead of accumulating unreachable ones)."""
    d = "a2m" if key["direction"] == "all_to_many" else "m2a"
    name = (f"TUNE_{key['backend']}_n{key['nprocs']}"
            f"_d{key['data_size']}_p{key['proc_node']}_{d}.json")
    return os.path.join(root, name)


def tune_paths(root: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, "TUNE_*.json")))


def save_tune(root: str, *, key: dict, manifest: dict | None,
              space: dict, race: dict, winner: dict,
              synthetic: bool = False,
              model_prune: dict | None = None) -> str:
    blob = {"schema": TUNE_SCHEMA, "key": dict(key),
            "manifest": manifest, "space": dict(space),
            "race": dict(race), "winner": dict(winner),
            "synthetic": bool(synthetic),
            "created_unix": time.time()}
    if model_prune is not None:
        # the --model-prune record (cli._model_prune): which committed
        # PREDICT artifact priced the grid, at what margin, and the
        # resulting kept/pruned split — enough for --replay to re-derive
        # the split with no model import
        blob["model_prune"] = dict(model_prune)
    path = artifact_path(root, key)
    from tpu_aggcomm_torch.obs.atomic import atomic_write
    with atomic_write(path) as fh:
        json.dump(blob, fh, indent=1)
        fh.write("\n")
    return path


def load_tune(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def lookup(root: str, key: dict, *,
           manifest: dict | None = None) -> tuple[dict | None, str | None]:
    """Resolve a tuned entry for ``key``: ``(entry, None)`` on a hit,
    ``(None, reason)`` on a miss — where ``reason`` distinguishes "no
    artifact", "schema-invalid artifact" and "manifest drift" (with the
    drifted keys named), because ``--auto``'s fallback warning must say
    WHY the cache did not serve."""
    path = artifact_path(root, key)
    if not os.path.exists(path):
        return None, f"no tuned entry at {path}"
    try:
        entry = load_tune(path)
    except (OSError, ValueError) as e:
        return None, f"unreadable tune artifact {path}: {e}"
    from tpu_aggcomm_torch.obs.regress import validate_tune
    errors = validate_tune(entry, os.path.basename(path))
    if errors:
        return None, (f"invalid tune artifact {path}: {errors[0]}"
                      + (f" (+{len(errors) - 1} more)"
                         if len(errors) > 1 else ""))
    ekey = entry.get("key", {})
    for k in ("nprocs", "data_size", "proc_node", "direction", "backend"):
        if ekey.get(k) != key.get(k):
            return None, (f"tune artifact {path} is for a different "
                          f"context ({k}={ekey.get(k)!r}, want "
                          f"{key.get(k)!r})")
    want = key.get("fingerprint")
    have = ekey.get("fingerprint")
    if want is not None and have != want:
        drift = diff_manifests(entry.get("manifest"), manifest)
        keys = ", ".join(d["key"] for d in drift[:4]) or "unknown keys"
        more = f" (+{len(drift) - 4} more)" if len(drift) > 4 else ""
        return None, (f"manifest drift vs tuned entry {path}: "
                      f"{keys}{more} — re-tune in this environment")
    return entry, None
