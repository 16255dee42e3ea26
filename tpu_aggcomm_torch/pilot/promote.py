"""Promotion records: the ONLY currency a live method swap accepts.

A promotion is data, not a side effect: one validated record carries
everything needed to apply it, audit it and REVERSE it — the old and
new method ids and cids, the canonical composition string (when the
winner is synthesized), the seeded-bootstrap win CI, and the manifest
fingerprint of the environment that measured the win. The serve layer's
``swap`` op refuses anything that fails :func:`validate_promotion_record`
(and re-verifies the new method byte-exact through its normal queue
before installing); ``demote`` re-installs the old entry by the SAME
record. torch-free on both sides — the server's control plane and the
planner share this module.

The copy of ``tpu_aggcomm/pilot/promote.py`` (import paths rewritten,
nothing else changed).
"""

from __future__ import annotations

import json

__all__ = ["PromotionError", "make_promotion_record",
           "validate_promotion_record", "promotion_sig_fields",
           "records_equal"]


class PromotionError(ValueError):
    """A promotion record the server must refuse, with the field named."""


#: (key, required type(s)) — the record schema both sides enforce.
_RECORD_FIELDS = (
    ("shape", dict), ("backend", str),
    ("old_method", int), ("old_cid", str),
    ("new_method", int), ("new_cid", str),
    ("win_ci_pct", list), ("seed", int),
    ("alpha", float), ("n_boot", int),
    ("fingerprint", str),
)


def promotion_sig_fields(record: dict) -> dict:
    """The request-shape dict a promotion overrides — exactly the serve
    journal's admitted ``shape`` block (protocol shape_fields)."""
    return dict(record["shape"])


def make_promotion_record(target: dict, campaign: dict, *,
                          fingerprint: str,
                          artifact: str | None = None) -> dict:
    """Build the record for one improved campaign. Raises
    :class:`PromotionError` when the campaign does not support one
    (no win, winner == incumbent) — a record must never exist without
    its evidence."""
    if not campaign.get("improved"):
        raise PromotionError(
            f"campaign for {campaign.get('incumbent_cid')} is not an "
            f"improvement (win CI {campaign.get('win_ci_pct')}) — no "
            f"promotion record to make")
    winner = campaign["winner"]
    record = {
        "shape": dict(target["shape"]),
        "backend": target["backend"],
        "old_method": int(target["shape"]["method"]),
        "old_cid": campaign["incumbent_cid"],
        "new_method": int(winner["method_id"]),
        "new_cid": winner["cid"],
        "composition": winner.get("composition"),
        "win_ci_pct": list(campaign["win_ci_pct"]),
        "seed": int(campaign["race"]["seed"]),
        "alpha": float(campaign["race"]["alpha"]),
        "n_boot": int(campaign["race"]["n_boot"]),
        "fingerprint": str(fingerprint),
        "artifact": artifact,
    }
    problems = validate_promotion_record(record)
    if problems:
        raise PromotionError("; ".join(problems))
    return record


def validate_promotion_record(record) -> list[str]:
    """Every reason this record must be refused, by name (empty = ok).
    Pure structural+logical validation — fingerprint drift vs a LIVE
    server is the server's own check (it knows its fingerprint)."""
    if not isinstance(record, dict):
        return [f"promotion record must be a JSON object, got "
                f"{type(record).__name__}"]
    problems: list[str] = []
    for key, typ in _RECORD_FIELDS:
        v = record.get(key)
        if isinstance(v, bool) or not isinstance(
                v, (int, float) if typ is float else typ):
            problems.append(f"record field {key!r} must be "
                            f"{typ.__name__}, got {v!r}")
    if problems:
        return problems
    shape = record["shape"]
    for f in ("method", "nprocs", "cb_nodes", "comm_size"):
        if not isinstance(shape.get(f), int):
            problems.append(f"record shape is missing an integer "
                            f"{f!r} field")
    if not problems and shape["method"] != record["old_method"]:
        problems.append(
            f"record shape carries method {shape['method']} but "
            f"old_method is {record['old_method']} — the override must "
            f"key the OLD request shape")
    if record["new_method"] == record["old_method"]:
        problems.append(f"new_method == old_method "
                        f"({record['old_method']}) — a no-op swap is "
                        f"refused, not silently applied")
    ci = record["win_ci_pct"]
    if len(ci) != 2 or not all(isinstance(x, (int, float))
                               and not isinstance(x, bool) for x in ci):
        problems.append(f"win_ci_pct must be [lo, hi] numbers, got "
                        f"{ci!r}")
    elif not ci[0] > 0:
        problems.append(
            f"win CI [{ci[0]:.3f}%, {ci[1]:.3f}%] does not exclude "
            f"zero on the win side — an unproven win never promotes "
            f"(the seeded-bootstrap gate, obs.metrics.bootstrap_delta_ci)")
    from tpu_aggcomm_torch.synth.register import SYNTH_ID_BASE
    comp = record.get("composition")
    if record["new_method"] > SYNTH_ID_BASE:
        if not isinstance(comp, str) or not comp:
            problems.append(
                f"new_method {record['new_method']} is synthesized "
                f"(> SYNTH_ID_BASE={SYNTH_ID_BASE}) but the record "
                f"carries no canonical composition string — an "
                f"unregisterable promotion cannot be reversed or "
                f"re-applied")
    elif comp is not None:
        problems.append(f"new_method {record['new_method']} is a "
                        f"reference id but the record carries "
                        f"composition {comp!r}")
    return problems


def records_equal(a: dict, b: dict) -> bool:
    """Byte-level record identity (demotion must present the SAME
    record that promoted — never a lookalike)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
