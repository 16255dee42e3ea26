"""Prediction: price a schedule with calibrated platform parameters.

The part of ``tpu_aggcomm/model/predict.py`` the port needs, copied
(import paths rewritten): :func:`floor_from_features` (the lower-bound
seconds of one rep; the serve layer's ``deadline_floor`` pre-shed and the
synthesizer's pricing), :func:`newest_predict_path` (the newest committed
``PREDICT_*.json``), :func:`predict_rounds` and :func:`predict_schedule`
(``--auto``'s fault advisory) and :func:`predict_candidates` (``tune
--model-prune``). The trace-summary floors come with ``inspect``.
"""

from __future__ import annotations

import glob
import os

__all__ = ["predict_schedule", "predict_rounds", "floor_from_features",
           "newest_predict_path", "predict_candidates"]


def _coef(params: dict) -> tuple[float, float, float, float, float]:
    from tpu_aggcomm_torch.model.features import PARAM_NAMES
    return tuple(float(params.get(k) or 0.0) for k in PARAM_NAMES)


def predict_rounds(per_round: list[dict], params: dict,
                   slow_factors: dict | None = None) -> list[dict]:
    """Per-round predictions over ``model.features.round_features``
    output. Each entry::

        {"round", "wall_s", "components": {"fence", "bytes",
         "bottleneck", "spill"}, "critical_rank", "per_rank_s",
         "slow_wall_s"}

    ``slow_wall_s`` is None when no slow clause is injected, else the
    smear ceiling ``wall * max(multipliers)`` — see the module
    docstring for why the envelope covers every round."""
    _rpc, fence, by_kb, bot_kb, sp_kb = _coef(params)
    slow_factors = slow_factors or {}
    max_factor = max(slow_factors.values()) if slow_factors else None
    out = []
    for rf in per_round:
        comp = {"fence": fence,
                "bytes": rf["bytes"] / 1e3 * by_kb,
                "bottleneck": rf["bottleneck"] / 1e3 * bot_kb,
                "spill": rf["spill"] / 1e3 * sp_kb}
        wall = comp["fence"] + comp["bytes"] + comp["bottleneck"] \
            + comp["spill"]
        shared = comp["fence"] + comp["bytes"]
        per_rank = {}
        for rank, io in rf["io"].items():
            own = io / 1e3 * bot_kb
            if rank == rf["hot_dst"]:
                own += rf["spill"] / 1e3 * sp_kb
            per_rank[rank] = shared + own
        critical = max(per_rank, key=lambda r: (per_rank[r], -r)) \
            if per_rank else None
        slow_wall = wall * max_factor if max_factor is not None else None
        out.append({"round": rf["round"], "wall_s": wall,
                    "components": comp, "critical_rank": critical,
                    "per_rank_s": per_rank, "slow_wall_s": slow_wall})
    return out


def predict_schedule(schedule, params: dict, *, fault=None) -> dict:
    """Predicted cost of one compiled schedule under one platform's
    parameters: ``{"rounds": [...], "total_s", "rpc_s", "fault"}``.

    ``fault`` (a spec string or FaultSpec) contributes its slow
    multipliers; dead links / dead aggregators must already be in the
    schedule (pass the REPAIRED schedule — the detour rounds are then
    priced like any other rounds, which is the whole point: detour
    inflation is attributed, not mysterious)."""
    from tpu_aggcomm_torch.faults.spec import parse_fault
    from tpu_aggcomm_torch.model.features import round_features

    spec = parse_fault(fault) if isinstance(fault, (str, type(None))) \
        else fault
    rounds = predict_rounds(round_features(schedule), params,
                            spec.slow_factors() if spec else None)
    rpc = _coef(params)[0]
    return {"rounds": rounds, "rpc_s": rpc,
            "total_s": rpc + sum(r["wall_s"] for r in rounds),
            "fault": spec.canonical() if spec and not spec.empty
            else None}


def floor_from_features(feats: dict, params: dict) -> float:
    """Lower-bound seconds for one rep from (possibly partial)
    features: rpc + per-round fence + aggregate bandwidth. Bottleneck
    and spill terms are included when the features carry them, so full
    features give the full prediction and ``round_traffic``-derived
    features give an honest floor."""
    rpc, fence, by_kb, bot_kb, sp_kb = _coef(params)
    total = rpc
    for rf in feats["per_round"]:
        total += fence + rf["bytes"] / 1e3 * by_kb \
            + rf["bottleneck"] / 1e3 * bot_kb + rf["spill"] / 1e3 * sp_kb
    return total


def predict_candidates(cands, params: dict, *, nprocs: int,
                       data_size: int, proc_node: int = 1) -> dict:
    """Predicted seconds/rep for each tune candidate (tune/space.py
    ``Candidate`` objects) from static features alone — the
    multi-fidelity estimate ``tune --model-prune`` races against.
    Pattern construction mirrors ``tune/measure.py`` exactly, so the
    model prices the very schedule the sampler would measure.

    Returns ``{cid: predicted_s | None}``; a candidate whose schedule
    refuses feature extraction (the TAM relay's ``TrafficError``) maps
    to None — the tuner must RACE what the model cannot price, never
    silently drop it."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.model.features import schedule_features
    from tpu_aggcomm_torch.obs.traffic import TrafficError

    out = {}
    for c in cands:
        pattern = AggregatorPattern(
            nprocs=nprocs, cb_nodes=c.cb_nodes,
            data_size=max(int(data_size), 1), proc_node=proc_node,
            comm_size=c.comm_size, placement=c.agg_type)
        try:
            feats = schedule_features(compile_method(c.method, pattern))
        except TrafficError:
            out[c.cid] = None
            continue
        out[c.cid] = floor_from_features(feats, params)
    return out


def newest_predict_path(root: str = ".") -> str | None:
    """Newest committed ``PREDICT_*.json`` under ``root`` (sorted by
    name — the r-number convention — so the answer is deterministic
    across filesystems, like every artifact scan)."""
    paths = sorted(glob.glob(os.path.join(root, "PREDICT_*.json")))
    return paths[-1] if paths else None
