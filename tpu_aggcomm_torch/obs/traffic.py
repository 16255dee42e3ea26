"""Traffic auditor: static communication-matrix accounting and throttle
conformance, derived ONLY from compiled op programs.

The flight recorder / straggler analytics / run ledger observe the *time*
domain; this module observes the *traffic* domain — which bytes cross
which (src, dst) edge in which round, how deep the incast fan-in at each
aggregator is, and whether a method's posting discipline actually bounds
in-flight messages to the ``-c`` limit the whole benchmark studies
(mpi_test.c's comm_size throttle).

Everything here is STATIC analysis over ``Schedule.programs``:

- :func:`round_edges` — per-round (src, dst) → bytes matrices, with
  0-byte SIGNAL handshakes counted on a separate channel and COPY
  memcpys (local, never on the wire) tracked apart from network edges.
- :func:`incast_depths` — per-round per-destination distinct-source
  counts (COPY excluded; MPI self-sends included — the reference posts
  them through the same transport).
- :func:`inflight_audit` — simulates each rank's nonblocking
  post/WAITALL token lifetimes and records the peak number of
  outstanding payload requests (sends + recvs; SIGNAL_SEND tokens are
  tracked separately — they carry no payload and the reference does not
  throttle them).
- :func:`documented_bound` — the per-method closed-form bound the
  ``-c`` throttle implies; :func:`audit_schedule` proves (CONFORMS) or
  refutes (REFUTED, naming the offending rank/round/count) it, and
  marks methods with no rank op programs (vendor collectives, the
  hierarchical TAM engine) EXEMPT.
- :func:`conformance_sweep` — the jax-free static gate over every
  method in ``core/methods.py:METHODS`` (wired into scripts/ci_tier1.sh).
- :func:`measured_overlay` — in the reference, joins the static matrix
  with flight-recorder round walls and ``harness/roofline.py``'s TPU
  floors. The port copies everything else of this module verbatim
  (import paths rewritten); the overlay raises ``NotPortedError`` until
  the ``inspect`` slice.

Invariant: traffic accounting is derived from op programs, never from
measured callbacks, and this module must stay importable without jax
(tests/test_obs.py pins the whole obs package; core.schedule /
core.methods import only numpy).
"""

from __future__ import annotations

import json
import math

__all__ = ["TrafficError", "TRAFFIC_SCHEMA", "round_edges", "incast_depths",
           "inflight_audit", "documented_bound", "audit_schedule",
           "round_traffic", "conformance_sweep", "measured_overlay",
           "render_audit", "render_sweep", "pearson"]

TRAFFIC_SCHEMA = "traffic-v1"

# payload edge lists above this total are dropped from the JSON artifact
# (the per-round msgs/bytes/incast summaries always stay)
MAX_ARTIFACT_EDGES = 20_000


class TrafficError(ValueError):
    """A schedule/trace cannot be audited as asked (no op programs, no
    matching run, no per-round slices)."""


def _op_kinds():
    from tpu_aggcomm_torch.core.schedule import OpKind
    return OpKind


# ---------------------------------------------------------------------------
# Matrix accounting

def round_edges(schedule) -> dict:
    """Per-round traffic of one compiled schedule.

    Returns ``{round: {"edges": {(src, dst): bytes}, "signals":
    {(src, dst): count}, "copies": {(src, dst): bytes}}}``. ``edges``
    are network payload messages (send-side ISEND/ISSEND/SEND with
    nbytes > 0 plus the send half of SENDRECV — MPI self-sends
    included); ``copies`` are COPY memcpys (payload that never crosses
    the wire); ``signals`` are 0-byte SIGNAL_SEND handshakes.

    Dense collectives (m=5/8) post ONE ALLTOALLW op per rank; their
    matrix is rebuilt from ``pattern.dense_counts()`` in round 0.
    Schedules with no rank op programs (the TAM relay) raise
    :class:`TrafficError`.
    """
    OpKind = _op_kinds()
    programs = getattr(schedule, "programs", None)
    if programs is None or getattr(schedule, "assignment", None) is not None:
        raise TrafficError(
            f"{getattr(schedule, 'name', schedule)}: hierarchical TAM "
            f"engine has no rank op programs to audit")
    out: dict[int, dict] = {}

    def cell(rnd):
        if rnd not in out:
            out[rnd] = {"edges": {}, "signals": {}, "copies": {}}
        return out[rnd]

    if getattr(schedule, "collective", False):
        # one dense vendor call: the whole pattern's matrix, round 0
        send, _recv = schedule.pattern.dense_counts()
        c = cell(0)
        n = schedule.pattern.nprocs
        for s in range(n):
            for d in range(n):
                b = int(send[s][d])
                if b:
                    c["edges"][(s, d)] = c["edges"].get((s, d), 0) + b
        return out

    for rank, prog in enumerate(programs):
        for op in prog:
            if (op.kind in (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND)
                    and op.nbytes > 0):
                c = cell(op.round)["edges"]
                c[(rank, op.peer)] = c.get((rank, op.peer), 0) + op.nbytes
            elif op.kind is OpKind.SENDRECV and op.nbytes > 0:
                c = cell(op.round)["edges"]
                c[(rank, op.peer)] = c.get((rank, op.peer), 0) + op.nbytes
            elif op.kind is OpKind.COPY:
                c = cell(op.round)["copies"]
                b = schedule.pattern.data_size
                c[(rank, rank)] = c.get((rank, rank), 0) + b
            elif op.kind is OpKind.SIGNAL_SEND:
                c = cell(op.round)["signals"]
                c[(rank, op.peer)] = c.get((rank, op.peer), 0) + 1
    return out


def incast_depths(edges: dict) -> dict:
    """Per-destination distinct-source counts from one round's ``edges``
    dict — the fan-in each receiver must absorb in that round. COPY
    never appears here (it is a memcpy, not incast); MPI self-sends do.
    """
    by_dst: dict[int, set] = {}
    for (src, dst) in edges:
        by_dst.setdefault(dst, set()).add(src)
    return {dst: len(srcs) for dst, srcs in by_dst.items()}


def round_traffic(schedule) -> dict | None:
    """Compact per-round summary ``{str(round): {"msgs", "bytes",
    "max_incast"}}`` for the flight recorder's counter tracks.

    ``msgs``/``bytes`` cover the same payload universe as
    ``Schedule.data_edges()`` (network edges + COPY self-edges, so the
    bytes agree with the existing ``bytes_in_flight`` counter);
    ``max_incast`` is network-only. None when there is nothing to count.
    """
    try:
        per_round = round_edges(schedule)
    except TrafficError:
        return None
    out: dict[str, dict] = {}
    for rnd, c in sorted(per_round.items()):
        inc = incast_depths(c["edges"])
        out[str(rnd)] = {
            "msgs": len(c["edges"]) + len(c["copies"]),
            "bytes": sum(c["edges"].values()) + sum(c["copies"].values()),
            "max_incast": max(inc.values()) if inc else 0}
    return out


# ---------------------------------------------------------------------------
# Static in-flight accounting

def inflight_audit(schedule) -> list[dict]:
    """Simulate every rank's nonblocking post/WAITALL token lifetimes.

    A token goes live at its posting op (ISEND/ISSEND → send, IRECV →
    recv, SIGNAL_SEND → signal) and dies at the WAITALL that lists it;
    a token never waited stays live to the end (conservative). Blocking
    ops hold no token and do not count — the ``-c`` throttle governs
    *posted nonblocking requests* (mpi_test.c's request arrays).

    Returns one dict per rank: ``{"rank", "peak", "round", "sends",
    "recvs", "peak_signals"}`` where ``peak`` is the max simultaneous
    payload tokens (sends + recvs), ``round`` the round tag of the op
    at which that peak was first reached, and ``sends``/``recvs`` its
    split. Signal tokens are tracked apart (0-byte, unthrottled).
    """
    OpKind = _op_kinds()
    programs = getattr(schedule, "programs", None)
    if programs is None or getattr(schedule, "assignment", None) is not None:
        raise TrafficError(
            f"{getattr(schedule, 'name', schedule)}: hierarchical TAM "
            f"engine has no rank op programs to audit")
    out = []
    for rank, prog in enumerate(programs):
        live: dict[int, str] = {}
        nsend = nrecv = nsig = 0
        peak = 0
        peak_round = 0
        peak_parts = (0, 0)
        sig_peak = 0
        for op in prog:
            if op.kind is OpKind.WAITALL:
                for t in op.tokens:
                    cls = live.pop(t, None)
                    if cls == "send":
                        nsend -= 1
                    elif cls == "recv":
                        nrecv -= 1
                    elif cls == "signal":
                        nsig -= 1
                continue
            if op.token < 0:
                continue
            if op.kind in (OpKind.ISEND, OpKind.ISSEND):
                live[op.token] = "send"
                nsend += 1
            elif op.kind is OpKind.IRECV:
                live[op.token] = "recv"
                nrecv += 1
            elif op.kind is OpKind.SIGNAL_SEND:
                live[op.token] = "signal"
                nsig += 1
            else:
                continue
            sig_peak = max(sig_peak, nsig)
            cur = nsend + nrecv
            if cur > peak:
                peak = cur
                peak_round = op.round
                peak_parts = (nsend, nrecv)
        out.append({"rank": rank, "peak": peak, "round": peak_round,
                    "sends": peak_parts[0], "recvs": peak_parts[1],
                    "peak_signals": sig_peak})
    return out


def documented_bound(method_id: int, pattern) -> tuple[int | None, str]:
    """The per-method closed-form peak-in-flight bound the ``-c``
    throttle implies, as ``(bound, formula)``. ``None`` ⇒ EXEMPT (no
    rank op programs to audit: vendor collectives m=5/8, the TAM engine
    m=15/16).

    Derivation (w = min(c, n), c = comm_size, n = nprocs, cb = cb_nodes):
    fully blocking methods (6, 9, 10) post no nonblocking requests at
    all; m=7 throttles aggregator-*classes*, each of size ceil(n/cb);
    m=12 posts at most min(c, cb) sends per block with blocking recvs;
    m=11 posts at most w aggregator sends per round; the dead m=22
    ignores -c by construction (unthrottled m=2: n sends + cb recvs);
    every other rank-program method bounds per-round posts by w with at
    most cb requests carried across rounds (pre-posted sends / recvs).
    """
    n = pattern.nprocs
    cb = pattern.cb_nodes
    c = pattern.comm_size
    w = min(c, n)
    if method_id in (5, 8, 15, 16):
        return None, "no rank op programs"
    if method_id in (6, 9, 10):
        return 0, "0 (fully blocking)"
    if method_id == 7:
        return min(c, cb) * math.ceil(n / cb), "min(c,cb)*ceil(n/cb)"
    if method_id == 12:
        return min(c, cb), "min(c,cb)"
    if method_id == 11:
        return w, "min(c,n)"
    if method_id == 22:
        return n + cb, "n+cb (ignores -c by construction)"
    return w + cb, "min(c,n)+cb"


# ---------------------------------------------------------------------------
# The audit artifact (traffic-v1)

def audit_schedule(schedule, max_edges: int = MAX_ARTIFACT_EDGES) -> dict:
    """Full static audit of one compiled schedule → a traffic-v1 dict.

    Combines the per-round matrix, incast depths, barrier signature and
    the in-flight conformance verdict. Never touches a backend or a
    measured callback; ``obs.regress.validate_traffic`` pins the shape.
    """
    from tpu_aggcomm_torch.core.schedule import barrier_rounds_of

    p = schedule.pattern
    cfg = {"method": schedule.method_id, "name": schedule.name,
           "nprocs": p.nprocs, "cb_nodes": p.cb_nodes,
           "data_size": p.data_size, "comm_size": p.comm_size,
           "proc_node": p.proc_node, "agg_type": int(p.placement),
           "direction": p.direction.value}
    if getattr(schedule, "fault", None):
        # fault-repaired schedule: the audit covers the DETOURED program
        # (relay hops included) — the artifact must say so
        cfg["fault"] = schedule.fault
    base = {"schema": TRAFFIC_SCHEMA, "config": cfg}

    if getattr(schedule, "assignment", None) is not None:
        base.update({
            "rounds": [], "edges_omitted": False, "barrier_rounds": {},
            "totals": {"msgs": 0, "bytes": 0, "signals": 0, "copies": 0},
            "conformance": {
                "verdict": "EXEMPT", "bound": None,
                "bound_formula": "no rank op programs",
                "peak": None, "offenders": [],
                "note": "hierarchical TAM engine: traffic rides mesh "
                        "collectives, no rank op programs to audit"}})
        return base

    per_round = round_edges(schedule)
    bound, formula = documented_bound(schedule.method_id, p)

    rounds = []
    tot_msgs = tot_bytes = tot_sig = tot_cp = 0
    n_edges = sum(len(c["edges"]) + len(c["copies"])
                  for c in per_round.values())
    omit = n_edges > max_edges
    for rnd, c in sorted(per_round.items()):
        inc = incast_depths(c["edges"])
        msgs = len(c["edges"])
        byts = sum(c["edges"].values()) + sum(c["copies"].values())
        sigs = sum(c["signals"].values())
        max_inc = max(inc.values()) if inc else 0
        inc_rank = (min(d for d, v in inc.items() if v == max_inc)
                    if inc else -1)
        row = {"round": rnd, "msgs": msgs, "bytes": byts,
               "signals": sigs, "copies": len(c["copies"]),
               "max_incast": max_inc, "incast_rank": inc_rank,
               "incast": {str(d): v for d, v in sorted(inc.items())}}
        if not omit:
            row["edges"] = [[s, d, b]
                            for (s, d), b in sorted(c["edges"].items())]
        rounds.append(row)
        tot_msgs += msgs
        tot_bytes += byts
        tot_sig += sigs
        tot_cp += len(c["copies"])

    if getattr(schedule, "collective", False):
        conf = {"verdict": "EXEMPT", "bound": None,
                "bound_formula": "no rank op programs",
                "peak": None, "offenders": [],
                "note": "dense vendor collective: the library schedules "
                        "in-flight messages, not the rank programs"}
    else:
        ranks = inflight_audit(schedule)
        peak_row = max(ranks, key=lambda r: r["peak"])
        offenders = sorted(
            ({"rank": r["rank"], "round": r["round"], "count": r["peak"]}
             for r in ranks if r["peak"] > bound),
            key=lambda o: -o["count"])[:10]
        verdict = "REFUTED" if offenders else "CONFORMS"
        note = (f"peak {peak_row['peak']} outstanding payload requests "
                f"({peak_row['sends']} sends + {peak_row['recvs']} recvs) "
                f"at rank {peak_row['rank']} round {peak_row['round']}; "
                f"signal peak "
                f"{max(r['peak_signals'] for r in ranks)}")
        conf = {"verdict": verdict, "bound": bound,
                "bound_formula": formula, "peak": peak_row["peak"],
                "peak_rank": peak_row["rank"],
                "peak_round": peak_row["round"],
                "peak_sends": peak_row["sends"],
                "peak_recvs": peak_row["recvs"],
                "peak_signals": max(r["peak_signals"] for r in ranks),
                "offenders": offenders, "note": note}

    base.update({
        "rounds": rounds, "edges_omitted": omit,
        "barrier_rounds": {str(k): v for k, v
                           in sorted(barrier_rounds_of(schedule).items())},
        "totals": {"msgs": tot_msgs, "bytes": tot_bytes,
                   "signals": tot_sig, "copies": tot_cp},
        "conformance": conf})
    return base


def conformance_sweep(nprocs: int, cb_nodes: int, comm_size: int,
                      data_size: int = 2048, proc_node: int = 1,
                      agg_type: int = 1, include_dead: bool = True) -> list:
    """Audit every method in METHODS at one shape — the jax-free static
    gate. Returns one row per method: ``{"method", "name", "verdict",
    "peak", "bound", "bound_formula"}``."""
    from tpu_aggcomm_torch.core.methods import METHODS, compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    p = AggregatorPattern(nprocs=nprocs, cb_nodes=cb_nodes,
                          data_size=data_size, placement=agg_type,
                          proc_node=proc_node, comm_size=comm_size)
    rows = []
    for mid in sorted(METHODS):
        if not include_dead and not METHODS[mid].dispatched:
            continue
        sched = compile_method(mid, p)
        audit = audit_schedule(sched, max_edges=0)
        conf = audit["conformance"]
        rows.append({"method": mid, "name": METHODS[mid].name,
                     "verdict": conf["verdict"], "peak": conf["peak"],
                     "bound": conf["bound"],
                     "bound_formula": conf["bound_formula"],
                     "offenders": conf["offenders"]})
    return rows


# ---------------------------------------------------------------------------
# Measured overlay (trace join)

def pearson(xs, ys) -> float | None:
    """Pearson correlation of two equal-length vectors; None when
    either side is constant or fewer than two points."""
    n = len(xs)
    if n < 2 or n != len(ys):
        return None
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    syy = sum((y - my) ** 2 for y in ys)
    if sxx == 0.0 or syy == 0.0:
        return None
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    return sxy / math.sqrt(sxx * syy)


def _find_run(events: list, cfg: dict, run_id=None) -> dict:
    runs = [e for e in events if e.get("ev") == "run"]
    if run_id is not None:
        for r in runs:
            if r["id"] == run_id:
                return r
        raise TrafficError(f"no run {run_id} in trace")
    for r in runs:
        if (r.get("method") == cfg["method"]
                and r.get("nprocs") == cfg["nprocs"]
                and r.get("data_size") == cfg["data_size"]
                and r.get("comm_size") == cfg["comm_size"]):
            return r
    raise TrafficError(
        f"trace has no run matching m={cfg['method']} n={cfg['nprocs']} "
        f"d={cfg['data_size']} c={cfg['comm_size']} "
        f"(runs: {[(r.get('method'), r.get('nprocs')) for r in runs]})")


def measured_overlay(audit: dict, events: list, run_id=None) -> dict:
    """Join a static audit with one traced run's round walls.

    Not ported: the reference's overlay divides round bytes by the
    TPU's HBM floor (``harness/roofline.py``), which the port does not
    copy. It comes with the ``inspect`` slice (ROADMAP.md queue A);
    calling it raises :class:`NotPortedError` by name.
    """
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    raise NotPortedError(
        "tpu_aggcomm_torch.obs.traffic.measured_overlay is not ported yet: "
        "its roofline floors are the TPU's (harness/roofline.py); it comes "
        "with the inspect slice (ROADMAP.md queue A)")


# ---------------------------------------------------------------------------
# Renderers

def _fmt_srcs(srcs: list) -> str:
    if len(srcs) <= 8:
        return ",".join(str(s) for s in srcs)
    return (",".join(str(s) for s in srcs[:8])
            + f",... ({len(srcs)} sources)")


def render_audit(audit: dict, overlay: dict | None = None,
                 max_dst_rows: int = 48) -> str:
    """Text report: per-round matrix (grouped by destination — the
    incast view), totals, barrier signature, conformance verdict, and
    the measured columns when an overlay is given."""
    cfg = audit["config"]
    head0 = (f"traffic audit: m={cfg['method']} \"{cfg['name']}\" "
             f"({cfg['direction']}) n={cfg['nprocs']} a={cfg['cb_nodes']} "
             f"c={cfg['comm_size']} d={cfg['data_size']} B")
    if cfg.get("fault"):
        head0 += f" [fault-repaired: {cfg['fault']}]"
    lines = [head0]
    ov_rounds = ({r["round"]: r for r in overlay["rounds"]}
                 if overlay else {})
    for r in audit["rounds"]:
        head = (f"  round {r['round']:3d}: {r['msgs']:5d} msgs, "
                f"{r['bytes']:10d} B, {r['signals']:4d} signals, "
                f"max incast {r['max_incast']:3d}")
        if r["max_incast"]:
            head += f" @ rank {r['incast_rank']}"
        ov = ov_rounds.get(r["round"])
        if ov is not None:
            head += (f" | wall {ov['wall_s'] * 1e6:10.1f} us, "
                     f"eff {ov['eff_bps'] / 1e9:8.3f} GB/s, "
                     f"{ov['frac_roofline'] * 100:6.2f}% of roofline")
        lines.append(head)
        by_dst: dict[int, list] = {}
        for e in r.get("edges", []):
            by_dst.setdefault(e[1], []).append(e)
        for i, dst in enumerate(sorted(by_dst)):
            if i >= max_dst_rows:
                lines.append(f"    ... ({len(by_dst) - max_dst_rows} "
                             f"more destinations)")
                break
            es = by_dst[dst]
            b = sum(e[2] for e in es)
            lines.append(f"    dst {dst:4d} <- "
                         f"{_fmt_srcs(sorted(e[0] for e in es))} "
                         f"({len(es)} x msg, {b} B)")
        if r.get("copies"):
            lines.append(f"    + {r['copies']} local copy(ies) "
                         f"(memcpy, not on the wire)")
    if audit.get("edges_omitted"):
        lines.append("  (edge lists omitted: too many edges; "
                     "per-round summaries above are complete)")
    t = audit["totals"]
    lines.append(f"totals: {t['msgs']} msgs, {t['bytes']} B, "
                 f"{t['signals']} signals, {t['copies']} copies over "
                 f"{len(audit['rounds'])} rounds")
    if audit["barrier_rounds"]:
        sig = ", ".join(f"r{k}: {v}"
                        for k, v in audit["barrier_rounds"].items())
        lines.append(f"barriers: {sig}")
    conf = audit["conformance"]
    if conf["verdict"] == "EXEMPT":
        lines.append(f"conformance: EXEMPT — {conf['note']}")
    else:
        lines.append(f"in-flight accounting: {conf['note']}")
        tail = (f"peak {conf['peak']} <= bound {conf['bound']} "
                f"({conf['bound_formula']})")
        if conf["verdict"] == "CONFORMS":
            lines.append(f"conformance: CONFORMS — {tail}")
        else:
            lines.append(f"conformance: REFUTED — peak {conf['peak']} > "
                         f"bound {conf['bound']} "
                         f"({conf['bound_formula']}); offenders:")
            for o in conf["offenders"]:
                lines.append(f"  rank {o['rank']:4d} round {o['round']:3d}: "
                             f"{o['count']} outstanding")
    if overlay is not None:
        isj = overlay["incast_straggler"]
        corr = isj["pearson_recv_bytes_vs_total_s"]
        corr_s = f"{corr:+.3f}" if corr is not None else "n/a"
        lines.append(f"incast vs straggler: pearson(recv bytes, total s) "
                     f"= {corr_s}; max-incast rank "
                     f"{isj['max_incast_rank']}, critical rank "
                     f"{isj['critical_rank']}")
        if overlay.get("note"):
            lines.append(f"overlay note: {overlay['note']}")
    return "\n".join(lines) + "\n"


def render_sweep(rows: list, nprocs: int, cb_nodes: int,
                 comm_size: int) -> str:
    lines = [f"conformance sweep: {len(rows)} methods at n={nprocs} "
             f"a={cb_nodes} c={comm_size}"]
    n_ref = 0
    for r in rows:
        if r["verdict"] == "EXEMPT":
            lines.append(f"  m={r['method']:2d} {r['name']:34s} EXEMPT    "
                         f"({r['bound_formula']})")
        elif r["verdict"] == "CONFORMS":
            lines.append(f"  m={r['method']:2d} {r['name']:34s} CONFORMS  "
                         f"peak {r['peak']:4d} <= {r['bound']:4d} "
                         f"({r['bound_formula']})")
        else:
            n_ref += 1
            o = r["offenders"][0] if r["offenders"] else {}
            lines.append(f"  m={r['method']:2d} {r['name']:34s} REFUTED   "
                         f"peak {r['peak']:4d} >  {r['bound']:4d} "
                         f"({r['bound_formula']}) — rank {o.get('rank')} "
                         f"round {o.get('round')}: {o.get('count')} "
                         f"outstanding")
    lines.append(f"REFUTED: {n_ref} of {len(rows)}")
    return "\n".join(lines) + "\n"


def write_artifact(path: str, audit: dict,
                   overlay: dict | None = None) -> str:
    """Write a traffic-v1 JSON artifact (schema-checked by
    ``scripts/check_bench_schema.py`` when committed as TRAFFIC_*.json)."""
    from tpu_aggcomm_torch.obs.atomic import atomic_write
    blob = dict(audit)
    if overlay is not None:
        blob["overlay"] = overlay
    with atomic_write(path) as fh:
        json.dump(blob, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return path
