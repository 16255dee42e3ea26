"""Chrome/Perfetto export of a flight-recorder event log.

Produces the Chrome Trace Event JSON format (the ``traceEvents`` array
form), loadable in ``ui.perfetto.dev`` or ``chrome://tracing``:

- pid 1, "host (measured)": real perf_counter windows (``host_span``)
  and instants — dispatch loops, chained differencing windows, oracle
  delivery events — plus the ``hbm`` counter tracks
  (``device.memory_stats()`` samples, host-sampled outside the timed
  path).
- pid 2, "ranks (reconstructed)": one thread (track) per logical rank.
  Rep envelopes and per-round bucket slices from the attribution cell
  stream. Every slice's args carry the exact attributed seconds
  (``dur_s``) and the run's column-accurate provenance label
  (``phase_source``) — the UI can never present a reconstructed slice
  as a measurement.
- pid 2, tid 0: the ``bytes_in_flight`` counter track (payload bytes
  entering flight per throttle round) plus the ``traffic_msgs`` /
  ``traffic_max_incast`` tracks (per-round message count and incast
  fan-in depth, static accounting from obs/traffic.py — args key
  ``value``, since they count messages, not bytes), plus the
  ``latency_p50_ms`` / ``latency_p95_ms`` / ``latency_p99_ms`` tracks:
  per-round rank-latency quantiles (obs/metrics.py over the
  reconstructed cell means — p50/p95 are ``round_stats`` VERBATIM, p99
  the same percentile arithmetic), one sample per (run, round) at the
  round's first slice timestamp, so the tail shows ON the timeline.
- pid 3, "serve requests (journal-derived)": one thread per serve
  request, phase slices (queue/batch/cache/dispatch/respond) between
  the boundary stamps each ``serve.request`` instant carries
  (obs/workload.py BOUNDARIES order) — the ``inspect workload``
  attribution projected onto the timeline, never ad-hoc host timing.
  Request slices carry the batch correlation id (``cid``), and Chrome
  flow events (``ph`` "s"/"f") link each request's ``dispatch`` slice
  to the first round slice of the cid-matched attributed run in pid 2 —
  the ``inspect flow`` causal join drawn as arrows on the timeline.

Multi-run legibility: the process names carry the backend(s) and the
``process_labels`` metadata lists every run (``m<id> <method name>
[backend]``), so a sweep export's tracks are identifiable in the UI
without opening a slice. The run-ledger preamble (obs/ledger.py) lands
as a ``ledger.manifest`` instant at ts 0 with the manifest in its args.

Slices within each track are sorted by timestamp, so ``ts`` is
monotonically non-decreasing per track (pinned by the round-trip
tests). Timestamps are microseconds (the format's unit).
"""

from __future__ import annotations

__all__ = ["to_chrome_trace", "HOST_PID", "RANKS_PID", "SERVE_PID",
           "HBM_TID"]

HOST_PID = 1
RANKS_PID = 2

#: Serve request-flow tracks: one thread per request id, phase slices
#: synthesized from the ``serve.request`` instants' recorded boundary
#: stamps (obs/workload.py BOUNDARIES order) — journal-derived timing,
#: never ad-hoc host callbacks.
SERVE_PID = 3

#: Host-process thread id of the HBM counter tracks (tid 1 is the host
#: span/instant timeline).
HBM_TID = 2


def _meta(pid: int, tid: int, what: str, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def _run_label(run: dict) -> str:
    return f"m{run.get('method')} {run.get('name')} [{run.get('backend')}]"


def to_chrome_trace(events: list[dict]) -> dict:
    """Convert flight-recorder events to a Chrome trace dict."""
    runs = {e["id"]: e for e in events if e["ev"] == "run"}
    backends = sorted({str(r.get("backend")) for r in runs.values()})
    ranks_name = "ranks (reconstructed)"
    if backends:
        ranks_name += " — " + "/".join(backends)
    run_labels = ", ".join(_run_label(runs[k]) for k in sorted(runs))
    out: list[dict] = [
        _meta(HOST_PID, 0, "process_name", "host (measured)"),
        _meta(HOST_PID, 1, "thread_name", "host timeline"),
        _meta(RANKS_PID, 0, "process_name", ranks_name),
        _meta(RANKS_PID, 0, "thread_name",
              "counters (bytes_in_flight, traffic_*, latency_*)"),
    ]
    if run_labels:
        for pid in (HOST_PID, RANKS_PID):
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_labels",
                        "args": {"labels": run_labels}})
    ranks_seen: set[int] = set()
    hbm_seen = False
    slices: list[dict] = []
    for e in events:
        ev = e["ev"]
        if ev == "host_span":
            slices.append({
                "ph": "X", "pid": HOST_PID, "tid": 1, "name": e["name"],
                "cat": "host", "ts": e["ts"], "dur": e["dur"],
                "args": e.get("args", {})})
        elif ev == "instant":
            slices.append({
                "ph": "i", "pid": HOST_PID, "tid": 1, "name": e["name"],
                "cat": "host", "ts": e["ts"], "s": "t",
                "args": e.get("args", {})})
        elif ev == "ledger":
            # the run-ledger preamble: environment manifest as an
            # instant at the origin, args carry the whole manifest
            slices.append({
                "ph": "i", "pid": HOST_PID, "tid": 1,
                "name": "ledger.manifest", "cat": "ledger", "ts": 0.0,
                "s": "p", "args": {"manifest": e.get("manifest")}})
        elif ev == "hbm":
            hbm_seen = True
            for key in ("bytes_in_use", "peak_bytes"):
                if e.get(key) is None:
                    continue
                slices.append({
                    "ph": "C", "pid": HOST_PID, "tid": HBM_TID,
                    "name": f"hbm_{key}", "ts": e["ts"],
                    "args": {"bytes": e[key]}})
        elif ev == "span":
            run = runs.get(e["run"], {})
            rank = e["rank"]
            ranks_seen.add(rank)
            rnd = e["round"]
            if e["bucket"] == "total":
                name = f"rep {e['rep']}"
            elif rnd is None or rnd == -1:
                name = e["bucket"]
            else:
                name = f"round {rnd}: {e['bucket']}" \
                    if isinstance(rnd, int) else f"{rnd}: {e['bucket']}"
            slices.append({
                "ph": "X", "pid": RANKS_PID, "tid": rank + 1,
                "name": name, "cat": run.get("name", "run"),
                "ts": e["ts"], "dur": e["dur"],
                "args": {"run": e["run"], "rep": e["rep"],
                         "round": rnd, "bucket": e["bucket"],
                         "dur_s": e["dur_s"],
                         "phase_source": e["src"],
                         "method": run.get("name")}})
        elif ev == "counter":
            # bytes_in_flight samples bytes; the traffic_* tracks
            # (msgs, incast depth) are counts, not bytes
            key = "bytes" if e["name"] == "bytes_in_flight" else "value"
            slices.append({
                "ph": "C", "pid": RANKS_PID, "tid": 0,
                "name": e["name"], "ts": e["ts"],
                "args": {key: e["value"]}})
        # "run"/"timer"/"meta" events carry no timeline geometry

    # per-round latency quantile counters: the histogram view
    # (obs/export.py) projected onto the timeline. p50/p95 are the
    # round_stats values VERBATIM and p99 is the same percentile
    # arithmetic over the same per-rank cell means — derived from the
    # attribution cell stream like every reconstructed slice, never
    # from host callbacks. Emitted at each round's first slice
    # timestamp so the counter sample sits where the round starts.
    from tpu_aggcomm_torch.obs.metrics import cell_means, percentile, round_stats
    for rid in sorted(runs):
        round_ts: dict = {}
        for e in events:
            if e["ev"] == "span" and e["run"] == rid \
                    and e["bucket"] != "total":
                rnd = e["round"]
                if rnd not in round_ts or e["ts"] < round_ts[rnd]:
                    round_ts[rnd] = e["ts"]
        means = cell_means(events, rid)
        for rs in round_stats(events, rid):
            rnd = rs["round"]
            ts = round_ts.get(rnd)
            if ts is None:
                continue
            vals = sorted(s for (_rank, r), s in means.items()
                          if r == rnd)
            for name, v in (("latency_p50_ms", rs["p50"]),
                            ("latency_p95_ms", rs["p95"]),
                            ("latency_p99_ms",
                             percentile(vals, 99.0) if vals else None)):
                if v is None:
                    continue
                slices.append({
                    "ph": "C", "pid": RANKS_PID, "tid": 0,
                    "name": name, "ts": ts,
                    "args": {"value": v * 1e3}})

    # serve request-flow tracks: each `serve.request` instant carries
    # the request's full boundary-stamp dict (relative to admission);
    # the instant itself was emitted at the respond boundary, so
    # admit_ts = instant_ts - respond_stamp re-anchors the request on
    # the host clock. One slice per consecutive recorded boundary pair,
    # one thread per request id — the same journal-derived attribution
    # `inspect workload` prints, projected onto the timeline.
    from tpu_aggcomm_torch.obs.workload import BOUNDARIES
    serve_seen: set[int] = set()
    # (rid, cid) -> the request's dispatch-slice start ts: the anchor
    # each flow arrow departs from (obs/flow.py joins on the same cid)
    dispatch_anchor: dict[tuple[int, str], float] = {}
    for e in events:
        if e["ev"] != "instant" or e.get("name") != "serve.request":
            continue
        args = e.get("args", {})
        phases = args.get("phases")
        rid = args.get("rid")
        if not isinstance(phases, dict) or not isinstance(rid, int):
            continue
        stamps = [(b, phases[b]) for b in BOUNDARIES
                  if isinstance(phases.get(b), (int, float))]
        if len(stamps) < 2:
            continue
        t0 = e["ts"] - stamps[-1][1] * 1e6
        serve_seen.add(rid)
        cid = args.get("cid")
        for (_b0, s0), (b1, s1) in zip(stamps, stamps[1:]):
            if b1 == "dispatch" and isinstance(cid, str):
                dispatch_anchor[(rid, cid)] = t0 + s0 * 1e6
            slices.append({
                "ph": "X", "pid": SERVE_PID, "tid": rid + 1,
                "name": b1, "cat": "serve",
                "ts": t0 + s0 * 1e6, "dur": (s1 - s0) * 1e6,
                "args": {"rid": rid, "phase": b1, "dur_s": s1 - s0,
                         "ok": args.get("ok"),
                         "backend": args.get("backend"),
                         "cache": args.get("cache"),
                         "cid": cid,
                         "batch_seq": args.get("batch_seq"),
                         "batch_n": args.get("batch_n")}})

    # flow links: request dispatch slice -> first round slice of the
    # cid-matched attributed run (the obs/flow.py causal join as Chrome
    # flow events). "s" binds to the enclosing dispatch slice; "f" with
    # bp "e" binds to the enclosing round slice in the ranks process.
    if dispatch_anchor:
        run_by_cid = {e["cid"]: e["id"] for e in events
                      if e["ev"] == "run" and isinstance(e.get("cid"), str)}
        first_round: dict = {}   # run id -> (rank tid, ts) of first slice
        for e in events:
            if e["ev"] == "span" and e["bucket"] != "total":
                cur = first_round.get(e["run"])
                if cur is None or e["ts"] < cur[1]:
                    first_round[e["run"]] = (e["rank"] + 1, e["ts"])
        flow_id = 0
        for (rid, cid), ts in sorted(dispatch_anchor.items()):
            target = first_round.get(run_by_cid.get(cid))
            if target is None:
                continue
            flow_id += 1
            common = {"cat": "flow", "name": "dispatch",
                      "id": flow_id, "args": {"rid": rid, "cid": cid}}
            slices.append({"ph": "s", "pid": SERVE_PID, "tid": rid + 1,
                           "ts": ts, **common})
            slices.append({"ph": "f", "bp": "e", "pid": RANKS_PID,
                           "tid": target[0], "ts": target[1], **common})
    if serve_seen:
        out.append(_meta(SERVE_PID, 0, "process_name",
                         "serve requests (journal-derived)"))
        for rid in sorted(serve_seen):
            out.append(_meta(SERVE_PID, rid + 1, "thread_name",
                             f"request {rid}"))

    if hbm_seen:
        out.append(_meta(HOST_PID, HBM_TID, "thread_name", "hbm"))
    for rank in sorted(ranks_seen):
        out.append(_meta(RANKS_PID, rank + 1, "thread_name",
                         f"rank {rank}"))
    slices.sort(key=lambda s: (s["pid"], s["tid"], s["ts"]))
    out.extend(slices)
    return {"traceEvents": out, "displayTimeUnit": "ms"}
