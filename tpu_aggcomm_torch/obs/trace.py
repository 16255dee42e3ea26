"""The flight recorder: structured span/counter events for every run.

Two kinds of time live here, and the recorder never mixes them up:

- **host spans** — real ``perf_counter`` windows measured on the host
  (dispatch loops, chained differencing windows, the oracle's delivery
  instants). These are honest wall measurements of HOST-visible
  boundaries.
- **reconstructed rank/round slices** — the per-rank per-round bucket
  slices of a rep. On the compiled backends phases cannot be bracketed
  individually inside one XLA program (harness/attribution.py module
  docstring), so these slices are rebuilt from the attribution cell
  stream (``harness.attribution.cell_recording``): every slice carries
  the EXACT seconds the attribution charged to the rank's Timer bucket,
  plus the run's column-accurate provenance label
  (``report.py:PHASE_SOURCES``) so a reconstructed slice can never be
  read as a measured one.

The cell stream mirrors the arithmetic of the ``Timer.add`` calls it
shadows — same expressions, same order — and :func:`aggregate_run`
replays the backend's own combine step (sequential accumulation for
per-dispatch reps, ``array * ntimes`` for chained/measured reps), so a
trace re-aggregates FLOAT-EXACTLY to the Timer columns the run reported
(the round-trip tests pin this). Span events are therefore written in
cell order; the timeline geometry (``ts``) is computed separately and
never feeds aggregation.

Host spans nest: each records its ``id`` and the ``id`` of the span
open around it on the same thread (``parent``), and its ends in
``perf_counter`` nanoseconds (``start_ns``, ``end_ns``). The meta event
records ``profiler_offset_ns``, which added to those ends gives the
clock of ``torch.profiler``'s events (Unix nanoseconds), so a span can be
laid over the profiler's device timeline. While a profiler is recording,
each host span is also a ``record_function`` range of the same name,
entered after the span's start is read and left before its end is, so
the profiler's range lies inside the recorder's span.

Tracing is off by default and zero-cost when off: the module-level
:func:`span` returns a shared no-op context manager and :func:`instant`
is a single ``is None`` check. A hot path with spans reads
:func:`current` once and, when it is None, runs its untraced code.
Nothing in this module imports jax or torch.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import sys
import threading
import time

__all__ = ["TraceRecorder", "aggregate_run", "current", "disable", "enable",
           "enabled", "flush", "hbm_sample", "instant", "run_context",
           "span", "summarize_trace", "summarize_events", "load_events",
           "round_key", "WHOLE_REP", "BUCKET_FIELDS", "span_self_us",
           "span_child_us", "span_total_s"]

#: ``round`` value of a slice that covers the whole rep (attributions with
#: no per-round decomposition: attribute_total, the measured post/deliver
#: split's post window, TAM byte-split totals).
WHOLE_REP = -1

#: Timer-column label -> the Timer fields it charges. "recv+send_wait"
#: charges BOTH wait columns — the reference brackets a non-aggregator's
#: Waitall once and adds it to both fields (mpi_test.c:1505-1510);
#: re-aggregation must preserve that or column sums drift.
BUCKET_FIELDS = {
    "post": ("post",),
    "send_wait": ("send_wait",),
    "recv_wait": ("recv_wait",),
    "recv+send_wait": ("recv_wait", "send_wait"),
    "barrier": ("barrier",),
}

_TIMER_COLS = ("post", "send_wait", "recv_wait", "barrier", "total")


class _NoopSpan:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def _profiler_range(name: str):
    """A ``record_function`` range named ``name``, entered, while a
    ``torch.profiler`` session is recording; else None. Reads torch only
    if the process has already imported its profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class _HostSpan:
    """A real perf_counter window appended to the event log on exit, with
    its place in the tree of spans open on its thread; a profiler range
    of the same name inside it while a profiler records."""

    __slots__ = ("_rec", "_name", "_args", "_t0", "_id", "_parent", "_rf")

    def __init__(self, rec: "TraceRecorder", name: str, args: dict):
        self._rec = rec
        self._name = name
        self._args = args

    def __enter__(self):
        stack = self._rec._local.open
        self._parent = stack[-1] if stack else None
        self._id = next(self._rec._ids)
        stack.append(self._id)
        self._t0 = time.perf_counter_ns()
        self._rf = _profiler_range(self._name)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        rec = self._rec
        rec._local.open.pop()
        rec._events.append({
            "ev": "host_span", "name": self._name,
            "ts": (self._t0 - rec._t0_ns) / 1e3,
            "dur": (t1 - self._t0) / 1e3, "args": self._args,
            "id": self._id, "parent": self._parent,
            "start_ns": self._t0, "end_ns": t1})
        return False

    def note(self, **args) -> None:
        """Add ``args`` to the span's arguments: what is known only
        inside it."""
        self._args.update(args)


class _OpenSpans(threading.local):
    """The ids of the spans open on each thread, innermost last."""

    def __init__(self):
        self.open: list = []


def _profiler_offset_ns() -> int:
    """Unix nanoseconds (the profiler's clock) minus ``perf_counter``
    nanoseconds, read between two perf_counter readings."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


def round_key(rnd):
    """Program-order sort key over mixed round labels: the whole-rep
    pseudo-round first, then integer throttle rounds, then the TAM hop
    labels ("P2" < "P3" < "P4"). Public — the analytics layer
    (obs/metrics.py, obs/compare.py) orders its tables with the exact
    key the recorder laid slices out with."""
    if rnd is None:
        return (-1,)
    if isinstance(rnd, int):
        return (0, rnd) if rnd == WHOLE_REP else (1, rnd)
    return (2, str(rnd))


_round_key = round_key


class TraceRecorder:
    """In-memory event log; one per enabled tracing session.

    Events are plain dicts (one JSONL line each on flush):

    - ``{"ev": "meta", ...}`` — one per recorder, schema version.
    - ``{"ev": "run", "id": k, ...}`` — one per (iter, method) backend
      run: config, provenance, the combine mode, and per-round payload
      bytes (the bytes-in-flight counter input).
    - ``{"ev": "span", "run": k, "rep": r, "rank": q, "round": rnd,
      "bucket": b, "ts": µs, "dur": µs, "dur_s": exact_seconds,
      "src": provenance}`` — one reconstructed slice. ``bucket ==
      "total"`` is the rep envelope; other buckets are Timer columns;
      ``round`` is an int throttle round, a TAM hop label, ``-1`` for a
      whole-rep attribution, or ``None`` on the envelope.
    - ``{"ev": "counter", ...}`` — bytes-in-flight samples on the
      reconstructed timeline.
    - ``{"ev": "timer", "run": k, "rank": q, ...}`` — the FINAL Timer
      columns the run reported, per rank (the round-trip ground truth).
    - ``{"ev": "host_span" | "instant", ...}`` — measured host windows.
    - ``{"ev": "ledger", "manifest": {...}}`` — the run-ledger preamble
      (obs/ledger.py): the environment manifest this trace was recorded
      under. Written at enable time, refreshed on flush so device facts
      recorded mid-run (platform, device kind) are included.
    - ``{"ev": "hbm", "ts": µs, "bytes_in_use": n, "peak_bytes": n}`` —
      ``device.memory_stats()`` samples (HBM counter track in the
      Perfetto export). Host-sampled OUTSIDE the timed path.
    """

    SCHEMA_VERSION = 1

    def __init__(self, manifest: bool = True):
        """``manifest=False`` makes a lean recorder: no run-ledger
        preamble, so enabling it collects no manifest (git, nvcc)."""
        self._t0_ns = time.perf_counter_ns()
        self._t0 = self._t0_ns / 1e9
        self._ids = itertools.count()
        self._local = _OpenSpans()
        self._events: list[dict] = [
            {"ev": "meta", "schema": self.SCHEMA_VERSION,
             "created_unix": time.time(),
             "profiler_offset_ns": _profiler_offset_ns()}]
        # the run-ledger preamble rides in every trace; ledger failure
        # (e.g. a sandboxed git) must never break tracing itself
        if manifest:
            try:
                from tpu_aggcomm_torch.obs import ledger
                self._events.append({"ev": "ledger",
                                     "manifest": ledger.manifest()})
            except Exception:  # lint: broad-ok (ledger enrichment must never sink a trace)
                pass
        self._cursor_us = 0.0           # reconstructed-timeline cursor
        self._next_run = 0

    # -- host-side API ---------------------------------------------------
    def span(self, name: str, **args):
        return _HostSpan(self, name, args)

    @property
    def profiler_offset_ns(self) -> int:
        """Add to a span's ``start_ns``/``end_ns`` for the profiler's
        clock."""
        return self._events[0]["profiler_offset_ns"]

    def instant(self, name: str, **args):
        self._events.append({
            "ev": "instant", "name": name,
            "ts": (time.perf_counter() - self._t0) * 1e6, "args": args})

    def hbm_sample(self, *, bytes_in_use=None, peak_bytes=None) -> None:
        """One HBM usage sample on the host timeline (sampled after a
        dispatch returns — never inside the timed path)."""
        self._events.append({
            "ev": "hbm", "ts": (time.perf_counter() - self._t0) * 1e6,
            "bytes_in_use": bytes_in_use, "peak_bytes": peak_bytes})

    # -- reconstructed-timeline API --------------------------------------
    def record_method_run(self, schedule, *, method: int, name: str,
                          iter_: int, ntimes: int, requested: str,
                          executed: str, phase_source: str, timers,
                          calls, rep_timers=None, fault=None) -> int:
        """Append the run/span/counter/timer events for one backend run.

        ``calls`` is the attribution cell stream captured around
        ``backend.run`` (``harness.attribution.cell_recording``); when it
        is empty (local/native measure reps directly, no attribution
        runs) the slices are rebuilt from ``rep_timers``
        (``backend.last_rep_timers``) instead.
        """
        run_id = self._next_run
        self._next_run += 1
        p = schedule.pattern
        if calls:
            combine = ("sum" if len(calls) == ntimes
                       else "scale" if len(calls) == 1
                       else "mixed")
        else:
            combine = "sum"
        round_bytes = _round_bytes(schedule)
        round_traffic = _round_traffic(schedule)
        run_event = {
            "ev": "run", "id": run_id, "method": method, "name": name,
            "iter": iter_, "ntimes": ntimes, "nprocs": p.nprocs,
            "data_size": p.data_size, "comm_size": p.comm_size,
            "cb_nodes": p.cb_nodes, "proc_node": p.proc_node,
            "agg_type": int(p.placement),
            "backend": requested, "executed": executed,
            "phase_source": phase_source, "combine": combine,
            "round_bytes": round_bytes, "round_traffic": round_traffic,
            "fault": fault}
        for k, v in _RUN_EXTRA.items():
            run_event.setdefault(k, v)   # context extras never shadow core
        self._events.append(run_event)

        if calls:
            for rep in range(ntimes):
                call = calls[rep] if combine != "scale" else calls[0]
                if combine == "mixed" and rep >= len(calls):
                    break
                self._emit_rep(run_id, rep, call, phase_source, p.nprocs,
                               round_bytes, round_traffic)
        else:
            self._emit_timer_reps(run_id, ntimes, timers, rep_timers,
                                  phase_source, p.nprocs)

        for rank, t in enumerate(timers):
            self._events.append({
                "ev": "timer", "run": run_id, "rank": rank,
                "post": t.post_request_time,
                "send_wait": t.send_wait_all_time,
                "recv_wait": t.recv_wait_all_time,
                "barrier": t.barrier_time, "total": t.total_time})
        return run_id

    def _emit_rep(self, run_id: int, rep: int, call: dict, src: str,
                  nprocs: int, round_bytes, round_traffic=None) -> None:
        """One rep's slices from one attribution call's cells.

        Geometry: every rank shares the rep envelope (on a fused program
        all ranks share wall windows — attribution.py); within the rep,
        round windows are laid out sequentially in program order, each
        as wide as its slowest rank (the wall view); within a round, a
        rank's bucket slices run back-to-back from the round start.
        Span EVENTS are appended in original cell order (aggregation
        order must match the ``Timer.add`` order); only ``ts`` uses the
        grouped geometry.
        """
        rep_start = self._cursor_us
        cells = call["cells"]
        rounds: list = []
        by_round: dict = {}
        for (rank, rnd, _bucket, secs) in cells:
            if rnd not in by_round:
                by_round[rnd] = {}
                rounds.append(rnd)
            per_rank = by_round[rnd]
            per_rank[rank] = per_rank.get(rank, 0.0) + secs
        rounds.sort(key=_round_key)

        # round window starts on the shared timeline
        round_start: dict = {}
        cursor = rep_start
        for rnd in rounds:
            round_start[rnd] = cursor
            if round_bytes is not None:
                self._events.append({
                    "ev": "counter", "run": run_id, "rep": rep,
                    "name": "bytes_in_flight", "ts": cursor,
                    "value": round_bytes.get(str(rnd), 0)})
            if round_traffic is not None:
                rt = round_traffic.get(str(rnd), {})
                for cname, ckey in (("traffic_msgs", "msgs"),
                                    ("traffic_max_incast", "max_incast")):
                    self._events.append({
                        "ev": "counter", "run": run_id, "rep": rep,
                        "name": cname, "ts": cursor,
                        "value": rt.get(ckey, 0)})
            cursor += max(by_round[rnd].values()) * 1e6

        rep_total = call["total"]
        rep_dur = max(rep_total * 1e6, cursor - rep_start)
        for rank in range(nprocs):
            self._events.append({
                "ev": "span", "run": run_id, "rep": rep, "rank": rank,
                "round": None, "bucket": "total", "ts": rep_start,
                "dur": rep_dur, "dur_s": rep_total, "src": src})

        # bucket slices, in cell order; per-(round, rank) running offset
        offs: dict = {}
        for (rank, rnd, bucket, secs) in cells:
            key = (rnd, rank)
            ts = offs.get(key, round_start[rnd])
            self._events.append({
                "ev": "span", "run": run_id, "rep": rep, "rank": rank,
                "round": rnd, "bucket": bucket, "ts": ts,
                "dur": secs * 1e6, "dur_s": secs, "src": src})
            offs[key] = ts + secs * 1e6
        if rounds and round_bytes is not None:
            self._events.append({
                "ev": "counter", "run": run_id, "rep": rep,
                "name": "bytes_in_flight", "ts": rep_start + rep_dur,
                "value": 0})
        if rounds and round_traffic is not None:
            for cname in ("traffic_msgs", "traffic_max_incast"):
                self._events.append({
                    "ev": "counter", "run": run_id, "rep": rep,
                    "name": cname, "ts": rep_start + rep_dur, "value": 0})
        self._cursor_us = rep_start + rep_dur

    def _emit_timer_reps(self, run_id: int, ntimes: int, timers,
                         rep_timers, src: str, nprocs: int) -> None:
        """Slices for backends that never ran the attribution: rebuild
        them from the per-rep Timer rows (local: total-only envelopes;
        native: per-op measured columns become one slice per nonzero
        column per rep)."""
        for rep in range(ntimes):
            rep_start = self._cursor_us
            if rep_timers is not None and rep < len(rep_timers):
                row = rep_timers[rep]
            else:
                # degenerate fallback: equal shares of the accumulated
                # totals (aggregation exactness is not claimed here)
                row = None
            wall = 0.0
            for rank in range(nprocs):
                if row is not None:
                    t = row[rank]
                    cols = [("post", t.post_request_time),
                            ("send_wait", t.send_wait_all_time),
                            ("recv_wait", t.recv_wait_all_time),
                            ("barrier", t.barrier_time)]
                    total = t.total_time
                else:
                    cols = []
                    total = timers[rank].total_time / ntimes
                wall = max(wall, total)
                self._events.append({
                    "ev": "span", "run": run_id, "rep": rep, "rank": rank,
                    "round": None, "bucket": "total", "ts": rep_start,
                    "dur": total * 1e6, "dur_s": total, "src": src})
                ts = rep_start
                for bucket, secs in cols:
                    if secs == 0.0:
                        continue
                    self._events.append({
                        "ev": "span", "run": run_id, "rep": rep,
                        "rank": rank, "round": WHOLE_REP, "bucket": bucket,
                        "ts": ts, "dur": secs * 1e6, "dur_s": secs,
                        "src": src})
                    ts += secs * 1e6
            self._cursor_us = rep_start + wall * 1e6

    # -- output ----------------------------------------------------------
    @property
    def events(self) -> list[dict]:
        return self._events

    def flush(self, prefix: str) -> tuple[str, str]:
        """Write ``<prefix>.trace.jsonl`` (the event log) and
        ``<prefix>.trace.json`` (Chrome/Perfetto). Returns both paths."""
        from tpu_aggcomm_torch.obs.perfetto import to_chrome_trace
        # refresh the ledger preamble: device facts (platform, kind) are
        # recorded by jax-side code after the recorder was created
        try:
            from tpu_aggcomm_torch.obs import ledger
            for e in self._events:
                if e.get("ev") == "ledger":
                    e["manifest"] = ledger.manifest()
                    break
        except Exception:  # lint: broad-ok (ledger enrichment must never sink a trace)
            pass
        from tpu_aggcomm_torch.obs.atomic import atomic_write
        jsonl = f"{prefix}.trace.jsonl"
        with atomic_write(jsonl) as fh:
            for e in self._events:
                fh.write(json.dumps(e) + "\n")
        pft = f"{prefix}.trace.json"
        with atomic_write(pft) as fh:
            json.dump(to_chrome_trace(self._events), fh)
        return jsonl, pft


def _round_bytes(schedule) -> dict | None:
    """Payload bytes entering flight per round, ``{str(round): bytes}``
    — the bytes-in-flight counter input. None when the schedule has no
    edge list to count (dense collectives, the TAM relay)."""
    if getattr(schedule, "assignment", None) is not None:
        return None
    if getattr(schedule, "collective", False):
        return None
    try:
        edges = schedule.data_edges()
    except Exception:  # lint: broad-ok (static shape summary optional; TAM has none)
        return None
    ds = schedule.pattern.data_size
    out: dict[str, int] = {}
    for e in edges:
        rnd = str(int(e[4]))
        out[rnd] = out.get(rnd, 0) + ds
    return out


def _round_traffic(schedule) -> dict | None:
    """Per-round msgs/bytes/max-incast summary for the ``traffic_*``
    counter tracks (obs.traffic.round_traffic, static accounting from
    the op programs — never from measured callbacks). None when the
    schedule has no edge list to count (dense collectives — their
    matrix is O(n^2) dense and belongs in `inspect traffic`, not in
    every traced run — and the TAM relay), mirroring _round_bytes."""
    if getattr(schedule, "assignment", None) is not None:
        return None
    if getattr(schedule, "collective", False):
        return None
    try:
        from tpu_aggcomm_torch.obs.traffic import round_traffic
        return round_traffic(schedule)
    except Exception:  # lint: broad-ok (static shape summary optional; TAM has none)
        return None


# ---------------------------------------------------------------------------
# Host span arithmetic: the readings a tree of host spans gives.

def _named_spans(events: list[dict], name: str) -> list[dict]:
    return sorted((e for e in events
                   if e["ev"] == "host_span" and e["name"] == name),
                  key=lambda e: e["ts"])


def span_total_s(events: list[dict], name: str) -> float:
    """Seconds in every host span named ``name``."""
    return sum(e["dur"] for e in _named_spans(events, name)) / 1e6


def span_child_us(events: list[dict], parent: str, name: str) -> list:
    """For each host span named ``parent``, in the order they started,
    the microseconds of its direct children named ``name``."""
    tops = _named_spans(events, parent)
    got = {e["id"]: 0.0 for e in tops}
    for e in events:
        if (e["ev"] == "host_span" and e["name"] == name
                and e.get("parent") in got):
            got[e["parent"]] += e["dur"]
    return [got[e["id"]] for e in tops]


def span_self_us(events: list[dict], name: str) -> list:
    """For each host span named ``name``, in the order they started, its
    microseconds less those of its direct children: the time spent in
    its own code."""
    tops = _named_spans(events, name)
    kids = {e["id"]: 0.0 for e in tops}
    for e in events:
        if e["ev"] == "host_span" and e.get("parent") in kids:
            kids[e["parent"]] += e["dur"]
    return [e["dur"] - kids[e["id"]] for e in tops]


# ---------------------------------------------------------------------------
# Re-aggregation: trace -> Timer columns (the round-trip contract).

def aggregate_run(events: list[dict], run_id: int):
    """Rebuild the per-rank Timer columns of one run from its span events.

    Mirrors the backend arithmetic exactly: bucket slices accumulate into
    their Timer fields sequentially in event order (the order the
    attribution's ``Timer.add`` calls ran), per rep; per-rep results
    combine by the run's recorded mode — ``sum`` adds rep columns
    sequentially (per-dispatch/profiled backends and the per-rep-timer
    backends), ``scale`` multiplies rep 0 by ntimes (chained/measured
    backends, which build their final timers as ``rep_array * ntimes``).
    Float-exact by construction on both paths.

    Returns ``{rank: {"post": s, "send_wait": s, "recv_wait": s,
    "barrier": s, "total": s}}``. A run that recorded no span events at
    all (zero rounds AND zero rep envelopes — e.g. an aborted dispatch)
    re-aggregates to the empty dict rather than raising: there is
    nothing to rebuild, and the analytics layer treats {} as "no data".
    """
    run = next(e for e in events
               if e["ev"] == "run" and e["id"] == run_id)
    ntimes, combine = run["ntimes"], run["combine"]
    reps: dict[int, dict[int, dict[str, float]]] = {}
    for e in events:
        if e["ev"] != "span" or e["run"] != run_id:
            continue
        per_rank = reps.setdefault(e["rep"], {})
        cols = per_rank.setdefault(
            e["rank"], {k: 0.0 for k in _TIMER_COLS})
        if e["bucket"] == "total":
            cols["total"] = e["dur_s"]
        else:
            for field in BUCKET_FIELDS[e["bucket"]]:
                cols[field] += e["dur_s"]

    out: dict[int, dict[str, float]] = {}
    if not reps:
        return out
    if combine == "scale":
        for rank, cols in reps.get(0, {}).items():
            out[rank] = {k: v * ntimes for k, v in cols.items()}
        return out
    for rep in sorted(reps):
        for rank, cols in reps[rep].items():
            acc = out.setdefault(rank, {k: 0.0 for k in _TIMER_COLS})
            for k, v in cols.items():
                acc[k] += v
    return out


def load_events(path: str) -> list[dict]:
    """Read a ``*.trace.jsonl`` event log."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def summarize_trace(path: str) -> str:
    """Round/rank critical-path summary of a trace file
    (``cli inspect trace <file>``). Works on the JSONL log; a Perfetto
    ``.trace.json`` should be opened in the Perfetto UI instead.
    Multiple files merge via :func:`tpu_aggcomm_torch.obs.metrics
    .summarize_traces`."""
    return summarize_events(load_events(path))


def summarize_events(events: list[dict]) -> str:
    """The per-run summary body of :func:`summarize_trace`, over an
    already-loaded event list (so the multi-file merge can prefix each
    file's section without re-reading)."""
    runs = [e for e in events if e["ev"] == "run"]
    lines = []
    for run in runs:
        rid = run["id"]
        lines.append(
            f"run {rid}: m={run['method']} \"{run['name']}\" "
            f"iter={run['iter']} n={run['nprocs']} d={run['data_size']} "
            f"ntimes={run['ntimes']}")
        lines.append(
            f"  backend {run['backend']} -> executed {run['executed']}; "
            f"phase columns: {run['phase_source']}")
        spans = [e for e in events
                 if e["ev"] == "span" and e["run"] == rid
                 and e["bucket"] != "total" and e["rep"] == 0]
        rounds: dict = {}
        for e in spans:
            r = rounds.setdefault(e["round"], {})
            r[e["rank"]] = r.get(e["rank"], 0.0) + e["dur_s"]
        rbytes = run.get("round_bytes") or {}
        if rounds:
            lines.append("  rep 0 rounds (wall = slowest rank):")
            for rnd in sorted(rounds, key=_round_key):
                per_rank = rounds[rnd]
                crit = max(per_rank, key=per_rank.get)
                label = ("whole-rep" if rnd == WHOLE_REP
                         else f"round {rnd}")
                nb = rbytes.get(str(rnd))
                lines.append(
                    f"    {label:>10}: wall {per_rank[crit] * 1e3:9.3f} ms"
                    f"  critical rank {crit}"
                    + (f"  bytes {nb}" if nb is not None else ""))
        agg = aggregate_run(events, rid)
        if agg:
            crit = max(agg, key=lambda r: agg[r]["total"])
            c = agg[crit]
            lines.append(
                f"  critical rank {crit}: post {c['post']:.6f}  "
                f"send_wait {c['send_wait']:.6f}  "
                f"recv_wait {c['recv_wait']:.6f}  "
                f"barrier {c['barrier']:.6f}  total {c['total']:.6f}")
    hosts = sum(1 for e in events if e["ev"] == "host_span")
    insts = sum(1 for e in events if e["ev"] == "instant")
    if hosts or insts:
        lines.append(f"host-measured events: {hosts} spans, "
                     f"{insts} instants")
    if not runs:
        lines.append("no runs recorded in trace")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Module-level recorder (one active tracing session, like logging's root).

_RECORDER: TraceRecorder | None = None

#: Extra key/value pairs merged into run events recorded while a
#: :func:`run_context` block is active — the causal-correlation channel:
#: the serve layer stamps its batch correlation id (``cid``) here so the
#: flow joiner (obs/flow.py) can tie a request's journal record to the
#: run event of the dispatch that served it. Extras never shadow core
#: run-event fields (``setdefault`` merge).
_RUN_EXTRA: dict = {}


@contextlib.contextmanager
def run_context(**extra):
    """Merge ``extra`` into every run event recorded inside the block.

    Works whether or not tracing is armed (the recorder reads the module
    dict at record time); nested contexts stack, innermost wins, and the
    previous extras are restored on exit — the same discipline as
    ``harness.attribution.cell_recording``."""
    global _RUN_EXTRA
    prev = _RUN_EXTRA
    _RUN_EXTRA = {**prev, **extra}
    try:
        yield
    finally:
        _RUN_EXTRA = prev


def enable(manifest: bool = True) -> TraceRecorder:
    """Switch tracing on; returns the fresh recorder (a lean one, with no
    run-ledger preamble, under ``manifest=False``)."""
    global _RECORDER
    _RECORDER = TraceRecorder(manifest=manifest)
    return _RECORDER


def disable() -> None:
    global _RECORDER
    _RECORDER = None


def enabled() -> bool:
    return _RECORDER is not None


def current() -> TraceRecorder | None:
    return _RECORDER


def span(name: str, **args):
    """A host-measured span when tracing is on; a shared no-op otherwise
    (zero allocation, zero timing calls)."""
    rec = _RECORDER
    return _NOOP if rec is None else rec.span(name, **args)


def instant(name: str, **args) -> None:
    rec = _RECORDER
    if rec is not None:
        rec.instant(name, **args)


def hbm_sample(**kwargs) -> None:
    """An HBM usage sample when tracing is on; a single ``is None``
    check otherwise (callers may skip even querying memory_stats when
    tracing is off — see harness/runner.py)."""
    rec = _RECORDER
    if rec is not None:
        rec.hbm_sample(**kwargs)


def flush(prefix: str):
    """Flush the active recorder to ``<prefix>.trace.{jsonl,json}``; no-op
    (returns None) when tracing is off."""
    rec = _RECORDER
    return None if rec is None else rec.flush(prefix)
