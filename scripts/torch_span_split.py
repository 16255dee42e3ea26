"""The port's host spans over one benchmark cell: where ``tables_s`` and
``host_dispatch_us`` go.

    python scripts/torch_span_split.py <cell> [--seed N] [--seconds S]
        [--root DIR] [--device cuda|cpu]

Runs the cell as ``python3 -m aggbench.run --workload <cell> --trace 0``
does (``aggbench.harness.Session`` and ``Session.measure``: the window,
with the flight recorder off, and the judgement of its outputs), and
adds the port's recorder, a lean one (no manifest):

- around the build, so the ``tables_s`` mark splits into the spans
  ``schedule.compile``, ``tables.edges`` and ``tables.rounds``
  (``schedule_s``, ``edges_s``, ``round_tables_s``), a TAM relay's
  ``tables.relay`` (``relay_tables_s``) and ``cuda_dma``'s step program
  ``tables.steps`` (``step_tables_s``);
- around the warm-up and the window, the port's kernel counters that
  moved in them
  (``window_counters``: ``cuda_dma``'s ``dma_steps.launches``,
  ``.waves`` and ``.full_checks``; ``waves_per_launch``, the wave chain
  a rep runs);
- in span slices after the window, before any profiler has run:
  ``profile_skip + profile_exchanges`` exchanges timed as the window
  times them, with the recorder on and no profiler, in turn with the
  same slice with the recorder off (plain, span, plain, span); over the
  last ``profile_exchanges`` of each span slice, the per-exchange means
  of ``rep``'s self time, ``rep.arena``, ``rep.issue`` and ``rep.hop``
  (``rep_self_us``, ``arena_us``, ``issue_us``, ``hop_us``), and of each
  relay hop's ``rep.hop`` (``hop_issue_us``, hops 1-3), against the span
  slices' own mean dispatch, and that against the plain slices' (what
  tracing costs when on);
- in a profiled slice (``aggbench.tracing.profile_slice``'s loop), run
  once with the recorder off and once on, each reduced by
  ``aggbench.tracing``; the second also with the device-side copies of
  the port's ranges left out (``clean``); where each exchange runs the
  relay's three ``deliver_rows`` launches, each hop's mean device time
  in the clean slice (``hop_device_us``: the exchange's first, second
  and third launch).

It also times empty spans: the wall of a span site off and on, and
what one child span adds to its parent's self time.

Prints one JSON line. Run from the root of a checkout, on the card
(``--device cpu`` with ``--root`` at a small copy of the benchmark
rehearses it).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from aggbench.run import _process_start  # noqa: E402

T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

BUILD = {"schedule_s": "schedule.compile", "edges_s": "tables.edges",
         "round_tables_s": "tables.rounds", "relay_tables_s": "tables.relay",
         "step_tables_s": "tables.steps"}
COUNTERS = ("launches", "waves", "full_checks")
HOPS = 3


def _card() -> str | None:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() or None


def _counters() -> dict:
    """``cuda_dma``'s kernel counters (``dma_steps.<name>``), where the
    process has loaded it."""
    mod = sys.modules.get("tpu_aggcomm_torch.backends.cuda_dma")
    if mod is None:
        return {}
    return {f"dma_steps.{k}": getattr(mod.dma_steps, k) for k in COUNTERS}


def _slice(profile: dict, n: int) -> dict:
    return {"kernels_per_exchange": profile["device_events"] / n,
            "device_busy_us": profile["busy_s"] / n * 1e6,
            "window_s": profile["window_s"],
            "idle_gaps": profile["idle_gaps"],
            "device_ops": profile["device_ops"]}


PARTS = ("rep_self_us", "arena_us", "issue_us", "hop_us")


def _parts(events) -> dict:
    from tpu_aggcomm_torch.obs import trace
    return dict(zip(PARTS, (
        trace.span_self_us(events, "rep"),
        trace.span_child_us(events, "rep", "rep.arena"),
        trace.span_child_us(events, "rep", "rep.issue"),
        trace.span_child_us(events, "rep", "rep.hop"))))


def _hop_issue_us(events) -> list:
    """Each relay hop's ``rep.hop`` span, mean microseconds, hops 1-3
    (empty where the rep runs no relay)."""
    by = {}
    for e in events:
        if e["ev"] == "host_span" and e["name"] == "rep.hop":
            by.setdefault(e["args"]["hop"], []).append(e["dur"])
    return [statistics.fmean(by[k]) for k in sorted(by)]


def _hop_device_us(device, host, skip: int, n: int) -> list:
    """Each relay hop's mean device microseconds over the slice's last
    ``n`` exchanges: the ``deliver_rows`` launches that start in them,
    taken three to an exchange in order (empty unless every exchange ran
    three). A hop's time runs to its end from the later of its start and
    the previous hop's end: each launch is a programmatic dependent one,
    whose record also holds its wait for the launch before it."""
    from aggbench.tracing import DISPATCH
    marks = sorted(h[0] for h in host if h[2] == DISPATCH)
    w0 = marks[skip]
    kernels = sorted((s, e) for s, e, name in device
                     if "deliver_rows_kernel" in name and s >= w0)
    if len(kernels) != HOPS * n:
        return []
    own = [e - (max(s, kernels[i - 1][1]) if i % HOPS else s)
           for i, (s, e) in enumerate(kernels)]
    return [statistics.fmean(t / 1e3 for t in own[k::HOPS])
            for k in range(HOPS)]


def _timed_slice(rep, arenas, count: int, sync, traced: bool):
    """``count`` exchanges timed as the benchmark's window times them:
    each rep call's dispatch seconds, and the recorder's events when
    ``traced``."""
    from tpu_aggcomm_torch.obs import trace
    perf = time.perf_counter
    rec = trace.enable(manifest=False) if traced else None
    dispatch = []
    try:
        for i in range(count):
            t0 = perf()
            got = rep(arenas[i % len(arenas)])
            dispatch.append(perf() - t0)
            sync()
            del got
    finally:
        trace.disable()
    return dispatch, rec.events if rec else None


def _profiled_events(rep, arenas, count: int, sync):
    """``aggbench.tracing.profile_slice``'s loop, returning the profiler's
    events unreduced."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    from aggbench.tracing import DISPATCH, SYNC
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(count):
                with record_function(DISPATCH):
                    got = rep(arenas[i % len(arenas)])
                with record_function(SYNC):
                    sync()
                del got
    return prof.profiler.kineto_results.events()


def _one_clock(rec, host) -> dict:
    """The recorder's ``rep`` spans, moved onto the profiler's clock,
    against the profiler's ``rep`` ranges on the host, in order: how many
    ranges lie inside their span, and the largest overhang (ns)."""
    off = rec.profiler_offset_ns
    spans = [(e["start_ns"] + off, e["end_ns"] + off) for e in rec.events
             if e["ev"] == "host_span" and e["name"] == "rep"]
    ranges = sorted((h[0], h[1]) for h in host if h[2] == "rep")
    if len(spans) != len(ranges):
        return {"spans": len(spans), "ranges": len(ranges)}
    over = [max(s0 - r0, r1 - s1, 0) for (s0, s1), (r0, r1)
            in zip(spans, ranges)]
    return {"spans": len(spans), "inside": sum(o == 0 for o in over),
            "max_overhang_ns": max(over)}


def _span_site_cost(count: int = 20000) -> dict:
    """Empty span sites: the wall of one off and on (ns), and what one
    empty child adds to its parent's self time (us)."""
    from tpu_aggcomm_torch.obs import trace
    perf = time.perf_counter_ns
    t0 = perf()
    for _ in range(count):
        with trace.span("cal"):
            pass
    off = (perf() - t0) / count
    rec = trace.enable(manifest=False)
    try:
        t0 = perf()
        for _ in range(count):
            with trace.span("cal"):
                pass
        on = (perf() - t0) / count
        for _ in range(count):
            with trace.span("cal.parent"):
                with trace.span("cal.child"):
                    pass
    finally:
        trace.disable()
    child = statistics.median(trace.span_self_us(rec.events, "cal.parent"))
    return {"off_ns": off, "on_ns": on, "child_in_parent_self_us": child}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/torch_span_split.py")
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=2**33 + 18)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from aggbench import harness, tracing
    from tpu_aggcomm_torch.obs import trace

    bench = harness.Bench(Path(args.root) if args.root else harness.ROOT)
    rec = trace.enable(manifest=False)
    try:
        session = harness.Session(bench, args.cell, args.device, t0=T0)
    finally:
        trace.disable()
    out = {"cell": args.cell, "seed": args.seed, "card": _card(),
           "device": session.kind}
    out.update({k: trace.span_total_s(rec.events, name)
                for k, name in BUILD.items()})
    out["tables_s"] = session.split["tables_s"]
    out["build_spans_share"] = (sum(out[k] for k in BUILD)
                                / out["tables_s"])

    before = _counters()
    record, checks, failed = session.measure(args.seed, args.seconds, False,
                                             release=False)
    moved = {k: v - before[k] for k, v in _counters().items()}
    out["window_counters"] = moved
    if moved.get("dma_steps.launches"):
        out["waves_per_launch"] = (moved["dma_steps.waves"]
                                   / moved["dma_steps.launches"])
    tr, ad, sync = session.cell.traffic, session.adapter, session.sync
    skip, n = tr["profile_skip"], tr["profile_exchanges"]
    out["correct"] = harness.passed(checks) and not failed
    out["exchange_us"] = record.window_s / record.exchanges * 1e6

    rep, arenas = ad.rep, session._arenas(args.seed)
    for i in range(tr["warmup_exchanges"]):
        rep(arenas[i % len(arenas)])
        sync()
    plain, spans, parts = [], [], {k: [] for k in PARTS}
    hop_issue = []
    for traced in (False, True, False, True):
        dispatch, events = _timed_slice(rep, arenas, skip + n, sync, traced)
        if not traced:
            plain += dispatch[skip:]
            continue
        spans += dispatch[skip:]
        hop_issue.append(_hop_issue_us(events))
        for k, v in _parts(events).items():
            if len(v) != skip + n:
                raise RuntimeError(f"{k}: {len(v)} rep spans in a slice of "
                                   f"{skip + n} exchanges")
            parts[k] += v[skip:]
    out.update({k: statistics.fmean(v) for k, v in parts.items()})
    out["plain_dispatch_us"] = statistics.fmean(plain) * 1e6
    out["span_dispatch_us"] = statistics.fmean(spans) * 1e6
    out["span_share"] = (sum(out[k] for k in PARTS)
                         / out["span_dispatch_us"])
    out["span_cost"] = out["span_dispatch_us"] / out["plain_dispatch_us"]
    out["hop_issue_us"] = [statistics.fmean(h) for h in zip(*hop_issue)]

    out["profiled_off"] = _slice(tracing.profile_slice(rep, arenas, skip, n,
                                                       sync), n)
    rec = trace.enable(manifest=False)
    try:
        events = _profiled_events(rep, arenas, skip + n, sync)
    finally:
        trace.disable()
    device, host = tracing.collect(events)
    out["profiled_on"] = _slice(tracing.reduce(device, host, skip, n), n)
    ported = {e["name"] for e in rec.events if e["ev"] == "host_span"}
    clean = [d for d in device if d[2] not in ported]
    out["profiled_on_clean"] = _slice(tracing.reduce(clean, host, skip, n),
                                      n)
    out["hop_device_us"] = _hop_device_us(clean, host, skip, n)
    out["one_clock"] = _one_clock(rec, host)
    out["span_sites"] = _span_site_cost()
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
