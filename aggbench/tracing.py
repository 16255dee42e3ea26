"""The traced slice: a fixed count of steady exchanges under
``torch.profiler`` (CPU and CUDA activities), reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The benchmark marks its own host spans around each call into the
program (``aggbench.dispatch``: the rep call to its return;
``aggbench.synchronize``: the wait for the device); no span is added
inside the program. The first ``skip`` exchanges of the slice are left
out of the reduction, so the profiler's own start-up is not read.
"""

from __future__ import annotations

import bisect

DISPATCH = "aggbench.dispatch"
SYNC = "aggbench.synchronize"
#: activity types of the device operations counted (kernels, copies, sets)
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: activity types of host events that name what the host was doing
HOST_KINDS = ("cpu_op", "user_annotation")
TOP = 10
#: a breakdown name is cut to this many characters (kernel names carry
#: whole template argument lists)
NAME_CHARS = 120


def profile_slice(rep, arenas, skip: int, n: int, sync) -> dict:
    """Run ``skip + n`` exchanges under the profiler; the reduced slice."""
    import warnings

    from torch.profiler import ProfilerActivity, profile, record_function

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(skip + n):
                with record_function(DISPATCH):
                    out = rep(arenas[i % len(arenas)])
                with record_function(SYNC):
                    sync()
                del out
    device, host = collect(prof.profiler.kineto_results.events())
    return reduce(device, host, skip, n)


def collect(events):
    """Plain ``(start_ns, end_ns, name)`` tuples of the device operations,
    and ``(start_ns, end_ns, name, thread)`` of the host events. The
    device-side copies of the benchmark's own spans (which cover a
    dispatch's kernels and the gaps between them) are not operations."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name() in (DISPATCH, SYNC):
                continue
            if kind is None or kind in DEVICE_KINDS:
                device.append((start, end, e.name()))
        elif e.device_type() == DeviceType.CPU:
            if kind is None or kind in HOST_KINDS:
                host.append((start, end, e.name(), e.start_thread_id()))
    return device, host


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _top(totals: dict) -> list:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in ranked]


def reduce(device, host, skip: int, n: int) -> dict:
    """The slice's exchanges ``skip .. skip + n - 1``: its wall, the union
    of device intervals in it (busy), the count of device operations that
    start in it, the operations that took most time by name, and the
    idle gaps summed by what the host was doing when each began (the
    benchmark's span, and the innermost host operation inside it)."""
    marks = [h for h in host if h[2] in (DISPATCH, SYNC)]
    dispatch = sorted(h for h in marks if h[2] == DISPATCH)
    syncs = sorted(h for h in marks if h[2] == SYNC)
    if len(dispatch) < skip + n or len(syncs) < skip + n:
        raise ValueError(f"the trace holds {len(dispatch)} dispatch and "
                         f"{len(syncs)} synchronize spans, not {skip + n}")
    thread = dispatch[0][3]
    w0, w1 = dispatch[skip][0], syncs[skip + n - 1][1]

    clipped, ops, count = [], {}, 0
    for s, e, name in device:
        if w0 <= s < w1:
            count += 1
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e))
            ops[name] = ops.get(name, 0) + (e - s)
    merged = _merge(clipped)
    busy = sum(e - s for s, e in merged)

    gaps, cursor = [], w0
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))

    idle = {}
    for (g0, g1), name in zip(gaps, _host_at([g for g, _ in gaps], [
            h for h in host if h[3] == thread])):
        idle[name] = idle.get(name, 0) + (g1 - g0)

    return {"exchanges": n, "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9, "device_events": count,
            "device_ops": _top(ops), "idle_gaps": _top(idle)}


def _host_at(times, host):
    """For each time (sorted), what the host thread was doing: ``between``
    outside the benchmark's spans, else ``dispatch`` or ``synchronize``,
    with the innermost host operation inside it after a colon."""
    events = sorted(host, key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in events]
    names, stack, j = [], [], 0
    for t in times:
        hi = bisect.bisect_right(starts, t)
        while j < hi:
            ev = events[j]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        live = [h for h in stack if h[1] > t]
        outer = next((h[2] for h in live if h[2] in (DISPATCH, SYNC)), None)
        if outer is None:
            names.append("between")
            continue
        label = "dispatch" if outer == DISPATCH else "synchronize"
        inner = live[-1][2]
        names.append(label if inner == outer else f"{label}:{inner}")
    return names
