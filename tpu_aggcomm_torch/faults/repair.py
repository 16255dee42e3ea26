"""Schedule repair: reroute around dead links and dead aggregators.

The repair pass is a *program transform* over ``Schedule.programs`` —
schedules stay data (core/schedule.py), no backend knows how repair works,
and the output must survive the same trust gates as any schedule: byte-exact
``--verify`` against the local oracle on every backend that executes it, and
a static traffic-auditor proof of its ``-c`` bound.

Two repairs, applied in this order:

1. **Fallback-aggregator election** (``deadagg:aI``): the I-th aggregator
   rank has failed in its aggregator role. A deterministic election picks
   the lowest-ranked live non-aggregator (avoiding every fault-named rank
   when possible), the pattern is re-homed via
   ``AggregatorPattern.rank_list_override``, and the schedule is simply
   *regenerated* — the method generators already know how to build a
   correct program for any rank_list, so election needs no program surgery
   and works on every backend.

2. **Dead-link detour** (``deadlink:S>D``): the payload for the dead edge
   is rerouted S -> V -> D via a live relay intermediate V on a fresh
   matching channel (``Op.chan`` — a detour sharing a directed pair with a
   pattern edge still matches uniquely). Mechanics per dead edge:

   - S's original send is retargeted to V in place (ISSEND downgraded to
     eager ISEND: V posts its relay receive at its program *tail*, and a
     rendezvous send blocking mid-program on a tail-posted receive would
     deadlock the oracle);
   - D's original receive is removed and its token dropped from D's
     waitalls (blocking mid-program on the late relay hop would deadlock:
     D stuck => D never posts later receives => rendezvous senders to D
     block => V never reaches its relay ops);
   - V appends: receive into a private staging row (``to_stage``), wait,
     forward to D from that staging row (``from_stage``), wait;
   - D appends: receive into the ORIGINAL recv slot, wait — so the
     repaired schedule fills exactly the bytes the healthy one fills
     (byte-exact ``--verify``).

   Relay hops occupy two fresh trailing rounds (hop 1 completes strictly
   before hop 2 begins — the collective backends apply rounds as
   sequential program steps, so a same-round relay would read unfilled
   staging). Token lifetimes are sequential (post, wait, post, wait), so
   the in-flight peak the traffic auditor proves never grows past the
   healthy bound.

jax-free (tests pin this with a poisoned-jax subprocess): repair runs on
CLI/replay paths where jax may not import.
"""

from __future__ import annotations

from dataclasses import replace

from tpu_aggcomm_torch.core.schedule import Op, OpKind, Schedule, TimerBucket
from tpu_aggcomm_torch.faults.spec import FaultSpec, FaultSpecError, parse_fault

__all__ = ["RepairError", "repair_schedule"]


class RepairError(ValueError):
    """The fault cannot be repaired on this schedule (dense collective,
    TAM, blocking receive on the dead edge, no live relay...)."""


_SEND_KINDS = (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND)


def _next_token(prog) -> int:
    """1 + the largest token id referenced anywhere in a rank's program."""
    mx = -1
    for op in prog:
        mx = max(mx, op.token, *op.tokens) if op.tokens else max(mx, op.token)
    return mx + 1


def _max_round(programs) -> int:
    return max((op.round for prog in programs for op in prog), default=0)


def _elect_fallbacks(schedule, spec: FaultSpec):
    """Deterministic fallback election for every dead aggregator index.

    Returns ``(new_pattern, dead_agg_ranks)`` — the re-homed pattern and
    the ORIGINAL ranks whose aggregator role died (the detour pass avoids
    them as relay intermediates)."""
    p = schedule.pattern
    rank_list = [int(r) for r in p.rank_list]
    dead_agg_ranks = [rank_list[i] for i in spec.deadaggs]
    fault_named = ({r for r, _ in spec.slow}
                   | {s for s, _ in spec.deadlinks}
                   | {d for _, d in spec.deadlinks}
                   | set(dead_agg_ranks))
    taken = set(rank_list)
    for i in spec.deadaggs:
        # preference: lowest live rank that is neither an aggregator nor
        # named by any fault clause; relaxed: any non-aggregator that is
        # not itself a dead aggregator (a slow replacement beats none)
        cand = next((r for r in range(p.nprocs)
                     if r not in taken and r not in fault_named), None)
        if cand is None:
            cand = next((r for r in range(p.nprocs)
                         if r not in taken and r not in dead_agg_ranks), None)
        if cand is None:
            raise RepairError(
                f"no live rank available to replace dead aggregator "
                f"a{i} (rank {rank_list[i]}) in nprocs={p.nprocs}")
        rank_list[i] = cand
        taken.add(cand)
    return (replace(p, rank_list_override=tuple(rank_list)), dead_agg_ranks)


def _pick_relay(nprocs: int, s: int, d: int, *, dead_links: set,
                avoid: set) -> int:
    """Deterministic relay choice for dead edge s->d: the lowest-ranked
    rank v with live links s->v and v->d, preferring ranks not named by
    any fault clause."""
    def ok(v: int, strict: bool) -> bool:
        if v in (s, d):
            return False
        if (s, v) in dead_links or (v, d) in dead_links:
            return False
        return not (strict and v in avoid)

    for strict in (True, False):
        for v in range(nprocs):
            if ok(v, strict):
                return v
    raise RepairError(
        f"no live relay intermediate for dead link {s}>{d} "
        f"(nprocs={nprocs})")


def _detour_dead_links(schedule, spec: FaultSpec, dead_agg_ranks):
    """Reroute every dead pattern edge via a live relay. Returns the
    repaired (programs, n_staging, dead_edges)."""
    progs = [[replace(op) for op in prog] for prog in schedule.programs]
    dead_links = set(spec.deadlinks)
    avoid = ({r for r, _ in spec.slow}
             | {x for e in spec.deadlinks for x in e}
             | set(dead_agg_ranks))
    base_round = _max_round(progs) + 1
    next_tok = [_next_token(prog) for prog in progs]
    dead_edges = []
    n_staging = 0
    for s, d in spec.deadlinks:
        send_op = next((op for op in progs[s]
                        if op.kind in _SEND_KINDS and op.peer == d
                        and op.nbytes > 0 and op.chan == 0), None)
        if send_op is None:
            sr = next((op for op in progs[s]
                       if op.kind is OpKind.SENDRECV and op.peer == d
                       and op.nbytes > 0), None)
            if sr is not None:
                raise RepairError(
                    f"dead link {s}>{d}: m={schedule.method_id} "
                    f"({schedule.name}) sends it inside a blocking "
                    f"SENDRECV pair; the paired exchange cannot be "
                    f"retargeted — no repair")
            continue  # the pattern has no s->d payload; nothing to reroute
        recv_op = next((op for op in progs[d]
                        if op.kind is OpKind.IRECV and op.peer == s
                        and op.chan == 0), None)
        if recv_op is None:
            blocking = next((op for op in progs[d]
                             if op.kind in (OpKind.RECV, OpKind.SENDRECV)
                             and (op.peer == s or op.peer2 == s)), None)
            if blocking is not None:
                raise RepairError(
                    f"dead link {s}>{d}: m={schedule.method_id} "
                    f"({schedule.name}) receives it with a blocking "
                    f"{blocking.kind.name}; the detour arrives after the "
                    f"blocking point and would deadlock — no repair")
            raise RepairError(
                f"dead link {s}>{d}: send found but no matching receive "
                f"in m={schedule.method_id} ({schedule.name})")
        v = _pick_relay(schedule.pattern.nprocs, s, d,
                        dead_links=dead_links, avoid=avoid)
        chan = 1 + n_staging
        stage = n_staging
        n_staging += 1
        nb = send_op.nbytes
        # hop 1: retarget s's send in place; eager (see module docstring)
        send_op.peer = v
        send_op.chan = chan
        send_op.round = base_round
        if send_op.kind is OpKind.ISSEND:
            send_op.kind = OpKind.ISEND
        # drop d's original receive and its token from d's waitalls
        progs[d].remove(recv_op)
        for op in progs[d]:
            if op.kind is OpKind.WAITALL and recv_op.token in op.tokens:
                op.tokens = tuple(t for t in op.tokens
                                  if t != recv_op.token)
        # relay rank v: stage in, forward out (sequential token lifetimes)
        t1, t2 = next_tok[v], next_tok[v] + 1
        next_tok[v] += 2
        progs[v] += [
            Op(OpKind.IRECV, peer=s, slot=stage, round=base_round,
               token=t1, bucket=TimerBucket.POST, nbytes=nb, chan=chan,
               to_stage=True),
            Op(OpKind.WAITALL, tokens=(t1,), round=base_round,
               bucket=TimerBucket.RECV_WAIT),
            Op(OpKind.ISEND, peer=d, slot=stage, round=base_round + 1,
               token=t2, bucket=TimerBucket.POST, nbytes=nb, chan=chan,
               from_stage=True),
            Op(OpKind.WAITALL, tokens=(t2,), round=base_round + 1,
               bucket=TimerBucket.SEND_WAIT),
        ]
        # d: re-receive into the ORIGINAL slot, from v
        t3 = next_tok[d]
        next_tok[d] += 1
        progs[d] += [
            Op(OpKind.IRECV, peer=v, slot=recv_op.slot,
               round=base_round + 1, token=t3, bucket=TimerBucket.POST,
               nbytes=nb, chan=chan),
            Op(OpKind.WAITALL, tokens=(t3,), round=base_round + 1,
               bucket=TimerBucket.RECV_WAIT),
        ]
        dead_edges.append((s, d))
    # Refusal scan: the oracle DROPS every chan-0 message on a dead link
    # (payload or 0-byte sync alike — backends/local.py try_deliver), so
    # any crossing op still left after the detours strands its receiver
    # at runtime. Before the model checker existed this fell through the
    # "no s->d payload; nothing to reroute" case and returned a
    # deadlocking program for e.g. the pairwise methods, whose 0-byte
    # SENDRECV sync exchange touches every directed pair. Refuse
    # instead — the checker (analysis/check.py) and the oracle agree.
    # (Signal handshakes ride separate plumbing with no drop rule and
    # are deliberately not scanned.)
    for r, prog in enumerate(progs):
        for op in prog:
            crossing = None
            if (op.kind in _SEND_KINDS and op.chan == 0
                    and (r, op.peer) in dead_links):
                crossing = (r, op.peer)
            elif op.kind is OpKind.SENDRECV:
                if (r, op.peer) in dead_links:
                    crossing = (r, op.peer)
                elif (op.peer2, r) in dead_links:
                    crossing = (op.peer2, r)
            elif (op.kind in (OpKind.IRECV, OpKind.RECV) and op.chan == 0
                    and (op.peer, r) in dead_links):
                crossing = (op.peer, r)
            if crossing:
                raise RepairError(
                    f"dead link {crossing[0]}>{crossing[1]}: rank {r} "
                    f"still crosses it with a {op.kind.name} "
                    f"({op.nbytes} B) after detouring — the link drops "
                    f"it and the receiver deadlocks; no repair for "
                    f"m={schedule.method_id} ({schedule.name})")
    return progs, n_staging, tuple(dead_edges)


def repair_schedule(schedule: Schedule, spec, *, barrier_type: int = 0):
    """Repair ``schedule`` for fault ``spec`` (a FaultSpec or spec string).

    Returns a new Schedule whose programs route every payload the healthy
    schedule delivers, with ``fault``/``variant`` stamped to the canonical
    spec (distinct compiled-cache key), ``n_staging`` relay rows, and the
    rerouted ``dead_edges`` recorded. Slow-rank clauses change no program
    — they are realized by the backends' injection layer — but the stamp
    still forces a distinct compiled program (the injected delay loop).
    Raises :class:`RepairError` when no safe reroute exists.
    """
    if isinstance(spec, str):
        spec = parse_fault(spec)
    if spec.empty:
        return schedule
    if getattr(schedule, "programs", None) is None:
        raise RepairError(
            f"m={schedule.method_id} has no op programs (TAM's staged "
            f"engine); fault repair needs a round-structured schedule")
    if schedule.collective:
        raise RepairError(
            f"m={schedule.method_id} ({schedule.name}) is a dense "
            f"collective; fault repair needs a round-structured schedule")
    p = schedule.pattern
    spec.validate_against(p.nprocs, p.cb_nodes)
    for s, d in spec.deadlinks:
        if s == d:
            raise FaultSpecError(
                f"deadlink {s}>{d} is a self-link (COPY edges cannot die)")

    dead_agg_ranks: list = []
    if spec.deadaggs:
        from tpu_aggcomm_torch.core.methods import compile_method
        pattern2, dead_agg_ranks = _elect_fallbacks(schedule, spec)
        schedule = compile_method(schedule.method_id, pattern2,
                                  barrier_type=barrier_type)

    progs, n_staging, dead_edges = _detour_dead_links(
        schedule, spec, dead_agg_ranks)

    canon = spec.canonical()
    repaired = replace(schedule, programs=progs, fault=canon,
                       variant=canon, n_staging=n_staging,
                       dead_edges=dead_edges)
    try:
        repaired.validate()
    except AssertionError as e:  # pragma: no cover - self-check
        raise RepairError(f"repair self-check failed: {e}") from e
    return repaired
