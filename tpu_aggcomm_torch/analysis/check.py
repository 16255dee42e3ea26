"""Schedule model checker: prove liveness and conservation statically.

Everything here is symbolic execution over ``Schedule.programs`` — no
backend, no jax, no measured callback. The completion semantics mirror
``backends/local.py`` (the runtime oracle) op for op:

- ISEND / SIGNAL_SEND complete at post (eager); SEND is modeled eager
  too (MPICH buffers benchmark-sized payloads eagerly and m=6/7 NEED
  that — see the oracle's SEND comment);
- ISSEND completes only when the matching receive is POSTED
  (rendezvous — delivery in the oracle happens at ``try_deliver`` as
  soon as both sides are posted);
- IRECV/RECV complete at delivery, i.e. when the matching send is
  posted; SENDRECV posts its send half eagerly and blocks on its recv
  half; WAITALL completes when every listed token's op completed;
- BARRIER / ALLTOALLW are n-rank generation joins;
- a chan-0 message on a dead link (``schedule.fault`` deadlinks) is
  DROPPED: it never delivers and never completes anything.

Five properties per schedule, each PROVEN or REFUTED with a named
witness (never a bare boolean):

1. **deadlock_freedom** — the Issue/Complete event graph is acyclic and
   every required completion has a match. Refutation names either the
   unmatched op (e.g. a rendezvous send whose receive was never posted)
   or the offending cycle, rank/op by rank/op.
2. **race_freedom** — no two in-flight writes to the same (rank, recv
   row) overlap: an IRECV's write interval spans post → its WAITALL
   (never-waited = open), blocking RECV / SENDRECV-recv / COPY write at
   their program point; staging rows are a separate namespace.
3. **conservation** — per matching key (src, dst, chan): exactly one
   send and one matching receive, byte counts equal where both sides
   declare them; chan-0 delivered bytes (+ COPY memcpys) equal the
   pattern's expected coverage, dead edges excepted — each dead edge
   must instead be covered by a relay detour chain. Cross-checked
   against ``obs.traffic.round_edges`` so the two static views can
   never drift apart silently.
4. **barrier_symmetry** — every rank's barrier (round-tag) signature is
   identical (the property ``core.schedule.barrier_rounds_of`` /
   ``schedule_shape_key`` now *check* instead of assume).
5. **round_monotonicity** — per rank, blocking-op round tags never
   decrease; matched send/recv (and signal) pairs agree on their round
   tag; a WAITALL's round is >= the round of every rendezvous-send /
   recv token it completes (eager tokens complete at post and are
   exempt — the repair pass legitimately retags a detoured eager send
   to its relay round).

Schedules with no rank op programs (the hierarchical TAM engine) are
EXEMPT, exactly like the traffic auditor.
"""

from __future__ import annotations

import math

__all__ = ["CheckError", "CHECK_SCHEMA", "PROPERTIES", "check_schedule",
           "check_sweep", "render_check", "render_check_sweep",
           "write_artifact"]

CHECK_SCHEMA = "check-v1"

PROPERTIES = ("deadlock_freedom", "race_freedom", "conservation",
              "barrier_symmetry", "round_monotonicity")

# cap per-property witness lists in reports/artifacts (the first
# offender is the proof; thousands of them are noise)
MAX_WITNESSES = 8


class CheckError(ValueError):
    """A schedule cannot be checked as asked (unknown method id,
    malformed fault spec...)."""


def _op_kinds():
    from tpu_aggcomm_torch.core.schedule import OpKind
    return OpKind


def _dead_pairs(schedule) -> set:
    """Directed chan-0 pairs whose link drops messages (the oracle's
    injection rule for UNREPAIRED faulted schedules). Repaired
    schedules have no chan-0 op left on these pairs, so the set is
    harmless there."""
    fault = getattr(schedule, "fault", None)
    if not fault:
        return set()
    from tpu_aggcomm_torch.faults.spec import parse_fault
    return set(parse_fault(fault).deadlinks)


def _op_label(rank: int, idx: int, op) -> dict:
    OpKind = _op_kinds()
    d = {"rank": rank, "op_index": idx, "kind": OpKind(op.kind).name,
         "round": int(op.round)}
    if op.kind is OpKind.WAITALL:
        d["tokens"] = list(op.tokens)
    elif op.peer >= 0:
        d["peer"] = int(op.peer)
    return d


# ---------------------------------------------------------------------------
# Property 1: deadlock freedom (the waits-for event graph)

def _deadlock_freedom(schedule) -> dict:
    OpKind = _op_kinds()
    progs = schedule.programs
    n = len(progs)
    dead = _dead_pairs(schedule)

    # node ids: per op, Issue = 2*opid, Complete = 2*opid + 1; virtual
    # join nodes (barrier / alltoallw generations) appended after.
    base = [0] * n
    total = 0
    for r, prog in enumerate(progs):
        base[r] = total
        total += len(prog)

    def issue(r, i):
        return 2 * (base[r] + i)

    def complete(r, i):
        return 2 * (base[r] + i) + 1

    deps: list[list[int]] = [[] for _ in range(2 * total)]
    never_desc: dict[int, str] = {}  # sentinel nodes that can never fire

    def never(desc: str) -> int:
        nid = len(deps)
        deps.append([])
        never_desc[nid] = desc
        return nid

    # matching tables (message matching is by (src, dst, chan), unique
    # per rep — mpi_test.c:1776; signals match FIFO per directed pair)
    send_post: dict = {}
    recv_post: dict = {}
    sig_send: dict = {}
    sig_recv: dict = {}
    token_of: list[dict] = [dict() for _ in range(n)]
    barrier_ops: list[list[int]] = [[] for _ in range(n)]
    a2aw_ops: list[list[int]] = [[] for _ in range(n)]
    dup = None
    for r, prog in enumerate(progs):
        for i, op in enumerate(prog):
            k = op.kind
            if k in (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND):
                key = (r, op.peer, op.chan)
                if key in send_post:
                    dup = dup or f"duplicate send on matching key {key}"
                send_post[key] = (r, i)
            elif k in (OpKind.IRECV, OpKind.RECV):
                key = (op.peer, r, op.chan)
                if key in recv_post:
                    dup = dup or f"duplicate recv on matching key {key}"
                recv_post[key] = (r, i)
            elif k is OpKind.SENDRECV:
                skey = (r, op.peer, 0)
                rkey = (op.peer2, r, 0)
                if skey in send_post:
                    dup = dup or f"duplicate send on matching key {skey}"
                if rkey in recv_post:
                    dup = dup or f"duplicate recv on matching key {rkey}"
                send_post[skey] = (r, i)
                recv_post[rkey] = (r, i)
            elif k is OpKind.SIGNAL_SEND:
                sig_send.setdefault((r, op.peer), []).append((r, i))
            elif k is OpKind.SIGNAL_RECV:
                sig_recv.setdefault((op.peer, r), []).append((r, i))
            elif k is OpKind.BARRIER:
                barrier_ops[r].append(i)
            elif k is OpKind.ALLTOALLW:
                a2aw_ops[r].append(i)
            if op.token >= 0:
                token_of[r][op.token] = i
    if dup:
        # ambiguous matching is a structural defect: the waits-for graph
        # is not well defined, which is itself a refutation
        return {"verdict": "REFUTED", "detail": dup, "unmatched": [],
                "cycle": []}

    # virtual generation joins: one node per barrier / collective
    # generation, depending on every rank's g-th Issue (linear in n
    # instead of the n^2 all-pairs join)
    def join_nodes(per_rank_ops, what):
        counts = {len(x) for x in per_rank_ops}
        gens = max(len(x) for x in per_rank_ops) if per_rank_ops else 0
        nodes = []
        for g in range(gens):
            nid = len(deps)
            deps.append([])
            for r in range(n):
                if g < len(per_rank_ops[r]):
                    deps[nid].append(issue(r, per_rank_ops[r][g]))
                else:
                    deps[nid].append(never(
                        f"{what} generation {g}: rank {r} has only "
                        f"{len(per_rank_ops[r])} {what} op(s) — the "
                        f"n-rank join can never release (arity skew)"))
            nodes.append(nid)
        return nodes, len(counts) > 1

    barrier_join, _ = join_nodes(barrier_ops, "barrier")
    a2aw_join, _ = join_nodes(a2aw_ops, "alltoallw")

    BLOCKING = (OpKind.RECV, OpKind.SENDRECV, OpKind.WAITALL,
                OpKind.BARRIER, OpKind.SIGNAL_RECV, OpKind.ALLTOALLW)

    def match_send(key, r, i, what):
        """Dep for 'the matching send of key is posted'."""
        if key[2] == 0 and (key[0], key[1]) in dead:
            return never(f"{what} at rank {r} op {i}: the {key[0]}>"
                         f"{key[1]} link is dead — the message is "
                         f"dropped and never delivers")
        if key in send_post:
            sr, si = send_post[key]
            return issue(sr, si)
        return never(f"{what} at rank {r} op {i}: no matching send "
                     f"posted for (src={key[0]}, dst={key[1]}, "
                     f"chan={key[2]})")

    def match_recv(key, r, i, what):
        """Dep for 'the matching receive of key is posted'."""
        if key[2] == 0 and (key[0], key[1]) in dead:
            return never(f"{what} at rank {r} op {i}: the {key[0]}>"
                         f"{key[1]} link is dead — rendezvous can "
                         f"never complete")
        if key in recv_post:
            rr, ri = recv_post[key]
            return issue(rr, ri)
        return never(f"{what} at rank {r} op {i}: no matching receive "
                     f"posted for (src={key[0]}, dst={key[1]}, "
                     f"chan={key[2]})")

    bar_seen = [0] * n
    a2aw_seen = [0] * n
    for r, prog in enumerate(progs):
        for i, op in enumerate(prog):
            k = op.kind
            # program order: issuing op i needs op i-1 issued, plus
            # completed when op i-1 blocks the program counter
            if i > 0:
                deps[issue(r, i)].append(issue(r, i - 1))
                if prog[i - 1].kind in BLOCKING:
                    deps[issue(r, i)].append(complete(r, i - 1))
            c = deps[complete(r, i)]
            c.append(issue(r, i))
            if k is OpKind.ISSEND:
                c.append(match_recv((r, op.peer, op.chan), r, i,
                                    "rendezvous ISSEND"))
            elif k in (OpKind.IRECV, OpKind.RECV):
                c.append(match_send((op.peer, r, op.chan), r, i,
                                    k.name))
            elif k is OpKind.SENDRECV:
                c.append(match_send((op.peer2, r, 0), r, i,
                                    "SENDRECV recv half"))
            elif k is OpKind.WAITALL:
                for t in op.tokens:
                    ti = token_of[r].get(t)
                    if ti is None:
                        c.append(never(
                            f"WAITALL at rank {r} op {i} waits on token "
                            f"{t} that no op of rank {r} ever posts"))
                    else:
                        c.append(complete(r, ti))
            elif k is OpKind.BARRIER:
                c.append(barrier_join[bar_seen[r]])
                bar_seen[r] += 1
            elif k is OpKind.SIGNAL_RECV:
                pair = (op.peer, r)
                ordinal = len([x for x in sig_recv.get(pair, ())
                               if x[0] == r and x[1] <= i]) - 1
                sends = sig_send.get(pair, ())
                if ordinal < len(sends):
                    sr, si = sends[ordinal]
                    c.append(issue(sr, si))
                else:
                    c.append(never(
                        f"SIGNAL_RECV at rank {r} op {i}: only "
                        f"{len(sends)} signal(s) ever sent on pair "
                        f"{pair}, need {ordinal + 1}"))
            elif k is OpKind.ALLTOALLW:
                c.append(a2aw_join[a2aw_seen[r]])
                a2aw_seen[r] += 1
            # ISEND / SEND / SIGNAL_SEND / COPY: complete at issue

    # Kahn propagation over the AND-dependency graph: a node fires when
    # every dep fired; sentinel ("never") nodes cannot fire
    n_nodes = len(deps)
    pending = [len(d) for d in deps]
    rev: list[list[int]] = [[] for _ in range(n_nodes)]
    for node, ds in enumerate(deps):
        for d in ds:
            rev[d].append(node)
    fired = [False] * n_nodes
    queue = [node for node in range(n_nodes)
             if pending[node] == 0 and node not in never_desc]
    while queue:
        node = queue.pop()
        if fired[node]:
            continue
        fired[node] = True
        for succ in rev[node]:
            pending[succ] -= 1
            if pending[succ] == 0 and succ not in never_desc:
                queue.append(succ)

    stuck = [node for node in range(2 * total) if not fired[node]]
    if not stuck:
        return {"verdict": "PROVEN",
                "detail": f"all {2 * total} issue/complete events fire: "
                          f"acyclic waits-for graph, every required "
                          f"completion matched",
                "unmatched": [], "cycle": []}

    # name the refutation: unmatched root causes first, then a cycle
    import bisect

    def describe(node):
        opid, kind = divmod(node, 2)
        r = bisect.bisect_right(base, opid) - 1
        while not progs[r]:
            r -= 1
        i = opid - base[r]
        d = _op_label(r, i, progs[r][i])
        d["event"] = "complete" if kind else "issue"
        return d

    # root causes: never-deps of ANY unfired node — virtual join nodes
    # included, so "barrier generation g: rank r has fewer barriers"
    # surfaces even though the join sits between the op and the sentinel
    unfired = [node for node in range(n_nodes)
               if not fired[node] and node not in never_desc]
    unmatched = []
    seen_desc = set()
    for node in unfired:
        for d in deps[node]:
            if d in never_desc and never_desc[d] not in seen_desc:
                seen_desc.add(never_desc[d])
                unmatched.append(never_desc[d])
    # cycle extraction: follow unsatisfied deps among unfired nodes
    # (virtual joins are traversed but elided from the description)
    cycle = []
    unfired_set = set(unfired)
    visited = set()
    for start in stuck:
        if start in visited:
            continue
        path, on_path = [], {}
        node = start
        while node is not None and node not in visited:
            if node in on_path:
                cyc = path[path.index(node):]
                cycle = [describe(x) for x in cyc if x < 2 * total]
                break
            on_path[node] = True
            path.append(node)
            node = next((d for d in deps[node]
                         if d in unfired_set), None)
        if cycle:
            break
        visited.update(path)
    head = (f"{len(stuck)} of {2 * total} events can never fire"
            if not unmatched else unmatched[0])
    if cycle and not unmatched:
        head = (f"waits-for cycle through {len(cycle)} events, e.g. "
                f"rank {cycle[0]['rank']} op {cycle[0]['op_index']} "
                f"({cycle[0]['kind']})")
    return {"verdict": "REFUTED", "detail": head,
            "unmatched": unmatched[:MAX_WITNESSES],
            "cycle": cycle[:4 * MAX_WITNESSES]}


# ---------------------------------------------------------------------------
# Property 2: recv-slot race freedom

def _race_freedom(schedule) -> dict:
    OpKind = _op_kinds()
    races = []
    checked = 0
    for r, prog in enumerate(schedule.programs):
        # token -> pc of the WAITALL completing it (first one listing it)
        wait_pc: dict[int, int] = {}
        for i, op in enumerate(prog):
            if op.kind is OpKind.WAITALL:
                for t in op.tokens:
                    wait_pc.setdefault(t, i)
        intervals: dict[tuple, list] = {}
        for i, op in enumerate(prog):
            if op.kind is OpKind.IRECV and op.nbytes > 0:
                row = (("stage" if op.to_stage else "slot"), op.slot)
                end = wait_pc.get(op.token, math.inf)
                intervals.setdefault(row, []).append((i, end, i))
            elif op.kind is OpKind.RECV and op.nbytes > 0:
                row = (("stage" if op.to_stage else "slot"), op.slot)
                intervals.setdefault(row, []).append((i, i, i))
            elif op.kind is OpKind.SENDRECV and op.nbytes > 0:
                intervals.setdefault(("slot", op.slot2), []).append((i, i, i))
            elif op.kind is OpKind.COPY:
                intervals.setdefault(("slot", op.slot2), []).append((i, i, i))
        for row, ivs in intervals.items():
            checked += len(ivs)
            ivs.sort()
            for (s1, e1, i1), (s2, _e2, i2) in zip(ivs, ivs[1:]):
                if s2 <= e1:
                    races.append({
                        "rank": r, "row": list(row),
                        "ops": [i1, i2],
                        "detail": f"rank {r} {row[0]} {row[1]}: write "
                                  f"of op {i2} is in flight while the "
                                  f"write of op {i1} (completed at "
                                  f"{'op %d' % e1 if e1 != math.inf else 'no WAITALL — open interval'}) "
                                  f"is still outstanding"})
    if races:
        return {"verdict": "REFUTED",
                "detail": races[0]["detail"],
                "races": races[:MAX_WITNESSES]}
    return {"verdict": "PROVEN",
            "detail": f"{checked} receive-row write intervals, no two "
                      f"in flight on the same (rank, row)",
            "races": []}


# ---------------------------------------------------------------------------
# Property 3: byte conservation

def _conservation(schedule) -> dict:
    OpKind = _op_kinds()
    p = schedule.pattern
    offenders = []
    if getattr(schedule, "collective", False):
        send, recv = p.dense_counts()
        tx = int(send.sum())
        rx = int(recv.sum())
        if tx != rx or (send.T != recv).any():
            offenders.append(f"dense matrices disagree: {tx} B sent vs "
                             f"{rx} B received")
        counts = [sum(1 for op in prog if op.kind is OpKind.ALLTOALLW)
                  for prog in schedule.programs]
        if len(set(counts)) > 1:
            offenders.append(f"collective join arity differs across "
                             f"ranks: {sorted(set(counts))}")
        if offenders:
            return {"verdict": "REFUTED", "detail": offenders[0],
                    "offenders": offenders, "edges": 0, "bytes": tx}
        return {"verdict": "PROVEN",
                "detail": f"dense collective: send matrix transposes "
                          f"to the recv matrix, {tx} B each way, "
                          f"uniform {counts[0]}-call join on all "
                          f"{p.nprocs} ranks",
                "offenders": [], "edges": int((send > 0).sum()),
                "bytes": tx}

    dead = _dead_pairs(schedule)
    sends: dict = {}
    recvs: dict = {}
    copies: dict = {}
    for r, prog in enumerate(schedule.programs):
        for i, op in enumerate(prog):
            k = op.kind
            if k in (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND):
                sends[(r, op.peer, op.chan)] = (op.nbytes, i,
                                                op.from_stage)
            elif k in (OpKind.IRECV, OpKind.RECV):
                recvs[(op.peer, r, op.chan)] = (op.nbytes, i,
                                                op.to_stage)
            elif k is OpKind.SENDRECV:
                sends[(r, op.peer, 0)] = (op.nbytes, i, False)
                # the recv half declares no independent byte count (the
                # op's nbytes is the SEND count — m=9/10 pairwise posts
                # asymmetric halves): existence-only
                recvs[(op.peer2, r, 0)] = (None, i, False)
            elif k is OpKind.COPY:
                copies[(r, r)] = copies.get((r, r), 0) + p.data_size

    delivered: dict = {}
    for key, (nb, _i, _st) in sends.items():
        src, dst, chan = key
        if nb and key not in recvs:
            offenders.append(f"send {key} ({nb} B) has no matching "
                             f"receive — bytes are lost")
            continue
        rnb = recvs.get(key, (None, None, None))[0]
        if nb and rnb is not None and rnb != nb:
            offenders.append(f"byte mismatch on {key}: send posts "
                             f"{nb} B, receive expects {rnb} B")
        if chan == 0 and (src, dst) in dead:
            if nb:
                offenders.append(f"send {key} ({nb} B) crosses the "
                                 f"dead {src}>{dst} link — dropped, "
                                 f"never delivered")
            continue
        if nb and chan == 0:
            delivered[(src, dst)] = delivered.get((src, dst), 0) + nb
    for key, (rnb, _i, _st) in recvs.items():
        if key not in sends:
            offenders.append(f"receive {key} has no matching send — "
                             f"it can never be satisfied")

    # pattern coverage: every (sender, receiver) pair must get its
    # data_size bytes on chan 0 or via COPY; a dead edge must instead
    # be covered by a relay detour chain (chan != 0, staged hop)
    dead_edges = {(int(s), int(d))
                  for s, d in getattr(schedule, "dead_edges", ())}
    expected = {(int(s), int(d)) for s in p.senders for d in p.receivers}
    for s, d in sorted(expected):
        got = delivered.get((s, d), 0) + copies.get((s, d), 0)
        if (s, d) in dead_edges:
            if got:
                offenders.append(f"dead edge ({s}, {d}) still delivers "
                                 f"{got} B on the data channel")
            hop1 = any(k[0] == s and k[2] and v[2]
                       for k, v in recvs.items())
            hop2 = any(k[1] == d and k[2] and v[2]
                       for k, v in sends.items())
            if not (hop1 and hop2):
                offenders.append(f"dead edge ({s}, {d}) has no relay "
                                 f"detour chain (staged hop via a live "
                                 f"intermediate)")
        elif got != p.data_size:
            offenders.append(f"pair ({s}, {d}) delivers {got} B, "
                             f"pattern expects {p.data_size} B")
    for pair in sorted(set(delivered) - expected):
        if delivered[pair]:
            offenders.append(f"pair {pair} delivers "
                             f"{delivered[pair]} B outside the "
                             f"pattern's sender x receiver coverage")

    # cross-check against the traffic auditor's matrix: two independent
    # walks over the same programs must count the same bytes per pair
    from tpu_aggcomm_torch.obs.traffic import round_edges
    tm: dict = {}
    for c in round_edges(schedule).values():
        for pair, b in c["edges"].items():
            tm[pair] = tm.get(pair, 0) + b
    mine: dict = {}
    for (src, dst, _chan), (nb, _i, _st) in sends.items():
        if nb:
            mine[(src, dst)] = mine.get((src, dst), 0) + nb
    if tm != mine:
        diff = {k: (mine.get(k, 0), tm.get(k, 0))
                for k in set(mine) | set(tm)
                if mine.get(k, 0) != tm.get(k, 0)}
        offenders.append(f"traffic-matrix cross-check disagrees on "
                         f"{len(diff)} pair(s), e.g. "
                         f"{sorted(diff.items())[:3]}")

    total = sum(v for v in delivered.values()) + sum(copies.values())
    if offenders:
        return {"verdict": "REFUTED", "detail": offenders[0],
                "offenders": offenders[:MAX_WITNESSES],
                "edges": len(sends), "bytes": total}
    return {"verdict": "PROVEN",
            "detail": f"{len(sends)} matched sends, {total} B delivered "
                      f"== pattern coverage; traffic-matrix cross-check "
                      f"agrees",
            "offenders": [], "edges": len(sends), "bytes": total}


# ---------------------------------------------------------------------------
# Property 4: barrier SPMD symmetry

def _barrier_symmetry(schedule) -> dict:
    from tpu_aggcomm_torch.core.schedule import barrier_signatures
    sigs = barrier_signatures(schedule)
    ref = sigs[0] if sigs else ()
    bad = [r for r, s in enumerate(sigs) if s != ref]
    if bad:
        r = bad[0]
        return {"verdict": "REFUTED",
                "detail": f"barrier signature of rank {r} is "
                          f"{list(sigs[r])}, rank 0 has {list(ref)} — "
                          f"the schedule is not SPMD-symmetric "
                          f"({len(bad)} divergent rank(s))",
                "signature": list(ref), "divergent_ranks":
                    bad[:MAX_WITNESSES]}
    return {"verdict": "PROVEN",
            "detail": f"all {len(sigs)} ranks share the barrier "
                      f"signature {list(ref)}",
            "signature": list(ref), "divergent_ranks": []}


# ---------------------------------------------------------------------------
# Property 5: round-fence monotonicity

def _round_monotonicity(schedule) -> dict:
    OpKind = _op_kinds()
    offenders = []
    BLOCKING = (OpKind.RECV, OpKind.SENDRECV, OpKind.WAITALL,
                OpKind.BARRIER, OpKind.SIGNAL_RECV, OpKind.ALLTOALLW)
    send_round: dict = {}
    recv_round: dict = {}
    sig_round: dict = {}
    for r, prog in enumerate(schedule.programs):
        last = -1
        token_op: dict[int, object] = {}
        for i, op in enumerate(prog):
            k = op.kind
            if k in BLOCKING:
                if op.round < last:
                    offenders.append(
                        f"rank {r} op {i} ({k.name}) at round "
                        f"{op.round} after a blocking op at round "
                        f"{last} — the fence order runs backward")
                last = max(last, op.round)
            if k in (OpKind.ISEND, OpKind.ISSEND, OpKind.SEND):
                send_round[(r, op.peer, op.chan)] = op.round
            elif k in (OpKind.IRECV, OpKind.RECV):
                recv_round[(op.peer, r, op.chan)] = op.round
            elif k is OpKind.SENDRECV:
                send_round[(r, op.peer, 0)] = op.round
                recv_round[(op.peer2, r, 0)] = op.round
            elif k is OpKind.SIGNAL_SEND:
                sig_round.setdefault((r, op.peer), []).append(op.round)
            elif k is OpKind.SIGNAL_RECV:
                sig_round.setdefault((op.peer, r, "recv"),
                                     []).append(op.round)
            if op.token >= 0:
                token_op[op.token] = op
            if k is OpKind.WAITALL:
                for t in op.tokens:
                    o = token_op.get(t)
                    if o is not None and o.kind in (OpKind.ISSEND,
                                                    OpKind.IRECV) \
                            and o.round > op.round:
                        offenders.append(
                            f"rank {r} WAITALL op {i} at round "
                            f"{op.round} completes a {o.kind.name} "
                            f"token tagged round {o.round} — the wait "
                            f"closes a fence that opens later")
    for key, rnd in send_round.items():
        if key in recv_round and recv_round[key] != rnd:
            offenders.append(
                f"matched pair {key} disagrees on its round: send "
                f"tagged {rnd}, receive tagged {recv_round[key]}")
    for pair, rounds in sig_round.items():
        if len(pair) == 2 and (pair[0], pair[1], "recv") in sig_round:
            got = sig_round[(pair[0], pair[1], "recv")]
            if sorted(rounds) != sorted(got):
                offenders.append(
                    f"signal pair {pair} round tags disagree: sends "
                    f"{sorted(rounds)}, receives {sorted(got)}")
    if offenders:
        return {"verdict": "REFUTED", "detail": offenders[0],
                "offenders": offenders[:MAX_WITNESSES]}
    return {"verdict": "PROVEN",
            "detail": "blocking rounds non-decreasing on every rank; "
                      "every matched pair agrees on its round tag",
            "offenders": []}


# ---------------------------------------------------------------------------
# The report

def check_schedule(schedule) -> dict:
    """Run all five properties over one compiled schedule → check-v1
    dict. Verdict is PROVEN only when every property is; EXEMPT for
    schedules with no rank op programs (the TAM engine)."""
    p = schedule.pattern
    cfg = {"method": schedule.method_id, "name": schedule.name,
           "nprocs": p.nprocs, "cb_nodes": p.cb_nodes,
           "data_size": p.data_size, "comm_size": p.comm_size,
           "proc_node": p.proc_node, "agg_type": int(p.placement),
           "direction": p.direction.value}
    if getattr(schedule, "fault", None):
        cfg["fault"] = schedule.fault
        # the repair pass stamps variant=canonical spec; a fault stamp
        # WITHOUT that variant is an injected, unrepaired program
        cfg["repaired"] = (getattr(schedule, "variant", "")
                          == schedule.fault)
    base = {"schema": CHECK_SCHEMA, "config": cfg}
    if (getattr(schedule, "programs", None) is None
            or getattr(schedule, "assignment", None) is not None):
        note = ("hierarchical TAM engine: traffic rides mesh "
                "collectives, no rank op programs to model-check")
        base.update({"verdict": "EXEMPT",
                     "properties": {k: {"verdict": "EXEMPT",
                                        "detail": note}
                                    for k in PROPERTIES}})
        return base
    props = {
        "deadlock_freedom": _deadlock_freedom(schedule),
        "race_freedom": _race_freedom(schedule),
        "conservation": _conservation(schedule),
        "barrier_symmetry": _barrier_symmetry(schedule),
        "round_monotonicity": _round_monotonicity(schedule),
    }
    verdict = ("REFUTED" if any(v["verdict"] == "REFUTED"
                                for v in props.values()) else "PROVEN")
    base.update({"verdict": verdict, "properties": props})
    return base


def check_sweep(nprocs: int, cb_nodes: int, comm_size: int,
                data_size: int = 2048, proc_node: int = 1,
                agg_type: int = 1, include_dead: bool = True,
                fault: str | None = None,
                barrier_type: int = 0) -> list:
    """Model-check every method in METHODS at one shape — the jax-free
    static gate (scripts/ci_tier1.sh). With ``fault``, each repairable
    method is checked in its REPAIRED form (methods the repair pass
    refuses are reported SKIPPED with the reason, not failed — refusal
    is designed behavior, e.g. jax_shard-style blocking exchanges)."""
    from tpu_aggcomm_torch.core.methods import METHODS, compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    p = AggregatorPattern(nprocs=nprocs, cb_nodes=cb_nodes,
                          data_size=data_size, placement=agg_type,
                          proc_node=proc_node, comm_size=comm_size)
    rows = []
    for mid in sorted(METHODS):
        if not include_dead and not METHODS[mid].dispatched:
            continue
        sched = compile_method(mid, p, barrier_type=barrier_type)
        row = {"method": mid, "name": METHODS[mid].name}
        if fault:
            from tpu_aggcomm_torch.faults import (FaultSpecError, RepairError,
                                            repair_schedule)
            try:
                sched = repair_schedule(sched, fault,
                                        barrier_type=barrier_type)
            except (FaultSpecError, RepairError) as e:
                row.update({"verdict": "SKIPPED", "detail": str(e),
                            "refuted": []})
                rows.append(row)
                continue
        rep = check_schedule(sched)
        refuted = [k for k, v in rep["properties"].items()
                   if v["verdict"] == "REFUTED"]
        detail = (rep["properties"][refuted[0]]["detail"] if refuted
                  else rep["properties"]["deadlock_freedom"]["detail"]
                  if rep["verdict"] != "EXEMPT"
                  else rep["properties"]["deadlock_freedom"]["detail"])
        row.update({"verdict": rep["verdict"], "refuted": refuted,
                    "detail": detail})
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Renderers / artifact

def render_check(report: dict) -> str:
    cfg = report["config"]
    head = (f"schedule check: m={cfg['method']} \"{cfg['name']}\" "
            f"({cfg['direction']}) n={cfg['nprocs']} a={cfg['cb_nodes']} "
            f"c={cfg['comm_size']} d={cfg['data_size']} B")
    if cfg.get("fault"):
        head += (f" [fault-{'repaired' if cfg.get('repaired') else 'INJECTED (unrepaired)'}: "
                 f"{cfg['fault']}]")
    lines = [head]
    for name in PROPERTIES:
        prop = report["properties"][name]
        lines.append(f"  {name:20s} {prop['verdict']:8s} {prop['detail']}")
        if prop["verdict"] != "REFUTED":
            continue
        for u in prop.get("unmatched", []):
            lines.append(f"    unmatched: {u}")
        cyc = prop.get("cycle", [])
        if cyc:
            lines.append(f"    cycle ({len(cyc)} events):")
            # one line per event keeps the witness pasteable into a bug
            for ev in cyc:
                tgt = (f" tokens={ev['tokens']}" if "tokens" in ev
                       else f" peer={ev['peer']}" if "peer" in ev else "")
                lines.append(f"      rank {ev['rank']:4d} op "
                             f"{ev['op_index']:4d} {ev['kind']:11s} "
                             f"round {ev['round']:3d}{tgt} "
                             f"[{ev['event']}]")
        for o in prop.get("offenders", [])[:MAX_WITNESSES]:
            lines.append(f"    offender: {o}")
        for rc in prop.get("races", [])[:MAX_WITNESSES]:
            lines.append(f"    race: {rc['detail']}")
    lines.append(f"verdict: {report['verdict']}")
    return "\n".join(lines) + "\n"


def render_check_sweep(rows: list, nprocs: int, cb_nodes: int,
                       comm_size: int, fault: str | None = None) -> str:
    head = (f"model-check sweep: {len(rows)} methods at n={nprocs} "
            f"a={cb_nodes} c={comm_size}")
    if fault:
        head += f" under fault \"{fault}\" (repaired)"
    lines = [head]
    n_ref = 0
    for r in rows:
        if r["verdict"] == "REFUTED":
            n_ref += 1
            lines.append(f"  m={r['method']:2d} {r['name']:34s} REFUTED  "
                         f"[{','.join(r['refuted'])}] {r['detail']}")
        elif r["verdict"] in ("EXEMPT", "SKIPPED"):
            lines.append(f"  m={r['method']:2d} {r['name']:34s} "
                         f"{r['verdict']:8s} {r['detail']}")
        else:
            lines.append(f"  m={r['method']:2d} {r['name']:34s} PROVEN   "
                         f"{r['detail']}")
    lines.append(f"REFUTED: {n_ref} of {len(rows)}")
    return "\n".join(lines) + "\n"


def write_artifact(path: str, report: dict) -> str:
    """Write a check-v1 JSON artifact (atomic_write: a kill mid-write
    can't tear it)."""
    import json

    from tpu_aggcomm_torch.obs.atomic import atomic_write
    with atomic_write(path) as fh:
        json.dump(report, fh, indent=1, sort_keys=False)
        fh.write("\n")
    return path
