"""Composable schedule primitives — the synthesizer's building blocks.

A :class:`Composition` is a small, canonically-stringable choice of
primitives that :func:`build_schedule` compiles to per-rank op programs
in the existing Schedule IR (core/schedule.py) — the same IR every
backend lowers and every analysis consumes, which is the whole design:
a synthesized schedule is checkable (analysis/check.py), auditable
(obs/traffic.py), priceable (model/predict.py), and runnable with zero
new backend code.

Primitive axes (HiCCL-style decomposition, arxiv 2408.05962):

- ``order`` — which sources feed an aggregator in which throttle round:
  ``strided`` (m=1's ``s % R`` classes), ``blocked`` (contiguous
  windows ``s // w``), ``rotated`` (m=13's rank-relative windows
  ``((s - d) % n) // w`` — every sender's load spreads across rounds),
  ``tree`` (k-ary fan-in: sources feed in reverse-BFS order of a k-ary
  tree rooted at the aggregator, ``fanin`` per round).
- ``sync`` — ``eager`` (ISEND), ``rendezvous`` (ISSEND, the reference
  default), or ``crossed`` (rendezvous sends WAITED before that
  round's recvs are posted — deliberately deadlock-prone; the model
  checker refutes the cyclic instances by name, which is exactly what
  the search's hard pruning is for).
- ``selfedge`` — the aggregator's message to itself as a ``wire``
  send/recv pair (m=1) or a local ``copy`` (m=3's memcpy).
- ``wait`` — ``round`` (per-round waitalls over that round's tokens)
  or ``tail`` (recvs waited per round, send tokens deferred to one
  final SEND_WAIT waitall, m=1's shape).
- ``relay`` — stage the last ``relay`` ring-predecessor sources of
  each aggregator through an intermediate rank (the fault-repair
  detour IR verbatim: staging rows, nonzero channels, ``dead_edges``
  bookkeeping — faults/repair.py), exercising multi-hop composition
  on a healthy pattern.
- ``window`` — how round count is derived from the ``-c`` throttle:
  ``chunk`` (at most ``min(c,n)`` sources per aggregator per round —
  the m=1 unit every reference method chunks by), ``posted`` (rounds
  sized to the documented peak-in-flight budget itself,
  ``min(c,n)+cb``: the smallest round count whose per-rank posted
  requests — recvs plus sends, both waited at the round fence — stay
  within the bound every reference method is audited against), or
  ``drain`` (ONE data round: every send posted nonblocking up front,
  the incast drained by BLOCKING recvs in the chunk-map order — the
  m=6/10/12 blocking discipline generalized to its fixed point:
  blocking recvs post no requests, so the audit sees only the sends,
  ``<= cb <= min(c,n)+cb``, and the whole aggregation needs a single
  round fence). The references chunk or block per cb-class; ``posted``
  and ``drain`` are the axes they never compose, and both need
  strictly fewer round fences at small ``c`` while the auditor still
  proves CONFORMS.

Throttle honesty: ``window=chunk`` assigns at most ``min(comm_size,
nprocs)`` sources per aggregator per round (``fanin`` may tighten
that) — the m=1 unit the ``-c`` bound documents. ``window=posted``
instead solves for the smallest round count whose statically-computed
peak posted requests respect the same documented bound the auditor
enforces (obs/traffic.py:documented_bound, ``min(c,n)+cb`` for
synthesized ids) — never beyond it, and the traffic audit re-verifies
the built schedule rather than trusting the solver.

Slot conventions are the registry's (core/methods.py module
docstring): ALL_TO_MANY send slot = aggregator index / recv slot =
source rank; MANY_TO_ALL send slot = dest rank / recv slot =
aggregator index — so harness/verify.py accepts synthesized schedules
unchanged.

jax-free: this module imports core only (numpy-backed), never jax.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_aggcomm_torch.core.pattern import AggregatorPattern, Direction
from tpu_aggcomm_torch.core.schedule import Op, OpKind, Schedule, TimerBucket

__all__ = ["Composition", "CompositionError", "parse_composition",
           "build_schedule", "ORDERS", "SYNCS", "SELFEDGES", "WAITS",
           "WINDOWS"]

ORDERS = ("strided", "blocked", "rotated", "tree")
SYNCS = ("eager", "rendezvous", "crossed")
SELFEDGES = ("wire", "copy")
WAITS = ("round", "tail")
WINDOWS = ("chunk", "posted", "drain")

_DEFAULTS = {"order": "rotated", "sync": "rendezvous", "self": "wire",
             "wait": "round", "fanin": 0, "relay": 0, "window": "chunk"}


class CompositionError(ValueError):
    """Malformed or unbuildable composition (named field + reason)."""


@dataclass(frozen=True)
class Composition:
    """One point in the synthesis space. ``canonical()`` is THE identity
    used everywhere downstream (MethodSpec.composition, Schedule.variant,
    artifact rows) — sorted ``key=value`` fields joined by ``|``, so two
    equal compositions can never alias under different spellings."""

    order: str = "rotated"
    sync: str = "rendezvous"
    selfedge: str = "wire"
    wait: str = "round"
    fanin: int = 0
    relay: int = 0
    window: str = "chunk"

    def __post_init__(self):
        if self.order not in ORDERS:
            raise CompositionError(
                f"order={self.order!r} not in {ORDERS}")
        if self.sync not in SYNCS:
            raise CompositionError(f"sync={self.sync!r} not in {SYNCS}")
        if self.selfedge not in SELFEDGES:
            raise CompositionError(
                f"self={self.selfedge!r} not in {SELFEDGES}")
        if self.wait not in WAITS:
            raise CompositionError(f"wait={self.wait!r} not in {WAITS}")
        if self.window not in WINDOWS:
            raise CompositionError(
                f"window={self.window!r} not in {WINDOWS}")
        if self.order == "tree":
            if self.fanin < 2:
                raise CompositionError(
                    f"order=tree needs fanin >= 2, got {self.fanin}")
        elif self.fanin != 0:
            raise CompositionError(
                f"fanin={self.fanin} only composes with order=tree")
        if self.sync == "crossed" and self.wait != "round":
            raise CompositionError(
                "sync=crossed implies per-round send waits; compose it "
                "with wait=round")
        if self.relay < 0:
            raise CompositionError(f"relay={self.relay} must be >= 0")
        if self.window == "posted":
            if self.wait != "round":
                raise CompositionError(
                    "window=posted budgets a round's posted recvs AND "
                    "sends against the in-flight bound, so both must "
                    "drain at the round fence; compose it with "
                    "wait=round")
            if self.order == "tree":
                raise CompositionError(
                    "window=posted resizes flat round maps; order=tree "
                    "rounds derive from fan-in depth, not the chunk "
                    "width")
            if self.relay != 0:
                raise CompositionError(
                    "window=posted budgets the main rounds only; relay "
                    "staging posts extra requests outside that budget "
                    "(compose relay with window=chunk)")
        if self.window == "drain":
            if self.wait != "round":
                raise CompositionError(
                    "window=drain has a single data round whose send "
                    "tokens drain at that round's fence; compose it "
                    "with wait=round")
            if self.order == "tree":
                raise CompositionError(
                    "window=drain collapses the round map; order=tree "
                    "rounds derive from fan-in depth and cannot "
                    "collapse")
            if self.relay != 0:
                raise CompositionError(
                    "window=drain has no later round for a staged hop "
                    "to land in (compose relay with window=chunk)")

    def canonical(self) -> str:
        return (f"fanin={self.fanin}|order={self.order}"
                f"|relay={self.relay}|self={self.selfedge}"
                f"|sync={self.sync}|wait={self.wait}"
                f"|window={self.window}")

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.canonical()


def parse_composition(text: str) -> Composition:
    """Parse ``key=value|key=value`` (any order, missing keys default).
    The inverse of :meth:`Composition.canonical`; raises
    :class:`CompositionError` naming the offending token."""
    fields = dict(_DEFAULTS)
    for token in str(text).split("|"):
        token = token.strip()
        if not token:
            continue
        if "=" not in token:
            raise CompositionError(
                f"composition token {token!r} is not key=value")
        key, _, val = token.partition("=")
        key, val = key.strip(), val.strip()
        if key not in fields:
            raise CompositionError(
                f"unknown composition key {key!r} "
                f"(have {sorted(fields)})")
        if key in ("fanin", "relay"):
            try:
                fields[key] = int(val)
            except ValueError:
                raise CompositionError(
                    f"composition {key}={val!r} is not an integer") \
                    from None
        else:
            fields[key] = val
    return Composition(order=fields["order"], sync=fields["sync"],
                       selfedge=fields["self"], wait=fields["wait"],
                       fanin=fields["fanin"], relay=fields["relay"],
                       window=fields["window"])


# --------------------------------------------------------------------------
# round assignment

def _tree_rounds(n: int, k: int, width: int) -> list[int]:
    """Round of each rank-relative position under k-ary fan-in order:
    positions feed leaves-first (reverse BFS of the k-ary heap rooted at
    position 0, ties by position), ``min(k, width)`` per round."""
    def depth(p: int) -> int:
        d = 0
        while p > 0:
            p = (p - 1) // k
            d += 1
        return d

    per_round = min(k, width)
    order = sorted(range(n), key=lambda p: (-depth(p), p))
    rounds = [0] * n
    for idx, p in enumerate(order):
        rounds[p] = idx // per_round
    return rounds


class _RoundMap:
    """Edge -> throttle round for one composition at one pattern shape.

    ``far`` is the fan-aggregation rank (the incast/outcast hub: the
    aggregator), ``leaf`` the rank on the wide side (source for a2m,
    destination for m2a) — the same formulas serve both directions."""

    def __init__(self, comp: Composition, nprocs: int, width: int,
                 n_rounds: int | None = None):
        self.order = comp.order
        self.n = nprocs
        self.width = width
        if comp.order == "tree":
            self._tree = _tree_rounds(nprocs, comp.fanin, width)
            self.n_rounds = max(self._tree) + 1
        elif n_rounds is not None:
            # window=posted: round count solved against the in-flight
            # budget; the flat formulas keep working off the rebalanced
            # width = ceil(n / rounds).
            self.n_rounds = int(n_rounds)
            self.width = (nprocs + self.n_rounds - 1) // self.n_rounds
        else:
            self.n_rounds = (nprocs + width - 1) // width

    def round_of(self, leaf: int, far: int) -> int:
        if self.order == "strided":
            return leaf % self.n_rounds
        if self.order == "blocked":
            return leaf // self.width
        if self.order == "rotated":
            return ((leaf - far) % self.n) // self.width
        return self._tree[(leaf - far) % self.n]


def _wire_jobs(rank: int, rmap: _RoundMap, comp: Composition,
               p: AggregatorPattern, relayed: set):
    """The chan-0 jobs of one rank under one round map, as
    ``(sends, recvs, copies)`` dicts ``rnd -> [(peer, slot)]`` /
    ``rnd -> [(sslot, rslot)]`` — THE single source of round structure
    for both :func:`build_schedule` and the ``window=posted`` budget
    solver (the solver must count exactly the requests the builder will
    post, or the solved round count proves nothing)."""
    agg_index = p.agg_index
    a2m = p.direction is Direction.ALL_TO_MANY
    myidx = int(agg_index[rank])
    isagg = myidx >= 0
    sends: dict[int, list[tuple[int, int]]] = {}   # rnd -> [(dst, slot)]
    recvs: dict[int, list[tuple[int, int]]] = {}   # rnd -> [(src, slot)]
    copies: dict[int, list[tuple[int, int]]] = {}  # rnd -> [(ss, rs)]
    if a2m:
        for j, d in enumerate(int(r) for r in p.rank_list):
            if (rank, d) in relayed:
                continue
            rnd = rmap.round_of(rank, d)
            if d == rank and comp.selfedge == "copy":
                # send slab j -> own recv row `rank` (source = self)
                copies.setdefault(rnd, []).append((j, rank))
            else:
                sends.setdefault(rnd, []).append((d, j))
        if isagg:
            for s in range(p.nprocs):
                if (s, rank) in relayed:
                    continue
                if s == rank and comp.selfedge == "copy":
                    continue  # delivered by the COPY above
                recvs.setdefault(rmap.round_of(s, rank),
                                 []).append((s, s))
    else:
        if isagg:
            for d in range(p.nprocs):
                rnd = rmap.round_of(d, rank)
                if d == rank and comp.selfedge == "copy":
                    # send slab `rank` -> own recv row myidx
                    copies.setdefault(rnd, []).append((rank, myidx))
                else:
                    sends.setdefault(rnd, []).append((d, d))
        for j, a in enumerate(int(r) for r in p.rank_list):
            if a == rank and comp.selfedge == "copy":
                continue
            recvs.setdefault(rmap.round_of(rank, a), []).append((a, j))
    return sends, recvs, copies


def _posted_rounds(comp: Composition, p: AggregatorPattern,
                   r_chunk: int) -> int:
    """The ``window=posted`` round count: the smallest R whose
    per-(rank, round) posted requests — that round's wire recvs plus
    wire sends, all outstanding together until the round-fence waitall
    (``posted`` implies ``wait=round``) — stay within the documented
    synthesized-id bound ``min(c,n)+cb``
    (obs/traffic.py:documented_bound). Counts come from the SAME job
    maps the builder emits; COPY self-edges post nothing. Falls back to
    the chunked count when no smaller R conforms (the audit then sees a
    schedule identical in shape to ``window=chunk``)."""
    n = p.nprocs
    budget = min(p.comm_size, n) + p.cb_nodes
    width = min(p.comm_size, n)
    for rounds in range(1, r_chunk):
        rmap = _RoundMap(comp, n, width, n_rounds=rounds)
        peak = 0
        for rank in range(n):
            sends, recvs, _ = _wire_jobs(rank, rmap, comp, p, set())
            for rnd in range(rounds):
                load = len(recvs.get(rnd, ())) + len(sends.get(rnd, ()))
                peak = max(peak, load)
        if peak <= budget:
            return rounds
    return r_chunk


# --------------------------------------------------------------------------
# relay staging (the repair detour IR on a healthy pattern)

def _relay_assignments(comp: Composition, p: AggregatorPattern):
    """Deterministic (src, dst, send_slot, via, chan, stage) tuples for
    the ``relay`` primitive: the ``relay`` ring-predecessor sources of
    each aggregator detour through the next live non-endpoint rank."""
    n = p.nprocs
    if comp.relay == 0:
        return []
    if p.direction is not Direction.ALL_TO_MANY:
        raise CompositionError(
            "relay staging composes with the all-to-many direction only "
            "(the m2a mirror has no incast to stage)")
    if comp.relay > n - 2:
        raise CompositionError(
            f"relay={comp.relay} needs at least relay+2 ranks, "
            f"have nprocs={n}")
    out = []
    stage = 0
    for j_idx, d in enumerate(int(r) for r in p.rank_list):
        for t in range(comp.relay):
            s = (d - 1 - t) % n
            via = next((s + off) % n for off in range(1, n)
                       if (s + off) % n not in (s, d))
            out.append((s, d, j_idx, via, 1 + stage, stage))
            stage += 1
    return out


# --------------------------------------------------------------------------
# schedule builder

def _wait_bucket(isagg: bool, has_recv: bool, has_send: bool):
    if has_recv and has_send:
        return (TimerBucket.RECV_WAIT if isagg
                else TimerBucket.RECV_AND_SEND_WAIT)
    return TimerBucket.RECV_WAIT if has_recv else TimerBucket.SEND_WAIT


class _Prog:
    """Per-rank program builder (the registry's token bookkeeping,
    extended with chan/staging fields for the relay hops)."""

    def __init__(self):
        self.ops: list[Op] = []
        self._next_token = 0

    def nb(self, kind: OpKind, peer: int, slot: int, rnd: int, nbytes: int,
           bucket: TimerBucket = TimerBucket.NONE, *, chan: int = 0,
           from_stage: bool = False, to_stage: bool = False) -> int:
        tok = self._next_token
        self._next_token += 1
        self.ops.append(Op(kind=kind, peer=peer, slot=slot, round=rnd,
                           token=tok, nbytes=nbytes, bucket=bucket,
                           chan=chan, from_stage=from_stage,
                           to_stage=to_stage))
        return tok

    def blocking(self, kind: OpKind, peer: int, slot: int, rnd: int,
                 nbytes: int, bucket: TimerBucket = TimerBucket.NONE):
        self.ops.append(Op(kind=kind, peer=peer, slot=slot, round=rnd,
                           nbytes=nbytes, bucket=bucket))

    def copy(self, sslot: int, rslot: int, rnd: int):
        self.ops.append(Op(kind=OpKind.COPY, slot=sslot, slot2=rslot,
                           round=rnd))

    def waitall(self, tokens, bucket: TimerBucket, rnd: int = 0):
        if tokens:
            self.ops.append(Op(kind=OpKind.WAITALL, tokens=tuple(tokens),
                               bucket=bucket, round=rnd))


def build_schedule(comp: Composition, p: AggregatorPattern, *,
                   method_id: int = 100, name: str | None = None) -> Schedule:
    """Compile one composition against one pattern.

    The canonical composition string is stamped into
    ``Schedule.variant`` (prefix ``synth:``) so ``schedule_shape_key``
    — and with it every compiled/tuned/served cache and every resume
    journal — distinguishes compositions even before registration
    assigns distinct method ids."""
    n, cb, ds = p.nprocs, p.cb_nodes, p.data_size
    agg_index = p.agg_index
    width = min(p.comm_size, n)
    rmap = _RoundMap(comp, n, width)
    if comp.window == "posted" and comp.order != "tree":
        rmap = _RoundMap(comp, n, width,
                         n_rounds=_posted_rounds(comp, p, rmap.n_rounds))
    R = rmap.n_rounds
    relays = _relay_assignments(comp, p)
    relayed = {(s, d) for s, d, _, _, _, _ in relays}
    send_kind = OpKind.ISEND if comp.sync == "eager" else OpKind.ISSEND

    progs = []
    for rank in range(n):
        b = _Prog()
        myidx = int(agg_index[rank])
        isagg = myidx >= 0

        # chan-0 jobs by round -------------------------------------------
        sends, recvs, copies = _wire_jobs(rank, rmap, comp, p, relayed)

        if comp.window == "drain":
            # ONE data round: sends posted nonblocking up front (every
            # rank's, so no drain can wait on a message that was never
            # posted), then the incast drained by BLOCKING recvs in the
            # chunk-map order. Blocking recvs post no requests — the
            # in-flight audit sees only the sends (<= cb), the m=6/10/12
            # conformance argument.
            toks_s = [b.nb(send_kind, d, sl, 0, ds, TimerBucket.POST)
                      for rnd in range(R) for d, sl in sends.get(rnd, ())]
            if comp.sync == "crossed":
                # send waits BEFORE the drain — the rendezvous instances
                # cycle and the checker refutes them by name
                b.waitall(toks_s, TimerBucket.SEND_WAIT, 0)
            for rnd in range(R):
                for ss, rs in copies.get(rnd, ()):
                    b.copy(ss, rs, 0)
            for rnd in range(R):
                for s, sl in recvs.get(rnd, ()):
                    b.blocking(OpKind.RECV, s, sl, 0, ds,
                               TimerBucket.RECV_WAIT)
            if comp.sync != "crossed":
                b.waitall(toks_s, TimerBucket.SEND_WAIT, 0)
            progs.append(b.ops)
            continue

        # main rounds -----------------------------------------------------
        pending_sends: list[int] = []
        for rnd in range(R):
            r_jobs = recvs.get(rnd, ())
            s_jobs = sends.get(rnd, ())
            if comp.sync == "crossed":
                # sends waited BEFORE this round's recvs are posted — the
                # deliberately cyclic shape the checker exists to refute
                toks_s = [b.nb(send_kind, d, sl, rnd, ds, TimerBucket.POST)
                          for d, sl in s_jobs]
                b.waitall(toks_s, TimerBucket.SEND_WAIT, rnd)
                for ss, rs in copies.get(rnd, ()):
                    b.copy(ss, rs, rnd)
                toks_r = [b.nb(OpKind.IRECV, s, sl, rnd, ds,
                               TimerBucket.POST) for s, sl in r_jobs]
                b.waitall(toks_r, TimerBucket.RECV_WAIT, rnd)
                continue
            toks_r = [b.nb(OpKind.IRECV, s, sl, rnd, ds, TimerBucket.POST)
                      for s, sl in r_jobs]
            for ss, rs in copies.get(rnd, ()):
                b.copy(ss, rs, rnd)
            toks_s = [b.nb(send_kind, d, sl, rnd, ds, TimerBucket.POST)
                      for d, sl in s_jobs]
            if comp.wait == "round":
                b.waitall(toks_r + toks_s,
                          _wait_bucket(isagg, bool(toks_r), bool(toks_s)),
                          rnd)
            else:
                b.waitall(toks_r, TimerBucket.RECV_WAIT, rnd)
                pending_sends.extend(toks_s)
        b.waitall(pending_sends, TimerBucket.SEND_WAIT, max(R - 1, 0))

        # relay staging rounds (repair detour IR, faults/repair.py) -------
        for stage_rnd in (R, R + 1):
            toks_r, toks_s = [], []
            for s, d, j, via, chan, stage in relays:
                if stage_rnd == R and rank == s:
                    toks_s.append(b.nb(OpKind.ISEND, via, j, R, ds,
                                       TimerBucket.POST, chan=chan))
                if stage_rnd == R and rank == via:
                    toks_r.append(b.nb(OpKind.IRECV, s, stage, R, ds,
                                       TimerBucket.POST, chan=chan,
                                       to_stage=True))
                if stage_rnd == R + 1 and rank == via:
                    toks_s.append(b.nb(OpKind.ISEND, d, stage, R + 1, ds,
                                       TimerBucket.POST, chan=chan,
                                       from_stage=True))
                if stage_rnd == R + 1 and rank == d:
                    toks_r.append(b.nb(OpKind.IRECV, via, s, R + 1, ds,
                                       TimerBucket.POST, chan=chan))
            b.waitall(toks_r, TimerBucket.RECV_WAIT, stage_rnd)
            b.waitall(toks_s, TimerBucket.SEND_WAIT, stage_rnd)
        progs.append(b.ops)

    canon = comp.canonical()
    sched = Schedule(
        p, method_id, name or f"Synth {canon}", progs,
        uses_rendezvous=comp.sync in ("rendezvous", "crossed"),
        variant=f"synth:{canon}",
        n_staging=len(relays),
        dead_edges=tuple(sorted((s, d) for s, d in relayed)))
    sched.validate()
    return sched
