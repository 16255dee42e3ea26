"""Serial-chained differenced timing.

The method of the reference's ``harness/chained.py``, in torch:

- chain ``iters`` reps strictly serially (the caller's
  ``chain_factory(iters)`` returns ``chain(send0)`` in which rep r+1's
  input depends on rep r's output, so no rep can be skipped or merged);
- force completion by reading back a device checksum with ``.item()``
  (PyTorch returns before the device finishes);
- cancel the fixed per-call overhead by differencing two chain lengths:
  ``per_rep = (T(big) - T(small)) / (big - small)``, best of ``windows``
  per length, one sample per trial.

The reference's chain is one jitted ``lax.scan``: the device runs every
rep and the host dispatches once. Here the same holds on a CUDA device:
:func:`graph_chain` captures a block of :data:`GRAPH_BLOCK` reps, each
with its token and XOR, as one CUDA graph, and a chain is that graph
replayed (a shorter graph runs the remainder), so the host enqueues one
graph per block instead of every operation of every rep. The rep index r
that the token adds lives on the device and the graph advances it, so a
replayed block goes on counting. On the CPU :func:`eager_chain` runs the
same steps one by one.

The chained token reproduces the reference's int32 arithmetic exactly, so
chain end states are byte-equal across packages, and between the graph
and the eager chain. A caller whose scan body is not a schedule rep plus
the token and XOR (the ``tam`` driver's proxy route: three gathers, then
``y ^ r``) passes its own in-place ``step`` to either chain.

With the flight recorder on, the timing records what the reference's
does: a ``chained.warmup`` span, a ``ledger.compile`` instant of the
warm-up (and one of every CUDA-graph capture: on the card the port's
compile is a capture, recorded as ``kind="graph-capture"`` with its
block length), one ``chained.trial`` instant per differenced trial and a
``chained.samples`` instant of the accepted trials. All are host-side
events outside the timed windows.
"""

from __future__ import annotations

import functools
import statistics
import time

import numpy as np
import torch

from tpu_aggcomm_torch.backends.lanes import wrap_i32
from tpu_aggcomm_torch.obs import ledger, trace

__all__ = ["MAX_MEASURED_ROUNDS", "GRAPH_BLOCK", "ChainCaptureError",
           "chain_token", "token_from_sum", "xor_word", "xor_token_",
           "chain_step", "rep_step", "checksum",
           "eager_chain", "graph_chain", "differenced_trials",
           "differenced_per_rep", "differenced_round_times"]

#: Round-count guard for measured per-round times: one chain family is
#: built and timed per round, so a 1024-round schedule would take hours;
#: callers refuse such schedules upfront and point at profile_rounds.
MAX_MEASURED_ROUNDS = 64

#: Reps per captured CUDA graph. It divides both default chain lengths
#: (50 and 1050), so a default chain is whole replays of one graph.
GRAPH_BLOCK = 50


class ChainCaptureError(RuntimeError):
    """A chain could not be captured as a CUDA graph. There is no eager
    fallback on the card: the eager chain measures the host."""


def chain_token(recv: torch.Tensor, n_recv_slots: int, r) -> torch.Tensor:
    """``(int32 sum of every rank's recv lane 0 + r) % 251`` as a 0-d
    int64 tensor in [0, 250]: the reference's wrapping int32 sum and floor
    modulo, without a host sync. ``r`` is an int or a 0-d int64 tensor on
    ``recv``'s device."""
    return token_from_sum(recv[:, :n_recv_slots, 0].sum(dtype=torch.int64),
                          r)


def token_from_sum(s: torch.Tensor, r) -> torch.Tensor:
    """``(s + r) % 251`` with ``s + r`` wrapped to int32 first, as the
    reference's int32 token: ``s`` is an int64 sum of the live recv
    lanes (0-d, on the device; summed over every process of a group by
    the sharded tier), ``r`` the rep index."""
    return torch.remainder(((s + r + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31, 251)


def xor_word(tok: torch.Tensor, lane_dtype: torch.dtype) -> torch.Tensor:
    """The chain perturbation: a token in [0, 250] becomes a word in the
    carry's lane dtype, XORed into the send buffer. For int32 lanes it is
    the byte replicated four times (computed in int64 so it cannot
    overflow, then wrapped); for byte lanes the byte itself. Both perturb
    identical byte streams."""
    if lane_dtype == torch.int32:
        return wrap_i32((tok & 0xFF) * 0x01010101)
    return tok.to(torch.uint8)


@functools.cache
def _words(device: torch.device) -> torch.Tensor:
    """``xor_word`` of every token 0..250 for int32 lanes, on ``device``."""
    return xor_word(torch.arange(251), torch.int32).to(device)


def chain_step(send: torch.Tensor, recv: torch.Tensor, n_recv_slots: int,
               r) -> None:
    """In place: ``send ^= xor_word(chain_token(recv, n_recv_slots, r))``,
    the word of an int32 carry looked up in a table of all 251 (two
    operations instead of the word's five, inside every captured rep; the
    XOR stays on 4-byte lanes, which a wide arena needs)."""
    xor_token_(send, chain_token(recv, n_recv_slots, r))


def xor_token_(send: torch.Tensor, tok: torch.Tensor) -> None:
    """In place: ``send ^= xor_word(tok)`` for a 0-d token in [0, 250];
    the word of an int32 carry is looked up in a table of all 251."""
    if send.dtype == torch.int32:
        # index_select, not [tok]: indexing with a 0-d tensor can read it
        # back to the host, which a graph capture refuses
        send.bitwise_xor_(_words(send.device).index_select(0,
                                                           tok.reshape(1)))
    else:
        send.bitwise_xor_(tok.to(send.dtype))


def rep_step(rep, n_recv_slots: int):
    """The default in-place chain step: ``step(send, r)`` runs
    :func:`chain_step` on ``rep(send)``."""
    def step(send: torch.Tensor, r) -> None:
        chain_step(send, rep(send), n_recv_slots, r)
    return step


#: elements a checksum widens at a time (a 512 MB int64 temporary)
_CHECKSUM_CHUNK = 1 << 26


def checksum(t: torch.Tensor) -> int:
    """A readback that forces completion of everything queued before it:
    the int64 sum of every element, widened a chunk at a time so an
    arena of billions of lanes (the flagship's at d=2048) needs no
    int64 copy of itself."""
    flat = t.reshape(-1)
    if flat.numel() <= _CHECKSUM_CHUNK:
        return int(flat.to(torch.int64).sum().item())
    parts = [flat[i:i + _CHECKSUM_CHUNK].to(torch.int64).sum()
             for i in range(0, flat.numel(), _CHECKSUM_CHUNK)]
    return int(torch.stack(parts).sum().item())


def eager_chain(rep, n_recv_slots: int = 0, *, step=None):
    """``make_chain(iters)`` running the chain one operation at a time:
    ``iters`` reps of ``rep``, rep r+1's send XOR-perturbed by
    ``xor_word`` of rep r's token. The chain on the CPU, and the plain
    version :func:`graph_chain` is held against.

    A caller with another scan body passes ``step(carry, r)`` (and
    ``rep=None``): rep r updates the carry in place, r a Python int from
    0; the chain runs it on a copy of ``send0``."""

    def make_chain(iters: int):
        def chain(send0):
            if step is not None:
                carry = send0.clone()
                for r in range(iters):
                    step(carry, r)
                return carry
            send = send0
            for r in range(iters):
                recv = rep(send)
                send = send ^ xor_word(chain_token(recv, n_recv_slots, r),
                                       send.dtype)
            return send
        return chain

    return make_chain


def _kernel_wrappers():
    """The port's kernel wrappers, each counting its launches in
    ``.launches`` (K1 its reps in ``.reps``, the row delivery the rounds
    of its many-round launches in ``.fused_rounds``)."""
    from tpu_aggcomm_torch.backends.cuda_dma import dma_steps
    from tpu_aggcomm_torch.backends.cuda_local import exchange
    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    from tpu_aggcomm_torch.backends.slow_delay import slow_delay
    from tpu_aggcomm_torch.native.fuse import fused_rep
    return (fused_rep, dma_steps, exchange, slow_delay, deliver_rows)


def _counters() -> dict:
    return {(w, a): getattr(w, a) for w in _kernel_wrappers()
            for a in ("launches", "reps", "fused_rounds") if hasattr(w, a)}


def _capture(fn, state: dict):
    """Capture ``fn()`` as a CUDA graph in the memory pool of ``state``
    (one pool per chain family, made at its first capture); returns the
    graph's ``replay``."""
    if "pool" not in state:
        state["pool"] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=state["pool"]):
        fn()
    return graph.replay


def graph_chain(rep, n_recv_slots: int = 0, *, step=None):
    """``make_chain(iters)`` for a CUDA device: the chain of
    :func:`eager_chain`, run as CUDA graph replays. ``step`` is
    :func:`eager_chain`'s hook; here ``r`` is the device rep counter, a
    0-d int64 tensor.

    At a chain family's first call, one eager rep warms ``rep`` up (kernel
    builds, lazy initialisation), then :data:`GRAPH_BLOCK` reps, each with its
    token and in-place XOR into a static carry and a device rep counter
    advanced inside the graph, are captured as one graph. A chain of
    ``iters`` reps copies ``send0`` into the carry, zeroes the counter,
    replays that graph ``iters // GRAPH_BLOCK`` times and a graph of the
    remaining reps (captured at its first use) once,
    and returns a copy of the carry. Every graph of the family draws on
    one memory pool, and the graphs live as long as the family: a caller
    that drops the factory frees them.

    A wrapper's Python runs only while a graph is captured, when nothing
    launches; so the launch counters are restored after each capture and
    every replay adds what one pass of its block launches (one launch of
    K2 a rep for ``cuda_fused``, one of the row delivery a round, or a
    rep of many barrier-free rounds, for ``torch_shard`` with no group,
    one of the slow-rank delay a faulted rep with a slow rank). A capture
    that fails raises
    :class:`ChainCaptureError`. Each capture is a ledger record of kind
    "graph-capture" with its block length."""
    state: dict = {"graphs": {}}
    one = step if step is not None else rep_step(rep, n_recv_slots)

    def body(length: int) -> None:
        carry, r = state["carry"], state["r"]
        for _ in range(length):
            one(carry, r)
            r.add_(1)

    def graph_of(length: int):
        if length not in state["graphs"]:
            before = _counters()
            t0 = time.perf_counter()
            try:
                replay_fn = _capture(lambda: body(length), state)
            except Exception as e:  # lint: broad-ok (re-raised, named)
                raise ChainCaptureError(
                    f"capturing {length} chained reps as a CUDA graph "
                    f"failed: {type(e).__name__}: {e}") from e
            finally:
                captured = {k: v - before[k] for k, v in _counters().items()}
                for (w, a), v in before.items():
                    setattr(w, a, v)
            rec = ledger.record_compile(
                f"graph(reps={length})", seconds=time.perf_counter() - t0,
                kind="graph-capture", reps=length)
            trace.instant("ledger.compile", **rec)
            state["graphs"][length] = (replay_fn, captured)
        return state["graphs"][length]

    def replay(length: int) -> None:
        replay_fn, captured = graph_of(length)
        replay_fn()
        for (w, a), v in captured.items():
            setattr(w, a, getattr(w, a) + v)

    def make_chain(iters: int):
        def chain(send0):
            if "carry" not in state:
                state["carry"] = send0.clone()
                state["r"] = torch.zeros((), dtype=torch.int64,
                                         device=send0.device)
                body(1)                      # warm-up, outside any graph
            carry = state["carry"]
            if carry.shape != send0.shape or carry.dtype != send0.dtype:
                raise ValueError(
                    f"a chain family runs one send shape: "
                    f"{tuple(carry.shape)} {carry.dtype}, got "
                    f"{tuple(send0.shape)} {send0.dtype}")
            carry.copy_(send0)
            state["r"].zero_()
            full, rest = divmod(iters, GRAPH_BLOCK)
            for _ in range(full):
                replay(GRAPH_BLOCK)
            if rest:
                replay(rest)
            return carry.clone()
        return chain

    return make_chain


def differenced_trials(chain_factory, send0, *, iters_small: int,
                       iters_big: int, trials: int = 3,
                       windows: int = 3, agree=None) -> list[float]:
    """Per-trial per-rep seconds from differenced serial-chain timings.

    ``chain_factory(iters)`` returns ``chain(send0) -> tensor`` running
    ``iters`` serially dependent reps. Both lengths are built once, warmed
    up once, then re-timed across trials; a non-positive difference is
    noise and is retried a bounded number of times.

    ``agree(v) -> v`` (the sharded tier's, over a process group) makes
    each trial's value the group's, before it is judged: every process
    then accepts and retries the same trials, so their chains, and the
    collectives in them, stay in step."""
    if iters_big <= iters_small:
        raise ValueError("iters_big must exceed iters_small")

    def timed(f) -> float:
        best = float("inf")
        for _ in range(windows):
            t0 = time.perf_counter()
            checksum(f(send0))
            best = min(best, time.perf_counter() - t0)
        return best

    f_small = chain_factory(iters_small)
    f_big = chain_factory(iters_big)
    # warm-up: allocator, kernel builds, graph captures
    with trace.span("chained.warmup", iters_small=iters_small,
                    iters_big=iters_big):
        t0 = time.perf_counter()
        checksum(f_small(send0))
        warm_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        checksum(f_big(send0))
        warm_big = time.perf_counter() - t0
    rec = ledger.record_compile(
        f"chain(iters={iters_small}/{iters_big})",
        seconds=warm_small + warm_big, kind="compile+warmup",
        warmup_small_s=warm_small, warmup_big_s=warm_big)
    trace.instant("ledger.compile", **rec)
    per = []
    retries = max(trials, 3)
    while len(per) < trials:
        t_s = timed(f_small)
        t_b = timed(f_big)
        v = (t_b - t_s) / (iters_big - iters_small)
        if agree is not None:
            v = agree(v)
        # the two chain wall times behind each accepted or rejected trial
        trace.instant("chained.trial", iters_small=iters_small,
                      iters_big=iters_big, t_small=t_s, t_big=t_b,
                      per_rep=v, accepted=v > 0)
        if v > 0:
            per.append(v)
        elif retries > 0:
            retries -= 1
        else:
            raise RuntimeError(
                f"differenced timing unstable: T({iters_big})={t_b:.6f}s <= "
                f"T({iters_small})={t_s:.6f}s repeatedly; increase "
                f"iters_big")
    # the accepted trial set, as one instant (the reference's obs/compare
    # bootstraps whole-rep deltas from it)
    trace.instant("chained.samples", iters_small=iters_small,
                  iters_big=iters_big, samples=list(per))
    return per


def differenced_per_rep(chain_factory, send0, *, iters_small: int,
                        iters_big: int, trials: int = 3,
                        windows: int = 3, agree=None) -> float:
    """Median per-rep seconds over :func:`differenced_trials`."""
    return statistics.median(differenced_trials(
        chain_factory, send0, iters_small=iters_small, iters_big=iters_big,
        trials=trials, windows=windows, agree=agree))


def differenced_round_times(make_prefix_chain, send0, round_ids,
                            per_full: float, *, iters_small: int,
                            iters_big: int, trials: int = 3,
                            windows: int = 3, memo: dict | None = None,
                            agree=None) -> dict:
    """Difference the round-prefix chains: the shared tail of
    ``measure_round_times``.

    ``make_prefix_chain(k)`` returns a ``chain_factory`` whose reps run
    only rounds 0..k-1 (full fidelity, same lowering and scaffold as the
    full rep); ``per_full`` is the full rep's differenced time. Round k's
    duration is the increment between consecutive prefix times; noise
    handling clamps increments at 0 and rescales them so they sum EXACTLY
    to ``per_full`` (uniform when every increment is 0). Returns
    ``{round id: seconds}`` in program order.

    ``memo`` (a caller-held dict, prefix index -> differenced seconds)
    shares the per-prefix measurements with the other consumers of the
    same prefix family (``measure_round_splits`` times the identical P
    prefixes), so each prefix chain is built and timed at most once per
    schedule."""
    R = len(round_ids)
    if R == 1:
        return {round_ids[0]: per_full}
    bounds = []
    for k in range(1, R):
        if memo is not None and k in memo:
            bounds.append(memo[k])
            continue
        t = differenced_per_rep(
            make_prefix_chain(k), send0, iters_small=iters_small,
            iters_big=iters_big, trials=trials, windows=windows,
            agree=agree)
        if memo is not None:
            memo[k] = t
        bounds.append(t)
    bounds.append(per_full)
    inc = np.maximum(np.diff(np.asarray([0.0] + bounds)), 0.0)
    s = float(inc.sum())
    inc = inc * (per_full / s) if s > 0 else np.full(R, per_full / R)
    return dict(zip(round_ids, inc.tolist()))
