#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``tpu_aggcomm_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tpu_aggcomm_torch/csrc`` and
drives the port on one CUDA device, stopping with a non-zero exit at the
first failure (no phase's failure is caught):

1. setup: the card's name and power limit (``nvidia-smi``), the kernel
   build, and ``ptxas``'s registers and shared memory per kernel;
2. kernel K1 (``csrc/exchange.cu``, one launch per chain) at 32x14x2048
   and 1024x64x2048: 9- and 260-rep chains against the plain chain and
   ``host_replay``, byte for byte, each one launch; its device time per
   rep (CUDA events around two chain lengths, differenced) and grid, the
   cost of one barrier from the kernel's %globaltimer stamps, one rep's
   graph and eager times, the plain version's, and both bounds: 2*n*cb*d
   / 3.35 TB/s (HBM) and the same bytes at the card's L2 copy rate
   (plain ``copy_`` of L2-resident buffers, two sizes differenced);
3. kernel K2 (``csrc/fused_rep.cu``, one launch per rep) through the
   ``cuda_fused`` backend: the 16 fusable methods at n=32 a=14 d=2048 c=3
   and m=1, 2 at n=256 a=16 c=16 verified, then one launch into a recv
   pre-filled with 0xA5 compared byte for byte with the plain version
   (and a plan that writes one cell in two rounds); at m=1 its device and
   eager times, its fence (the cluster barrier at the README shape, the
   hand-rolled one at n=256) and the split of a rep from the kernel's
   %globaltimer stamps (launch, copies, fences), the zeroing alone,
   beside the bound, and the host dispatch of its rep by the bound launch
   and by the full argument check (mean of 10,000 reps, no profiler),
   with the bound launch's hit share (1.0);
4. kernel K3 (``csrc/dma_steps.cu``, one launch per rep) through
   ``cuda_dma`` (lockstep) and ``cuda_dma_conc`` (concurrent): its
   co-resident CTA cap and the card's one-way signal latency from an
   independent probe (``csrc/signal_probe.cu``: two CTAs on two SMs
   ping-pong a counter); then the 16 stepped methods and m=13 ``-b 1`` at
   the README shape, m=1 and m=18 at n=256 a=16 c=16 and m=1 at n=1024
   a=64 c=16 (1024 CTAs, 8202 steps), each verified and compared byte for
   byte with the plain version on the whole arena, launched into a recv
   pre-filled with 0xA5; m=1 at each shape timed beside its steps, waves,
   table-build seconds and both bounds (bytes; waves x the signal
   latency), its graph replays checked against the plain version, and at
   the README shape the split of a wave from rank 0's %globaltimer stamps
   (post, wait) and the zeroing; last the bound rep
   (``CudaDmaBackend.one_rep``) at the benchmark cell
   ``theta_n1280_a2m_c64_dma``'s shape (n=1280 a=20 c=64 ``-p 64``, 2571
   waves) held byte for byte against the plain version, its launch and
   wave counts, its time and its stamp split, on the kernels line as
   K3's ``theta_cell``;

   each kernel and plain version is timed twice: on the device alone (a
   CUDA graph of many calls, replayed) and as Python launches it, one
   call after another (CUDA events around the calls);
5. the main path, one segment per slice, each with its launch counts set
   to 0 just before it and read just after: the CLI ``run`` of m=1 on
   ``torch_sim`` (README config n=32 a=14 d=2048 c=3 ``--chained
   --verify``, then n=1024 a=64 c=16 ``--verify``: 64 padded rounds, a
   2.15 GB recv arena) and on ``cuda_fused`` (README config ``--chained
   --verify``; on the card a chain is CUDA graph replays, and K2's count
   adds the reps each replay runs), then ``python -m
   tpu_aggcomm_torch.bench``, failing unless K1 and K2 launched; then m=1
   on ``cuda_dma`` and ``cuda_dma_conc`` (README config ``--verify -k
   5``) and ``-m 0`` on ``cuda_dma`` (TAM and m=5/8 routed to
   ``torch_sim``), failing unless K3 launched; then ``--measured-phases
   --verify`` on ``torch_sim`` for m=1 and m=2 at the README config and
   TAM m=15 and m=16 at n=32 a=14 ``-p 1`` and ``-p 4`` (the n=256 and
   n=1024 measured phases are cut for time), each decomposition held to
   sum to its chained total, ``--profile-rounds --verify`` at the README
   config and at n=256 a=16 c=16, and ``-m 0 --verify`` on ``torch_sim``
   (20 methods) and ``cuda_fused`` (16: TAM and the dense collectives
   dropped), failing unless K2 launched;
6. slice 6's path (``faults_sweep``), its launch counts zeroed after
   the kernel check and read at its end: the slow-rank delay kernel
   (``csrc/slow_delay.cu``) against its plain version (acc and the whole
   arena) on ``slow:r2*8`` at the README shape and at n=1024 a=64 c=16,
   timed beside its bound; ``--chained --verify`` at the README shape
   healthy and under ``--fault slow:r2*2``, ``*4``, ``*8``, failing
   unless the per-rep time rises strictly with the factor; a repaired
   ``deadlink:5>3`` on every round-structured method at the README shape
   (the unrepairable ones refused by the repair) and ``deadlink:5>16``
   at n=1024 a=64 c=16 ``--chained --verify``; the refusals of
   ``cuda_fused`` and ``cuda_dma`` with a fault; ``sweep`` over the Theta
   grid (m=1 and m=2 on ``torch_sim``, m=1 on ``cuda_fused``, m=1 at
   n=1024 at ``-c`` 16 and unthrottled, the rest cut for time: the
   whole grid is ``scripts/torch_sweeps.py``'s), each cell's chained
   per-rep time on a
   ``# sweep`` line; and ``sweep --fault none --fault deadlink:5>3``
   followed by a ``--resume`` that must skip every cell;
7. slice 7's path (``tam_obs``), K2's launch count zeroed first and
   read at its end: ``tam`` on every host engine at n=64 ``-p 8 -b 16``
   (``-t`` 0 and 3, each ``| correctness: PASSED``); the ``sim`` engine
   on the card at n=16384 ``-p 64 -t 0`` and n=4096 ``-p 64 -t 3`` (n cut
   from 16384: ``-t 3`` is n^2 messages), ``--chained -k 3`` and
   per-dispatch ``-k 3``, each verified, with its host table-build
   seconds and its bytes a rep beside the HBM bound, and its graph chain
   against the eager chain at 5, 50 and 53 reps; ``run --trace`` on
   ``torch_sim --chained`` at the README shape (a Perfetto slice per
   round, the events re-aggregating float-exactly to the timer columns)
   and ``sweep --trace`` over ``-c`` 1, 3 and unthrottled; ``run
   --xprof`` on ``cuda_fused`` and ``torch_sim``, each report read from
   the card's device span (``cupti-device-span``), with the device busy
   share of the profiled rep;
8. slice 8's path (``serve``): first the delay kernel's request axis
   against its plain version at the README shape (``slow:r2*2``, B = 1,
   2, 4 and 8 requests in one launch each, timed beside its bound) and
   one batched README rep's device time per request at B = 1, 2, 4, 8
   beside K2's; then, the delay's and K2's counts zeroed, an in-process
   ``ScheduleServer(device="cuda")`` (journalled, 50 ms batch window)
   driven by ``ServeClient`` bursts of verified requests, the shape's
   schedule resolved once before each cold burst: the README
   shape m=1 on ``torch_sim`` (8 cold in one batch, 8 warm hits, 3
   padded to 4) and on ``cuda_fused`` (8 cold, 8 warm: K2 launched once
   a request plus once for the warm-up), n=256 a=16 c=16 m=3, TAM m=15,
   ``slow:r2*2`` (the delay launched once a batched dispatch plus the
   warm-up) and ``deadlink:5>3`` at the README shape, n=1024 a=64 c=16
   m=1 (a batch of 2, 4.3 GB of recv arena); each leg's cold and warm
   latency, requests/s, fill and padding waste, each build's compile
   seconds (tables, warm-up) and each dispatch's wall beside its verify
   wall; the shutdown's drain record replayed ``REPRODUCED``, and a
   second server recovering from the journal pre-warms every shape and
   answers its first README request as a hit;
9. slice 9's path (``tune_synth``), everything in a temporary
   directory: first K2 on the committed synthesized methods m=101-103
   (``SYNTH_r01.json``: one round carrying every data edge) at the README
   shape and at n=256 a=16 c=16 against its plain version, m=103 timed
   beside its bound; then, K2's count zeroed, ``tune`` racing 12
   candidates (m=1, 3, 7 x ``-a`` 4, 14 x ``-c`` 3, 8) at n=32 d=2048
   (the tuner's defaults: chains of 50 and 1050 reps, 3 trials a batch)
   on fresh chained device samples on ``torch_sim`` and on ``cuda_fused``
   (every sample K2 launches replayed from CUDA graphs), each artifact
   validated and replayed ``REPRODUCED``, with its candidates, batches,
   eliminations, winner, captures and race wall on a ``# tune`` line;
   ``run --auto --chained --verify`` applying the ``torch_sim`` winner;
   ``tune --model-prune`` on the card reading the ``gpu`` block of
   ``H100_PREDICT_r01.json``; ``run -m 101``, ``102``, ``103
   --synth-root --verify`` on ``torch_sim``, ``cuda_fused`` and ``local``
   at both shapes; and a short ``synth`` at the README cell, ranked by
   the ``gpu`` block (``--predict-root`` the repository), its verdict (a
   synthesized winner that validates and replays, or the named reference
   win) and ``params_source`` on a ``# synth`` line;
10. slice 10's path (``pilot_obs``), everything in a temporary
   directory, K2's launch count zeroed first and read at its end: an
   in-process ``ScheduleServer(device="cuda", metrics_port=0)``
   (journalled, default backend ``torch_sim``) serves a tight skewed
   burst at the README cell, every request verified (10x m=1 and 2x m=3
   on ``torch_sim``, then 6x m=1 on ``cuda_fused``: a K2 launch each
   plus the warm-up); its ``/metrics`` is scraped, validated and held to
   ``stats()`` (request counter, batch fill); then ``cli pilot
   JOURNAL --serve-port PORT --device cuda --max-batches 4`` runs in
   this process against the server (campaigns raced on fresh
   ``torch_sim`` samples on the card, promotions through the server's
   ``swap`` op, its verify request through the normal queue), its
   artifact validated and replayed ``REPRODUCED``, each campaign's
   candidates, batches, winner, medians, win CI and wall and each
   decision with its verify request's wall on a ``# pilot`` line; every
   promoted shape's next request is served by the new method, verified;
   6 more hot requests and a second pass (promoted targets skipped, a
   demotion row per promotion); a lookalike record refused and the same
   record demoting, the old method served again, verified (campaign
   survivors ranked by the ``gpu`` block: ``--predict-root`` the
   repository, ``params_source`` on each ``# pilot`` line); and ``sweep
   --metrics-port 0`` over ``-c`` 1, 2, 4, 8 at the README shape
   (``torch_sim --chained --verify``) on a thread, its endpoint scraped
   mid-run, each scrape on a ``# metrics`` line;
11. slice 11's path (``inspect_roofline``), in a temporary directory,
   K2's launch count zeroed first and read at its end: ``run --chained
   --verify --trace`` at the README cell on ``torch_sim`` and on
   ``cuda_fused`` (K2), each dispatch's soft deadline printed (``#
   deadline``: the roofline floor ``derive_deadline`` got, the deadline,
   the wall); over those traces and the CSV ``inspect trace``, ``inspect
   ledger``, ``inspect traffic --trace --json --fused-export`` (every
   round's H100 HBM floor below its measured wall, K2's plan tables
   matching the audit), ``inspect check -m 0`` and ``analyze``; ``inspect
   -m 1 --roofline --waves`` at n=32 a=14 c=3, n=256 a=16 c=16 and
   n=1024 a=64 c=16; then every ``torch_sim`` floor of the roofline
   (``--chained``: the rep's bytes plus the token and XOR, at 3.35 TB/s)
   held below the chained time measured at the same shape, each pair on
   a ``# floor`` line and its ratio on a ``# ratio`` line: this phase's
   README run, the sweep cells of ``faults_sweep`` (m=1 and m=2 over the
   Theta grid, m=1 at n=1024 c=16) and the measured-phase totals of the
   main path (m=2, m=1 at n=256, TAM m=15/16 at n=32 ``-p`` 1 and 4 and
   at n=1024 ``-p 64``); a shape with no earlier time gets one short
   ``--chained`` run; and the L2 copy rate beside the roofline's figure;
12. slice 12's path (``model_gpu``), in a temporary directory, K2's
   launch count zeroed first and read at its end, every
   ``--predict-root`` the repository: ``inspect explain --replay
   H100_PREDICT_r01.json`` (REPRODUCED); the held-out n=32 grid against
   this run (``faults_sweep``'s m=1 and m=2 ``torch_sim`` cells and m=1
   ``cuda_fused`` cells, plus an m=2 ``cuda_fused`` sweep here): each
   cell beside its committed value and its ``gpu`` prediction, tau-b of
   the predictions against this run, and on ``# crossover`` lines each
   cell's predicted fused speedup beside the measured ``(torch_sim -
   cuda_fused) / torch_sim``; then every consumer once, each line naming
   ``H100_PREDICT_r01.json [gpu]``: ``inspect explain`` on README
   ``--chained --trace`` runs of ``torch_sim`` and ``cuda_fused`` (K2),
   ``tune --model-prune`` over the ``tune_synth`` grid (kept, pruned, and
   whether the unpruned winner was kept), ``run --auto --fault
   deadlink:5>3`` on a tune-cache miss (the advisory), a served request
   under a budget below the ``gpu`` floor (``SHED[deadline_floor]`` with
   ``floor_s``) and the same request with 1000 ms (served, verified), and
   ``inspect watch --predict`` over the phase's journal and trace, whose
   artifact replays;
13. slice 13's path (``obs_views``), in a temporary directory that is
   the history root, K2's and the delay's launch counts zeroed first and
   read at its end, at the README cell: ``inspect compare --by round
   --json`` of a ``torch_sim`` and a ``cuda_fused`` (K2) ``--chained
   --verify --trace`` trace (the dominant delta cell printed), and of the
   healthy trace against a ``slow:r2*2`` one, refused without
   ``--across-faults`` and with it a RECOVERY delta most of which must be
   the delay kernel's time at that spec (the serve phase's B=1 row);
   ``inspect flow`` over an in-process server's journal and trace and the
   client's own stamp journal (the line format of
   ``scripts/serve_loadgen.py --client-journal``): a leg on
   ``cuda_fused`` and one on ``torch_sim``, each a cold request then 8
   warm, every request joined to a round stream, the artifact replayed
   REPRODUCED and joined by ``inspect watch --flow``, each leg's warm
   overhead fraction with its CI and dominant component on a ``# flow``
   line; ``inspect live`` attached once mid-run (exit 1, work left) and
   once after the end (exit 0) of ``sweep --backend cuda_fused --chained
   --verify --trace`` over ``-c`` 1, 2, 4, 8 in a subprocess, the floor
   read from the gpu block of the predict artifact and the ETA printed
   beside the sweep's real remaining wall; ``inspect history --json`` and
   ``inspect report`` over the root (this run's bench line as a
   ``BENCH_r01.json`` record, every trace, the compare, flow and watch
   artifacts and a copy of ``H100_PREDICT_r01.json``), every artifact
   validated, the bench series keyed ``| gpu``, the report's cost-model
   pane naming ``H100_PREDICT_r01.json [gpu]``; and
   ``obs/regress.check_regression`` over the root and over the
   repository, both verdicts printed;
14. slice 14's path (``shard_flagship``), the launch counts of the
   delay kernel and of the row-delivery kernel (``deliver_rows.cu``,
   each round of ``torch_shard`` on one card) zeroed first and read at
   its end, failing unless both launched: the sharded tier
   ``--backend torch_shard`` on this one card through ``cli run
   --chained --verify``: the README cell (beside ``torch_sim``'s same
   run), the README cell under ``--fault slow:r2*2`` (``slow_delay.cu``
   once a rep) and the Theta flagship cell n=16384 a=256 d=256 m=1
   unthrottled (4.19M slabs, verified), each on a ``# shard`` line with
   its chained per-rep time, its ``torch_shard`` roofline floor (which
   must lie below it) and its peak device memory; then the delay against
   its plain version on the backend's own flat arenas;
15. the row-delivery kernel alone (``deliver_rows``) at the Theta
   flagship n=16384 a=256 m=1: the unthrottled round's 4,194,304 rows on
   random send arenas of d=2048 and d=256, one launch into a receive
   arena the caching allocator hands back filled with 0xFF, compared byte
   for byte with the plain version and with ATen's gather and
   ``index_put_`` into a zeroed arena, timed (graph and eager) beside the
   plain version and the bytes bound (2*E*d plus the zeroed rows at
   3.35 TB/s), the d=2048 launch on the wide-row engine and equal to the
   persistent grid's arena; beside that pass (a) ``copy_`` of one 8.59 GB
   arena into another (``library_ms``), (b)-(c) the persistent grid on
   identity and Theta tables, (d) the wide-row engine on both, and both
   engines on 4,096-262,144 of its rows, where the rule's fewest rows lie;
   then the ``-c 64`` rep's 256 rounds at d=2048, each
   launched alone (its own device time from the profiler's kernel
   records, and its bound), the rep as the main path issues them (one
   many-round launch, its rounds fenced inside the kernel) and as one
   launch a round (programmatic dependent launches), both back to back
   by CUDA events, their arenas equal to each other and to the plain
   version's; from one stamped launch each round's copy time and each
   fence's time (median, p95) beside the round's bound and the 1.5 us
   fence target; and the README shape's 11 rounds both ways, the one
   launch held against the rounds and the plain version;
16. slice 15's path (``mesh_tier``), the one-rank-per-device tier:
   (a) a NCCL world of one process on ``cuda:0``, a child started with
   ``python -m torch.distributed.run --standalone --nproc_per_node 1
   chip_smoke.py --mesh-tier-child OUT`` that runs ``cli run -n 1 -a 1 -d
   2048 --backend torch_ici --verify`` for m=1, 8 and 17, eager and
   ``--chained``, ``--profile-rounds`` for m=1, TAM m=15 and m=16 at
   ``-p 1``, ``cli tam --engine jax`` and ``--engine shared_jax`` at
   ``-n 1 -p 1 -t 3 --mode 1``, each printing which collectives it issued
   (at n=1 the m=1 edge is a self copy; the dense all_to_all and the
   barrier all-reduce go through NCCL), then the per-call microseconds of
   a NCCL ``all_to_all_single`` of one 2048-byte row and of an
   ``all_reduce`` of one int64, eager and in a CUDA graph, and the
   refusals of ``pt2pt`` and of ``cuda_dma`` under the group; (b) in this
   process, with no group, the refusals of ``-n 2 --backend torch_ici``
   and of a CUDA world of 2 processes (``TooFewCardsError``); (c)
   ``dryrun_multichip(8, "cpu")`` over 8 gloo processes on the host's CPU
   (labelled CPU: no card number);
17. a ``measured phases {...}`` line (each decomposition in
   microseconds), the device busy shares, each phase's wall time, the
   ``shard cells {...}`` line, the ``mesh tier {...}`` line, a
   ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and as the
   last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
README = dict(n=32, a=14, d=2048, c=3)
FUSABLE = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14, 17, 18, 19, 20]
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
PREDICT_GPU = "H100_PREDICT_r01.json"   # the cost model's gpu calibration


class SmokeError(RuntimeError):
    """A phase of the smoke produced a wrong or missing result."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, replayed, so no host launch cost is in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (3 * iters)


def timings(kernel, plain, graph_iters: int, plain_graph_iters: int,
            eager_iters: int = 2000, plain_eager_iters: int = 200,
            warmup: int = 20) -> dict:
    """A kernel's and its plain version's milliseconds per call: ``ms``
    and ``plain_ms`` on the device alone (CUDA graph replay), and
    ``eager_ms`` and ``plain_eager_ms`` as a Python caller launches them
    one by one (CUDA events over back-to-back calls)."""
    return dict(ms=graph_ms(kernel, graph_iters),
                eager_ms=cuda_ms(kernel, eager_iters, warmup),
                plain_ms=graph_ms(plain, plain_graph_iters),
                plain_eager_ms=cuda_ms(plain, plain_eager_iters,
                                       min(warmup, plain_eager_iters)))


def max_abs_err(a, b) -> int:
    import torch
    if a.dtype == torch.uint8:      # exact without widening a 2 GB arena
        return int((torch.maximum(a, b) - torch.minimum(a, b)).max().item())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_setup() -> None:
    import torch

    from tpu_aggcomm_torch.csrc.build import build, ptxas_report
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    lib = build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{lib.name}")
    lines = ptxas_report()
    check(all(any(k in ln for ln in lines) for k in
              ("exchange_chain_kernel", "fused_rep_kernel",
               "dma_steps_kernel", "slow_delay_kernel",
               "deliver_rows_kernel", "deliver_rounds_kernel")),
          f"ptxas report lacks a kernel: {lines}")
    for ln in lines:
        print(f"# {ln}")


def chain_us(p, send0, small: int, big: int) -> float:
    """Device microseconds per rep of a K1 chain: CUDA events around one
    chain launch of ``small`` and of ``big`` reps (best of three each),
    differenced, so the launch and the fixed cost cancel."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_local import (check_barrier,
                                                       exchange_chain)

    def best(iters: int) -> float:
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            exchange_chain(p, send0, iters, check=False)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return min(times)

    best(small)                                   # warm-up
    per = (best(big) - best(small)) / (big - small) * 1e3
    check_barrier(send0.device)
    return per


def l2_copy_rate() -> float:
    """The card's L2 copy rate in bytes moved (read + write) per second:
    plain ``copy_`` between two L2-resident buffers, graph-timed at 8 and
    16 MiB and differenced, so the fixed cost of a copy cancels. Independent
    of K1."""
    import torch
    times = {}
    for mib in (8, 16):
        src = torch.ones(mib * 2**18, dtype=torch.int32, device="cuda")
        dst = torch.empty_like(src)
        times[mib] = graph_ms(lambda: dst.copy_(src), 200)
    return 2 * 8 * 2**20 / ((times[16] - times[8]) * 1e-3)


def barrier_us(p, send0, iters: int = 201) -> float:
    """Microseconds one K1 barrier costs at ``p``'s grid: from the last
    CTA's arrival to the last CTA's departure (the kernel's %globaltimer
    stamps of one diagnostic chain), mean over the barriers after the
    first 20."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_local import (chain_grid,
                                                       exchange_chain)
    stamps = torch.zeros((chain_grid(p, send0.device), iters - 1, 2),
                         dtype=torch.int64, device=send0.device)
    exchange_chain(p, send0, iters, stamps=stamps)
    st = stamps[:, 20:].double()
    return float((st[:, :, 1].max(0).values
                  - st[:, :, 0].max(0).values).mean()) / 1e3


def phase_k1(dev) -> dict:
    """K1 (one launch per chain) against its plain version and the host
    replay at the bench shape and at a shape far beyond L2; returns the
    bench shape's row."""
    import numpy as np
    import torch

    from tpu_aggcomm_torch.backends.cuda_local import (chain_grid, exchange,
                                                       exchange_chain,
                                                       exchange_plain,
                                                       host_replay,
                                                       order_table,
                                                       rep_word)
    from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    l2_rate = l2_copy_rate()
    print(f"L2 copy rate: {l2_rate / 1e12:.3f} TB/s (plain copy_ of "
          f"L2-resident 8 and 16 MiB buffers, differenced)", flush=True)
    rows = []
    for n, cb, d in ((32, 14, 2048), (1024, 64, 2048)):
        p = AggregatorPattern(n, cb, data_size=d, comm_size=3)
        s0 = np.random.default_rng(n).integers(0, 2**32, size=(n, cb, d // 4),
                                               dtype=np.uint32)
        send0 = from_reference(s0, dev)
        for iters in (9, 260):
            before = exchange.launches
            got = exchange_chain(p, send0, iters)
            torch.cuda.synchronize()
            check(exchange.launches == before + 1,
                  f"K1 {n}x{cb}x{d}: a {iters}-rep chain was not one launch")
            plain = exchange_chain(p, send0, iters, step=exchange_plain)
            err = max_abs_err(got, plain)
            got_np = to_reference(got)
            check(err == 0 and np.array_equal(got_np, to_reference(plain)),
                  f"K1 {n}x{cb}x{d}: {iters}-rep kernel chain != plain")
            check(np.array_equal(got_np, host_replay(p, s0, iters)),
                  f"K1 {n}x{cb}x{d}: {iters}-rep kernel chain != replay")
            check(np.array_equal(to_reference(send0), s0),
                  f"K1 {n}x{cb}x{d}: the chain wrote send0")
            del got, plain
        big = n * cb * d > 2**26
        small_it, big_it = (10, 110) if big else (200, 4200)
        us_per_rep = chain_us(p, send0, small_it, big_it)
        us_barrier = barrier_us(p, send0)
        order, out = order_table(p, dev), torch.empty_like(send0)
        word = rep_word(1)

        def run_kernel():
            exchange(send0, order, word, out=out)

        def run_plain():
            exchange_plain(send0, order, word)

        one = timings(run_kernel, run_plain, 200 if big else 1000,
                      50 if big else 200)
        nbytes = 2 * n * cb * d
        row = dict(shape=[n, cb, d], max_abs_err=err,
                   ms=us_per_rep / 1e3, us_per_rep=us_per_rep,
                   one_rep_ms=one["ms"], eager_ms=one["eager_ms"],
                   plain_ms=one["plain_ms"],
                   plain_eager_ms=one["plain_eager_ms"],
                   grid=chain_grid(p, dev),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   l2_bound_ms=nbytes / l2_rate * 1e3,
                   us_per_fence=us_barrier)
        print(f"K1 {n}x{cb}x{d}: 9- and 260-rep chains == plain == "
              f"host_replay, one launch each; {us_per_rep:.3f} us/rep in a "
              f"chain (events, {small_it} vs {big_it} reps differenced) on "
              f"{row['grid']} CTAs, {us_barrier:.3f} us of it a barrier "
              f"(stamps); one rep {one['ms'] * 1e3:.3f} us device "
              f"(CUDA graph), {one['eager_ms'] * 1e3:.3f} us eager; plain "
              f"{one['plain_ms'] * 1e3:.3f} us device, "
              f"{one['plain_eager_ms'] * 1e3:.3f} us eager; HBM bound "
              f"{row['bound_ms'] * 1e3:.3f} us ({nbytes} B / 3.35 TB/s), L2 "
              f"figure {row['l2_bound_ms'] * 1e3:.3f} us ({nbytes} B at "
              f"{l2_rate / 1e12:.3f} TB/s)", flush=True)
        rows.append(row)
        del send0, out
    return dict(rows[0], large={k: rows[1][k] for k in (
        "shape", "ms", "one_rep_ms", "eager_ms", "plain_ms", "grid",
        "bound_ms", "us_per_fence")})


def stamp_split(send, tabs, device_ms: float, runs: int = 20) -> dict:
    """How one K2 rep splits, from the kernel's %globaltimer stamps (mean
    over ``runs`` launches): the launch (graph-timed device time less the
    stamped span), each round's copies and each fence, in microseconds."""
    import torch

    from tpu_aggcomm_torch.native.fuse import fused_plan, fused_rep
    plan = fused_plan(send, tabs)
    grid, ncopy = plan["grid"], plan["copy_ctas"]
    P = max(tabs.n_rounds, 1)
    stamps = torch.zeros((grid, 2 + 2 * P), dtype=torch.int64,
                         device=send.device)
    acc = None
    for _ in range(runs + 1):
        fused_rep(send, tabs, stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.double()
        t0 = st[:, 0].min()
        cp = st[:ncopy]                       # the copying CTAs
        copy_end = cp[:, 1:1 + 2 * P:2].max(0).values
        fence_end = cp[:, 2:2 + 2 * P:2].max(0).values
        starts = torch.cat([t0.reshape(1), fence_end[:-1]])
        zero_end = st[ncopy:, -1].max() if grid > ncopy else t0
        one = torch.stack([
            (copy_end - starts).sum(), (fence_end - copy_end).sum(),
            st[:, -1].max() - t0, st[:, 0].max() - t0, zero_end - t0])
        acc = one * 0 if acc is None else acc + one   # first run: warm-up
    copy_us, fence_us, span_us, spread_us, zero_us = \
        (acc / runs / 1e3).tolist()
    return dict(copy_us=copy_us, fence_us=fence_us,
                us_per_round_copy=copy_us / P,
                us_per_fence=fence_us / max(P - 1, 1), zero_us=zero_us,
                span_us=span_us, cta_start_spread_us=spread_us,
                launch_us=device_ms * 1e3 - span_us)


def k2_dispatch_us(rep, send, reps: int = 10000) -> dict:
    """The host dispatch of K2's rep as the benchmark reads it (the host
    wall from the call to its return, a synchronize after each; mean over
    ``reps``, no profiler), by the bound launch (``rep``, whose tables are
    bound) and by the full argument check (the same tables unbound); with
    the bound path's hit share, 1 - full checks / launches, over its
    loop."""
    import dataclasses

    import torch

    from tpu_aggcomm_torch.native.fuse import fused_rep

    unbound = dataclasses.replace(rep.tables, bound=None)
    paths = {"bound": rep, "full": lambda x: fused_rep(x, unbound)}
    out = {}
    for name, fn in paths.items():
        for _ in range(100):
            fn(send)
        torch.cuda.synchronize()
        launches, checks = fused_rep.launches, fused_rep.full_checks
        total = 0.0
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(send)
            total += time.perf_counter() - t0
            torch.cuda.synchronize()
        out[f"{name}_us"] = total / reps * 1e6
        out[f"{name}_hit_share"] = 1 - (fused_rep.full_checks - checks) \
            / (fused_rep.launches - launches)
    return out


def phase_k2(dev) -> dict:
    """K2 through cuda_fused for every fusable method, then into a
    poisoned recv against the plain version; the split of a rep and its
    fence at the README shape and at n=256; returns the README m=1 row
    with the n=256 one under ``large`` (the cluster and the hand-rolled
    fence)."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
    from tpu_aggcomm_torch.backends.lanes import from_reference
    from tpu_aggcomm_torch.backends.torch_sim import dense_send_lanes
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.native.fuse import (FusePlan, check_fence,
                                               fuse_plan, fused_plan,
                                               fused_rep, fused_rep_plain,
                                               plan_tables)

    def poisoned(tabs, send):
        return torch.full((tabs.nprocs, tabs.n_recv_rows, send.shape[2]),
                          -0x5A5A5A5B, dtype=send.dtype, device=send.device)

    backend = CudaFusedBackend(device="cuda")
    cells = [(m, README) for m in FUSABLE] + \
        [(m, dict(n=256, a=16, d=2048, c=16)) for m in (1, 2)]
    rows = {}
    for m, cfg in cells:
        s = compile_method(m, AggregatorPattern(
            cfg["n"], cfg["a"], data_size=cfg["d"], comm_size=cfg["c"]))
        backend.run(s, verify=True)
        plan = fuse_plan(s)
        tabs = plan_tables(plan, dev)
        send = from_reference(dense_send_lanes(s.pattern, 0), dev)
        plain = fused_rep_plain(send, tabs)
        before = fused_rep.launches
        got = fused_rep(send, tabs, out=poisoned(tabs, send))
        check(fused_rep.launches == before + 1,
              f"K2 m={m} {cfg}: not one launch")
        check_fence(tabs)
        err = max_abs_err(got, plain)
        check(err == 0 and torch.equal(got, plain),
              f"K2 m={m} {cfg}: kernel != plain")
        if m != 1:
            continue
        n, d = cfg["n"], cfg["d"]
        edges, rounds = plan.n_edges, len(plan.rounds)
        zero_bytes = n * tabs.n_recv_rows * d
        written = n * tabs.n_recv_rows - tabs.zero_rows
        big = zero_bytes > 2**26
        out = torch.empty_like(plain)
        zero_ms = graph_ms(lambda: out.zero_(), 100 if big else 1000)
        t = timings(lambda: fused_rep(send, tabs),
                    lambda: fused_rep_plain(send, tabs),
                    100 if big else 1000, 20 if big else 100)
        launch = fused_plan(send, tabs)
        split = stamp_split(send, tabs, t["ms"])
        row = dict(shape=[n, cfg["a"], d, cfg["c"]], max_abs_err=err,
                   ms=t["ms"], eager_ms=t["eager_ms"],
                   plain_ms=t["plain_ms"], plain_eager_ms=t["plain_eager_ms"],
                   zero_bytes=zero_bytes, zeroing_alone_ms=zero_ms,
                   us_per_fence=split["us_per_fence"], **launch, split=split)
        row["chained_ms"] = backend.measure_per_rep(s) * 1e3
        row["dispatch"] = k2_dispatch_us(backend.one_rep(s), send)
        check(row["dispatch"]["bound_hit_share"] == 1.0
              and row["dispatch"]["full_hit_share"] == 0.0,
              f"K2 m=1 {cfg}: the bound launch was not taken on every "
              f"rep, or the unbound tables took it")
        row["copy_bound_ms"] = 2 * edges * d / HBM_BYTES_PER_S * 1e3
        # least bytes: each edge row read once and written once, every
        # never-written row written once (zero)
        row["bound_ms"] = (2 * edges * d + tabs.zero_rows * d) \
            / HBM_BYTES_PER_S * 1e3
        print(f"K2 m=1 n={n} a={cfg['a']} c={cfg['c']}: {rounds} rounds, "
              f"{edges} edges ({written} distinct rows written, "
              f"{tabs.zero_rows} zeroed in {len(tabs.zero_runs)} runs); "
              f"{launch['fence']} fence, {launch['grid']} CTAs "
              f"({launch['copy_ctas']} copying): {row['ms'] * 1e3:.3f} us "
              f"device (CUDA graph), {row['eager_ms'] * 1e3:.3f} us eager, "
              f"{row['chained_ms'] * 1e3:.3f} us/rep chained; split: launch "
              f"{split['launch_us']:.3f} us, zeroing CTAs done at "
              f"{split['zero_us']:.3f} us, copies {split['copy_us']:.3f} us "
              f"({split['us_per_round_copy']:.3f} per round), fences "
              f"{split['fence_us']:.3f} us ({split['us_per_fence']:.3f} "
              f"per fence); zeroing the whole arena alone "
              f"{zero_ms * 1e3:.3f} us (graph of the memset); plain "
              f"{row['plain_ms'] * 1e3:.3f} us device, "
              f"{row['plain_eager_ms'] * 1e3:.3f} us eager; bound "
              f"{row['bound_ms'] * 1e3:.3f} us (copies "
              f"{row['copy_bound_ms'] * 1e3:.3f}); host dispatch "
              f"{row['dispatch']['bound_us']:.3f} us bound, "
              f"{row['dispatch']['full_us']:.3f} us with the full "
              f"check (mean of 10000); bound hit share "
              f"{row['dispatch']['bound_hit_share']:.4f}", flush=True)
        rows[n] = row
    # one recv cell written in rounds 0 and 2: the later row lands
    plan = FusePlan(nprocs=2, data_size=2048, n_send_slots=2, n_recv_slots=2,
                    rounds=((0, ((0, 0, 1, 0),)), (1, ((1, 0, 0, 1),)),
                            (2, ((0, 1, 1, 0), (1, 1, 0, 0)))), barriers=())
    tabs = plan_tables(plan, dev)
    send = torch.randint(-2**31, 2**31 - 1, (2, 2, 512), dtype=torch.int32,
                         device=dev)
    got = fused_rep(send, tabs, out=poisoned(tabs, send))
    check_fence(tabs)
    check(torch.equal(got, fused_rep_plain(send, tabs))
          and torch.equal(got[1, 0], send[0, 1]),
          "K2 two-writer plan: the later round's row is lost")
    print(f"K2: {len(FUSABLE)} fusable methods at n=32 a=14 d=2048 c=3, m=1, "
          f"2 at n=256 a=16 c=16 and a two-writer plan verified and == "
          f"plain into a poisoned recv", flush=True)
    return dict(rows[README["n"]], large={k: rows[256][k] for k in (
        "shape", "ms", "eager_ms", "plain_ms", "fence", "grid", "copy_ctas",
        "us_per_fence", "bound_ms")})


def signal_latency_us(iters: int = 20000) -> dict:
    """The card's one-way release -> acquire signal latency between two
    SMs, from ``csrc/signal_probe.cu`` (not K3's code): two CTAs that
    cannot share an SM ping-pong a counter ``iters`` times; CTA 0's
    %globaltimer span over 2 * iters, the second of two runs."""
    import ctypes

    import torch

    from tpu_aggcomm_torch.csrc.build import load
    fn = load().aggcomm_signal_probe
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_ulonglong, p, ctypes.c_int]
    fn.restype = ctypes.c_int
    for _ in range(2):
        counters = torch.zeros(64, dtype=torch.int32, device="cuda")
        out = torch.zeros(3, dtype=torch.int64, device="cuda")
        error = torch.zeros(3, dtype=torch.int32, device="cuda")
        rc = fn(counters.data_ptr(), iters, out.data_ptr(), error.data_ptr(),
                10**10, torch.cuda.current_stream().cuda_stream,
                torch.cuda.current_device())
        check(rc == 0, f"signal probe launch failed: cudaError {rc}")
        torch.cuda.synchronize()
        check(not error.any(), f"signal probe timed out: {error.tolist()}")
    span_ns, sm0, sm1 = out.tolist()
    check(sm0 != sm1 and span_ns > 0, f"signal probe: SMs {sm0}, {sm1}, "
          f"span {span_ns} ns")
    return dict(us=span_ns / (2 * iters) / 1e3, sms=[sm0, sm1], iters=iters)


def k3_stamp_split(send, tabs, device_ms: float, runs: int = 20) -> dict:
    """How one K3 rep splits, from rank 0's %globaltimer stamps (mean over
    ``runs`` launches after one): zeroing, then per wave the post (copies,
    the CTA barrier, the releases) and the wait (the last release to the
    wait's end), and the launch (graph-timed device time less the
    stamped span), in microseconds."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_dma import dma_steps
    stamps = torch.zeros((tabs.n_waves + 1, 3), dtype=torch.int64,
                         device=send.device)
    acc = None
    for _ in range(runs + 1):
        dma_steps(send, tabs, stamps=stamps)
        st = stamps.double()
        w = st[1:]
        one = torch.stack([
            st[0, 1] - st[0, 0], (w[:, 1] - w[:, 0]).sum(),
            (w[:, 2] - w[:, 1]).sum(), st[0, 2] - st[0, 0]])
        acc = one * 0 if acc is None else acc + one   # first run: warm-up
    zero_us, post_us, wait_us, span_us = (acc / runs / 1e3).tolist()
    return dict(zero_us=zero_us, post_us=post_us, wait_us=wait_us,
                us_per_wave_post=post_us / tabs.n_waves,
                us_per_wave_wait=wait_us / tabs.n_waves, span_us=span_us,
                launch_us=device_ms * 1e3 - span_us)


def k3_graph_check(send, tabs, plain, label: str) -> None:
    """A CUDA graph of two K3 launches, replayed twice into a recv
    poisoned before each replay, equals plain: the graph-timed numbers
    are of a kernel that does the work."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_dma import (check_protocol,
                                                     dma_steps)
    out = torch.empty_like(plain)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(2):
            dma_steps(send, tabs, out=out, check=False)
    for _ in range(2):
        out.fill_(0xA5)
        graph.replay()
        torch.cuda.synchronize()
        check_protocol(tabs)
        check(torch.equal(out, plain), f"K3 {label}: graph replay != plain")


def k3_theta_cell(dev, signal_us: float, reps: int = 20) -> dict:
    """K3's bound rep (``CudaDmaBackend.one_rep``) at the benchmark cell
    ``theta_n1280_a2m_c64_dma``'s shape: m=1 at n=1280 a=20 d=2048 c=64,
    64 ranks a node, lockstep. Held byte for byte against the plain
    version into an arena it allocates itself, its launch and wave
    counts read, then timed by CUDA events over ``reps`` bound reps back
    to back, and split from rank 0's stamps (zeroing, posts, waits)."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend,
                                                     check_protocol,
                                                     dma_steps,
                                                     dma_steps_plain,
                                                     send_arena)
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    s = compile_method(1, AggregatorPattern(
        1280, 20, data_size=2048, comm_size=64, proc_node=64, placement=1))
    t0 = time.perf_counter()
    rep = CudaDmaBackend(device="cuda").one_rep(s)
    build_s = time.perf_counter() - t0
    tabs = rep.tables
    send = send_arena(s.pattern, 0, dev)
    plain = dma_steps_plain(send, tabs)
    launches, waves = dma_steps.launches, dma_steps.waves
    got = rep(send)
    check_protocol(tabs)
    err = max_abs_err(got, plain)
    check(err == 0 and torch.equal(got, plain),
          "K3 bound rep at the Theta cell's shape != plain")
    counted = dict(launches=dma_steps.launches - launches,
                   waves=dma_steps.waves - waves)
    check(counted == dict(launches=1, waves=tabs.n_waves),
          f"K3 bound rep counted {counted}, not one launch of "
          f"{tabs.n_waves} waves")
    del got, plain
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        rep(send)
    stop.record()
    stop.synchronize()
    check_protocol(tabs)
    ms = start.elapsed_time(stop) / reps
    split = k3_stamp_split(send, tabs, ms)
    row = dict(shape=[1280, 20, 2048, 64], proc_node=64,
               steps=tabs.n_steps, waves=tabs.n_waves, max_abs_err=err,
               counted=counted, build_s=build_s, eager_ms=ms,
               us_per_wave=ms * 1e3 / tabs.n_waves,
               chain_bound_ms=tabs.n_waves * signal_us / 1e3,
               zero_rows=tabs.zero_rows, split=split)
    print(f"K3 bound rep at the Theta cell (n=1280 a=20 c=64 -p 64): "
          f"{tabs.n_waves} waves, == plain, {counted['launches']} launch "
          f"of {counted['waves']} waves; {ms * 1e3:.3f} us a rep (events, "
          f"{reps} back to back), {row['us_per_wave']:.3f} us/wave, "
          f"wave chain {row['chain_bound_ms'] * 1e3:.3f} us; split: "
          f"zeroing {split['zero_us']:.3f} us, posts "
          f"{split['us_per_wave_post']:.3f} and waits "
          f"{split['us_per_wave_wait']:.3f} us a wave, launch "
          f"{split['launch_us']:.3f} us", flush=True)
    return row


def phase_k3(dev) -> dict:
    """K3 through cuda_dma and cuda_dma_conc: every stepped method (and
    m=13 -b 1) at the README shape, m=1 and m=18 at n=256 a=16 c=16 and
    m=1 at n=1024 a=64 c=16, each verified and compared byte for byte
    with the plain version on the whole arena, launched into a poisoned
    recv; m=1 timed at each shape beside the bytes bound and the
    wave-chain bound from the signal probe; the stamp split at the README
    shape. Returns the README m=1 rows by discipline, each with its
    larger shapes under ``large``."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_dma import (CudaDmaBackend,
                                                     capacity,
                                                     check_protocol,
                                                     dma_steps,
                                                     dma_steps_plain,
                                                     send_arena)
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    cap = capacity()
    probe = signal_latency_us()
    print(f"K3: co-resident CTA cap {cap} (blocks per SM x SMs); one-way "
          f"signal latency {probe['us']:.4f} us (signal probe, SMs "
          f"{probe['sms']}, {probe['iters']} round trips)", flush=True)
    n256, n1024 = dict(n=256, a=16, d=2048, c=16), dict(n=1024, a=64,
                                                        d=2048, c=16)
    cells = ([(m, README, 0) for m in FUSABLE] + [(13, README, 1)]
             + [(m, n256, 0) for m in (1, 18)] + [(1, n1024, 0)])
    # (kernel graph, kernel eager, plain graph, plain eager) calls per
    # timing, by rank count: the lockstep n=1024 program takes ~13 ms
    iters = {32: (50, 200, 3, 5), 256: (20, 50, 1, 3), 1024: (2, 5, 1, 2)}
    rows = {}
    for conc in (False, True):
        backend = CudaDmaBackend(device="cuda", concurrent=conc)
        for m, cfg, bt in cells:
            n, d = cfg["n"], cfg["d"]
            s = compile_method(m, AggregatorPattern(
                n, cfg["a"], data_size=d, comm_size=cfg["c"]),
                barrier_type=bt)
            t0 = time.perf_counter()
            tabs = backend.tables(s)
            build_s = time.perf_counter() - t0
            backend.run(s, verify=True)
            send = send_arena(s.pattern, 0, dev)
            plain = dma_steps_plain(send, tabs)
            got = dma_steps(send, tabs, out=torch.full_like(plain, 0xA5))
            err = max_abs_err(got, plain)
            check(err == 0 and torch.equal(got, plain),
                  f"K3 {backend.name} m={m} -b {bt} {cfg}: kernel != plain")
            del got
            if m != 1:
                del plain
                continue
            kg, ke, pg, pe = iters[n]
            row = dict(shape=[n, cfg["a"], d, cfg["c"]],
                       discipline=backend.name, max_abs_err=err,
                       steps=tabs.n_steps, waves=tabs.n_waves,
                       table_build_s=build_s,
                       **timings(lambda: dma_steps(send, tabs, check=False),
                                 lambda: dma_steps_plain(send, tabs),
                                 kg, pg, ke, pe, warmup=min(20, ke)))
            check_protocol(tabs)
            label = f"{backend.name} m=1 n={n}"
            k3_graph_check(send, tabs, plain, label)
            recv_bytes = n * tabs.n_recv_rows * d
            # least bytes of the function: the send rows real steps read
            # (a dummy step only signals, so no dummy row is read), the
            # three step tables, wave ends and zero runs read once, the
            # recv arena written once
            real = tabs.sslot != tabs.n_send_rows - 1
            ranks = torch.arange(n, device=dev)[:, None].expand_as(real)
            read_rows = torch.unique(
                ranks[real].long() * tabs.n_send_rows
                + tabs.sslot[real].long()).numel()
            min_bytes = (read_rows * d + 3 * 4 * n * tabs.n_steps
                         + 4 * tabs.n_waves + 4 * (2 * len(tabs.zero_runs)
                                                   + 1) + recv_bytes)
            edges = len(s.data_edges())
            bytes_ms = min_bytes / HBM_BYTES_PER_S * 1e3
            # the waves are a dependent chain: each ends no sooner than
            # one cross-SM signal after the wave before it
            chain_ms = tabs.n_waves * probe["us"] / 1e3
            row.update(
                us_per_wave=row["ms"] * 1e3 / tabs.n_waves,
                bound_ms=max(bytes_ms, chain_ms),
                bound_by="latency" if chain_ms > bytes_ms else "bytes",
                bytes_bound_ms=bytes_ms, chain_bound_ms=chain_ms,
                zero_rows=tabs.zero_rows,
                payload_bound_ms=2 * edges * d / HBM_BYTES_PER_S * 1e3)
            split = ""
            if n == README["n"]:
                row["split"] = k3_stamp_split(send, tabs, row["ms"])
                sp = row["split"]
                split = (f"; split (rank 0's stamps): launch "
                         f"{sp['launch_us']:.3f} us, zeroing "
                         f"{sp['zero_us']:.3f} us, posts "
                         f"{sp['post_us']:.3f} us "
                         f"({sp['us_per_wave_post']:.3f} a wave), waits "
                         f"{sp['wait_us']:.3f} us "
                         f"({sp['us_per_wave_wait']:.3f} a wave)")
            print(f"K3 {label} a={cfg['a']} c={cfg['c']}: "
                  f"{tabs.n_steps} steps, {tabs.n_waves} waves, tables "
                  f"built in {build_s:.3f} s; one launch "
                  f"{row['ms'] * 1e3:.3f} us device (CUDA graph, replays "
                  f"== plain), {row['eager_ms'] * 1e3:.3f} us eager "
                  f"(events), {row['us_per_wave']:.3f} us/wave; plain "
                  f"{row['plain_ms'] * 1e3:.3f} us device, "
                  f"{row['plain_eager_ms'] * 1e3:.3f} us eager; bound "
                  f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}): "
                  f"bytes {bytes_ms * 1e3:.3f} us ({min_bytes} B read "
                  f"once + written once; {read_rows} send rows read, "
                  f"{tabs.zero_rows} rows zeroed), "
                  f"wave chain {chain_ms * 1e3:.3f} us ({tabs.n_waves} x "
                  f"{probe['us']:.4f} us); payload bound "
                  f"{row['payload_bound_ms'] * 1e3:.3f} us ({edges} edges)"
                  f"{split}", flush=True)
            rows[(n, conc)] = row
            del send, plain
        print(f"K3 {backend.name}: {len(cells)} cells verified and == "
              f"plain into a poisoned recv", flush=True)
    theta = k3_theta_cell(dev, probe["us"])
    keep = ("shape", "steps", "waves", "ms", "eager_ms", "plain_ms",
            "plain_eager_ms", "us_per_wave", "bound_ms", "bound_by",
            "bytes_bound_ms", "chain_bound_ms")
    out = {name: dict(rows[(32, conc)], signal_latency_us=probe["us"],
                      large=[{k: rows[(n, conc)][k] for k in keep}
                             for n in (256, 1024)])
           for name, conc in (("lockstep", False), ("concurrent", True))}
    out["lockstep"]["theta_cell"] = theta
    return out


@contextlib.contextmanager
def recorded_backends():
    """The backends the runner makes while the block runs, in order (each
    keeps its measured samples, so a chained cell's per-rep time is read
    at full precision, not from the CSV's microseconds)."""
    from tpu_aggcomm_torch.backends import registry
    from tpu_aggcomm_torch.harness import runner

    made = []

    def recording(*args, **kw):
        made.append(registry.get_backend(*args, **kw))
        return made[-1]

    runner.get_backend = recording
    try:
        yield made
    finally:
        runner.get_backend = registry.get_backend


def run_cli(runs) -> None:
    from tpu_aggcomm_torch import cli
    for argv in runs:
        print(f"$ python -m tpu_aggcomm_torch.cli {' '.join(argv)}",
              flush=True)
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, f"cli {argv} failed")
        print(f"# ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_main_path() -> dict:
    """The port's entry points, launch counts zeroed first; returns the
    counts and the bench's JSON record."""
    from tpu_aggcomm_torch.backends.cuda_dma import dma_steps
    from tpu_aggcomm_torch.backends.cuda_local import exchange
    from tpu_aggcomm_torch.native.fuse import fused_rep

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    csv = str(OUT_DIR / "results.csv")
    readme = ["-m", "1", "-a", "14", "-d", "2048", "-c", "3",
              "--results-csv", csv]
    runs = [
        ["-n", "32", *readme, "--backend", "torch_sim", "--chained",
         "--verify"],
        ["-n", "1024", "-m", "1", "-a", "64", "-d", "2048", "-c", "16",
         "--backend", "torch_sim", "--verify", "--results-csv", csv],
        ["-n", "32", *readme, "--backend", "cuda_fused", "--chained",
         "--verify"],
    ]
    exchange.launches = exchange.reps = 0
    fused_rep.launches = 0
    run_cli(runs)
    print("$ python -m tpu_aggcomm_torch.bench", flush=True)
    buf, code = io.StringIO(), 0
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("tpu_aggcomm_torch.bench", run_name="__main__")
        except SystemExit as e:
            code = e.code
    bench_out = buf.getvalue()
    print(bench_out, end="", flush=True)
    check(code == 0, f"bench exited {code}")
    record = json.loads(bench_out.strip().splitlines()[-1])
    check("error" not in record and record["platform"] == "gpu",
          f"bench record: {record}")
    check(record.get("manifest", {}).get("device_kind")
          == record["device_kind"] and record.get("compile_seconds", 0) > 0,
          "the bench record lacks the run ledger's manifest and "
          "compile_seconds")
    counts = {"exchange": exchange.launches, "fused_rep": fused_rep.launches}
    reps = {"exchange": exchange.reps, "fused_rep": fused_rep.launches}
    print(f"# main-path launches: {counts}", flush=True)
    check(counts["exchange"] > 0, "K1 was not launched on the main path")
    check(counts["fused_rep"] > 0, "K2 was not launched on the main path")

    # slice 2's path: the remote-DMA transport through the CLI; -m 0
    # runs in the output directory, since m=13 writes its per-rank CSVs
    # into the working directory
    dma = ["-n", "32", *readme, "--verify"]
    dma_steps.launches = 0
    run_cli([[*dma, "--backend", "cuda_dma", "-k", "5"],
             [*dma, "--backend", "cuda_dma_conc", "-k", "5"]])
    buf = io.StringIO()
    with contextlib.chdir(OUT_DIR), contextlib.redirect_stdout(buf):
        run_cli([["-n", "32", "-m", "0", "-a", "14", "-d", "2048", "-c",
                  "3", "--backend", "cuda_dma", "--verify",
                  "--results-csv", csv]])
    print(buf.getvalue(), end="", flush=True)
    check(buf.getvalue().count("max total time") == 20
          and "Many to all TAM max total time" in buf.getvalue(),
          "-m 0 on cuda_dma did not run the 20 methods, TAM routed")
    counts["dma_steps"] = reps["dma_steps"] = dma_steps.launches
    print(f"# main-path launches (cuda_dma): {counts['dma_steps']}",
          flush=True)
    check(counts["dma_steps"] > 0, "K3 was not launched on the main path")

    # slice 5's path: measured phases, profile_rounds and TAM on
    # torch_sim, -m 0 on torch_sim and cuda_fused
    fused_rep.launches = 0
    t0 = time.perf_counter()
    measured = phase_measured(csv)
    measured_s = time.perf_counter() - t0
    counts["fused_rep"] += fused_rep.launches
    reps["fused_rep"] += fused_rep.launches
    print(f"# main-path launches (measured phases, -m 0): "
          f"{fused_rep.launches} of K2", flush=True)
    check(fused_rep.launches > 0,
          "K2 was not launched by -m 0 on cuda_fused")
    return {"counts": counts, "reps": reps, "bench": record,
            "measured": measured, "measured_s": measured_s}


def argv_of(cell: dict) -> list:
    """CLI flags of a cell ``dict(n, m, a, d, c, p)``."""
    return [x for k in ("n", "m", "a", "d", "c", "p")
            for x in (f"-{k}", str(cell[k]))]


def phase_measured(csv: str) -> dict:
    """``--measured-phases --verify`` and ``--profile-rounds --verify``
    through ``cli run`` on torch_sim: m=1 and m=2 at the README shape and
    m=1 at n=256 a=16 c=16 (round splits); TAM m=15 and m=16 at n=32 a=14
    ``-p 1`` and ``-p 4`` and m=15 at n=1024 a=64 c=16 ``-p 64`` (hop
    splits);
    each decomposition held to sum to its chained total (the backend's
    cached ``measure_per_rep``). Then ``-m 0 --verify`` on torch_sim and
    cuda_fused at the README shape. Returns each cell's decomposition in
    microseconds."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    # the n=256 round splits and the n=1024 TAM hops are cut for time
    # (59, 48 and 81 s: the sharded flagship took their place); the
    # splits and hops are measured at n=32, and inspect_roofline times
    # those shapes' chained totals
    rounds = [dict(README, m=m, p=1) for m in (1, 2)]
    profiled = rounds + [dict(n=256, a=16, d=2048, c=16, m=1, p=1)]
    tam = [dict(n=32, a=14, d=2048, c=3, m=m, p=p)
           for p in (1, 4) for m in (15, 16)]
    out = {}
    with recorded_backends() as made:
        for cell in rounds + tam:
            label = " ".join(f"{k}={cell[k]}" for k in
                             ("m", "n", "a", "c", "p"))
            run_cli([[*argv_of(cell), "--measured-phases", "--verify",
                      "--results-csv", csv]])
            b = made[-1]
            s = compile_method(cell["m"], AggregatorPattern(
                cell["n"], cell["a"], data_size=cell["d"],
                comm_size=cell["c"], proc_node=cell["p"]))
            total = b.measure_per_rep(s)          # cached: the chained total
            parts = b.last_round_times[0]
            check(min(parts) >= 0 and abs(sum(parts) - total)
                  <= 1e-9 * max(total, 1e-9),
                  f"{label}: decomposition {parts} does not sum to the "
                  f"chained total {total}")
            if cell["m"] in (15, 16):
                hops = b.measure_tam_hops(s)      # cached
                row = {k: hops[k] * 1e6 for k in ("p2", "p3", "p4")}
            else:
                splits = b.measure_round_splits(s)  # cached
                row = {"post": [v[0] * 1e6 for v in splits.values()],
                       "deliver": [v[1] * 1e6 for v in splits.values()]}
            row.update(total_us=total * 1e6, provenance=b.last_provenance[1])
            out[label] = row
            print(f"# {label}: {b.last_provenance[1]}; chained total "
                  f"{total * 1e6:.3f} us = sum of {len(parts)} measured "
                  f"parts {[round(x * 1e6, 3) for x in parts]}", flush=True)
        for cell in profiled:
            run_cli([[*argv_of(cell), "--profile-rounds", "--verify",
                      "--results-csv", csv]])
            b = made[-1]
            check(b.last_provenance[1] == "attributed-rounds",
                  f"--profile-rounds: {b.last_provenance}")
            out[f"profile m={cell['m']} n={cell['n']}"] = {
                "round_us": [x * 1e6 for x in b.last_round_times[0]]}
    # -m 0: every dispatched method on torch_sim; the fusable subset on
    # cuda_fused (TAM and the dense collectives dropped). m=13 writes its
    # per-rank CSVs into the working directory.
    with contextlib.chdir(OUT_DIR):
        for backend, expect in (("torch_sim", 20), ("cuda_fused", 16)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run_cli([["-n", "32", "-m", "0", "-a", "14", "-d", "2048",
                          "-c", "3", "--backend", backend, "--verify",
                          "--results-csv", csv]])
            got = buf.getvalue()
            print(got, end="", flush=True)
            check(got.count("max total time") == expect,
                  f"-m 0 on {backend}: {got.count('max total time')} "
                  f"methods, expected {expect}")
            check(("TAM max total time" in got) == (backend == "torch_sim"),
                  f"-m 0 on {backend}: TAM routing")
    return out


def refused(argv, needle: str) -> str:
    """Run the CLI expecting a one-line named refusal containing
    ``needle``; returns the line."""
    from tpu_aggcomm_torch import cli
    print(f"$ python -m tpu_aggcomm_torch.cli {' '.join(argv)}  # refused",
          flush=True)
    try:
        cli.main(argv)
    except (SystemExit, ValueError) as e:
        # a scope refusal exits with one line; an upfront guard of the
        # runner raises ValueError, as the reference's does
        line = str(e.code if isinstance(e, SystemExit) else e)
        check(needle in line and "\n" not in line,
              f"cli {argv}: refusal {line!r} lacks {needle!r}")
        print(f"# {line[:160]}", flush=True)
        return line
    raise SmokeError(f"cli {argv} ran; a named refusal was expected")


def delay_check(dev, cfg: dict, spec: str) -> dict:
    """The delay kernel against its plain version on the card, on the
    faulted schedule's own inputs: its live send lanes, the recv arena its
    rounds leave, its slow ranks and iteration counts. Returns acc, the
    errors and both times (CUDA graph of calls, and eager)."""
    import torch

    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,
                                                      _faulted_tables,
                                                      dense_send_lanes)
    from tpu_aggcomm_torch.backends.lanes import from_reference
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.faults import parse_fault, repair_schedule
    from tpu_aggcomm_torch.harness.verify import slot_shapes

    s = repair_schedule(compile_method(cfg["m"], AggregatorPattern(
        cfg["n"], cfg["a"], data_size=cfg["d"], comm_size=cfg["c"])),
        parse_fault(spec))
    _, n_recv = slot_shapes(s.pattern)
    *_rest, slow = _faulted_tables(s, n_recv)
    tabs = slow_tables(slow, dev)
    send = from_reference(dense_send_lanes(s.pattern, 0), dev)
    # the arena the rep leaves (its rounds, then the delay's zero delta)
    recv0 = TorchSimBackend("cuda").one_rep(s)(send)
    want = recv0.clone()
    acc_plain = slow_delay_plain(send, want, tabs)
    got = recv0.clone()
    acc = slow_delay(send, got, tabs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0 and torch.equal(got, want)
          and torch.equal(acc, acc_plain),
          f"slow_delay {cfg} {spec}: kernel != plain (acc "
          f"{acc.tolist()} vs {acc_plain.tolist()})")
    w = send.shape[2]
    it = max(tabs.iters)
    row = dict(shape=[cfg["n"], cfg["a"], cfg["d"], cfg["c"]], spec=spec,
               slow_ranks=list(tabs.ranks), iters=list(tabs.iters),
               acc=acc.tolist(), max_abs_err=err,
               **timings(lambda: slow_delay(send, got, tabs),
                         lambda: slow_delay_plain(send, want, tabs),
                         20, 2, 50, 3, warmup=3))
    # least time for the same work: the operations (an add, a floor
    # modulo and an add per lane and iteration, over the card's 67 TFLOP/s
    # float32 rate, the table's nearest integer figure) against the bytes
    # (each slow rank's row read once, acc written, recv[r, 0, 0] read and
    # written); latency, one block reduction an iteration, binds above both
    ops = 3 * w * sum(tabs.iters)
    nbytes = len(tabs.ranks) * (w * send.element_size() + 4
                                + 2 * send.element_size())
    ops_ms, bytes_ms = ops / 67e12 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    row.update(us_per_iteration=row["ms"] * 1e3 / it,
               bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)
    print(f"slow_delay {spec} at n={cfg['n']} a={cfg['a']} c={cfg['c']}: "
          f"ranks {row['slow_ranks']} x {row['iters']} iterations, acc "
          f"{row['acc']} == plain, arena == plain; one launch "
          f"{row['ms'] * 1e3:.3f} us device (CUDA graph), "
          f"{row['eager_ms'] * 1e3:.3f} us eager, "
          f"{row['us_per_iteration']:.4f} us/iteration; plain "
          f"{row['plain_ms'] * 1e3:.3f} us device, "
          f"{row['plain_eager_ms'] * 1e3:.3f} us eager; bound "
          f"{row['bound_ms'] * 1e3:.5f} us ({row['bound_by']}: "
          f"{ops} operations; bytes {bytes_ms * 1e3:.5f} us)", flush=True)
    del got, want, recv0, send
    return row


def per_rep_us(backend) -> float:
    """A chained run's per-rep time in microseconds, from the backend's
    own samples (the median the CSV rounds to microseconds)."""
    import statistics
    return statistics.median(backend.last_samples) * 1e6


def sweep_line(label: str, backends, grid) -> list:
    cells = [round(per_rep_us(b), 3) for b in backends]
    check(len(cells) == len(grid), f"{label}: {len(cells)} cells for "
          f"{len(grid)} throttle values")
    print(f"# sweep {label}: us/rep by -c " + json.dumps(
        dict(zip(map(str, grid), cells))), flush=True)
    return cells


def phase_faults_sweep(dev) -> dict:
    """Slice 6's path, through the CLI: the slow-rank delay kernel against
    its plain version (README shape and n=1024 a=64 c=16, slow:r2*8), the
    chained README time healthy and under slow:r2*2, *4, *8 (rising
    strictly), the repaired dead link on every round-structured method at
    the README shape and at n=1024 (chained, full width), the named
    refusals, and sweep over the Theta grid: m=1 and m=2 on torch_sim,
    m=1 on cuda_fused (K2 a cell), m=1 at n=1024 at -c 16 and
    unthrottled, and the fault axis with --resume. The delay's and K2's launch counts are
    zeroed after the kernel check and read at the end."""
    from tpu_aggcomm_torch.backends.slow_delay import slow_delay
    from tpu_aggcomm_torch.cli import THETA_COMM_SIZES
    from tpu_aggcomm_torch.core.methods import (METHODS, compile_method,
                                                method_ids)
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.faults import (RepairError, parse_fault,
                                          repair_schedule)
    from tpu_aggcomm_torch.native.fuse import fused_rep

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    readme1 = dict(README, m=1)
    n1024 = dict(n=1024, a=64, d=2048, c=16, m=1)
    rows = [delay_check(dev, readme1, "slow:r2*8"),
            delay_check(dev, n1024, "slow:r2*8")]
    csv = str(OUT_DIR / "faults.csv")
    readme = ["-n", "32", "-a", "14", "-d", "2048"]
    slow_delay.launches = 0
    fused_rep.launches = 0
    out = {"delay": rows}

    # the delay's cost in a chained rep: healthy and factors 2, 4, 8
    times = {}
    with recorded_backends() as made:
        for f in (1, 2, 4, 8):
            run_cli([[*readme, "-m", "1", "-c", "3", "--backend",
                      "torch_sim", "--chained", "--verify",
                      "--results-csv", csv]
                     + ([] if f == 1 else ["--fault", f"slow:r2*{f}"])])
            times[f] = per_rep_us(made[-1])
    series = [times[f] for f in (1, 2, 4, 8)]
    check(all(a < b for a, b in zip(series, series[1:])),
          f"chained us/rep does not rise with the slow factor: {times}")
    per_iter = rows[0]["us_per_iteration"]
    print(f"# delay timing (torch_sim --chained, README m=1): us/rep "
          f"healthy {times[1]:.3f}, slow:r2*2 {times[2]:.3f}, *4 "
          f"{times[4]:.3f}, *8 {times[8]:.3f}; the kernel "
          f"{per_iter:.4f} us/iteration", flush=True)
    out["delay_chained_us"] = times

    # a repaired dead link: every round-structured method at the README
    # shape (-m 0 with --fault is refused: TAM and the dense collectives
    # have no op programs to repair), and at n=1024 in full width; 5>3
    # carries no payload at n=1024, whose aggregators are multiples of 16
    repaired, unrepairable = [], []
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    for m in method_ids():
        if METHODS[m].tam or compile_method(m, p).collective:
            continue
        argv = [*readme, "-m", str(m), "-c", "3", "--fault",
                "deadlink:5>3", "--verify", "--results-csv", csv]
        try:
            repair_schedule(compile_method(m, p), parse_fault("deadlink:5>3"))
        except RepairError:
            refused(argv, "--fault: dead link 5>3")
            unrepairable.append(m)
            continue
        run_cli([argv])
        repaired.append(m)
    refused([*readme, "-m", "0", "-c", "3", "--fault", "deadlink:5>3",
             "--results-csv", csv],
            "--fault does not support methods [5, 8, 15, 16]")
    with recorded_backends() as made:
        run_cli([["-n", "1024", "-m", "1", "-a", "64", "-d", "2048", "-c",
                  "16", "--backend", "torch_sim", "--chained", "--verify",
                  "--fault", "deadlink:5>16", "--results-csv", csv]])
        out["deadlink_n1024_us"] = per_rep_us(made[-1])
    print(f"# dead link repaired and verified: m={repaired} at the README "
          f"shape (m={unrepairable} refused by the repair, as in the "
          f"reference); n=1024 a=64 c=16 deadlink:5>16 --chained "
          f"{out['deadlink_n1024_us']:.3f} us/rep", flush=True)
    out.update(repaired=repaired, unrepairable=unrepairable)

    # the named refusals
    refused([*readme, "-m", "1", "-c", "3", "--backend", "cuda_fused",
             "--fault", "deadlink:5>3", "--results-csv", csv],
            "UnfusableScheduleError: repaired schedule")
    refused([*readme, "-m", "1", "-c", "3", "--backend", "cuda_dma",
             "--fault", "slow:r2*4", "--results-csv", csv],
            "DmaFaultError: --fault slow:r2*4 is refused")

    # sweep over the Theta grid
    grid = list(THETA_COMM_SIZES)
    sweeps = {}
    for label, extra in (("m=1 torch_sim", ["-m", "1"]),
                         ("m=2 torch_sim", ["-m", "2"]),
                         ("m=1 cuda_fused", ["-m", "1", "--backend",
                                             "cuda_fused"])):
        before = fused_rep.launches
        with recorded_backends() as made:
            run_cli([["sweep", *readme, "-i", "1", *extra, "--chained",
                      "--verify", "--results-csv", csv]])
        sweeps[label] = sweep_line(f"{label} n=32 a=14 d=2048", made, grid)
        if "cuda_fused" in label:
            check(fused_rep.launches - before >= len(grid),
                  "K2 did not run every cuda_fused sweep cell")
    # n=1024, cut for time to two cells (about 20 s a cell: 11000
    # chained reps of 1.2-1.5 ms): 64 rounds and unthrottled; -c 1..8 are
    # 1024..128 rounds, -c 2048..8192 the one-round schedule of -c 1024;
    # the whole n=1024 grid is scripts/torch_sweeps.py's
    wide = [16, 999_999_999]
    with recorded_backends() as made:
        run_cli([["sweep", "-n", "1024", "-a", "64", "-d", "2048", "-m",
                  "1", "-i", "1", "--comm-sizes",
                  ",".join(map(str, wide)), "--chained", "--verify",
                  "--results-csv", csv]])
    sweeps["m=1 torch_sim n=1024"] = sweep_line(
        "m=1 torch_sim n=1024 a=64 d=2048 (cut for time to -c 16 and "
        "unthrottled: -c 1, 2, 4, 8, 32, 64, 128, 256, 512 and the "
        "one-round 1024, 2048, 4096, 8192 dropped)", made, wide)
    # the fault axis, then --resume skips every cell
    fcsv = str(OUT_DIR / "faults_sweep.csv")
    for path in Path(OUT_DIR).glob("faults_sweep.csv*"):
        path.unlink()
    axis = ["sweep", *readme, "-m", "1", "-i", "1", "--fault", "none",
            "--fault", "deadlink:5>3", "--verify", "--results-csv", fcsv]
    run_cli([axis])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli([[*axis, "--resume"]])
    got = buf.getvalue()
    print(got, end="", flush=True)
    skip = f"skipping already-recorded comm sizes {grid}"
    check("RUN_OPTS" not in got and got.count(skip) == 2
          and f"{skip} [fault deadlink:5>3]" in got,
          "sweep --resume did not skip every recorded cell")
    out["sweeps_us"] = sweeps
    out["counts"] = {"slow_delay": slow_delay.launches,
                     "fused_rep": fused_rep.launches}
    print(f"# faults_sweep launches: {out['counts']}", flush=True)
    check(slow_delay.launches > 0, "the delay kernel was not launched on "
          "the faults_sweep path")
    check(fused_rep.launches > 0, "K2 was not launched by the sweep")
    return out


@contextlib.contextmanager
def recorded_routes():
    """The ``(flat, times)`` of every proxy route the ``tam`` CLI runs
    while the block runs, in order (the printed "min rep" keeps six
    decimals of a second; these are the full-precision samples)."""
    from tpu_aggcomm_torch.tam import workload_engines

    made = []
    real = workload_engines.proxy_route

    def recording(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    workload_engines.proxy_route = recording
    try:
        yield made
    finally:
        workload_engines.proxy_route = real


def cli_out(argv) -> str:
    """Run one CLI command, echo its output and return it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli([argv])
    print(buf.getvalue(), end="", flush=True)
    return buf.getvalue()


def sim_chain_check(dev) -> None:
    """The sim route's chain on the card: the graph chain's end state
    (CUDA graph replays, the device rep counter) against the eager chain
    on the card and on the CPU, at 5, 50 and 53 reps, n=256 ``-p 64 -t
    0``."""
    import torch

    from tpu_aggcomm_torch.core.topology import static_node_assignment
    from tpu_aggcomm_torch.core.workload import initialize_setting
    from tpu_aggcomm_torch.harness.chained import eager_chain, graph_chain
    from tpu_aggcomm_torch.tam.workload_engines import proxy_route_program

    na = static_node_assignment(256, 64, 0)
    wl = initialize_setting(na, 16, 0)
    x0, _, step = proxy_route_program(wl, na, dev)
    c0, _, cstep = proxy_route_program(wl, na, "cpu")
    make = graph_chain(None, step=step)
    for iters in (5, 50, 53):
        got = make(iters)(x0)
        want = eager_chain(None, step=step)(iters)(x0)
        cpu = eager_chain(None, step=cstep)(iters)(c0)
        check(torch.equal(got, want) and torch.equal(got.cpu(), cpu),
              f"sim graph chain != eager chain at {iters} reps")
    print("# sim chain: graph replays equal the eager chain (card and "
          "CPU) at 5, 50, 53 reps, n=256 -p 64 -t 0", flush=True)


def sim_cell(label: str, argv: list, cut: str) -> dict:
    """One full-width ``tam --engine sim`` cell through the CLI, chained
    and per-dispatch ``-k 3``: verified each time (the CLI's vectorised
    check), the chained and per-dispatch microseconds a rep, the host
    table-build seconds, and the route's bytes a rep beside its HBM
    bound."""
    from tpu_aggcomm_torch.obs import ledger

    out = {}
    for mode, extra in (("chained", ["--chained", "-k", "3"]),
                        ("dispatch", ["-k", "3"])):
        with recorded_routes() as made:
            text = cli_out(["tam", *argv, "--engine", "sim", *extra])
        check("| correctness: PASSED" in text and len(made) == 1,
              f"tam sim {label} {mode} did not verify")
        flat, times = made[0]
        build = [r for r in ledger.compile_records()
                 if r["kind"] == "table-build"][-1]
        out[f"{mode}_us"] = [t * 1e6 for t in times]
        out[f"{mode}_table_s"] = build["seconds"]
        n_bytes = flat.numel()
        del made, flat
    # three hops of int32 table read + byte read + byte write, then the
    # chain's XOR (read + write)
    out["bytes_per_rep"] = bytes_rep = 3 * (4 + 1 + 1) * n_bytes + 2 * n_bytes
    out["bound_us"] = bytes_rep / HBM_BYTES_PER_S * 1e6
    out["hop_bytes"] = n_bytes
    print(f"# tam sim {label}{cut}: {n_bytes} bytes a hop; chained "
          f"{out['chained_us'][0]:.3f} us/rep, per-dispatch -k 3 "
          f"{', '.join(f'{t:.3f}' for t in out['dispatch_us'])} us; "
          f"tables {out['chained_table_s']:.3f} / "
          f"{out['dispatch_table_s']:.3f} s on the host; "
          f"{bytes_rep} bytes a rep, HBM bound {out['bound_us']:.3f} us",
          flush=True)
    return out


def phase_tam_obs(dev) -> dict:
    """Slice 7's path, through the CLI, K2's launch count zeroed first
    and read at the end: ``tam`` on every host engine at n=64 ``-p 8``
    (``-t`` 0 and 3), the ``sim`` engine at full width on the card
    (n=16384 ``-p 64 -t 0`` and n=4096 ``-p 64 -t 3``, chained and
    per-dispatch, each verified) and its graph chain against the eager
    chain; ``run --trace`` on torch_sim (the Perfetto file has a slice
    per round, the events re-aggregate float-exactly to the timer
    columns) and ``sweep --trace``; ``run --xprof`` on cuda_fused and
    torch_sim, each report from the card's device span, with the device
    busy share of the profiled rep."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.obs.perfetto import RANKS_PID
    from tpu_aggcomm_torch.obs.trace import (aggregate_run, load_events,
                                             summarize_trace)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    fused_rep.launches = 0
    out = {}

    # the host engines; at -t 3 every rank is a destination, and the
    # shared window needs each to be a local aggregator: -c 8 there
    for t in (0, 3):
        for engine in ("proxy", "local_agg", "shared", "benchmark",
                       "native", "native2", "native3"):
            co = "8" if t == 3 and engine in ("shared", "native3") else "2"
            text = cli_out(["tam", "-n", "64", "-p", "8", "-b", "16", "-t",
                            str(t), "-c", co, "--mode", "1", "--engine",
                            engine])
            check("| correctness: PASSED" in text,
                  f"tam --engine {engine} -t {t} did not verify")
    print("# tam host engines verified at n=64 -p 8 -b 16, -t 0 and 3 "
          "(-c 2 --mode 1; -c 8 for shared and native3 at -t 3)",
          flush=True)

    # the sim engine at full width on the card
    sim_chain_check(dev)
    out["sim_t0"] = sim_cell(
        "n=16384 -p 64 -b 16 -t 0",
        ["-n", "16384", "-p", "64", "-b", "16", "-t", "0"], "")
    out["sim_t3"] = sim_cell(
        "n=4096 -p 64 -b 16 -t 3",
        ["-n", "4096", "-p", "64", "-b", "16", "-t", "3"],
        " (n cut from 16384: -t 3 is n^2 messages)")

    # --trace on run and sweep
    prefix = str(OUT_DIR / "readme")
    csv = str(OUT_DIR / "obs.csv")
    readme = ["-n", "32", "-m", "1", "-a", "14", "-d", "2048"]
    text = cli_out([*readme, "-c", "3", "--backend", "torch_sim",
                    "--chained", "--verify", "--trace", prefix,
                    "--results-csv", csv])
    jsonl, pft = prefix + ".trace.jsonl", prefix + ".trace.json"
    check(Path(jsonl).exists() and Path(pft).exists(),
          "run --trace wrote no trace pair")
    with open(pft) as fh:
        chrome = json.load(fh)
    seen = {e["args"]["round"] for e in chrome["traceEvents"]
            if e.get("ph") == "X" and e.get("pid") == RANKS_PID}
    sched = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                                comm_size=3))
    rounds = {int(e[4]) for e in sched.data_edges()}
    check(rounds <= seen, f"trace slices cover rounds {sorted(seen - {None})}"
          f", the schedule has {sorted(rounds)}")
    events = load_events(jsonl)
    timers = {e["rank"]: {k: e[k] for k in ("post", "send_wait",
                                             "recv_wait", "barrier",
                                             "total")}
              for e in events if e["ev"] == "timer" and e["run"] == 0}
    check(aggregate_run(events, 0) == timers and len(timers) == 32,
          "the trace does not re-aggregate to the timer columns")
    max_total = max(t["total"] for t in timers.values())
    check(f"| All to many max total time = {max_total:.6f}" in text,
          "the traced timer columns are not the printed ones")
    check("run 0:" in summarize_trace(jsonl), "summarize_trace failed")
    names = {e["name"] for e in events if e["ev"] == "instant"}
    check({"chained.trial", "chained.samples", "ledger.compile"} <= names,
          f"trace instants: {sorted(names)}")
    captures = [e["args"] for e in events if e["ev"] == "instant"
                and e["name"] == "ledger.compile"
                and e["args"].get("kind") == "graph-capture"]
    check(captures, "no graph-capture record in the trace")
    print(f"# run --trace: {len(rounds)} rounds, each with slices; "
          f"{len(events)} events re-aggregate float-exactly to 32 ranks' "
          f"timer columns; graph captures "
          f"{[(c['reps'], round(c['seconds'], 4)) for c in captures]}",
          flush=True)
    prefix2 = str(OUT_DIR / "sweep")
    cli_out(["sweep", *readme, "-i", "1", "--comm-sizes", "1,3,999999999",
             "--verify", "--trace", prefix2, "--results-csv", csv])
    events2 = load_events(prefix2 + ".trace.jsonl")
    runs = [e for e in events2 if e["ev"] == "run"]
    check(Path(prefix2 + ".trace.json").exists() and
          [r["comm_size"] for r in runs] == [1, 3, 999999999],
          f"sweep --trace covered {[r['comm_size'] for r in runs]}")
    for r in runs:
        timers = {e["rank"]: {k: e[k] for k in ("post", "send_wait",
                                                 "recv_wait", "barrier",
                                                 "total")}
                  for e in events2 if e["ev"] == "timer"
                  and e["run"] == r["id"]}
        check(aggregate_run(events2, r["id"]) == timers,
              f"sweep trace run {r['id']} does not re-aggregate")
    print("# sweep --trace: one trace pair over -c 1, 3, 999999999, each "
          "cell re-aggregating float-exactly", flush=True)

    # --xprof on cuda_fused and torch_sim: the device span, and the
    # device busy share of the profiled rep's host wall
    out["xprof"] = {}
    for backend in ("cuda_fused", "torch_sim"):
        logdir = OUT_DIR / f"xprof_{backend}"
        cli_out([*readme, "-c", "3", "--backend", backend, "--verify",
                 "--xprof", str(logdir), "--results-csv", csv])
        rep = ledger.xprof_reports()[-1]
        check(rep["source"] == "cupti-device-span",
              f"--xprof on {backend}: source {rep['source']} "
              f"({rep.get('error')})")
        dev_ev = ledger.chrome_trace_device_events(
            str(next(Path(rep["logdir"]).glob("*.pt.trace.json"))))
        row = {"plane": rep["device_plane"],
               "profiled_wall_us": rep["profiled_wall_s"] * 1e6,
               "device_span_us": dev_ev["span_s"] * 1e6,
               "device_busy_us": dev_ev["busy_s"] * 1e6,
               "device_events": dev_ev["events"],
               "reconstructed_us": rep["reconstructed_s"] * 1e6,
               "busy_share": dev_ev["busy_s"] / rep["profiled_wall_s"],
               "busy_share_of_span": dev_ev["busy_s"] / dev_ev["span_s"]}
        out["xprof"][backend] = row
        print(f"# xprof {backend}: {json.dumps(row)}", flush=True)
    out["counts"] = {"fused_rep": fused_rep.launches}
    print(f"# tam_obs launches: {out['counts']}", flush=True)
    check(fused_rep.launches > 0, "K2 was not launched by --xprof on "
          "cuda_fused")
    return out


def batched_delay_check(dev, spec: str = "slow:r2*2",
                        batches=(1, 2, 4, 8)) -> list:
    """The delay kernel's request axis against its plain version at the
    README shape, on the inputs the serve layer's batched rep gives it:
    B requests' live send rows (iters 0..B-1) and the (B, n, F+1, w)
    arena the batched rep leaves; one launch for the batch. Returns a row
    per B with both times and the bound."""
    import torch

    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,
                                                      _faulted_tables,
                                                      dense_send_batch)
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.faults import parse_fault, repair_schedule
    from tpu_aggcomm_torch.harness.verify import slot_shapes

    s = repair_schedule(compile_method(1, AggregatorPattern(
        README["n"], README["a"], data_size=README["d"],
        comm_size=README["c"])), parse_fault(spec))
    _, n_recv = slot_shapes(s.pattern)
    *_rest, slow = _faulted_tables(s, n_recv)
    tabs = slow_tables(slow, dev)
    brep = TorchSimBackend("cuda").batched_rep(s)
    rows = []
    for b in batches:
        sends = dense_send_batch(s.pattern, list(range(b)), b, dev)
        recv0 = brep(sends)
        want = recv0.clone()
        acc_plain = slow_delay_plain(sends, want, tabs)
        got = recv0.clone()
        before = slow_delay.launches
        acc = slow_delay(sends, got, tabs)
        torch.cuda.synchronize()
        check(slow_delay.launches == before + 1,
              f"batched slow_delay B={b}: not one launch")
        err = max_abs_err(got, want)
        check(err == 0 and torch.equal(got, want)
              and torch.equal(acc, acc_plain),
              f"batched slow_delay B={b} {spec}: kernel != plain")
        row = dict(batch=b, spec=spec, slow_ranks=list(tabs.ranks),
                   iters=list(tabs.iters), max_abs_err=err,
                   **timings(lambda: slow_delay(sends, got, tabs),
                             lambda: slow_delay_plain(sends, want, tabs),
                             20, 2, 50, 3, warmup=3))
        # the same counts as the one-request row, times B requests
        w = sends.shape[-1]
        ops = 3 * w * sum(tabs.iters) * b
        nbytes = b * len(tabs.ranks) * (w * sends.element_size() + 4
                                        + 2 * sends.element_size())
        ops_ms, bytes_ms = ops / 67e12 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        row.update(bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   us_per_iteration=row["ms"] * 1e3 / max(tabs.iters))
        print(f"slow_delay batched B={b} {spec} at the README shape: acc "
              f"and arena == plain, one launch {row['ms'] * 1e3:.3f} us "
              f"device (CUDA graph), {row['eager_ms'] * 1e3:.3f} us "
              f"eager; plain {row['plain_ms'] * 1e3:.3f} us device; "
              f"bound {row['bound_ms'] * 1e3:.5f} us ({row['bound_by']})",
              flush=True)
        rows.append(row)
        del sends, recv0, want, got
    return rows


def batched_rep_us(dev) -> dict:
    """One batched README rep (m=1, torch_sim) at B = 1, 2, 4, 8: device
    time (a CUDA graph of 20 dispatches, replayed) and eager time (CUDA
    events around 200 back-to-back dispatches), each per request, beside
    K2's one-request rep."""
    from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
    from tpu_aggcomm_torch.backends.torch_sim import (TorchSimBackend,
                                                      dense_send_batch)
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    s = compile_method(1, AggregatorPattern(
        README["n"], README["a"], data_size=README["d"],
        comm_size=README["c"]))
    brep = TorchSimBackend("cuda").batched_rep(s)
    out = {}
    for b in (1, 2, 4, 8):
        sends = dense_send_batch(s.pattern, list(range(b)), b, dev)
        dev_ms = graph_ms(lambda: brep(sends), 20)
        eager_ms = cuda_ms(lambda: brep(sends), 200)
        out[b] = dict(device_us=dev_ms * 1e3,
                      device_us_per_request=dev_ms * 1e3 / b,
                      eager_us=eager_ms * 1e3,
                      eager_us_per_request=eager_ms * 1e3 / b)
    fused = CudaFusedBackend("cuda")
    k2 = fused._compiled(s)
    send = fused._global_send(s.pattern, 0)
    out["k2"] = dict(device_us_per_request=graph_ms(lambda: k2(send), 200)
                     * 1e3,
                     eager_us_per_request=cuda_ms(lambda: k2(send), 2000)
                     * 1e3)
    print("# serve batched README rep (torch_sim m=1), us: "
          + json.dumps(out), flush=True)
    return out


def serve_burst(port: int, payloads: list) -> tuple:
    """Fire ``payloads`` as one burst of ServeClient threads (connected
    first, then released together); fails on any response that is not
    ok. Returns (responses, wall seconds)."""
    import threading

    from tpu_aggcomm_torch.serve import ServeClient

    out = [None] * len(payloads)
    gate = threading.Barrier(len(payloads))

    def fire(i):
        with ServeClient(port, timeout=900.0) as c:
            c._connect()
            gate.wait()
            out[i] = c.run(**payloads[i])

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(payloads))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for r in out:
        check(r is not None and r.get("ok") is True,
              f"serve request failed: {r}")
    return out, wall


def serve_leg(srv, label: str, shape: dict, n: int, *, iter0: int = 0,
              want_cache: str | None = None) -> dict:
    """One burst of ``n`` same-shape verified requests; checks every one
    verified (and the cache disposition); returns the leg's line.

    Before a cold burst (``want_cache="miss"``) the server resolves the
    shape's schedule once, timed (``resolve_s``): the server caches the
    resolution per shape, but concurrent first admissions of one shape
    each build it (n=1024: seconds of host work under one interpreter
    lock), which spreads a burst's admissions past the batch window."""
    from tpu_aggcomm_torch.obs.metrics import percentile
    from tpu_aggcomm_torch.serve.protocol import parse_request

    resolve_s = None
    if want_cache == "miss":
        t0 = time.perf_counter()
        srv._schedule_for(parse_request(dict(shape)),
                          shape.get("backend") or "torch_sim")
        resolve_s = time.perf_counter() - t0
    st0 = srv.stats()["batch"]
    resps, wall = serve_burst(srv.port, [dict(shape, iter=iter0 + i,
                                              verify=True)
                                         for i in range(n)])
    st1 = srv.stats()["batch"]
    check(all(r["verified"] is True for r in resps),
          f"serve {label}: not every request verified")
    if want_cache is not None:
        check(all(r["cache"] == want_cache for r in resps),
              f"serve {label}: cache {[r['cache'] for r in resps]}, "
              f"want {want_cache}")

    def q(vals):
        return ({"p50_us": percentile(vals, 50.0) * 1e6,
                 "p95_us": percentile(vals, 95.0) * 1e6, "n": len(vals)}
                if vals else None)

    slots = st1["padded_slots"] - st0["padded_slots"]
    reqs = st1["dispatched_requests"] - st0["dispatched_requests"]
    row = dict(label=label, requests=n, resolve_s=resolve_s,
               batch_n=sorted({r["batch_n"] for r in resps}),
               cache=sorted({r["cache"] for r in resps}),
               cold=q([r["latency_s"] for r in resps if r["cache"] != "hit"]),
               warm=q([r["latency_s"] for r in resps if r["cache"] == "hit"]),
               requests_per_s=n / wall, wall_s=wall,
               compile_s=sorted({r["compile_s"] for r in resps
                                 if r["compile_s"] is not None}),
               batches=st1["batches"] - st0["batches"],
               padded_slots=slots, fill=reqs / slots if slots else None,
               padding_waste_bytes=(st1["padding_waste_bytes"]
                                    - st0["padding_waste_bytes"]))
    print(f"# serve {label}: {json.dumps(row)}", flush=True)
    return row


@contextlib.contextmanager
def recorded_serve():
    """The server's chain builds and batch dispatches while the block
    runs: ``(builds, batches)``, each build with its compile seconds and
    their table and warm-up parts, each batch with its dispatch and
    verify walls."""
    from tpu_aggcomm_torch.serve import executor

    builds, batches = [], []
    real_build, real_exec = executor.build_chain, executor.execute_batch

    def build(schedule, backend_name, **kw):
        chain, secs = real_build(schedule, backend_name, **kw)
        builds.append(dict(backend=backend_name, method=schedule.method_id,
                           n=schedule.pattern.nprocs, compile_s=secs,
                           tables_s=chain.tables_s,
                           warmup_s=chain.warmup_s))
        return chain, secs

    def execute(chain, reqs):
        res = real_exec(chain, reqs)
        batches.append(dict(backend=chain.backend_name,
                            method=chain.schedule.method_id,
                            n=chain.schedule.pattern.nprocs,
                            fault=getattr(chain.schedule, "fault", None),
                            requests=len(reqs),
                            dispatch_s=res[0]["dispatch_s"],
                            verify_s=sum(r["verify_s"] for r in res)))
        return res

    executor.build_chain, executor.execute_batch = build, execute
    try:
        yield builds, batches
    finally:
        executor.build_chain, executor.execute_batch = real_build, real_exec


def phase_serve(dev) -> dict:
    """Slice 8's path: the schedule server (``ScheduleServer(device=
    "cuda")`` on a thread, journalled) driven by ServeClient bursts of
    verified requests at full width: the README shape m=1 on torch_sim
    (8 cold, one batch; 8 warm hits; 3 padded to 4), on cuda_fused (8
    cold and 8 warm, a K2 launch each), n=256 a=16 c=16 m=3, TAM m=15,
    slow:r2*2 (one delay launch a batched dispatch) and deadlink:5>3 at
    the README shape, n=1024 a=64 c=16 m=1 (a batch of 2: 4.3 GB of recv
    arena); then the shutdown's drain record replayed REPRODUCED, and a
    second server recovering from the journal: every shape pre-warmed,
    its first README request a hit. Before the counts are zeroed: the
    delay kernel's request axis against its plain version (B = 1, 2, 4,
    8) and the batched README rep's device time per request."""
    from tpu_aggcomm_torch.backends.slow_delay import slow_delay
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.serve import ScheduleServer, ServeClient
    from tpu_aggcomm_torch.serve.recover import replay_journal

    out = {"delay": batched_delay_check(dev),
           "batched_rep_us": batched_rep_us(dev)}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    journal = OUT_DIR / "serve.journal.jsonl"
    journal.unlink(missing_ok=True)
    readme = dict(method=1, nprocs=README["n"], cb_nodes=README["a"],
                  comm_size=README["c"], data_size=README["d"])
    slow = dict(readme, fault="slow:r2*2")
    legs = []
    slow_delay.launches = 0
    fused_rep.launches = 0
    t0 = time.perf_counter()
    with recorded_serve() as (builds, batches):
        # a 50 ms batch window (the CLI's default is 5 ms): a burst's
        # threads are admitted within it however the host schedules them
        srv = ScheduleServer(device="cuda", max_batch=8,
                             batch_window_s=0.05, journal_path=str(journal))
        srv.start()
        try:
            legs.append(serve_leg(srv, "readme torch_sim cold", readme, 8,
                                  want_cache="miss"))
            check(legs[-1]["batch_n"] == [8] and legs[-1]["batches"] == 1,
                  f"the cold README burst was not one batch of 8: "
                  f"{legs[-1]}")
            legs.append(serve_leg(srv, "readme torch_sim warm", readme, 8,
                                  iter0=8, want_cache="hit"))
            legs.append(serve_leg(srv, "readme torch_sim burst of 3",
                                  readme, 3, iter0=16, want_cache="hit"))
            check(legs[-1]["padded_slots"] == 4
                  and legs[-1]["fill"] == 0.75,
                  f"a burst of 3 did not pad to 4: {legs[-1]}")
            fused = dict(readme, backend="cuda_fused")
            legs.append(serve_leg(srv, "readme cuda_fused cold", fused, 8,
                                  want_cache="miss"))
            legs.append(serve_leg(srv, "readme cuda_fused warm", fused, 8,
                                  iter0=8, want_cache="hit"))
            k2_reqs = fused_rep.launches
            check(k2_reqs == 16 + 1, f"K2 launches {k2_reqs} in the "
                  f"cuda_fused legs, want 16 requests + 1 warm-up")
            legs.append(serve_leg(srv, "n256 m3 torch_sim", dict(
                method=3, nprocs=256, cb_nodes=16, comm_size=16,
                data_size=2048), 4, want_cache="miss"))
            legs.append(serve_leg(srv, "readme m15 (TAM) torch_sim",
                                  dict(readme, method=15), 4,
                                  want_cache="miss"))
            before = slow_delay.launches
            n_disp = len(batches)
            legs.append(serve_leg(srv, "readme slow:r2*2 torch_sim", slow,
                                  4, want_cache="miss"))
            got = slow_delay.launches - before
            check(got == 1 + len(batches) - n_disp,
                  f"slow_delay launches {got} for "
                  f"{len(batches) - n_disp} batched dispatch(es) + 1 "
                  f"warm-up")
            legs.append(serve_leg(srv, "readme deadlink:5>3 torch_sim",
                                  dict(readme, fault="deadlink:5>3"), 2,
                                  want_cache="miss"))
            legs.append(serve_leg(srv, "n1024 m1 torch_sim", dict(
                method=1, nprocs=1024, cb_nodes=64, comm_size=16,
                data_size=2048), 2, want_cache="miss"))
            check(legs[-1]["batch_n"] == [2], "n=1024 was not one batch")
            with ServeClient(srv.port, timeout=120.0) as c:
                stats = c.stats()
                check(c.shutdown()["stopping"] is True, "shutdown refused")
            srv.join(timeout=300.0)
        finally:
            srv.stop()
            srv.close()
        served = time.perf_counter() - t0
        rep = replay_journal(str(journal))
        check(rep["verdict"] == "REPRODUCED" and len(rep["drains"]) == 1
              and rep["lost"] == [] and rep["failed"] == [],
              f"journal replay: {rep['verdict']} {rep['problems']}")
        n_shapes = len(builds)
        t_rec = time.perf_counter()
        srv2 = ScheduleServer(device="cuda", recover=str(journal))
        recovered = srv2.ready_info()["recover"]
        check(recovered["verdict"] == "REPRODUCED"
              and recovered["prewarmed"] == n_shapes
              and recovered["skipped"] == [],
              f"recovery: {recovered}")
        srv2.start()
        try:
            first = serve_leg(srv2, "recovered readme torch_sim", readme,
                              1, iter0=100, want_cache="hit")
            with ServeClient(srv2.port, timeout=120.0) as c:
                check(c.shutdown()["stopping"] is True, "shutdown refused")
            srv2.join(timeout=300.0)
        finally:
            srv2.stop()
            srv2.close()
        recover_s = time.perf_counter() - t_rec
    out.update(legs=legs, recovered=dict(
        {k: recovered[k] for k in ("verdict", "prewarmed", "completed")},
        first=first, wall_s=recover_s), builds=builds, batches=batches,
        stats=stats, served_s=served,
        counts={"slow_delay": slow_delay.launches,
                "fused_rep": fused_rep.launches})
    print(f"# serve journal: {rep['verdict']}, {len(rep['completed'])} "
          f"completed, one drain record; recovery pre-warmed "
          f"{recovered['prewarmed']} shapes in {recover_s:.1f} s "
          f"(first README request a hit)", flush=True)
    for b in builds:
        print(f"# serve build {json.dumps(b)}", flush=True)
    for b in batches:
        print(f"# serve dispatch {json.dumps(b)}", flush=True)
    print(f"# serve launches: {json.dumps(out['counts'])}", flush=True)
    return out


def cli_capture(argv, expect=(0,)) -> tuple:
    """Run one CLI command in-process; returns (exit code, stdout,
    stderr), both echoed. Fails unless the code is one of ``expect``."""
    from tpu_aggcomm_torch import cli
    print(f"$ python -m tpu_aggcomm_torch.cli {' '.join(argv)}", flush=True)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:     # a usage error or a named refusal
            rc = e.code
    print(out.getvalue(), end="")
    print("".join(f"# stderr: {ln}\n" for ln in err.getvalue().splitlines()),
          end="")
    print(f"# ({time.perf_counter() - t0:.1f} s, exit {rc})", flush=True)
    check(rc in expect, f"cli {argv} exited {rc}, expected {expect}")
    return rc, out.getvalue(), err.getvalue()


def k2_against_plain(dev, s) -> tuple:
    """One K2 launch of schedule ``s`` into a poisoned recv, held against
    the plain version on the same send; returns (plan, tables, send,
    max_abs_err) and fails unless the two are byte-equal."""
    import torch

    from tpu_aggcomm_torch.backends.lanes import from_reference
    from tpu_aggcomm_torch.backends.torch_sim import dense_send_lanes
    from tpu_aggcomm_torch.native.fuse import (check_fence, fuse_plan,
                                               fused_rep, fused_rep_plain,
                                               plan_tables)

    plan = fuse_plan(s)
    tabs = plan_tables(plan, dev)
    send = from_reference(dense_send_lanes(s.pattern, 0), dev)
    plain = fused_rep_plain(send, tabs)
    got = fused_rep(send, tabs, out=torch.full_like(plain, -0x5A5A5A5B))
    check_fence(tabs)
    err = max_abs_err(got, plain)
    check(err == 0 and torch.equal(got, plain),
          f"K2 {s.name} n={s.pattern.nprocs} a={s.pattern.cb_nodes} "
          f"c={s.pattern.comm_size}: kernel != plain")
    return plan, tabs, send, err


def synth_k2_check(dev, synth_root: str) -> list:
    """K2 on the committed synthesized methods m=101-103 (one round
    carrying every data edge, window=drain) at the README cell and at
    n=256 a=16 c=16: one launch into a poisoned recv against the plain
    version, and m=103's device time beside its bound at each shape."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.native.fuse import fused_rep, fused_rep_plain
    from tpu_aggcomm_torch.synth import ensure_registered

    check(sorted(ensure_registered(synth_root)) == [101, 102, 103],
          "the committed SYNTH_r01.json did not register m=101-103")
    rows = []
    for cfg in (README, dict(n=256, a=16, d=2048, c=16)):
        for m in (101, 102, 103):
            s = compile_method(m, AggregatorPattern(
                cfg["n"], cfg["a"], data_size=cfg["d"], comm_size=cfg["c"]))
            plan, tabs, send, err = k2_against_plain(dev, s)
            check(len(plan.rounds) == 1
                  and plan.n_edges == cfg["n"] * cfg["a"],
                  f"m={m} {cfg}: not one round of n*a edges")
            row = {"method": m, "shape": cfg, "edges": plan.n_edges,
                   "max_abs_err": err}
            if m == 103:
                n, d = cfg["n"], cfg["d"]
                # each delivered row read once and written once, and the
                # rest of the recv arena zeroed
                nbytes = 2 * plan.n_edges * d + (
                    n * tabs.n_recv_rows - plan.n_edges) * d
                row.update(timings(lambda: fused_rep(send, tabs),
                                   lambda: fused_rep_plain(send, tabs),
                                   200, 20, eager_iters=500,
                                   plain_eager_iters=50),
                           bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           bound_by="bytes")
            rows.append(row)
    for r in rows:
        if "ms" in r:
            print(f"# K2 synthesized m=103 n={r['shape']['n']} "
                  f"({r['edges']} edges, one round): {r['ms'] * 1e3:.3f} "
                  f"us device, {r['eager_ms'] * 1e3:.3f} eager, plain "
                  f"{r['plain_ms'] * 1e3:.3f}, bound "
                  f"{r['bound_ms'] * 1e3:.3f} us", flush=True)
    print(f"K2 == plain into a poisoned recv for m=101-103 at n=32 a=14 "
          f"c=3 and n=256 a=16 c=16 ({len(rows)} cells)", flush=True)
    return rows


TUNE_GRID = dict(methods=(1, 3, 7), cb_nodes=(4, 14), comm_sizes=(3, 8),
                 agg_types=(1,), nprocs=32, data_size=2048, proc_node=1)


def tune_grid_k2_check(dev) -> int:
    """K2 against its plain version at every cell the cuda_fused race
    samples (``TUNE_GRID``, candidates from the tuner's own
    ``build_space`` and schedules compiled as its sampler compiles
    them): the race's samples are timed chains that verify nothing."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.tune.space import build_space

    g = TUNE_GRID
    cands = build_space(g["methods"], g["cb_nodes"], g["comm_sizes"],
                        g["agg_types"], nprocs=g["nprocs"])
    for c in cands:
        k2_against_plain(dev, compile_method(c.method, AggregatorPattern(
            nprocs=g["nprocs"], cb_nodes=c.cb_nodes,
            data_size=g["data_size"], proc_node=g["proc_node"],
            comm_size=c.comm_size, placement=c.agg_type)))
    print(f"K2 == plain into a poisoned recv at every cell of the tune "
          f"grid ({', '.join(c.cid for c in cands)})", flush=True)
    return len(cands)


def tune_line(label: str, blob: dict, text: str, t_wall: float) -> dict:
    """One ``tune`` run's numbers: the race's from its artifact, the race
    wall and the graph captures (printed, not stored) from its output."""
    import re
    import statistics
    race = blob["race"]
    win = race["winner"]
    cap = re.search(r"race wall ([0-9.]+) s, (\d+) CUDA graph capture\(s\) "
                    r"in ([0-9.]+) s", text)
    rec = {"backend": label, "candidates": len(race["order"]),
           "batches": race["batches_run"],
           "eliminations": len(race["eliminations"]), "winner": win,
           "winner_us_per_rep": statistics.median(
               x for b in race["samples"][win] for x in b) * 1e6,
           "captures": int(cap.group(2)), "capture_s": float(cap.group(3)),
           "race_wall_s": float(cap.group(1)), "wall_s": t_wall,
           "max_batches": race["max_batches"],
           "batch_trials": race["batch_trials"]}
    print(f"# tune {json.dumps(rec)}", flush=True)
    return rec


def phase_tune_synth(dev) -> dict:
    """Slice 9's path, in a temporary directory, K2's launch count zeroed
    after the kernel check and read at the end: the tuner racing 12
    candidates on fresh device samples (torch_sim, then cuda_fused: every
    sample K2 launches replayed from CUDA graphs) at n=32 d=2048, each
    artifact replayed REPRODUCED, K2 held against its plain version at
    every cell of that grid; ``run --auto`` applying each backend's
    winner with --verify; ``--model-prune`` on the card naming the
    missing gpu calibration; m=101-103 from a copy of SYNTH_r01.json on
    torch_sim, cuda_fused and local at the README cell and n=256 a=16
    c=16, verified; a short ``synth`` at the README cell, whose verdict
    (a synthesized winner that validates and replays, or the named
    reference win) is the result."""
    import shutil
    import tempfile

    import torch

    from tpu_aggcomm_torch.core.methods import METHODS
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.obs.regress import validate_synth, validate_tune

    repo = Path(__file__).resolve().parent
    ids = set(METHODS)
    out = {}
    with tempfile.TemporaryDirectory(prefix="tune_synth_") as tmp:
        tmp = Path(tmp)
        synth_root = tmp / "synth"
        synth_root.mkdir()
        shutil.copy(repo / "SYNTH_r01.json", synth_root)
        out["k2"] = synth_k2_check(dev, str(synth_root))
        out["k2_tune_grid_cells"] = tune_grid_k2_check(dev)
        fused_rep.launches = 0

        g = TUNE_GRID
        iters_big, max_batches = 1050, 6
        grid = ["-n", str(g["nprocs"]), "-d", str(g["data_size"]), "-p",
                str(g["proc_node"]), "--methods", ",".join(
                    map(str, g["methods"])), "--cb-nodes", ",".join(
                    map(str, g["cb_nodes"])), "--comm-sizes", ",".join(
                    map(str, g["comm_sizes"])), "--agg-types", ",".join(
                    map(str, g["agg_types"])), "--iters-big", str(iters_big),
                "--max-batches", str(max_batches)]
        out["tune"] = []
        for backend in ("torch_sim", "cuda_fused"):
            root = tmp / backend
            root.mkdir()
            before = fused_rep.launches
            t0 = time.perf_counter()
            _, text, _ = cli_capture(["tune", "--backend", backend, *grid,
                                      "--tune-root", str(root)])
            wall = time.perf_counter() - t0
            path = root / f"TUNE_{backend}_n32_d2048_p1_a2m.json"
            blob = json.loads(path.read_text())
            check(validate_tune(blob) == [], f"{path.name} invalid")
            rec = tune_line(backend, blob, text, wall)
            rec.update(iters_big=iters_big,
                       k2_launches=fused_rep.launches - before)
            check(rec["candidates"] == 12, f"tune {backend}: not 12")
            check(rec["captures"] >= 1,
                  f"tune {backend}: no CUDA graph was captured")
            if backend == "cuda_fused":
                check(rec["k2_launches"] > 0,
                      "tune --backend cuda_fused launched no K2")
            else:
                check(rec["k2_launches"] == 0, "torch_sim launched K2")
            check(blob["manifest"]["device_kind"]
                  == torch.cuda.get_device_name(0),
                  "the tune manifest does not name the card")
            _, text, _ = cli_capture(["tune", "--replay", str(path)])
            check("-> REPRODUCED" in text, f"{path.name} did not replay")
            out["tune"].append(rec)
        man = ledger.manifest()
        check(man["versions"]["torch"] == torch.__version__
              and man["versions"]["cuda"] == torch.version.cuda,
              f"manifest versions {man['versions']} != torch's")

        out["auto"] = {}
        for backend in ("torch_sim", "cuda_fused"):
            win = json.loads((tmp / backend / f"TUNE_{backend}_n32_d2048_"
                              "p1_a2m.json").read_text())["winner"]
            _, text, _ = cli_capture(
                ["-m", "1", "-d", "2048", "--backend", backend, "--chained",
                 "--verify", "--auto", "--tune-root", str(tmp / backend),
                 "--results-csv", str(tmp / "auto.csv")])
            want = (f"auto: tuned -m {win['method']} -a {win['cb_nodes']} "
                    f"-c {win['comm_size']} -t {win['agg_type']} from ")
            check(want in text,
                  f"run --auto did not apply the {backend} winner")
            check(f"cb_nodes = {win['cb_nodes']}," in text
                  and f"comm_size = {win['comm_size']}," in text,
                  f"run --auto on {backend} ran other flags than the "
                  f"winner's")
            out["auto"][backend] = dict(win)

        (tmp / "prune").mkdir()
        with contextlib.chdir(repo):
            cli_capture(
                ["tune", "--backend", "torch_sim", "--model-prune", "-n",
                 "32", "-d", "2048", "--methods", "1,3", "--cb-nodes",
                 "14", "--comm-sizes", "3", "--max-batches", "1",
                 "--iters-big", "250", "--tune-root", str(tmp / "prune")])
        mp = json.loads(next((tmp / "prune").glob("TUNE_*.json"))
                        .read_text()).get("model_prune") or {}
        check(mp.get("platform") == "gpu"
              and mp.get("artifact") == PREDICT_GPU,
              f"tune --model-prune on the card read no gpu block: {mp}")
        print(f"# tune --model-prune (m=1, 3 at a=14 c=3): "
              f"{model_source(mp['artifact'])}; kept {mp['kept']}, pruned "
              f"{mp['pruned']}", flush=True)

        runs = 0
        for cfg in (README, dict(n=256, a=16, d=2048, c=16)):
            for backend in ("torch_sim", "cuda_fused", "local"):
                for m in (101, 102, 103):
                    argv = ["-n", str(cfg["n"]), "-m", str(m), "-a",
                            str(cfg["a"]), "-d", str(cfg["d"]), "-c",
                            str(cfg["c"]), "--backend", backend,
                            "--synth-root", str(synth_root), "--verify",
                            "--results-csv", str(tmp / "synth.csv")]
                    _, text, _ = cli_capture(argv)
                    check("| Synthesized " in text,
                          f"run -m {m} on {backend} printed no result")
                    runs += 1
        out["synth_runs"] = runs

        t0 = time.perf_counter()
        rc, text, err = cli_capture(
            ["synth", "--backend", "torch_sim", "-n", "32", "-a", "14",
             "-c", "3", "-d", "2048", "--init", "16", "--mutate-rounds",
             "1", "--top-k", "2", "--max-batches", "4", "--synth-root",
             str(synth_root), "--predict-root", str(repo)],
            expect=(0, 1))
        check("ranking finalists structurally" not in err,
              "synth on the card ranked structurally: no gpu block read")
        import re
        wall = re.search(r"search and race wall ([0-9.]+) s", text)
        rec = {"race_wall_s": float(wall.group(1)),
               "wall_s": time.perf_counter() - t0, "exit": rc}
        if rc == 0:
            path = Path(text.split("synth artifact written: ")[1].split()[0])
            blob = json.loads(path.read_text())
            check(validate_synth(blob) == [], f"{path.name} invalid")
            _, replay, _ = cli_capture(["synth", "--replay", str(path)])
            check("-> REPRODUCED" in replay, f"{path.name} did not replay")
            sr, win = blob["search"], blob["winner"]
            check(blob["inputs"]["params_source"]
                  == model_source(PREDICT_GPU),
                  f"synth priced with {blob['inputs']['params_source']}")
            rec["params_source"] = blob["inputs"]["params_source"]
            rec.update(evaluated=sr["evaluated"], space=sr["space_size"],
                       checker_refutations=sr["pruned"]["check"],
                       pruned=sr["pruned"], finalists=len(sr["finalists"]),
                       winner=win["cid"],
                       winner_us_per_rep=win["median_s"] * 1e6,
                       verdict=f"synthesized winner, {path.name} "
                               f"REPRODUCED")
        else:
            check("won the race — no synthesized schedule beat the field"
                  in err, "synth exited 1 without the reference-win line")
            # a reference win writes no artifact: its output is the record
            searched = re.search(r"searched (\d+)/(\d+) compositions "
                                 r"\(pruned: (\{[^}]*\})\), (\d+) finalist",
                                 text)
            pruned = json.loads(searched.group(3).replace("'", '"'))
            winner = re.search(r"winner: (\S+) \(median ([0-9.]+) us/rep\)",
                               text)
            # no artifact records the source: the search was priced (no
            # structural-ranking note above), by the gpu block
            rec["params_source"] = model_source(PREDICT_GPU)
            rec.update(evaluated=int(searched.group(1)),
                       space=int(searched.group(2)),
                       checker_refutations=pruned["check"], pruned=pruned,
                       finalists=int(searched.group(4)),
                       winner=winner.group(1),
                       winner_us_per_rep=float(winner.group(2)),
                       verdict="a reference method won; no artifact")
        print(f"# synth {json.dumps(rec)}", flush=True)
        out["synth"] = rec
    for mid in set(METHODS) - ids:
        del METHODS[mid]
    out["counts"] = {"fused_rep": fused_rep.launches}
    print(f"# tune_synth launches: {json.dumps(out['counts'])}", flush=True)
    check(fused_rep.launches > 0, "K2 was not launched by tune_synth")
    return out


def scrape(url: str) -> tuple:
    """One GET of a ``/metrics`` endpoint: (text, wall seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as resp:
        check(resp.headers["Content-Type"].startswith(
            "application/openmetrics-text"), f"{url}: not OpenMetrics")
        text = resp.read().decode()
    return text, time.perf_counter() - t0


def metrics_line(label: str, text: str, wall: float) -> dict:
    """Validate one scrape and print its ``# metrics`` line; returns
    ``{(name, labels): value}`` of its samples under ``"values"``."""
    from tpu_aggcomm_torch.obs.regress import (parse_openmetrics,
                                               validate_openmetrics)

    errors = validate_openmetrics(text)
    check(errors == [], f"{label} /metrics invalid: {errors[:3]}")
    parsed = parse_openmetrics(text)
    rec = dict(label=label, scrape_s=wall, samples=len(parsed["samples"]),
               families=len(parsed["families"]), valid=True)
    print(f"# metrics {json.dumps(rec)}", flush=True)
    rec["values"] = {(s["name"], tuple(sorted(s["labels"].items()))):
                     s["value"] for s in parsed["samples"]}
    return rec


@contextlib.contextmanager
def recorded_campaigns():
    """Each campaign the pilot runs while the block runs, with its host
    wall (search, registration and race)."""
    from tpu_aggcomm_torch.pilot import artifact

    walls = []
    real = artifact.run_campaign

    def run(target, sampler, **kw):
        t0 = time.perf_counter()
        row = real(target, sampler, **kw)
        walls.append(time.perf_counter() - t0)
        return row

    artifact.run_campaign = run
    try:
        yield walls
    finally:
        artifact.run_campaign = real


def pilot_pass(label: str, journal, port: int, root, out_name: str) -> dict:
    """One measured ``cli pilot`` pass against the in-process server, on
    the card; the artifact validated and replayed REPRODUCED. Returns
    the artifact and the pass's numbers (its ``# pilot`` line)."""
    import statistics

    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.obs.regress import validate_pilot

    out = root / out_name
    k2 = fused_rep.launches
    t0 = time.perf_counter()
    with recorded_campaigns() as walls:
        _, text, err = cli_capture(
            ["pilot", str(journal), "--serve-port", str(port), "--device",
             "cuda", "--max-batches", "4", "--synth-root", str(root),
             "--predict-root", str(Path(__file__).resolve().parent),
             "--out", str(out)])
    wall = time.perf_counter() - t0
    blob = json.loads(out.read_text())
    check(blob["inputs"]["params_source"] == model_source(PREDICT_GPU)
          and "ranking finalists structurally" not in err,
          f"pilot {label} read no gpu block: {blob['inputs']}")
    check(validate_pilot(blob, out.name) == [], f"{out.name} invalid")
    _, replay, _ = cli_capture(["pilot", "--replay", str(out)])
    check("-> REPRODUCED" in replay, f"{out.name} did not replay")
    verify_walls = {r["key"]["request"]: r.get("latency_s")
                    for r in map(json.loads, Path(journal).read_text()
                                 .splitlines())
                    if isinstance(r.get("key"), dict)
                    and "request" in r["key"] and r.get("status") == "done"}
    campaigns = []
    for c, w in zip(blob["campaigns"], walls):
        race = c["race"]
        inc = [x for b in race["samples"].get(c["incumbent_cid"]) or []
               for x in b]
        campaigns.append(dict(
            incumbent=c["incumbent_cid"], candidates=len(race["order"]),
            searched=(c["search"] or {}).get("evaluated"),
            registered=sorted(int(m) for m in c["registration"] or {}),
            batches=race["batches_run"],
            eliminations=len(race["eliminations"]),
            winner=c["winner"]["cid"],
            winner_us_per_rep=c["winner"]["median_s"] * 1e6,
            incumbent_us_per_rep=statistics.median(inc) * 1e6
            if inc else None,
            win_ci_pct=c["win_ci_pct"], improved=c["improved"],
            wall_s=w))
    decisions = [dict(
        incumbent=d["incumbent_cid"], winner=d["winner_cid"],
        action=d["action"],
        verify_rid=(d["swap"] or {}).get("verify_rid"),
        verify_wall_s=verify_walls.get((d["swap"] or {}).get("verify_rid")),
        error=(d["swap"] or {}).get("error")) for d in blob["decisions"]]
    rec = dict(
        label=label, mode=blob["mode"],
        requests=blob["requests"]["admitted"],
        targets=[dict(kind=t["kind"], backend=t["backend"],
                      incumbent=t["incumbent_cid"], skipped=t["skipped"])
                 for t in blob["targets"]],
        campaigns=campaigns, decisions=decisions,
        demotions=[dict(seq=r["seq"], action=r["action"],
                        n_walls=r["n_walls"],
                        outcome=(r["outcome"] or {}).get("ok"))
                   for r in blob["demotions"]],
        promotions=len(blob["promotions"]),
        params_source=blob["inputs"]["params_source"],
        k2_launches=fused_rep.launches - k2, wall_s=wall)
    print(f"# pilot {json.dumps(rec)}", flush=True)
    return {"blob": blob, "line": rec}


def sweep_endpoint(tmp) -> dict:
    """``cli sweep ... --metrics-port 0`` on a thread of this process,
    its endpoint scraped from the main thread while the sweep runs: the
    first scrape right after the endpoint is announced, then until a
    cell has completed. Returns the scrapes' lines and the sweep's exit."""
    import threading

    from tpu_aggcomm_torch import cli
    from tpu_aggcomm_torch.obs.regress import parse_openmetrics

    argv = ["sweep", "-m", "1", "-n", str(README["n"]), "-a",
            str(README["a"]), "-d", str(README["d"]), "--comm-sizes",
            "1,2,4,8", "--backend", "torch_sim", "--chained", "--verify",
            "--metrics-port", "0", "--results-csv", str(tmp / "sweep.csv")]
    print(f"$ python -m tpu_aggcomm_torch.cli {' '.join(argv)}", flush=True)
    out, err, result = io.StringIO(), io.StringIO(), {}

    def run():
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                result["rc"] = cli.main(argv)
        except BaseException as e:  # lint: broad-ok (re-raised on the main thread)
            result["error"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=run)
    th.start()
    url, scrapes, done = None, [], 0.0
    while th.is_alive() and done < 1:
        if url is None:
            for ln in err.getvalue().splitlines():
                if ln.startswith("# metrics endpoint: "):
                    url = ln.split(": ", 1)[1].strip()
        if url is not None:
            try:
                text, wall = scrape(url)
            except OSError:
                if th.is_alive():
                    raise
                break                   # the sweep ended and closed it
            if th.is_alive():
                scrapes.append((text, wall, time.perf_counter() - t0))
                done = next((s["value"] for s in parse_openmetrics(text)[
                    "samples"] if s["name"] == "tpu_aggcomm_sweep_cells_total"
                    and s["labels"].get("status") == "done"), 0.0)
        time.sleep(0.05)
    th.join()
    print(out.getvalue(), end="")
    print("".join(f"# stderr: {ln}\n" for ln in err.getvalue().splitlines()),
          end="")
    if "error" in result:
        raise result["error"]
    check(result.get("rc") == 0, f"sweep --metrics-port exited {result}")
    check(url is not None and url.startswith("http://127.0.0.1:"),
          "sweep never announced its loopback endpoint")
    check(scrapes, "the sweep endpoint was never scraped mid-run")
    lines = []
    for i, (text, wall, at) in enumerate(scrapes[:1] + scrapes[-1:]):
        rec = metrics_line(f"sweep mid-run {'first' if i == 0 else 'last'}"
                           f" (at {at:.2f} s)", text, wall)
        check(any(k[0] == "tpu_aggcomm_sweep_cells_total"
                  for k in rec["values"]),
              "the sweep's /metrics names no tpu_aggcomm_sweep_cells_total")
        lines.append({k: v for k, v in rec.items() if k != "values"})
    return {"scrapes": len(scrapes), "lines": lines,
            "wall_s": time.perf_counter() - t0}


def phase_pilot_obs(dev) -> dict:
    """Slice 10's path, in a temporary directory, K2's launch count zeroed
    first: an in-process ``ScheduleServer(device="cuda",
    metrics_port=0)`` (default backend torch_sim, journalled) serves a
    tight skewed burst at the README cell, every request verified: 10x
    m=1 and 2x m=3 on torch_sim, 6x m=1 on cuda_fused (a K2 launch
    each); its /metrics scraped and held to ``stats()``; then a measured
    ``cli pilot`` pass (in this process, against the server's port, on
    the card: campaigns on fresh torch_sim samples, promotions through
    the server's swap op) whose artifact replays; every promoted shape's
    next request served by the new method, verified; 6 more hot
    requests and a second pass (promoted targets skipped, a demotion
    row); a lookalike record refused and the same record demoting, the
    old method served again, verified; then ``sweep --metrics-port 0``
    scraped mid-run."""
    import shutil
    import tempfile

    from tpu_aggcomm_torch.core.methods import METHODS
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.serve import ScheduleServer, ServeClient

    repo = Path(__file__).resolve().parent
    ids = set(METHODS)
    readme = dict(method=1, nprocs=README["n"], cb_nodes=README["a"],
                  comm_size=README["c"], data_size=README["d"])
    out = {}
    fused_rep.launches = 0
    with tempfile.TemporaryDirectory(prefix="pilot_obs_") as tmp:
        tmp = Path(tmp)
        shutil.copy(repo / "SYNTH_r01.json", tmp)
        journal = tmp / "serve_pilot.journal.jsonl"
        srv = ScheduleServer(device="cuda", journal_path=str(journal),
                             metrics_port=0)
        srv.start()
        try:
            url = srv.ready_info()["metrics_url"]
            check(url.startswith("http://127.0.0.1:"),
                  f"the server's endpoint is not loopback: {url}")
            t0 = time.perf_counter()
            hot, _ = serve_burst(srv.port, [dict(readme, iter=i,
                                                 verify=True)
                                            for i in range(10)])
            minority, _ = serve_burst(srv.port, [dict(readme, method=3,
                                                      iter=i, verify=True)
                                                 for i in range(2)])
            k2 = fused_rep.launches
            fused, _ = serve_burst(srv.port, [dict(
                readme, backend="cuda_fused", iter=i, verify=True)
                for i in range(6)])
            out["k2_traffic"] = fused_rep.launches - k2
            out["traffic_s"] = time.perf_counter() - t0
            check(all(r["verified"] is True and r["served_method"]
                      == r_method
                      for rs, r_method in ((hot, 1), (minority, 3),
                                           (fused, 1)) for r in rs),
                  "the skewed burst was not served verified as asked")
            check(out["k2_traffic"] == 6 + 1,
                  f"K2 launches {out['k2_traffic']} for 6 cuda_fused "
                  f"requests + 1 warm-up")
            stats = srv.stats()
            text, wall = scrape(url)
            rec = metrics_line("serve after the burst", text, wall)
            v = rec.pop("values")
            served = sum(val for (name, labels), val in v.items()
                         if name == "tpu_aggcomm_serve_requests_total"
                         and ("outcome", "ok") in labels)
            fill = v.get(("tpu_aggcomm_serve_batch_fill_ratio", ()))
            check(served == stats["completed"] == 18,
                  f"/metrics counts {served} requests, stats() "
                  f"{stats['completed']}")
            check(fill == stats["batch"]["fill_ratio"],
                  f"/metrics batch fill {fill} != stats() "
                  f"{stats['batch']['fill_ratio']}")
            out["serve_metrics"] = rec

            first = pilot_pass("first pass", journal, srv.port, tmp,
                               "PILOT_r01.json")
            out["first"] = first["line"]
            promoted = []
            for d in first["blob"]["decisions"]:
                if d["action"] != "promote":
                    continue
                rec_ = d["record"]
                req = {k: v for k, v in rec_["shape"].items()
                       if v is not None}
                with ServeClient(srv.port, timeout=600.0) as c:
                    r = c.run(**dict(req, backend=rec_["backend"],
                                     verify=True, iter=50))
                check(r["verified"] is True
                      and r["served_method"] == rec_["new_method"],
                      f"promoted {rec_['old_cid']} -> {rec_['new_cid']} "
                      f"but the next request was served by "
                      f"m{r['served_method']}")
                promoted.append(rec_)
            out["promoted"] = [(p["old_cid"], p["new_cid"], p["backend"])
                               for p in promoted]
            print(f"# pilot promoted and served: {out['promoted']}",
                  flush=True)

            serve_burst(srv.port, [dict(readme, iter=60 + i, verify=True)
                                   for i in range(6)])
            second = pilot_pass("second pass", journal, srv.port, tmp,
                                "PILOT_r02.json")
            out["second"] = second["line"]
            blob2 = second["blob"]
            shapes = {json.dumps(p["shape"], sort_keys=True)
                      for p in promoted}
            for t in blob2["targets"]:
                if json.dumps(t["shape"], sort_keys=True) in shapes:
                    check(t["skipped"] == "already-promoted",
                          f"second pass raced a promoted target: {t}")
            check(len(blob2["demotions"]) == len(promoted),
                  "the second pass has no demotion row per promotion")
            demoted = []
            for row in blob2["demotions"]:
                rec_ = row["record"]
                if row["action"] != "demote":
                    with ServeClient(srv.port, timeout=120.0) as c:
                        look = c.demote(dict(rec_, win_ci_pct=[
                            rec_["win_ci_pct"][0] + 1.0,
                            rec_["win_ci_pct"][1]]), "chip_smoke: lookalike")
                        check(not look["ok"]
                              and "never a lookalike" in look["error"],
                              f"a lookalike demotion was not refused: "
                              f"{look}")
                        down = c.demote(rec_, "chip_smoke: the second "
                                        "pass held; demoted to show the "
                                        "old method serves again")
                    check(down["ok"] and down["restored_method"]
                          == rec_["old_method"], f"demote failed: {down}")
                else:
                    check(row["outcome"]["ok"] is True,
                          f"the pilot's live demotion failed: {row}")
                req = {k: v for k, v in rec_["shape"].items()
                       if v is not None}
                with ServeClient(srv.port, timeout=600.0) as c:
                    r = c.run(**dict(req, backend=rec_["backend"],
                                     verify=True, iter=70))
                check(r["verified"] is True
                      and r["served_method"] == rec_["old_method"],
                      f"after the demotion m{r['served_method']} served "
                      f"{rec_['old_cid']}")
                demoted.append((rec_["new_cid"], rec_["old_cid"],
                                row["action"]))
            check(srv.stats()["promotions"] == [],
                  "a promotion is still installed after the demotions")
            out["demoted"] = demoted
            print(f"# pilot demoted and served: {demoted}", flush=True)
            text, wall = scrape(url)
            rec = metrics_line("serve at the end", text, wall)
            rec.pop("values")
            out["serve_metrics_end"] = rec
        finally:
            srv.stop()
            srv.close()
        out["sweep"] = sweep_endpoint(tmp)
    for mid in set(METHODS) - ids:
        del METHODS[mid]
    out["counts"] = {"fused_rep": fused_rep.launches}
    print(f"# pilot_obs launches: {json.dumps(out['counts'])}", flush=True)
    check(fused_rep.launches > 0, "K2 was not launched by pilot_obs")
    return out

@contextlib.contextmanager
def recorded_deadlines():
    """The soft deadline of every dispatch the runner makes while the
    block runs: ``derive_deadline``'s inputs (the roofline floor) and
    ``soft_deadline_check``'s site, wall and deadline, in order."""
    from tpu_aggcomm_torch.harness import runner

    derive, check_fn = runner.derive_deadline, runner.soft_deadline_check
    rows = []

    def derive_rec(**kw):
        rows.append({"floor_s": kw.get("floor_s"), "ntimes": kw.get("ntimes")})
        return derive(**kw)

    def check_rec(site, *, wall_s, deadline_s, out=None):
        rows[-1].update(site=site, wall_s=wall_s, deadline_s=deadline_s)
        return check_fn(site, wall_s=wall_s, deadline_s=deadline_s, out=out)

    runner.derive_deadline, runner.soft_deadline_check = derive_rec, check_rec
    try:
        yield rows
    finally:
        runner.derive_deadline, runner.soft_deadline_check = derive, check_fn


def chained_floor_us(cell: dict) -> tuple:
    """``(chained floor, rep floor)`` in microseconds a rep of ``cell``
    (``dict(n, m, a, d, c, p)``) on torch_sim, from the port's roofline:
    the rep's bytes (TAM's three hops for m=15/16), plus the chain's token
    and XOR, at the H100's HBM rate."""
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.harness import roofline

    s = compile_method(cell["m"], AggregatorPattern(
        cell["n"], cell["a"], data_size=cell["d"], comm_size=cell["c"],
        proc_node=cell.get("p", 1)))
    rb = (roofline.tam_rep_bytes(s) if cell["m"] in (15, 16)
          else roofline.rep_bytes(s))
    chained = rb.total(fenced=True) + roofline.chain_overhead_bytes(s)
    return (roofline.floor_seconds(chained) * 1e6,
            rb.floor_seconds(fenced=True) * 1e6)


def phase_inspect_roofline(dev, measured: dict | None = None,
                           faults: dict | None = None) -> dict:
    """Slice 11's path, in a temporary directory, K2's launch count zeroed
    first: ``run --chained --verify --trace`` at the README cell on
    torch_sim and on cuda_fused (K2), each dispatch's soft deadline
    printed; over the traces and the CSV ``inspect trace``, ``inspect
    ledger``, ``inspect traffic --trace --json --fused-export`` (the
    measured overlay: every round's H100 HBM floor below its wall),
    ``inspect check -m 0`` and ``analyze``; ``inspect -m 1 --roofline
    --waves`` at the README, n=256 a=16 c=16 and n=1024 a=64 c=16 shapes.
    Then every torch_sim floor the roofline gives is held below the
    chained torch_sim time measured at the same shape: this phase's
    README run, and the earlier phases' measured-phase totals (m=1, m=2
    and TAM m=15/16) and sweep cells (``measured``, ``faults``); a shape
    with no earlier time gets one short ``--chained`` run here."""
    import tempfile

    import torch

    from tpu_aggcomm_torch.harness.roofline import L2_COPY_H100_GBPS
    from tpu_aggcomm_torch.native.fuse import fused_rep

    measured = measured or {}
    faults = faults or {}
    readme = ["-n", "32", "-m", "1", "-a", "14", "-d", "2048", "-c", "3"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        fused_rep.launches = 0
        times = {}
        with recorded_backends() as made, recorded_deadlines() as dl:
            for backend in ("torch_sim", "cuda_fused"):
                run_cli([[*readme, "--backend", backend, "--chained",
                          "--verify", "--trace", backend, "--results-csv",
                          "results.csv"]])
                times[backend] = per_rep_us(made[-1])
        check(len(dl) == 2 and all("deadline_s" in r for r in dl),
              f"the runner derived no soft deadline a dispatch: {dl}")
        for backend, row in zip(("torch_sim", "cuda_fused"), dl):
            floor = row["floor_s"]
            check((floor is not None) == (backend == "torch_sim"),
                  f"{backend}: schedule_floor_s gave {floor}")
            print(f"# deadline {row['site']} {backend}: floor "
                  + ("none (no model for this backend)" if floor is None
                     else f"{floor * 1e6:.3f} us/rep")
                  + f" x {row['ntimes']} rep(s) -> soft deadline "
                  f"{row['deadline_s']:.3f} s; dispatch wall "
                  f"{row['wall_s']:.3f} s", flush=True)
        out["deadlines"] = dl
        traces = [f"{b}.trace.jsonl" for b in ("torch_sim", "cuda_fused")]
        _, text, _ = cli_capture(["inspect", "trace", *traces])
        check(all(f"== {t} ==" in text for t in traces)
              and text.count("critical path") >= 2,
              "inspect trace did not summarize both traces")
        _, text, _ = cli_capture(["inspect", "ledger", *traces])
        check(torch.cuda.get_device_name(0) in text,
              "inspect ledger does not name the card")
        overlays = {}
        for backend, trace_file in zip(("torch_sim", "cuda_fused"), traces):
            _, text, _ = cli_capture(
                ["inspect", "traffic", *readme, "--trace", trace_file,
                 "--json", f"traffic_{backend}.json", "--fused-export"])
            check("fused export: MATCH (11 rounds, 448 edges" in text,
                  f"inspect traffic --fused-export ({backend}): no MATCH")
            with open(f"traffic_{backend}.json") as fh:
                ov = json.load(fh)["overlay"]
            fracs = [r["frac_roofline"] for r in ov["rounds"]]
            check(len(fracs) == 11 and all(0 < f < 1 for f in fracs),
                  f"{backend} overlay: a round's H100 HBM floor is not "
                  f"below its wall: {fracs}")
            overlays[backend] = {"backend": ov["backend"],
                                 "frac_roofline": fracs}
            print(f"# overlay {backend}: 11 rounds, floor/wall "
                  f"{min(fracs):.6f}-{max(fracs):.6f}", flush=True)
        out["overlays"] = overlays
        _, text, _ = cli_capture(["inspect", "check", "-m", "0",
                                  *readme[:2], *readme[4:]])
        check("REFUTED: 0 of " in text, "inspect check -m 0 refuted one")
        _, text, _ = cli_capture(["analyze", "--results-csv",
                                  "results.csv"])
        faster = min(times, key=times.get)
        check("winner: All to many" in text and f"[{faster}, " in text,
              f"analyze did not pick the faster README row ({faster})")
        for n, a, c in ((32, 14, 3), (256, 16, 16), (1024, 64, 16)):
            _, text, _ = cli_capture(
                ["inspect", "-n", str(n), "-m", "1", "-a", str(a), "-d",
                 "2048", "-c", str(c), "--roofline", "--waves"])
            check("roofline (floors at 3350 GB/s H100 HBM" in text
                  and "cuda_dma concurrent:" in text,
                  f"inspect --roofline --waves at n={n}: rows missing")
        out["counts"] = {"fused_rep": fused_rep.launches}
        print(f"# inspect_roofline launches: {json.dumps(out['counts'])}",
              flush=True)
        check(fused_rep.launches > 0,
              "K2 was not launched on the inspect_roofline path")

        # every floor below the chained time measured at its shape
        from tpu_aggcomm_torch.cli import THETA_COMM_SIZES
        pairs = [(dict(README, m=1, p=1), times["torch_sim"],
                  "this phase's run --chained")]
        if "delay_chained_us" in faults:
            pairs.append((dict(README, m=1, p=1),
                          faults["delay_chained_us"][1],
                          "faults_sweep healthy --chained"))
        sweeps = faults.get("sweeps_us", {})
        for m in (1, 2):
            for c, us in zip(THETA_COMM_SIZES,
                             sweeps.get(f"m={m} torch_sim", [])):
                pairs.append((dict(n=32, a=14, d=2048, c=c, m=m, p=1), us,
                              "faults_sweep sweep cell"))
        wide = sweeps.get("m=1 torch_sim n=1024", [])
        shapes = [(dict(README, m=2, p=1), "measured phases"),
                  (dict(n=256, a=16, d=2048, c=16, m=1, p=1),
                   "measured phases")] + [
            (dict(README, m=m, p=p), "measured phases")
            for p in (1, 4) for m in (15, 16)] + [
            (dict(n=1024, a=64, d=2048, c=16, m=m, p=64), "measured phases")
            for m in (15, 16)]
        for cell, source in shapes:
            label = " ".join(f"{k}={cell[k]}" for k in
                             ("m", "n", "a", "c", "p"))
            if label in measured:
                pairs.append((cell, measured[label]["total_us"], source))
                continue
            with recorded_backends() as made:
                run_cli([[*argv_of(cell), "--chained", "--verify",
                          "--results-csv", "results.csv"]])
            pairs.append((cell, per_rep_us(made[-1]),
                          "run --chained in this phase"))
        n1024 = dict(n=1024, a=64, d=2048, c=16, m=1, p=1)
        if wide:
            pairs.append((n1024, wide[0], "faults_sweep sweep cell"))
        else:
            with recorded_backends() as made:
                run_cli([[*argv_of(n1024), "--chained", "--verify",
                          "--results-csv", "results.csv"]])
            pairs.append((n1024, per_rep_us(made[-1]),
                          "run --chained in this phase"))
    rows = []
    for cell, us, source in pairs:
        floor, rep_floor = chained_floor_us(cell)
        label = " ".join(f"{k}={cell[k]}" for k in ("m", "n", "a", "c", "p"))
        print(f"# floor {label} torch_sim --chained: floor {floor:.3f} "
              f"us/rep (rep alone {rep_floor:.3f}) vs measured {us:.3f} "
              f"us/rep ({source})", flush=True)
        print(f"# ratio {label}: floor/measured {floor / us:.4f}",
              flush=True)
        check(floor < us, f"{label}: the roofline floor {floor:.3f} us/rep "
              f"is above the measured {us:.3f} us/rep ({source})")
        rows.append({"cell": label, "floor_us": floor,
                     "rep_floor_us": rep_floor, "measured_us": us,
                     "ratio": floor / us, "source": source})
    out["floors"] = rows
    out["readme_us"] = times
    l2 = l2_copy_rate()
    print(f"# L2 copy rate this run {l2 / 1e12:.3f} TB/s; the roofline's "
          f"L2 figure {L2_COPY_H100_GBPS / 1e3:.3f} TB/s", flush=True)
    out["l2_tbps"] = l2 / 1e12
    return out


def model_source(blob_or_path, platform: str = "gpu") -> str:
    return f"{Path(str(blob_or_path)).name} [{platform}]"


def phase_model_gpu(dev, faults: dict, tune_synth: dict) -> dict:
    """Slice 12's path, in a temporary directory, K2's launch count zeroed
    first: the cost model's ``gpu`` block (``H100_PREDICT_r01.json``,
    fitted on ``RESULTS_H100.md``'s grids) replayed REPRODUCED, held
    against this run's n=32 cells (``faults_sweep``'s m=1 and m=2 on
    torch_sim and m=1 on cuda_fused, plus m=2 on cuda_fused here), and
    read by every consumer once: ``inspect explain`` on README traces of
    torch_sim and cuda_fused, ``tune --model-prune``, ``run --auto
    --fault`` on a cache miss, the serve ``deadline_floor`` pre-shed and
    ``inspect watch --predict``. Every ``--predict-root`` points at the
    repository; a consumer that reads no gpu block fails the phase."""
    import shutil
    import tempfile

    from tpu_aggcomm_torch.cli import THETA_COMM_SIZES
    from tpu_aggcomm_torch.model import (explain_trace, load_artifact,
                                         parse_results_grids)
    from tpu_aggcomm_torch.model.fit import kendall_tau_b
    from tpu_aggcomm_torch.model.predict import trace_platform
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.obs.trace import load_events
    from tpu_aggcomm_torch.serve import ScheduleServer, ServeClient

    repo = Path(__file__).resolve().parent
    art_path = repo / PREDICT_GPU
    art = load_artifact(str(art_path))
    params = art["platforms"]["gpu"]["params"]
    source = model_source(art_path)
    print("# model gpu params (us): " + json.dumps(
        {k: v * 1e6 for k, v in params.items()}), flush=True)
    out = {"params": params}
    readme = ["-n", "32", "-m", "1", "-a", "14", "-d", "2048", "-c", "3"]
    with tempfile.TemporaryDirectory(prefix="model_gpu_") as tmp, \
            contextlib.chdir(tmp):
        tmp = Path(tmp)
        fused_rep.launches = 0
        _, text, _ = cli_capture(["inspect", "explain", "--replay",
                                  str(art_path)])
        check(f"explain replay: REPRODUCED ({art_path})" in text,
              f"{PREDICT_GPU} did not replay REPRODUCED")

        # the held-out n=32 grid and the crossover, against this run
        committed = parse_results_grids(str(repo / "RESULTS_H100.md"))
        grid = committed["n32"]
        sweeps = faults["sweeps_us"]
        comms = [c["comm"] for c in grid["cells"] if c["method"] == 1]
        pick = [THETA_COMM_SIZES.index(c) for c in comms]
        measured = {("torch_sim", m): [sweeps[f"m={m} torch_sim"][i]
                                       for i in pick] for m in (1, 2)}
        measured[("cuda_fused", 1)] = [sweeps["m=1 cuda_fused"][i]
                                       for i in pick]
        before = fused_rep.launches
        with recorded_backends() as made:
            run_cli([["sweep", "-n", "32", "-a", "14", "-d", "2048", "-m",
                      "2", "-i", "1", "--backend", "cuda_fused",
                      "--comm-sizes", ",".join(map(str, comms)),
                      "--chained", "--verify", "--results-csv",
                      "fused.csv"]])
        check(fused_rep.launches > before, "K2 did not run the m=2 cells")
        measured[("cuda_fused", 2)] = [per_rep_us(b) for b in made]
        xo = {(c["method"], c["comm"]): c
              for c in art["crossover"]["cells"]}
        pairs, rows = [], []
        for cell in grid["cells"]:
            m, c = cell["method"], cell["comm"]
            i = comms.index(c)
            pred = xo[(m, c)]["predicted_fenced_s"] * 1e6
            sim = measured[("torch_sim", m)][i]
            fused = measured[("cuda_fused", m)][i]
            got = (sim - fused) / sim
            want = xo[(m, c)]["predicted_speedup_rel"]
            pairs.append((pred, sim))
            c_txt = "inf" if c == 999_999_999 else str(c)
            print(f"# held-out n=32 m={m} c={c_txt}: this run "
                  f"{sim:.3f} us/rep, committed {cell['us']:.2f}, "
                  f"predicted {pred:.3f} ({source})", flush=True)
            print(f"# crossover n=32 m={m} c={c_txt}: predicted fused "
                  f"speedup {want:+.4f}, measured (torch_sim - cuda_fused)"
                  f" / torch_sim {got:+.4f} ({sim:.3f} vs {fused:.3f} "
                  f"us/rep; {source})", flush=True)
            rows.append(dict(method=m, comm=c, measured_us=sim,
                             committed_us=cell["us"], predicted_us=pred,
                             fused_us=fused, predicted_speedup=want,
                             measured_speedup=got))
        tau = kendall_tau_b(pairs)
        print(f"# model n=32 tau-b of the gpu predictions against this "
              f"run's 14 cells: {tau:.4f} (committed validation "
              f"{art['validation']['n32']['tau_b']:.4f}; {source})",
              flush=True)
        out.update(n32=rows, tau_b_this_run=tau)

        # every consumer once, each reading the gpu block
        consumers = {}
        traces = {}
        for backend in ("torch_sim", "cuda_fused"):
            run_cli([[*readme, "--backend", backend, "--chained",
                      "--verify", "--trace", backend, "--results-csv",
                      "results.csv"]])
            trace_file = f"{backend}.trace.jsonl"
            man = next(e["manifest"] for e in load_events(trace_file)
                       if e.get("ev") == "ledger")
            check(trace_platform(man) == "gpu",
                  f"the {backend} trace's manifest does not name the card")
            _, text, _ = cli_capture(["inspect", "explain", trace_file,
                                      "--predict-root", str(repo)])
            check("[platform=gpu]" in text
                  and f"[calibration: {art_path}]" in text,
                  f"inspect explain did not price {trace_file} with the "
                  f"gpu block")
            exp = explain_trace(trace_file, art["platforms"])
            run = exp["runs"][-1]
            verdicts = sorted({r["verdict"] for r in run["rounds"]})
            tot = run["total"]
            print(f"# consumer inspect explain ({backend} README trace): "
                  f"{source}; total predicted "
                  f"{tot['predicted_s'] * 1e6:.3f} us, measured "
                  + ("-" if tot["measured_s"] is None else
                     f"{tot['measured_s'] * 1e6:.3f} us")
                  + f", {tot['verdict']}; round verdicts {verdicts}",
                  flush=True)
            consumers[f"explain {backend}"] = dict(
                source=source, total=tot, round_verdicts=verdicts)
            traces[backend] = trace_file
        check(fused_rep.launches > 0, "K2 was not launched by the "
              "cuda_fused trace run")

        # tune --model-prune at the README shape: the tune_synth grid
        g = TUNE_GRID
        (tmp / "prune").mkdir()
        with contextlib.chdir(repo):
            cli_capture(["tune", "--backend", "torch_sim",
                         "--model-prune", "-n", str(g["nprocs"]), "-d",
                         str(g["data_size"]), "--methods",
                         ",".join(map(str, g["methods"])), "--cb-nodes",
                         ",".join(map(str, g["cb_nodes"])),
                         "--comm-sizes", ",".join(map(str,
                                                      g["comm_sizes"])),
                         "--tune-root", str(tmp / "prune")])
        blob = json.loads(next((tmp / "prune").glob("TUNE_*.json"))
                          .read_text())
        mp = blob.get("model_prune") or {}
        check(mp.get("platform") == "gpu"
              and mp.get("artifact") == PREDICT_GPU,
              f"tune --model-prune read no gpu block: {mp}")
        unpruned = tune_synth["tune"][0]["winner"]
        kept = unpruned in mp["kept"]
        print(f"# consumer tune --model-prune: {model_source(mp['artifact'])}"
              f"; kept {len(mp['kept'])} of 12 {mp['kept']}, pruned "
              f"{mp['pruned']}; the unpruned torch_sim race's winner "
              f"{unpruned} {'kept' if kept else 'PRUNED'}; winner now "
              f"{blob['race']['winner']}", flush=True)
        consumers["tune --model-prune"] = dict(
            source=model_source(mp["artifact"]), kept=mp["kept"],
            pruned=mp["pruned"], unpruned_winner=unpruned,
            unpruned_winner_kept=kept, winner=blob["race"]["winner"])

        # run --auto --fault on a tune-cache miss: the model's advisory
        (tmp / "empty").mkdir()
        with contextlib.chdir(repo):
            _, text, err = cli_capture(
                ["-n", "32", "-m", "1", "-a", "14", "-d", "2048", "-c",
                 "3", "--fault", "deadlink:5>3", "--auto", "--tune-root",
                 str(tmp / "empty"), "--verify", "--results-csv",
                 str(tmp / "auto.csv")])
        adv = [ln for ln in err.splitlines() if "ADVISORY pick" in ln]
        check(len(adv) == 1 and f"{PREDICT_GPU}, gpu)" in adv[0],
              "run --auto --fault printed no gpu advisory")
        print(f"# consumer run --auto --fault deadlink:5>3: {source}; "
              f"{adv[0]}", flush=True)
        consumers["auto fault advisory"] = dict(source=source,
                                                line=adv[0])

        # the serve deadline_floor pre-shed, then the same request served
        journal = tmp / "model.journal.jsonl"
        srv = ScheduleServer(device="cuda", predict_root=str(repo),
                             journal_path=str(journal))
        srv.start()
        try:
            check(srv.floor_source() == source,
                  f"the server's floor reads {srv.floor_source()}")
            req = dict(method=1, nprocs=32, cb_nodes=14, comm_size=3,
                       data_size=2048, verify=True)
            with ServeClient(srv.port, timeout=300.0) as c:
                shed = c.run(**dict(req, deadline_ms=0.001))
                served = c.run(**dict(req, iter=1, deadline_ms=1000.0))
        finally:
            srv.stop()
            srv.close()
        recs = [json.loads(ln) for ln in journal.read_text().splitlines()]
        floor = [r for r in recs if r.get("status") == "shed"
                 and r.get("reason") == "deadline_floor"]
        check(shed.get("shed") == "deadline_floor"
              and shed["error"].startswith("SHED[deadline_floor]")
              and len(floor) == 1 and floor[0].get("floor_s"),
              f"no deadline_floor shed: {shed}")
        check(served.get("ok") is True and served.get("verified") is True,
              f"the 1000 ms request was not served and verified: {served}")
        print(f"# consumer serve deadline_floor: {source}; deadline 0.001 "
              f"ms -> SHED[deadline_floor] floor_s "
              f"{floor[0]['floor_s'] * 1e6:.3f} us; deadline 1000 ms -> "
              f"served, verified, latency {served['latency_s']:.4f} s",
              flush=True)
        consumers["serve deadline_floor"] = dict(
            source=source, floor_s=floor[0]["floor_s"],
            served_latency_s=served["latency_s"])

        # inspect watch --predict over this phase's journal and trace
        _, text, _ = cli_capture(["inspect", "watch", str(journal),
                                  traces["torch_sim"], "--predict",
                                  str(art_path), "--json", "watch.json"])
        wblob = json.loads(Path("watch.json").read_text())
        joined = {k: v for k, v in wblob["evidence"]["explain"].items()
                  if v}
        check(wblob.get("predict") == PREDICT_GPU and joined,
              f"watch --predict joined no explain verdicts: "
              f"{wblob['evidence']['explain']}")
        shutil.copy(art_path, PREDICT_GPU)
        _, text, _ = cli_capture(["inspect", "watch", "--replay",
                                  "watch.json"])
        check("watch replay: REPRODUCED" in text,
              "the watch artifact recording the predict artifact did not "
              "replay")
        verdicts = sorted({r["verdict"] for rows_ in joined.values()
                           for r in rows_})
        print(f"# consumer inspect watch --predict: {source}; explain "
              f"joined for {sorted(joined)}, verdicts {verdicts}; the "
              f"watch artifact replays REPRODUCED", flush=True)
        consumers["watch --predict"] = dict(source=source,
                                            runs=sorted(joined))
    out["consumers"] = consumers
    out["counts"] = {"fused_rep": fused_rep.launches}
    print(f"# model_gpu launches: {json.dumps(out['counts'])}", flush=True)
    check(all(v["source"] == source for v in consumers.values()),
          f"a consumer read another block: {consumers}")
    return out


def flow_burst(port: int, payloads: list, journal: Path, i0: int) -> list:
    """Fire ``payloads`` as one burst of ServeClient threads (connected
    first, then released together), stamping the client's own journal in
    the line format of ``scripts/serve_loadgen.py --client-journal``: a
    ``send`` line before the round trip, a ``recv`` line after it, one
    lock, flushed a line. Request ``i`` is ``i0`` plus its index. Fails
    on any response that is not ok and verified."""
    import threading

    from tpu_aggcomm_torch.serve import ServeClient

    out = [None] * len(payloads)
    gate = threading.Barrier(len(payloads))
    lock = threading.Lock()
    p0 = payloads[0]
    shape_spec = (f"m{p0['method']} n{p0['nprocs']} a{p0['cb_nodes']} "
                  f"c{p0['comm_size']} d{p0['data_size']}")

    with open(journal, "a") as fh:
        def stamp(line: dict) -> None:
            with lock:
                fh.write(json.dumps(line) + "\n")
                fh.flush()

        def fire(k):
            i = i0 + k
            with ServeClient(port, timeout=900.0) as c:
                c._connect()
                gate.wait()
                t0 = time.monotonic()
                stamp({"ev": "send", "i": i, "t_send": t0,
                       "shape": shape_spec})
                resp = c.run(**payloads[k])
                t1 = time.monotonic()
            stamp({"ev": "recv", "i": i, "rid": resp.get("request_id"),
                   "t_send": t0, "t_recv": t1, "client_wall_s": t1 - t0,
                   "ok": bool(resp.get("ok")), "shed": resp.get("shed"),
                   "cache": resp.get("cache"), "error": resp.get("error")})
            out[k] = resp

        threads = [threading.Thread(target=fire, args=(k,))
                   for k in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for r in out:
        check(r is not None and r.get("ok") is True
              and r.get("verified") is True,
              f"flow request failed or unverified: {r}")
    return out


def phase_obs_views(dev, bench: dict, delay_rows: list) -> dict:
    """Slice 13's path (``obs_views``), in a temporary directory that is
    the history root, K2's and the delay's launch counts zeroed first and
    read at its end, at the README cell: ``inspect compare`` of a
    ``torch_sim`` and a ``cuda_fused`` (K2) ``--chained --verify --trace``
    trace ``--by round``, and of the healthy trace against a ``slow:r2*2``
    one (refused without ``--across-faults``; with it, the delay kernel's
    time at that spec must be most of the recovery delta); ``inspect
    flow`` over a served burst a leg on ``cuda_fused`` and ``torch_sim``
    (a cold request, then 8 warm), the client's journal stamped here,
    every request joined to a round stream, the artifact replayed and
    joined by ``inspect watch --flow``; ``inspect live`` attached once
    mid-run and once after the end of a ``cuda_fused`` sweep in a
    subprocess, its cost-model floor read from the gpu block; ``inspect
    history`` and ``inspect report`` over the root (this run's bench line
    as a ``BENCH_r01.json`` record, the traces, the artifacts, a copy of
    the predict artifact), every artifact validated; and the bench-history
    gate over the root and over the repository."""
    import os
    import shutil
    import tempfile
    from collections import Counter

    from tpu_aggcomm_torch.backends.slow_delay import slow_delay
    from tpu_aggcomm_torch.model.predict import (events_platform,
                                                 floor_from_trace_events,
                                                 newest_predict_path)
    from tpu_aggcomm_torch.native.fuse import fused_rep
    from tpu_aggcomm_torch.obs import live as obs_live
    from tpu_aggcomm_torch.obs import regress
    from tpu_aggcomm_torch.obs import trace as obs_trace
    from tpu_aggcomm_torch.obs.flow import warm_overhead_block
    from tpu_aggcomm_torch.obs.history import build_index
    from tpu_aggcomm_torch.obs.report_html import build_payload
    from tpu_aggcomm_torch.obs.trace import load_events
    from tpu_aggcomm_torch.serve import ScheduleServer

    repo = Path(__file__).resolve().parent
    on_card = dev.type == "cuda"
    platform = "gpu" if on_card else "cpu"
    dev_args = [] if on_card else ["--device", "cpu"]
    art_src = newest_predict_path(str(repo), platform)
    check(art_src is not None, f"no {platform} predict artifact in the "
          f"repository")
    art_name = Path(art_src).name
    source = model_source(art_name, platform)
    cell = ["-n", str(README["n"]), "-m", "1", "-a", str(README["a"]),
            "-d", str(README["d"]), "-c", str(README["c"])]
    comms = [1, 2, 4, 8]
    out = {}
    with tempfile.TemporaryDirectory(prefix="obs_views_") as tmp, \
            contextlib.chdir(tmp):
        tmp = Path(tmp)
        shutil.copy(art_src, art_name)
        fused_rep.launches = 0
        slow_delay.launches = 0

        # 1. compare: K2 against torch_sim, and a slow rank's recovery
        for label, extra in (("torch_sim", ["--backend", "torch_sim"]),
                             ("cuda_fused", ["--backend", "cuda_fused"]),
                             ("slow", ["--backend", "torch_sim", "--fault",
                                       "slow:r2*2"])):
            run_cli([[*cell, *extra, "--chained", "--verify", "--trace",
                      label, "--results-csv", "results.csv", *dev_args]])
        if on_card:
            check(fused_rep.launches > 0 and slow_delay.launches > 0,
                  "the compared traces did not run K2 and the delay kernel")
        cli_capture(["inspect", "compare", "torch_sim.trace.jsonl",
                     "cuda_fused.trace.jsonl", "--by", "round", "--json",
                     "COMPARE_r01.json"])
        rec = json.loads(Path("COMPARE_r01.json").read_text())[
            "result"]["runs"][0]
        dom = rec["dominant"]
        print(f"# compare torch_sim -> cuda_fused (README m=1, --by round):"
              f" max-over-ranks total {rec['total_a_s'] * 1e6:.3f} -> "
              f"{rec['total_b_s'] * 1e6:.3f} us/rep "
              f"({rec['total_delta_pct']:+.2f}%); dominant delta cell rank "
              f"{dom['rank']} round {dom['round']}: "
              f"{dom['delta_s'] * 1e6:+.3f} us ({dom['a_s'] * 1e6:.3f} -> "
              f"{dom['b_s'] * 1e6:.3f}), share of the total delta "
              f"{dom['share_of_total_delta']}", flush=True)
        refused(["inspect", "compare", "torch_sim.trace.jsonl",
                 "slow.trace.jsonl"], "fault specs differ")
        _, text, _ = cli_capture(["inspect", "compare",
                                  "torch_sim.trace.jsonl",
                                  "slow.trace.jsonl", "--across-faults",
                                  "--json", "COMPARE_r02.json"])
        frec = json.loads(Path("COMPARE_r02.json").read_text())[
            "result"]["runs"][0]
        delta_us = (frec["total_b_s"] - frec["total_a_s"]) * 1e6
        delay = next(r for r in delay_rows if r["batch"] == 1)
        delay_us = delay["ms"] * 1e3
        share = delay_us / delta_us if delta_us > 0 else None
        check("RECOVERY delta" in text and frec["fault_b"] == "slow:r2*2",
              "the faulted compare is not a named recovery delta")
        print(f"# compare healthy -> slow:r2*2 (--across-faults): "
              f"{frec['total_a_s'] * 1e6:.3f} -> "
              f"{frec['total_b_s'] * 1e6:.3f} us/rep, recovery delta "
              f"{delta_us:+.3f} us; the delay kernel at slow:r2*2 "
              f"{delay_us:.3f} us ({delay['iters']} iterations) = "
              f"{share} of it", flush=True)
        check(share is not None and share >= 0.5,
              f"the slow rank's delay ({delay_us:.3f} us) does not "
              f"dominate the recovery delta ({delta_us:.3f} us)")
        out["compare"] = dict(fused=dict(total_a_s=rec["total_a_s"],
                                         total_b_s=rec["total_b_s"],
                                         dominant=dom),
                              faulted=dict(total_a_s=frec["total_a_s"],
                                           total_b_s=frec["total_b_s"],
                                           delay_us=delay_us,
                                           delay_share=share))

        # 2. flow: a served burst a leg, the client's own stamp journal
        client = tmp / "client.journal.jsonl"
        shape = dict(method=1, nprocs=README["n"], cb_nodes=README["a"],
                     comm_size=README["c"], data_size=README["d"])
        srv = ScheduleServer(device=dev.type, predict_root=str(tmp),
                             journal_path="serve.journal.jsonl",
                             batch_window_s=0.05)
        legs, i = {}, 0
        obs_trace.enable()
        try:
            srv.start()
            try:
                for backend in ("cuda_fused", "torch_sim"):
                    leg = dict(shape, backend=backend, verify=True)
                    flow_burst(srv.port, [dict(leg, iter=i)], client, i)
                    warm = flow_burst(srv.port, [dict(leg, iter=i + 1 + k)
                                                 for k in range(8)],
                                      client, i + 1)
                    check(all(r["cache"] == "hit" for r in warm),
                          f"flow {backend}: the burst was not warm")
                    legs[backend] = [r["request_id"] for r in warm]
                    i += 9
            finally:
                srv.stop()
                srv.close()
        finally:
            obs_trace.flush("serve")
            obs_trace.disable()
        cli_capture(["inspect", "flow", "client.journal.jsonl",
                     "serve.journal.jsonl", "serve.trace.jsonl", "--json",
                     "FLOW_r01.json"])
        flow = json.loads(Path("FLOW_r01.json").read_text())
        check(not flow["problems"] and flow["requests"]["joined"] == i
              and all(r["run"] for r in flow["per_request"]),
              f"flow: not every request joined a round stream: "
              f"{flow['requests']}, problems {flow['problems']}")
        _, text, _ = cli_capture(["inspect", "flow", "--replay",
                                  "FLOW_r01.json"])
        check("flow replay: REPRODUCED (FLOW_r01.json)" in text,
              "the flow artifact did not replay REPRODUCED")
        cli_capture(["inspect", "watch", "serve.journal.jsonl", "--flow",
                     "FLOW_r01.json", "--json", "WATCH_r01.json"])
        watch = json.loads(Path("WATCH_r01.json").read_text())
        check(watch.get("flow") == "FLOW_r01.json"
              and watch["evidence"].get("flow"),
              "inspect watch --flow took no flow evidence")
        out["flow"] = {}
        for backend, rids in legs.items():
            rows = [r for r in flow["per_request"] if r["rid"] in rids]
            wo = warm_overhead_block(rows, seed=0)
            doms = Counter(r["dominant"] for r in rows)
            comps = {c: sum(r["fractions"][c] for r in rows) / len(rows)
                     for c in rows[0]["fractions"]}
            print(f"# flow {backend} (README m=1, 8 warm requests): warm "
                  f"overhead fraction {wo['mean']:.6f} (95% CI "
                  f"{wo['ci95']}, seed 0); dominant component "
                  f"{doms.most_common(1)[0][0]} {dict(doms)}; mean "
                  f"fractions {json.dumps(comps)}", flush=True)
            out["flow"][backend] = dict(warm_overhead=wo["mean"],
                                        ci95=wo["ci95"],
                                        dominant=dict(doms),
                                        fractions=comps)

        # 3. live: a sweep in a subprocess, attached mid-run and after it
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(repo), os.environ.get("PYTHONPATH", "")]))
        sweep = [sys.executable, "-m", "tpu_aggcomm_torch.cli", "sweep",
                 *cell[:-2],
                 "--backend", "cuda_fused", "--chained", "--verify",
                 "--trace", "live", "--comm-sizes",
                 ",".join(map(str, comms)), "--results-csv", "live.csv",
                 *dev_args]
        # positionals right after the view: argparse before Python
        # 3.12.7 leaves a '*' positional empty once an option intervenes
        traces = ["cuda_fused.trace.jsonl", "live.trace.jsonl"]
        live = ["inspect", "live", *traces, "--results-csv", "live.csv",
                "--comm-sizes", ",".join(map(str, comms))]
        print(f"$ {' '.join(sweep[1:])}  # in a subprocess", flush=True)
        t0 = time.perf_counter()
        with open("live.out", "w") as log:
            proc = subprocess.Popen(sweep, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)
            try:
                done = []
                while proc.poll() is None and not done:
                    st = obs_live.sweep_status("live.csv",
                                               comm_sizes=comms)
                    done = [c for c in st["cells"] if c["status"] == "done"]
                    time.sleep(0.02)
                t_mid = time.perf_counter()
                print(f"# live: {len(done)} cell(s) done, the sweep "
                      f"{'running' if proc.poll() is None else 'exited'}"
                      f" after {t_mid - t0:.3f} s", flush=True)
                cli_capture(live, expect=(1,))
                mid = obs_live.sweep_status("live.csv", comm_sizes=comms,
                                            trace_paths=traces)
                rc = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        t_end = time.perf_counter()
        print("".join(f"# sweep: {ln}\n" for ln in
                      Path("live.out").read_text().splitlines()[-12:]),
              end="", flush=True)
        check(rc == 0, f"the live sweep exited {rc}")
        mid_done = [c for c in mid["cells"] if c["status"] == "done"]
        check(mid_done and mid["remaining"],
              f"the mid-run attach saw {len(mid_done)} cells done and "
              f"{len(mid['remaining'])} left")
        art = json.loads(Path(art_name).read_text())
        events = load_events("cuda_fused.trace.jsonl")
        want, _ = floor_from_trace_events(
            events, {platform: art["platforms"][platform]})
        eta = mid["eta"]
        check(events_platform(events) == platform
              and eta["model_floor_s"] is not None
              and eta["model_floor_s"] == want,
              f"inspect live's floor {eta['model_floor_s']} is not the "
              f"{platform} block's {want}")
        print(f"# live mid-run ({len(mid_done)} of {len(comms)} cells done, "
              f"{t_mid - t0:.3f} s after the sweep started): eta "
              f"{eta['total_s']} s for {len(mid['remaining'])} cell(s) "
              f"(median cell wall {eta['per_cell_s']} s), soft budget "
              f"{eta['soft_budget_s']} s a cell; cost-model floor "
              f"{eta['model_floor_s'] * 1e6:.3f} us/rep ({source}); the "
              f"sweep's real remaining wall {t_end - t_mid:.3f} s",
              flush=True)
        cli_capture(live, expect=(0,))
        end = obs_live.sweep_status("live.csv", comm_sizes=comms,
                                    trace_paths=traces)
        check(not end["remaining"]
              and end["activity"]["trace"] == "live.trace.jsonl"
              and end["eta"]["model_floor_s"] is not None,
              "the attach after the end saw work left or no floor")
        print(f"# live after the end: nothing remaining, {len(end['cells'])}"
              f" cells, walls {[c['wall_s'] for c in end['cells']]} s; "
              f"floor of the sweep's last run "
              f"{end['eta']['model_floor_s'] * 1e6:.3f} us/rep ({source}); "
              f"sweep wall {t_end - t0:.3f} s", flush=True)
        out["live"] = dict(mid_done=len(mid_done), eta_total_s=eta["total_s"],
                           per_cell_s=eta["per_cell_s"],
                           soft_budget_s=eta["soft_budget_s"],
                           model_floor_s=eta["model_floor_s"],
                           real_remaining_s=t_end - t_mid,
                           sweep_wall_s=t_end - t0)

        # 4. history and report over this root
        Path("BENCH_r01.json").write_text(json.dumps(
            {"n": 1, "cmd": "python -m tpu_aggcomm_torch.bench", "rc": 0,
             "tail": json.dumps(bench), "parsed": bench}, indent=1))
        validators = {"BENCH_r*.json": regress.validate_bench,
                      "COMPARE_r*.json": regress.validate_compare,
                      "FLOW_r*.json": regress.validate_flow,
                      "WATCH_r*.json": regress.validate_watch,
                      art_name: regress.validate_predict}
        for pattern, validate in validators.items():
            for path in sorted(Path(".").glob(pattern)):
                errs = validate(json.loads(path.read_text()), path.name)
                check(not errs, f"{path.name}: {errs}")
                print(f"# {path.name}: valid", flush=True)
        cli_capture(["inspect", "history", "--json", "history.json"])
        index = build_index(".")
        check(index["errors"] == [] and list(index["bench"]) == [
            f"{bench['metric']} | {platform}"],
              f"the history's bench series: {list(index['bench'])}, "
              f"errors {index['errors']}")
        traced = ["torch_sim.trace.jsonl", "cuda_fused.trace.jsonl",
                  "slow.trace.jsonl", "serve.trace.jsonl",
                  "live.trace.jsonl"]
        cli_capture(["inspect", "report", *traced, "--out", "report.html"])
        html = Path("report.html").read_text()
        payload = build_payload(".", traced)
        # the pane names its block off the cpu platform (the reference's
        # pane, exactly, on the cpu)
        pane_file = art_name if platform == "cpu" else source
        panes = {k: payload[k] for k in ("tune", "synth", "workload",
                                         "watch", "flow")}
        check(payload["errors"] == [] and payload["explain"]["file"]
              == pane_file and payload["explain"]["error"] is None
              and not any(r.get("error") for rows in panes.values()
                          for r in rows),
              f"the report's panes: errors {payload['errors']}, explain "
              f"{payload['explain'].get('file')}")
        check(json.dumps(pane_file)[1:-1] in html and "<link" not in html
              and "src=" not in html, "report.html is not self-contained "
              "or does not name the gpu block")
        print(f"# report.html: {len(html)} bytes, self-contained; cost-model"
              f" pane {payload['explain']['file']}; {len(payload['runs'])} "
              f"trace runs, {len(payload['flow'])} flow round(s), bench "
              f"series {list(index['bench'])}", flush=True)

        # 5. the bench-history gate, over this root and the repository
        verdicts = {}
        for label, root in (("this run's root", "."),
                            ("the repository", str(repo))):
            v = regress.check_regression(root)
            slim = {k: v.get(k) for k in ("ok", "rounds", "current",
                                          "baseline", "delta_pct", "gate",
                                          "gate_note", "trend")}
            slim["schema_errors"] = v["schema_errors"]
            check(not v["schema_errors"],
                  f"check_regression over {label}: {v['schema_errors']}")
            print(f"# bench-history gate over {label}: {json.dumps(slim)}",
                  flush=True)
            verdicts[label] = slim
        out["gate"] = verdicts
    out["counts"] = {"fused_rep": fused_rep.launches,
                     "slow_delay": slow_delay.launches}
    print(f"# obs_views launches: {json.dumps(out['counts'])}", flush=True)
    return out


@contextlib.contextmanager
def recorded_schedules():
    """The schedules the runner compiles while the block runs, in order
    (the flagship's 4.19M-edge schedule is priced by the roofline without
    compiling it twice)."""
    from tpu_aggcomm_torch.harness import runner

    made, compile_method = [], runner.compile_method

    def recording(*args, **kw):
        made.append(compile_method(*args, **kw))
        return made[-1]

    runner.compile_method = recording
    try:
        yield made
    finally:
        runner.compile_method = compile_method


def shard_cell(label: str, argv: list) -> dict:
    """One ``cli run --backend torch_shard --chained --verify`` cell on
    the card: its chained per-rep time (the backend's samples), the
    ``torch_shard`` roofline floor of a chained rep (on one card a
    row-delivery launch a round; the rep's bytes plus the token and XOR
    at 3.35 TB/s), which must lie below it, the peak device memory and
    the wall; one ``# shard`` line."""
    import torch

    from tpu_aggcomm_torch.harness import roofline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_backends() as made, recorded_schedules() as scheds:
        cli_capture(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    b, s = made[-1], scheds[-1]
    check(b.name == "torch_shard" and b.last_provenance[0] == "torch_shard",
          f"{label}: ran {b.last_provenance}")
    us = per_rep_us(b)
    t1 = time.perf_counter()
    rb = roofline.rep_bytes(s, lowering="torch_shard")
    chained = rb.total() + roofline.chain_overhead_bytes(
        s, lowering="torch_shard")
    floor_us = roofline.floor_seconds(chained) * 1e6
    price_s = time.perf_counter() - t1
    check(0 < floor_us < us, f"{label}: torch_shard floor {floor_us:.3f} "
          f"us/rep not below the measured {us:.3f} us/rep")
    row = dict(us_per_rep=us, samples_us=[x * 1e6 for x in b.last_samples],
               floor_us=floor_us, rep_floor_us=rb.floor_seconds() * 1e6,
               ratio=us / floor_us, bytes_per_rep=chained,
               peak_bytes=peak, wall_s=wall, price_s=price_s,
               edges=rb.edges, rounds=rb.rounds)
    print(f"# shard {label}: {us:.3f} us/rep chained (median of "
          f"{len(b.last_samples)} trials {[round(x, 3) for x in row['samples_us']]}), "
          f"floor {floor_us:.3f} us/rep ({chained} bytes a chained rep at "
          f"3.35 TB/s; rep alone {row['rep_floor_us']:.3f}), ratio "
          f"{row['ratio']:.3f}; peak device memory {peak} bytes; cli wall "
          f"{wall:.1f} s, roofline priced in {price_s:.1f} s", flush=True)
    return row


def phase_shard_flagship(dev) -> dict:
    """Slice 14's path (``shard_flagship``), in a temporary directory, the
    delay kernel's launch count zeroed first and read at its end: the
    sharded tier ``--backend torch_shard`` on this one card (the
    reference's single-device path) through ``cli run --chained
    --verify``: the README cell beside ``torch_sim``'s same run; the
    README cell under ``--fault slow:r2*2`` (one ``slow_delay.cu`` launch
    a rep), whose delay is then held against its plain version on the
    backend's own flat arenas; and the Theta flagship cell, n=16384
    a=256 d=256 m=1 unthrottled (4.19M slabs, verified). Each cell's
    floor must lie below its time; its peak device memory is printed."""
    import tempfile

    import torch

    from tpu_aggcomm_torch.backends.deliver_rows import deliver_rows
    from tpu_aggcomm_torch.backends.slow_delay import (slow_delay,
                                                       slow_delay_plain,
                                                       slow_tables)
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.faults import repair_schedule

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv = str(Path(tmp) / "shard.csv")
        readme = ["-n", "32", "-m", "1", "-a", "14", "-d", "2048", "-c", "3",
                  "--chained", "--verify", "--results-csv", csv]
        slow_delay.launches = deliver_rows.launches = 0
        deliver_rows.fused_rounds = 0
        out["readme"] = shard_cell("README m=1 n=32 a=14 d=2048 c=3",
                                   [*readme, "--backend", "torch_shard"])
        with recorded_backends() as made:
            cli_capture([*readme, "--backend", "torch_sim"])
        out["readme"]["torch_sim_us_per_rep"] = per_rep_us(made[-1])
        print(f"# shard README beside torch_sim: torch_shard "
              f"{out['readme']['us_per_rep']:.3f} us/rep, torch_sim "
              f"{out['readme']['torch_sim_us_per_rep']:.3f} us/rep",
              flush=True)
        out["slow"] = shard_cell("README slow:r2*2",
                                 [*readme, "--backend", "torch_shard",
                                  "--fault", "slow:r2*2"])
        check(slow_delay.launches > 0,
              "torch_shard's faulted run launched no slow_delay")
        out["flagship"] = shard_cell(
            "flagship m=1 n=16384 a=256 d=256 unthrottled",
            ["-n", "16384", "-m", "1", "-a", "256", "-d", "256",
             "--backend", "torch_shard", "--chained", "--verify",
             "--results-csv", csv])
        out["counts"] = {"slow_delay": slow_delay.launches,
                         "deliver_rows": deliver_rows.launches,
                         "deliver_rows_fused_rounds":
                             deliver_rows.fused_rounds}
        check(deliver_rows.launches > 0,
              "torch_shard on the card launched no deliver_rows")
        check(deliver_rows.fused_rounds > 0,
              "torch_shard's README rounds took no many-round launch")
        print(f"# shard_flagship launches: {json.dumps(out['counts'])}",
              flush=True)

    # the delay against its plain version on torch_shard's own inputs:
    # the device's flat send buffer, the flat recv its rounds leave, and
    # its iteration count (the sum over its slow ranks)
    p = AggregatorPattern(32, 14, data_size=2048, comm_size=3)
    s = repair_schedule(compile_method(1, p), "slow:r2*2")
    b = TorchShardBackend(dev)
    built = b._compiled(s)
    send = b._send(s.pattern, 0, built)
    from tpu_aggcomm_torch.faults.inject import slow_iter_table
    from tpu_aggcomm_torch.faults.spec import parse_fault
    iters = int(slow_iter_table(parse_fault(s.fault), 32,
                                len(built.rounds)).sum())
    tabs = slow_tables([iters], dev)
    recv0 = b._compiled(compile_method(1, p)).rep(send)
    want, got = recv0.clone(), recv0.clone()
    acc_plain = slow_delay_plain(send[None], want[None], tabs)
    acc = slow_delay(send[None], got[None], tabs)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0 and torch.equal(acc, acc_plain),
          f"torch_shard slow_delay != plain (acc {acc.tolist()} vs "
          f"{acc_plain.tolist()})")
    row = dict(spec="slow:r2*2", iters=[iters], acc=acc.tolist(),
               max_abs_err=err,
               **timings(lambda: slow_delay(send[None], got[None], tabs),
                         lambda: slow_delay_plain(send[None], want[None],
                                                  tabs),
                         20, 2, 50, 3, warmup=3))
    out["delay"] = row
    print(f"# shard slow_delay {row['spec']}: one device's {iters} "
          f"iterations, acc {row['acc']} == plain, arena == plain; "
          f"{row['ms'] * 1e3:.3f} us device, plain "
          f"{row['plain_ms'] * 1e3:.3f} us", flush=True)
    return out


def phase_deliver_rows(dev) -> dict:
    """The row-delivery kernel alone (``csrc/deliver_rows.cu``:
    ``torch_shard``'s round on one card with no group) at the Theta
    flagship, n=16384 a=256 m=1. The unthrottled round's tables
    (4,194,304 rows) and its zero runs, on random send arenas of d=2048
    and of d=256: one launch through the wrapper into a receive arena the
    caching allocator hands back filled with 0xFF, held byte for byte
    against ``deliver_rows_plain`` on the same inputs (its arena of 0xFF
    too, so its zero runs are applied) and against the gather and
    ``index_put_`` into a zeroed arena; timed (CUDA graph and eager)
    beside the plain version (eager) and the bytes bound: 2*E*d plus the
    zeroed rows at 3.35 TB/s; the d=2048 launch is the wide-row engine's
    (``deliver_rows.wide_launches``), the d=256 one the persistent grid's.
    Beside the d=2048 pass, CUDA events over 10 back-to-back launches, in
    turns, twice: (a) ``Tensor.copy_`` of one 8.59 GB arena into another
    (``library_ms``; the port never calls it), (b) the persistent grid on
    identity tables, (c) on the Theta tables, (d) the wide-row engine on
    both, each as ms and as a share of 3.35 TB/s; the two engines on the
    Theta tables' first n rows, back to back, where the rule's fewest rows
    lie; the persistent grid's arena == the wide-row engine's. Then the
    Theta script's ``-c 64`` (256
    rounds) at d=2048: each round's own device time, launched alone after
    a synchronize, from the profiler's kernel records (a record of a
    launch back to back would also hold its wait for the previous round:
    each is a programmatic dependent launch), against its own bound; the
    rep as the main path issues it (one launch, its rounds fenced inside
    the kernel) and as one launch a round, each by CUDA events over
    back-to-back reps, their arenas equal to each other and to
    ``deliver_rounds_plain`` into a 0xFF arena; and from one stamped launch,
    each round's copy time and each fence's time (the latest CTA's stamp
    after the round's copies, and after the fence) beside the round's
    bound and the 1.5 us fence target, no CTA past a fence before every
    CTA has copied its round. Last, the README shape's 11 rounds as one
    launch and as one launch a round (CUDA graph and eager), the one
    launch held against both the rounds and the plain version."""
    import warnings

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_aggcomm_torch.backends.deliver_rows import (_deliver_rows_on,
                                                         arena_launcher,
                                                         deliver_rounds,
                                                         deliver_rows,
                                                         deliver_rounds_plain,
                                                         deliver_rows_plain,
                                                         row_tables,
                                                         rounds_plan)
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    n, a = 16384, 256
    ALONE = "chip_smoke.rounds_alone"
    gen = torch.Generator(device=dev)
    gen.manual_seed(2**31 + 19)
    torch.cuda.empty_cache()

    def build(c):
        t0 = time.perf_counter()
        s = compile_method(1, AggregatorPattern(n, a, data_size=2048,
                                                comm_size=c))
        return TorchShardBackend(dev)._compiled(s), time.perf_counter() - t0

    def random_send(rows, w):
        return torch.randint(-2**31, 2**31 - 1, (rows, w), dtype=torch.int32,
                             device=dev, generator=gen)

    def poisoned(rows, w):
        block = torch.empty(rows * w * 4, dtype=torch.uint8, device=dev)
        block.fill_(0xFF)
        del block
        return torch.empty((rows, w), dtype=torch.int32, device=dev)

    def bound_ms(n_rows, zero_rows, d):
        return (2 * n_rows * d + zero_rows * d) / HBM_BYTES_PER_S * 1e3

    def engine_readings(send, recv, tabs, zero):
        """Readings (a)-(d) at the Theta pass and the two engines on the
        first n rows of its tables (ms, and shares of 3.35 TB/s)."""
        n_rows = tabs.n_rows
        ident = row_tables(np.arange(n_rows), np.arange(n_rows), F=F, Fs=Fs,
                           device=dev)
        a_src, a_dst = send[:n_rows], recv[:n_rows]
        runs = {"library": lambda: a_dst.copy_(a_src),
                "persistent_ident": lambda: _deliver_rows_on(
                    "persistent", send, recv, ident),
                "persistent": lambda: _deliver_rows_on("persistent", send,
                                                       recv, tabs, zero),
                "wide_ident": lambda: _deliver_rows_on("wide", send, recv,
                                                       ident),
                "wide": lambda: _deliver_rows_on("wide", send, recv, tabs,
                                                 zero)}
        ms = {k: [] for k in runs}
        for _turn in range(2):
            for k, fn in runs.items():
                ms[k].append(cuda_ms(fn, 10, 2))
        bound = bound_ms(n_rows, 0, 2048)
        got = {f"{k}_ms": v for k, v in ms.items()}
        got.update({f"{k}_peak": [bound / m for m in v]
                    for k, v in ms.items()})
        got["library_ms"] = min(ms["library"])
        del ident
        sweep = []
        for n_sub in (4096, 16384, 32768, 65536, 262144):
            sub = row_tables(tabs.src[:n_sub], tabs.dst[:n_sub], F=F, Fs=Fs,
                             device=dev)
            sweep.append(dict(rows=n_sub, **{
                f"{e}_us": cuda_ms(lambda e=e: _deliver_rows_on(
                    e, send, recv, sub), 50, 5) * 1e3
                for e in ("persistent", "wide")}))
            del sub
        got["sweep"] = sweep
        print("# deliver_rows readings at the Theta pass (CUDA events over "
              "10 launches, two turns; ms, share of 3.35 TB/s): "
              + "; ".join(f"{lab} " + ", ".join(
                  f"{m:.4f} ({bound / m:.3f})" for m in ms[k])
                  for lab, k in (("(a) copy_", "library"),
                                 ("(b) persistent identity",
                                  "persistent_ident"),
                                 ("(c) persistent Theta", "persistent"),
                                 ("(d) wide identity", "wide_ident"),
                                 ("(d) wide Theta", "wide"))), flush=True)
        for r in sweep:
            print(f"# deliver_rows the first {r['rows']} Theta rows, back to "
                  f"back: persistent {r['persistent_us']:.2f} us, wide "
                  f"{r['wide_us']:.2f} us", flush=True)
        return got

    built, build_s = build(999_999_999)
    F, Fs = built.F, built.Fs
    (_r, tab, _nbar), = built.rounds
    tabs, zero = tab.rows, built.zero
    out = {}
    for d in (2048, 256):
        w = d // 4
        send = random_send(Fs, w)
        wide = deliver_rows.wide_launches
        got = deliver_rows(send, poisoned(F, w), tabs, zero)
        check(deliver_rows.wide_launches - wide == (d == 2048),
              f"deliver_rows d={d}: the launch took the wrong engine")
        want = deliver_rows_plain(
            send, torch.full((F, w), -1, dtype=torch.int32, device=dev),
            tabs, zero)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0 and torch.equal(got, want),
              f"deliver_rows d={d}: kernel != plain")
        if d == 2048:
            other = _deliver_rows_on("persistent", send, poisoned(F, w),
                                     tabs, zero)
            check(torch.equal(other, want), "deliver_rows d=2048: the "
                  "persistent grid's arena != the wide-row engine's")
            del other
        want.zero_()
        deliver_rows_plain(send, want, tabs)
        check(torch.equal(got, want), f"deliver_rows d={d}: kernel != the "
              f"gather and index_put_ into a zeroed arena")
        del want
        torch.cuda.empty_cache()
        row = dict(shape=[n, a, d, 999_999_999], rows=tabs.n_rows,
                   zero_rows=zero.rows, max_abs_err=err,
                   ms=graph_ms(lambda: deliver_rows(send, got, tabs, zero),
                               10),
                   eager_ms=cuda_ms(lambda: deliver_rows(send, got, tabs,
                                                         zero), 20, 3),
                   plain_eager_ms=cuda_ms(lambda: deliver_rows_plain(
                       send, got, tabs, zero), 3, 1),
                   bound_ms=bound_ms(tabs.n_rows, zero.rows, d))
        row["roofline"] = row["bound_ms"] / row["ms"]
        if d == 2048:
            row.update(engine_readings(send, got, tabs, zero))
        out[d] = row
        print(f"# deliver_rows n={n} a={a} d={d} unthrottled: "
              f"{tabs.n_rows} rows copied, {zero.rows} zeroed; == plain "
              f"into a 0xFF arena and == gather/index_put_ into a zeroed "
              f"one; {row['ms']:.4f} ms device (CUDA graph), "
              f"{row['eager_ms']:.4f} ms eager, plain "
              f"{row['plain_eager_ms']:.4f} ms eager; bound "
              f"{row['bound_ms']:.4f} ms, {100 * row['roofline']:.2f}% of "
              f"it", flush=True)
        del send, got
        torch.cuda.empty_cache()
    del built, tabs, zero

    built, build64_s = build(64)
    F, R, d = built.F, len(built.rounds), 2048
    zero, tabs = built.zero, built.fused
    check(tabs is not None, "deliver_rows -c 64: the rep is not one launch")
    send = random_send(built.Fs, d // 4)
    recv = torch.empty((F, d // 4), dtype=torch.int32, device=dev)
    issue = arena_launcher(send, recv)

    def per_round():
        for i, (_r, t, _nb) in enumerate(built.rounds):
            issue(t.rows, zero if i == 0 else None)

    built.rep(send)
    per_round()
    torch.cuda.synchronize()
    launches = deliver_rows.launches
    rep_ms = cuda_ms(lambda: built.rep(send), 10, 2)
    check(deliver_rows.launches - launches == 12, "deliver_rows -c 64: the "
          "rep is not one launch")
    per_round_ms = cuda_ms(per_round, 10, 2)
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")
        built.rep(send)              # the profiler's start-up: not read
        torch.cuda.synchronize()
        with record_function(ALONE):
            for i, (_r, t, _nb) in enumerate(built.rounds):
                issue(t.rows, zero if i == 0 else None)
                torch.cuda.synchronize()
    got = built.rep(send)
    torch.cuda.synchronize()
    check(torch.equal(got, recv), "deliver_rows -c 64: the rep's one "
          "launch != its rounds launched one a round")
    want = deliver_rounds_plain(send, torch.full_like(got, -1), tabs, R, zero)
    check(torch.equal(got, want), "deliver_rows -c 64: the rep's one "
          "launch != the plain version")
    del want
    check(tabs.sync.tolist() == [0, 0, 0, 0], f"deliver_rows -c 64: fence "
          f"words {tabs.sync.tolist()} after the reps")
    events = list(prof.profiler.kineto_results.events())
    t0 = min((e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU and e.name() == ALONE),
             default=None)
    check(t0 is not None, f"deliver_rows -c 64: no {ALONE} range traced")
    own = sorted(e.duration_ns() / 1e3 for e in events
                 if e.device_type() == DeviceType.CUDA
                 and "deliver_rows_kernel" in e.name() and e.start_ns() >= t0)
    check(R // 2 <= len(own) <= R, f"deliver_rows -c 64: {len(own)} "
          f"kernel records of {R} rounds launched alone")
    bounds = [bound_ms(t.rows.n_rows, zero.rows if i == 0 else 0, d) * 1e3
              for i, (_r, t, _nb) in enumerate(built.rounds)]
    own_mean = sum(own) / len(own)
    # one stamped launch: per CTA its start, after each round's copies,
    # after each fence, its end (deliver_rows.cu)
    plan = rounds_plan(send, got, tabs, R, zero)
    stamps = torch.zeros(plan["grid"] * (2 + 2 * R), dtype=torch.int64,
                         device=dev)
    deliver_rounds(send, got, tabs, R, zero, stamps=stamps)
    torch.cuda.synchronize()
    check(torch.equal(got, recv), "deliver_rows -c 64: the stamped launch "
          "!= the rounds launched one a round")
    st = stamps.view(plan["grid"], 2 + 2 * R)[:plan["copy_ctas"]].cpu()
    copied = st[:, 1:2 * R:2].max(0).values
    fenced = st[:, 2:2 * R + 1:2].max(0).values
    check(all(int(st[:, 2 + 2 * k].min()) >= int(copied[k])
              for k in range(R - 1)),
          "deliver_rows -c 64: a CTA left a fence before every CTA had "
          "copied its round")
    start = torch.cat([st[:, 0].min().view(1), fenced[:-1]])
    copy_us = sorted(((copied - start).double() / 1e3).tolist())
    fence_us = sorted(((fenced - copied)[:-1].double() / 1e3).tolist())

    def q(xs, f):
        return xs[min(len(xs) - 1, int(f * len(xs)))]

    c64 = dict(shape=[n, a, d, 64], rounds=R, recorded=len(own),
               rows_per_round=built.rounds[0][1].rows.n_rows,
               zero_rows=zero.rows, own_us_mean=own_mean,
               own_us_median=own[len(own) // 2], own_us_min=own[0],
               own_us_max=own[-1], bound_us_round=sum(bounds) / R,
               own_roofline=sum(bounds) / R / own_mean,
               rep_us=rep_ms * 1e3, per_round_us=per_round_ms * 1e3,
               bound_us_rep=sum(bounds),
               rep_roofline=sum(bounds) / (rep_ms * 1e3),
               grid=plan["grid"], copy_ctas=plan["copy_ctas"],
               copy_us_median=q(copy_us, 0.5), copy_us_p95=q(copy_us, 0.95),
               fence_us_median=q(fence_us, 0.5),
               fence_us_p95=q(fence_us, 0.95), fence_target_us=1.5,
               stamped_us=float(st[:, 1 + 2 * R].max() - st[:, 0].min()) / 1e3,
               build_s=build64_s)
    out["c64"] = c64
    out["build_s"] = build_s
    del built, tabs, send, recv, got
    torch.cuda.empty_cache()

    # the README shape (11 rounds of about 41 rows): latency, not bytes
    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    small = TorchShardBackend(dev)._compiled(s)
    send = random_send(small.Fs, 512)
    recv = torch.empty((small.F, 512), dtype=torch.int32, device=dev)

    def small_rounds():
        # the issuer reads the current stream, as the rep's does: made
        # here, a graph's capture takes its launches
        issue = arena_launcher(send, recv)
        for i, (_r, t, _nb) in enumerate(small.rounds):
            issue(t.rows, small.zero if i == 0 else None)

    small_rounds()
    check(small.fused is not None and torch.equal(small.rep(send), recv),
          "deliver_rows README: the rep's one launch != its rounds")
    check(torch.equal(recv, deliver_rounds_plain(
        send, torch.full_like(recv, -1), small.fused, len(small.rounds),
        small.zero)), "deliver_rows README: the rep's one launch != the "
          "plain version")
    readme = dict(rounds=len(small.rounds),
                  rep_graph_us=graph_ms(lambda: small.rep(send), 50) * 1e3,
                  per_round_graph_us=graph_ms(small_rounds, 50) * 1e3,
                  rep_eager_us=cuda_ms(lambda: small.rep(send), 200) * 1e3,
                  per_round_eager_us=cuda_ms(small_rounds, 200) * 1e3)
    out["readme"] = readme
    print(f"# deliver_rows README n=32 a=14 d=2048 -c 3: {readme['rounds']} "
          f"rounds; one launch {readme['rep_graph_us']:.2f} us (CUDA graph), "
          f"{readme['rep_eager_us']:.2f} us eager; one launch a round "
          f"{readme['per_round_graph_us']:.2f} us (graph), "
          f"{readme['per_round_eager_us']:.2f} us eager", flush=True)
    print(f"# deliver_rows n={n} a={a} d={d} -c 64: {R} rounds of "
          f"{c64['rows_per_round']} rows; a round launched alone (a "
          f"synchronize between launches; {len(own)} profiler records): "
          f"{own_mean:.2f} us mean, {c64['own_us_min']:.2f}-"
          f"{c64['own_us_max']:.2f} (median {c64['own_us_median']:.2f}), "
          f"{100 * c64['own_roofline']:.2f}% of its bound "
          f"({c64['bound_us_round']:.2f} us); the rep as the main path "
          f"issues it (one launch of {plan['grid']} CTAs, its rounds fenced "
          f"inside, CUDA events over 10 reps): {c64['rep_us']:.1f} us, "
          f"{100 * c64['rep_roofline']:.2f}% of its bound "
          f"({c64['bound_us_rep']:.1f} us); one launch a round "
          f"{c64['per_round_us']:.1f} us; == the rounds launched one a "
          f"round", flush=True)
    print(f"# deliver_rows -c 64 stamps: a round's copies "
          f"{c64['copy_us_median']:.2f} us median, {c64['copy_us_p95']:.2f} "
          f"p95 (bound {c64['bound_us_round']:.2f}); a fence "
          f"{c64['fence_us_median']:.3f} us median, {c64['fence_us_p95']:.3f} "
          f"p95 (target {c64['fence_target_us']}); the stamped launch "
          f"{c64['stamped_us']:.1f} us", flush=True)
    return out


def phase_tam_relay(dev) -> dict:
    """TAM's relay on one card (``torch_shard`` with no group: m=15/16 as
    three bound row deliveries over m=1/m=2's compacted arenas). At
    n=1024 a=64 ``-p 64`` d=2048, both directions: each hop's arena, the
    allocator handed 0xFF blocks first, held byte for byte against the
    same hop through ``deliver_rows_plain`` on the card (its arenas of
    0xFF too), and the delivered arena against m=1's (m=2's) one-launch
    rep of the same send. At the Theta job's p64 deployment (n=16384
    a=256 ``-p 64`` d=2048, m=15): the build's seconds, the delivered
    arena (the three hops on the wide-row engine, back to back) against
    the plain hops' and m=1's rep, the peak memory of a rep, the rep by
    CUDA events over back-to-back reps, and each hop alone on each
    engine, against its bound (2*E*d at 3.35 TB/s, and the zeroed trash
    row in P4/P5's)."""
    import torch

    from tpu_aggcomm_torch.backends.deliver_rows import (_deliver_rows_on,
                                                         deliver_rows,
                                                         deliver_rows_plain,
                                                         row_launcher)
    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern

    gen = torch.Generator(device=dev)
    gen.manual_seed(2**31 + 53)
    torch.cuda.empty_cache()

    def filled(rows, w):
        block = torch.empty(rows * w * 4, dtype=torch.uint8, device=dev)
        block.fill_(0xFF)
        del block

    def build(method, n, a):
        t0 = time.perf_counter()
        s = compile_method(method, AggregatorPattern(
            n, a, data_size=2048, proc_node=64, comm_size=999_999_999))
        return s, TorchShardBackend(dev)._compiled(s), \
            time.perf_counter() - t0

    def plain_hops(built, send, keep=True):
        """The three hops through the plain version, into arenas of -1:
        each hop's arena (``keep``), else the last alone."""
        out, src = [], send
        for k, tabs in enumerate(built.relay, 1):
            rows = built.F if k == 3 else tabs.recv_rows
            src = deliver_rows_plain(
                src, torch.full((rows, send.shape[1]), -1, dtype=send.dtype,
                                device=dev), tabs,
                built.zero if k == 3 else None)
            if keep or k == 3:
                out.append(src)
        return out

    def direct(s, send):
        one = compile_method(s.method_id - 14, s.pattern)
        return TorchShardBackend(dev)._compiled(one).rep(send)

    out = {}
    for method in (15, 16):
        s, built, _s = build(method, 1024, 64)
        send = torch.randint(-2**31, 2**31 - 1, (built.Fs, 512),
                             dtype=torch.int32, device=dev, generator=gen)
        filled(built.F + 2 * built.relay[0].recv_rows, 512)
        launches, hops = deliver_rows.launches, deliver_rows.relay_hops
        stages = []
        got = built.rep(send, stages=stages)
        torch.cuda.synchronize()
        check(deliver_rows.launches - launches == 3
              and deliver_rows.relay_hops - hops == 3,
              f"tam_relay m={method} n=1024: not three launches a rep")
        for k, (g, w) in enumerate(zip(stages, plain_hops(built, send)), 1):
            check(torch.equal(g, w), f"tam_relay m={method} n=1024: hop "
                  f"{k} != its plain version")
        check(torch.equal(got, direct(s, send)), f"tam_relay m={method} "
              f"n=1024: the relay's arena != m={method - 14}'s")
        print(f"# tam_relay m={method} n=1024 a=64 -p 64 d=2048: "
              f"{built.relay[0].n_rows} slabs a hop; each hop == its plain "
              f"version, the arena == m={method - 14}'s rep", flush=True)
        del s, built, send, stages, got
        torch.cuda.empty_cache()

    s, built, build_s = build(15, 16384, 256)
    w, d = 512, 2048
    E = built.relay[0].n_rows
    send = torch.randint(-2**31, 2**31 - 1, (built.Fs, w), dtype=torch.int32,
                         device=dev, generator=gen)
    filled(built.F + 2 * E, w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wide = deliver_rows.wide_launches
    got = built.rep(send)
    torch.cuda.synchronize()
    rep_peak = torch.cuda.max_memory_allocated(dev) - base
    check(deliver_rows.wide_launches - wide == 3, "tam_relay Theta p64: "
          "the three hops did not all take the wide-row engine")
    (want,) = plain_hops(built, send, keep=False)
    check(torch.equal(got, want), "tam_relay Theta p64: the relay's arena "
          "!= its plain hops'")
    del want
    torch.cuda.empty_cache()
    check(torch.equal(got, direct(s, send)), "tam_relay Theta p64: the "
          "relay's arena != m=1's rep")
    torch.cuda.empty_cache()
    rep_ms = cuda_ms(lambda: built.rep(send), 10, 2)
    arenas = [send, torch.empty((E, w), dtype=torch.int32, device=dev),
              torch.empty((E, w), dtype=torch.int32, device=dev), got]
    hop_ms, persistent_ms, bound_ms = [], [], []
    for k, tabs in enumerate(built.relay, 1):
        zero = built.zero if k == 3 else None
        src, dst = arenas[k - 1], arenas[k]
        issue = row_launcher(tabs, zero, send_shape=tuple(src.shape),
                             recv_shape=tuple(dst.shape), dtype=torch.int32)
        hop_ms.append(cuda_ms(lambda: issue(src, dst), 10, 2))
        persistent_ms.append(cuda_ms(lambda: _deliver_rows_on(
            "persistent", src, dst, tabs, zero), 10, 2))
        bound_ms.append((2 * tabs.n_rows * d + (zero.rows if zero else 0)
                         * d) / HBM_BYTES_PER_S * 1e3)
    theta = dict(shape=[16384, 256, d, 64], slabs=E, build_s=build_s,
                 rep_ms=rep_ms, hop_ms=hop_ms,
                 hop_persistent_ms=persistent_ms, hop_bound_ms=bound_ms,
                 bound_ms=sum(bound_ms), roofline=sum(bound_ms) / rep_ms,
                 hop_roofline=[b / h for b, h in zip(bound_ms, hop_ms)],
                 rep_peak_bytes=rep_peak)
    out["theta"] = theta
    print(f"# tam_relay Theta p64 n=16384 a=256 d=2048 m=15: build "
          f"{build_s:.2f} s; the arena == its plain hops' and m=1's rep; a "
          f"rep {rep_ms:.3f} ms (CUDA events over 10 reps), "
          f"{100 * theta['roofline']:.2f}% of its bound "
          f"{theta['bound_ms']:.3f} ms; hops alone "
          + ", ".join(f"{h:.3f} ms ({100 * b / h:.2f}%)"
                      for h, b in zip(hop_ms, bound_ms))
          + " on the wide-row engine, "
          + ", ".join(f"{h:.3f} ms ({100 * b / h:.2f}%)"
                      for h, b in zip(persistent_ms, bound_ms))
          + f" on the persistent grid; a rep allocates {rep_peak / 1e9:.2f} "
          f"GB at its peak",
          flush=True)
    del s, built, send, got, arenas
    torch.cuda.empty_cache()
    return out


MESH_ARGS = ["-n", "1", "-a", "1", "-d", "2048", "--backend", "torch_ici",
             "--verify"]


def nccl_call_us(dev) -> dict:
    """Microseconds a call of the two NCCL collectives the tier issues,
    in this process's group (a world of one): an ``all_to_all_single`` of
    one 2048-byte int32 row and an ``all_reduce`` of one int64, eager
    (CUDA events over back-to-back calls from Python) and in a CUDA graph
    (the communicator warmed by the eager calls first)."""
    import torch
    import torch.distributed as dist
    x = torch.arange(512, dtype=torch.int32, device=dev).reshape(1, 512)
    out = torch.empty_like(x)
    tok = torch.ones(1, dtype=torch.int64, device=dev)
    calls = {"all_to_all_single": lambda: dist.all_to_all_single(
                 out, x, [1], [1]),
             "all_reduce": lambda: dist.all_reduce(tok)}
    res = {}
    for name, fn in calls.items():
        eager = cuda_ms(fn, 2000, warmup=50) * 1e3
        graph = graph_ms(fn, 200) * 1e3
        res[name] = dict(eager_us=eager, graph_us=graph)
    check(torch.equal(out, x) and int(tok.item()) == 1,
          "a NCCL collective over a world of one changed its data")
    return res


def mesh_tier_child(out_path: str) -> int:
    """The NCCL world of one, run under ``torch.distributed.run``: the
    tier's runs through the CLI, each with the collectives it issued and
    its per-rep time, then the per-call NCCL times and the refusals
    under the group; everything into ``out_path`` as JSON."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_aggcomm_torch.parallel import COLLECTIVE_CALLS, distributed_init

    smi = nvidia_smi()
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    check(distributed_init(device="cuda"), "no launcher group to join")
    check(str(dist.get_backend()).lower() == "nccl"
          and dist.get_world_size() == 1, "not a NCCL world of one")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        csv = str(Path(tmp) / "mesh.csv")
        cells = [(f"m{m}{' chained' if ch else ''}",
                  ["-m", str(m), *MESH_ARGS, *(["--chained"] if ch else []),
                   "--results-csv", csv])
                 for m in (1, 8, 17) for ch in (False, True)]
        cells.append(("m1 profile-rounds", ["-m", "1", *MESH_ARGS,
                                            "--profile-rounds",
                                            "--results-csv", csv]))
        cells += [(f"TAM m{m} -p 1", ["-m", str(m), *MESH_ARGS, "-p", "1",
                                      "--results-csv", csv])
                  for m in (15, 16)]
        for label, argv in cells:
            COLLECTIVE_CALLS.clear()
            with recorded_backends() as made:
                _rc, text, _err = cli_capture(argv)
            b = made[-1]
            row = dict(label=label, calls=dict(COLLECTIVE_CALLS),
                       provenance=list(b.last_provenance),
                       max_total_s=float(text.rsplit(
                           "max total time = ", 1)[1].split()[0]))
            if "chained" in label:
                row["us_per_rep"] = per_rep_us(b)
            check(b.last_provenance[0] == "torch_ici",
                  f"{label}: ran {b.last_provenance}")
            runs.append(row)
        for engine in ("jax", "shared_jax"):
            COLLECTIVE_CALLS.clear()
            _rc, text, _err = cli_capture(
                ["tam", "-n", "1", "-p", "1", "-t", "3", "--mode", "1",
                 "--engine", engine, "--device", "cuda"])
            check("| correctness: PASSED" in text, f"tam {engine} failed")
            runs.append(dict(label=f"tam --engine {engine}",
                             calls=dict(COLLECTIVE_CALLS),
                             min_rep_s=float(text.rsplit("min rep = ", 1)[1]
                                             .split()[0])))
        nccl = nccl_call_us(dev)
        refusals = [
            refused(["pt2pt", "-d", "2048", "--device", "cuda"],
                    "TooFewProcessesError: pt2pt needs >= 2 devices"),
            refused(["-m", "1", "-n", "1", "-a", "1", "-d", "2048",
                     "--backend", "cuda_dma", "--verify",
                     "--results-csv", csv],
                    "NotPortedError: cuda_dma under a process group")]
    for row in runs:
        print(f"# mesh_tier {row['label']}: collectives "
              f"{json.dumps(row['calls'])}" + (
                  f", {row['us_per_rep']:.3f} us/rep chained"
                  if "us_per_rep" in row else "") + f" ({smi})", flush=True)
    for name, r in nccl.items():
        print(f"# mesh_tier NCCL {name} (world of one): "
              f"{r['eager_us']:.3f} us eager, {r['graph_us']:.3f} us in a "
              f"CUDA graph ({smi})", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    from tpu_aggcomm_torch.obs.atomic import atomic_write
    with atomic_write(out_path) as fh:
        json.dump(dict(runs=runs, nccl=nccl, refusals=refusals, smi=smi),
                  fh)
    return 0


def phase_mesh_tier(smi: str) -> dict:
    """Slice 15's path (``mesh_tier``): (b) the refusals with no group in
    this process, (a) the NCCL world of one in a child under
    ``torch.distributed.run``, (c) ``dryrun_multichip(8, "cpu")`` over
    gloo on the host's CPU."""
    import tempfile

    from tpu_aggcomm_torch.parallel import (TooFewCardsError,
                                            distributed_init, is_distributed)
    from tpu_aggcomm_torch.parallel.dryrun import dryrun_multichip

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["refusals"] = [refused(
            ["-n", "2", "-m", "1", "-a", "1", "-d", "2048", "--backend",
             "torch_ici", "--verify", "--results-csv",
             str(Path(tmp) / "r.csv")],
            "TooFewProcessesError: pattern needs 2 devices")]
        try:
            distributed_init(f"file://{tmp}/world2", 2, 0, device="cuda",
                             timeout_s=30)
        except TooFewCardsError as e:
            line = f"{type(e).__name__}: {e}"
            print(f"# {line}", flush=True)
            out["refusals"].append(line)
        else:
            raise SmokeError("a CUDA world of 2 on one card was not refused")
        check(not is_distributed(), "a refused world left a group up")
        child_out = Path(tmp) / "mesh_tier.json"
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", str(Path(__file__).resolve()),
                "--mesh-tier-child", str(child_out)]
        print(f"$ {' '.join(argv[:6])} chip_smoke.py --mesh-tier-child ...",
              flush=True)
        t0 = time.perf_counter()
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_RANK")}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(Path(__file__).resolve().parent),
                        env.get("PYTHONPATH")) if p)
        r = subprocess.run(argv, env=env, capture_output=True, text=True,
                           timeout=400)
        print(r.stdout, end="", flush=True)
        if r.returncode != 0:
            print(r.stderr[-6000:], file=sys.stderr)
        check(r.returncode == 0, f"the NCCL world of one exited "
              f"{r.returncode}")
        child = json.loads(child_out.read_text())
        out["child_s"] = time.perf_counter() - t0
    out.update(runs=child["runs"], nccl=child["nccl"])
    out["refusals"] += child["refusals"]
    by = {row["label"]: row["calls"] for row in child["runs"]}
    check(not by["m1"] and by["m8"].get("all_to_all_single")
          and by["m17"].get("all_reduce"),
          f"NCCL calls at n=1 not as expected: {by}")
    t0 = time.perf_counter()
    line = dryrun_multichip(8, "cpu", timeout_s=300)
    out["dryrun_s"] = time.perf_counter() - t0
    check("ok (" in line, f"dryrun: {line}")
    print(f"# dryrun_multichip(8, \"cpu\") ok: 8 gloo processes on the "
          f"host's CPU in {out['dryrun_s']:.1f} s (CPU: no card number)",
          flush=True)
    print(f"# mesh_tier: child {out['child_s']:.1f} s on {smi}", flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    import tpu_aggcomm_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["--mesh-tier-child"]:
        return mesh_tier_child(sys.argv[2])

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda")
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        walls[name] = time.perf_counter() - t0
        return got

    timed("setup", phase_setup)
    k1 = timed("k1", phase_k1, dev)
    k2 = timed("k2", phase_k2, dev)
    k3 = timed("k3", phase_k3, dev)
    # the line's bound is the bytes' (the larger of bytes and operations,
    # and K3 moves rows, it computes nothing); the dependent wave chain,
    # which binds in practice, stays beside it as chain_bound_ms
    k3_row = dict(k3["lockstep"], us_per_rep=k3["lockstep"]["ms"] * 1e3,
                  us_per_fence=k3["lockstep"]["us_per_wave"], concurrent={
                      k: v for k, v in k3["concurrent"].items()
                      if k != "shape"},
                  bound_ms=k3["lockstep"]["bytes_bound_ms"],
                  bound_by="bytes",
                  binding=k3["lockstep"]["bound_by"])
    main_path = timed("main_path", phase_main_path)
    counts = main_path["counts"]
    faults = timed("faults_sweep", phase_faults_sweep, dev)
    tam_obs = timed("tam_obs", phase_tam_obs, dev)
    serve = timed("serve", phase_serve, dev)
    tune_synth = timed("tune_synth", phase_tune_synth, dev)
    pilot_obs = timed("pilot_obs", phase_pilot_obs, dev)
    inspect = timed("inspect_roofline", phase_inspect_roofline, dev,
                    main_path["measured"], faults)
    model = timed("model_gpu", phase_model_gpu, dev, faults, tune_synth)
    views = timed("obs_views", phase_obs_views, dev, main_path["bench"],
                  serve["delay"])
    shard = timed("shard_flagship", phase_shard_flagship, dev)
    deliver = timed("deliver_rows", phase_deliver_rows, dev)
    relay = timed("tam_relay", phase_tam_relay, dev)
    mesh = timed("mesh_tier", phase_mesh_tier, smi)
    later_k2 = (tam_obs["counts"]["fused_rep"] + serve["counts"]["fused_rep"]
                + tune_synth["counts"]["fused_rep"]
                + pilot_obs["counts"]["fused_rep"]
                + inspect["counts"]["fused_rep"]
                + model["counts"]["fused_rep"]
                + views["counts"]["fused_rep"])
    counts["fused_rep"] += later_k2
    main_path["reps"]["fused_rep"] += later_k2
    busy = {b: round(r["busy_share"], 6)
            for b, r in tam_obs["xprof"].items()}
    print(f"device busy share of one profiled README rep (union of the "
          f"device events over the rep's host wall): {json.dumps(busy)}")
    print("measured phases " + json.dumps(main_path["measured"]))
    walls["main_path.measured"] = main_path["measured_s"]
    print(f"# phase walls (s): {json.dumps(walls)}")
    print("shard cells " + json.dumps({k: v for k, v in shard.items()
                                       if k in ("readme", "slow",
                                                "flagship")}))
    print("mesh tier " + json.dumps({k: mesh[k] for k in ("runs", "nccl")}))
    # no single PyTorch call computes any of these functions (a permuted
    # copy plus XOR; a round-fenced scatter of rows; a semaphore-
    # synchronized step program), so library_ms is null; K1's, K2's and
    # K3's bounds are bytes (K3's "binding" names the wave chain)
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": counts[name],
         "reps": main_path["reps"][name], "bound_by": "bytes",
         "library_ms": None, "matches_plain": row["max_abs_err"] == 0,
         "us_per_rep": row["ms"] * 1e3, **row}
        for name, source, replaces, row in (
            ("exchange", "tpu_aggcomm_torch/csrc/exchange.cu",
             "tpu_aggcomm/backends/pallas_local.py:83", k1),
            ("fused_rep", "tpu_aggcomm_torch/csrc/fused_rep.cu",
             "tpu_aggcomm/native/fuse.py:390", k2),
            ("dma_steps", "tpu_aggcomm_torch/csrc/dma_steps.cu",
             "tpu_aggcomm/backends/pallas_dma.py:420", k3_row))]
    # K2 on the synthesized one-round incasts (m=101-103, slice 9)
    incast = tune_synth["k2"]
    kernels[1]["synthesized"] = [
        {k: v for k, v in r.items() if k != "shape"}
        | {"n": r["shape"]["n"]} for r in incast]
    kernels[1]["matches_plain"] = kernels[1]["matches_plain"] and all(
        r["max_abs_err"] == 0 for r in incast)
    # the slow-rank delay replaces an XLA fori_loop, not a pallas_call;
    # its row is the README shape's slow:r2*8, n=1024's under "large"
    delay = faults["delay"]
    kernels.append(dict(
        {k: v for k, v in delay[0].items()},
        name="slow_delay", route="cuda",
        source="tpu_aggcomm_torch/csrc/slow_delay.cu",
        replaces="tpu_aggcomm/backends/jax_sim.py:435",
        launches=(faults["counts"]["slow_delay"]
                  + serve["counts"]["slow_delay"]
                  + views["counts"]["slow_delay"]
                  + shard["counts"]["slow_delay"]),
        library_ms=None,
        matches_plain=all(r["max_abs_err"] == 0
                          for r in delay + serve["delay"] + [shard["delay"]]),
        sharded=shard["delay"],
        large=[{k: v for k, v in r.items() if k not in ("acc",)}
               for r in delay[1:]],
        batched=serve["delay"]))
    # torch_shard's round on one card replaces an XLA gather-scatter
    # fusion, not a pallas_call; its row is d=2048 at the Theta flagship
    # (its library_ms: copy_ of the same bytes between two arenas, which
    # the port never calls), d=256 under "narrow", the -c 64 rounds under
    # "c64"; launches are the torch_shard CLI runs' (CUDA-graph replays
    # included)
    wide = deliver[2048]
    kernels.append(dict(
        wide, name="deliver_rows", route="cuda",
        source="tpu_aggcomm_torch/csrc/deliver_rows.cu",
        replaces="tpu_aggcomm/backends/jax_shard.py:70",
        launches=shard["counts"]["deliver_rows"], bound_by="bytes",
        us_per_rep=wide["ms"] * 1e3,
        matches_plain=wide["max_abs_err"] == 0
        and deliver[256]["max_abs_err"] == 0,
        narrow=deliver[256], c64=deliver["c64"], relay=relay["theta"]))
    print(json.dumps({"kernels": kernels}))
    print(f"# chip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
