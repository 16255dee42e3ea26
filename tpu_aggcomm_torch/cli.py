"""Command-line interface, flag-compatible with the reference ``./test``.

The port of ``tpu_aggcomm/cli.py``'s ``run`` command and its ``sweep``
subcommand. Bare flags are ``run``, as in the reference: grammar
``"hp:c:m:d:a:i:k:t:b:"`` (mpi_test.c:2130-2166) plus ``-n`` (rank count;
the reference gets it from ``mpiexec -n``), ``--backend``, ``--verify``,
``--chained``, ``--profile-rounds``, ``--measured-phases``, ``--fault``,
``--device``, ``--results-csv``, ``--trace`` (the flight recorder) and
``--xprof`` (one extra rep per method under ``torch.profiler``).
``sweep`` is the reference's Theta job scripts: one run per throttle
value over ``-c`` in 1, 2, 4, ..., 8192 and unthrottled, with ``--fault``
as an extra axis, ``--resume`` and ``--trace``. ``tam`` is the
reference's DEBUG driver of the TAM engine (lustre_driver_test.c:
1417-1509): topology, OST-stripe workload, two-level aggregator
metadata, an engine, the correctness check. All run on the CUDA device
unless ``--device cpu`` is given; ``local`` and ``native`` and the
``tam`` engines other than ``sim`` are host engines, for which
``--device`` does not apply.

Examples::

    python -m tpu_aggcomm_torch.cli -m 1 -a 14 -d 2048 -c 3 --backend torch_sim --verify
    python -m tpu_aggcomm_torch.cli -n 8 -m 1 -a 3 -d 256 -c 2 --device cpu --verify
    python -m tpu_aggcomm_torch.cli -n 8 -m 1 -a 3 -d 256 -c 2 --fault slow:r2*4 --device cpu --verify
    python -m tpu_aggcomm_torch.cli -m 0 -a 14 -d 2048 -c 3 --backend cuda_fused --chained
    python -m tpu_aggcomm_torch.cli -m 1 -a 14 -d 2048 -c 3 --backend cuda_dma_conc --verify
    python -m tpu_aggcomm_torch.cli -m 2 -a 14 -d 2048 -c 3 --measured-phases --verify
    python -m tpu_aggcomm_torch.cli -m 15 -a 14 -d 2048 -p 4 --measured-phases --verify
    python -m tpu_aggcomm_torch.cli sweep -n 8 -a 3 -d 256 --comm-sizes 1,2,4 --device cpu --verify
    python -m tpu_aggcomm_torch.cli sweep -m 1 -a 14 -d 2048 --chained --verify --fault none --fault deadlink:5>3
    python -m tpu_aggcomm_torch.cli -n 8 -m 1 -a 3 -d 256 -c 2 --device cpu --verify --trace /tmp/t
    python -m tpu_aggcomm_torch.cli -m 1 -a 14 -d 2048 -c 3 --verify --xprof /tmp/xp
    python -m tpu_aggcomm_torch.cli tam -n 16 -p 4 -b 16 -t 1 -c 2 --mode 1 --engine local_agg
    python -m tpu_aggcomm_torch.cli tam -n 16384 -p 64 -b 16 -t 0 --engine sim --chained
"""

from __future__ import annotations

import argparse
import sys

from tpu_aggcomm_torch.backends.registry import BACKENDS, HOST_BACKENDS

__all__ = ["main", "build_parser", "THETA_COMM_SIZES"]

#: the throttle grid of the reference's job scripts (script_theta_*.sh)
THETA_COMM_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                    4096, 8192, 999_999_999)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpu_aggcomm_torch",
        description="aggregator-communication benchmark on one CUDA device "
                    "(the reference MPI ./test harness's run command; "
                    "'sweep' runs its throttle job scripts)")
    sub = ap.add_subparsers(dest="command")
    ap.add_argument("-n", "--nprocs", type=int, default=32,
                    help="logical ranks (reference: mpiexec -n); all of "
                         "them live on one device")
    ap.add_argument("-m", dest="method", type=int, default=0,
                    help="method id (0 = all dispatched methods)")
    ap.add_argument("-a", dest="cb_nodes", type=int, default=1,
                    help="number of aggregators (cb_nodes)")
    ap.add_argument("-d", dest="data_size", type=int, default=0,
                    help="message size in bytes")
    ap.add_argument("-c", dest="comm_size", type=int, default=200_000_000,
                    help="max in-flight messages per round (throttle)")
    ap.add_argument("-i", dest="iters", type=int, default=1,
                    help="outer experiment repetitions (fresh buffers)")
    ap.add_argument("-k", dest="ntimes", type=int, default=1,
                    help="timed reps inside one window (no resync)")
    ap.add_argument("-p", dest="proc_node", type=int, default=1,
                    help="ranks per (simulated) node")
    ap.add_argument("-t", dest="agg_type", type=int, default=1,
                    help="aggregator placement policy 0-3")
    ap.add_argument("-b", dest="barrier_type", type=int, default=0,
                    help="barrier mode for m=13 (0 none, 1 per rep, "
                         "2 per block)")
    ap.add_argument("--backend", choices=BACKENDS, default="torch_sim")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when "
                         "asked for (not read by the host oracles local "
                         "and native)")
    ap.add_argument("--verify", action="store_true",
                    help="deterministic-fill verification of every "
                         "delivered byte")
    ap.add_argument("--chained", action="store_true",
                    help="torch_sim/cuda_fused: serial-chained on-device "
                         "per-rep measurement (on the card the chain runs "
                         "as CUDA graph replays; differenced chain lengths "
                         "cancel the fixed per-call overhead)")
    ap.add_argument("--profile-rounds", action="store_true",
                    help="torch_sim: time each throttle round separately "
                         "(one launch sequence and synchronize per round, "
                         "host clock)")
    ap.add_argument("--measured-phases", action="store_true",
                    help="torch_sim, round-structured methods and TAM "
                         "m=15/16: MEASURED per-round / per-hop durations "
                         "via chained prefix-truncation differencing "
                         "(single-round schedules take the measured "
                         "post/deliver split); phase columns marked "
                         "'measured-rounds/-hops/-split...+attributed(...)' "
                         "in the provenance sidecar")
    ap.add_argument("--fault", default=None, metavar="SPEC",
                    help="fault-injection scenario, e.g. 'slow:r3*4.0', "
                         "'deadlink:5>2', 'deadagg:a1' (comma-joined); "
                         "schedules are repaired before any method runs "
                         "and torch_sim realizes the rest (slow-rank "
                         "delay loops, dead edges of unrepaired "
                         "schedules); refused on cuda_dma/cuda_dma_conc")
    ap.add_argument("--results-csv", default="results.csv")
    ap.add_argument("--trace", metavar="PREFIX", default=None,
                    help="flight recorder: write PREFIX.trace.jsonl "
                         "(structured events) and PREFIX.trace.json "
                         "(Chrome/Perfetto). Results CSVs and console "
                         "output are unchanged; off = zero overhead")
    ap.add_argument("--xprof", metavar="LOGDIR", default=None,
                    help="profile ONE extra rep per method under "
                         "torch.profiler into LOGDIR and print a "
                         "divergence report: device timeline (or "
                         "profiled host wall) vs the reconstructed "
                         "attribution rep — a cross-check only; the "
                         "timed path and the reconstructed cells are "
                         "untouched")

    # TAM workload harness — the reference's DEBUG driver
    # (lustre_driver_test.c:1417-1509, grammar "hp:b:n:t:r:c:")
    tam = sub.add_parser(
        "tam", help="hierarchical-engine workload harness: topology -> "
                    "synthetic workload -> aggregator metadata -> engine -> "
                    "correctness check (the reference's DEBUG driver)")
    tam.add_argument("-n", "--nprocs", type=int, default=8,
                     help="logical ranks (reference: mpiexec -n)")
    tam.add_argument("-p", dest="proc_node", type=int, default=4,
                     help="ranks per (simulated) node")
    tam.add_argument("-b", dest="blocklen", type=int, default=16,
                     help="message block unit size (sizes are 1 + rank %% b)")
    tam.add_argument("-t", dest="stripe", type=int, default=0,
                     choices=[0, 1, 2, 3],
                     help="workload type: 0 SAME (node proxies), 1 GREATER "
                          "(odd ranks), 2 LESS (first half), 3 ALL")
    tam.add_argument("-r", dest="rank_assignment", type=int, default=0,
                     choices=[0, 1],
                     help="node map: 0 contiguous, 1 round-robin")
    tam.add_argument("-c", dest="co", type=int, default=1,
                     help="local aggregators per node")
    tam.add_argument("-k", dest="ntimes", type=int, default=1,
                     help="timed engine repetitions")
    tam.add_argument("--mode", type=int, default=0, choices=[0, 1],
                     help="local-aggregator selection: 0 even spread, "
                          "1 superset of global aggregators")
    tam.add_argument("--engine",
                     choices=("proxy", "local_agg", "shared", "benchmark",
                              "jax", "shared_jax", "sim", "native",
                              "native2", "native3"),
                     default="proxy",
                     help="route: collective_write / _2 / _3 / _benchmark "
                          "oracles, the single-device proxy route (sim: "
                          "three fenced byte gathers on the card), or the "
                          "C++ threaded engines (native = proxy route, "
                          "native2 = two-level local-aggregator route, "
                          "native3 = shared-window route); jax and "
                          "shared_jax (the mesh programs) need one device "
                          "per rank and are refused by name")
    tam.add_argument("--chained", action="store_true",
                     help="engine sim only: serial-chained differenced "
                          "per-rep timing (CUDA graph replays on the card)")
    tam.add_argument("--reorder", action="store_true",
                     help="apply reorder_ranklist before the engine: deal "
                          "the destination list round-robin across nodes "
                          "so consecutive destinations sit on distinct "
                          "nodes (the reference driver's commented-out "
                          "flow, lustre_driver_test.c:1495-1499 — an "
                          "optional extension, not dispatched there)")
    tam.add_argument("--device", default="cuda",
                     help="engine sim only: cuda (default) or cpu")

    # sweep — the Theta job scripts (script_theta_*.sh:33-106)
    sw = sub.add_parser(
        "sweep", help="throttle sweep over the reference job-script grid "
                      "(-c in 1,2,4,...,8192,unthrottled); runs on "
                      "torch_sim on the card by default, where the "
                      "reference's sweep defaults to the local oracle")
    sw.add_argument("-n", "--nprocs", type=int, default=32)
    sw.add_argument("-m", dest="method", type=int, default=1,
                    help="method id (scripts use 1 / 2)")
    sw.add_argument("-a", dest="cb_nodes", type=int, default=4)
    sw.add_argument("-d", dest="data_size", type=int, default=2048)
    sw.add_argument("-i", dest="iters", type=int, default=5)
    sw.add_argument("-k", dest="ntimes", type=int, default=1)
    sw.add_argument("-p", dest="proc_node", type=int, default=1)
    sw.add_argument("-t", dest="agg_type", type=int, default=1)
    sw.add_argument("--backend", choices=BACKENDS, default="torch_sim",
                    help="default torch_sim on the card (a departure: the "
                         "reference's sweep defaults to --backend local; "
                         "the port's entry points run on the card)")
    sw.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sw.add_argument("--verify", action="store_true")
    sw.add_argument("--measured-phases", action="store_true",
                    help="torch_sim: measured per-round/per-hop rows per "
                         "sweep cell (one prefix-chain family per round "
                         "per cell; cells beyond MAX_MEASURED_ROUNDS fail "
                         "upfront)")
    sw.add_argument("--chained", action="store_true",
                    help="torch_sim/cuda_fused: serial-chained per-rep "
                         "measurement")
    sw.add_argument("--resume", action="store_true",
                    help="skip throttle values already recorded for this "
                         "config (the run journal first, checked against "
                         "this environment's manifest; then the sweep "
                         "sidecar; then the results CSV)")
    sw.add_argument("--results-csv", default="results.csv")
    sw.add_argument("--comm-sizes", type=str, default=None,
                    help="comma-separated throttle values (default: the "
                         "Theta grid 1,2,4,...,8192,999999999)")
    sw.add_argument("--fault", action="append", default=None,
                    metavar="SPEC",
                    help="fault scenario as an extra sweep axis "
                         "(repeatable): each occurrence reruns the whole "
                         "throttle grid under that scenario; the literal "
                         "'none' is the healthy baseline cell; recorded "
                         "in the resume sidecar and journal")
    sw.add_argument("--trace", metavar="PREFIX", default=None,
                    help="flight recorder over the whole sweep: one "
                         "PREFIX.trace.{jsonl,json} pair covering every "
                         "cell")
    # reference flags whose machinery is not ported yet (ROADMAP.md queue
    # A item 6): accepted so the refusal is named
    sw.add_argument("--auto", action="store_true",
                    help="not ported yet (refused by name)")
    sw.add_argument("--tune-root", default=None,
                    help="not ported yet (refused by name)")
    sw.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT", help="not ported yet (refused by name)")
    return ap


def _sweep_sidecar(csv_path: str) -> str:
    return csv_path + ".sweep.jsonl"


def _sweep_journal(csv_path: str) -> str:
    """The resilience run journal riding next to the legacy sidecar."""
    return csv_path + ".journal.jsonl"


def _sweep_key(nprocs, cb_nodes, data_size, method, iters, ntimes, agg_type,
               proc_node, backend, chained, measured_phases=False,
               fault=None, device="cuda") -> dict:
    """The reference's sweep key; the port stamps ``device`` only for a
    device backend run on the CPU, so a card sweep's keys are the
    reference's exactly and a CPU rehearsal never counts as a card
    cell."""
    key = {"nprocs": nprocs, "cb_nodes": cb_nodes, "data_size": data_size,
           "method": method, "iters": iters, "ntimes": ntimes,
           "agg_type": agg_type, "proc_node": proc_node,
           "backend": backend, "chained": bool(chained)}
    if measured_phases:
        # only stamped when set: older sidecar records (no key) keep
        # matching their non-measured sweeps exactly
        key["measured_phases"] = True
    if fault:
        # same back-compat rule: healthy cells never stamp the key
        key["fault"] = fault
    if device != "cuda" and backend not in HOST_BACKENDS:
        key["device"] = device
    return key


def _completed_throttles(csv_path: str, nprocs: int, cb_nodes: int,
                         data_size: int, method: int, iters: int,
                         ntimes: int, agg_type: int, proc_node: int = 1,
                         backend: str = "torch_sim",
                         chained: bool = False,
                         measured_phases: bool = False,
                         fault: str | None = None,
                         device: str = "cuda") -> set:
    """Throttle values already fully recorded for this sweep config, as
    the reference finds them (``tpu_aggcomm/cli.py:_completed_throttles``).

    Primary source: the sweep sidecar (``<results_csv>.sweep.jsonl``, one
    JSON line per completed throttle carrying the FULL run config). When
    the sidecar has seen this config family, only its exact-config
    matches count. Fallback for pre-sidecar CSVs: every required method
    name has >= iters rows at that comm size matching the parameters the
    reference CSV does carry (nprocs, cb_nodes, data_size, ntimes,
    agg_type). A faulted config never takes the fallback: the CSV cannot
    record a fault spec."""
    import csv
    import json
    import os
    from collections import Counter

    from tpu_aggcomm_torch.core.methods import METHODS, method_ids

    ids = method_ids() if method == 0 else [method]
    unknown = [m for m in ids if m not in METHODS]
    if unknown:
        raise SystemExit(f"unknown method id {unknown[0]}; valid ids: "
                         f"{sorted(METHODS)}")

    sidecar = _sweep_sidecar(csv_path)
    if os.path.exists(sidecar):
        key = _sweep_key(nprocs, cb_nodes, data_size, method, iters, ntimes,
                         agg_type, proc_node, backend, chained,
                         measured_phases, fault, device)
        family = (nprocs, cb_nodes, data_size, ntimes, agg_type)
        family_seen = False
        done = set()
        with open(sidecar) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                comm = rec.pop("comm", None)
                if comm is None:
                    continue
                try:
                    rec_family = (rec["nprocs"], rec["cb_nodes"],
                                  rec["data_size"], rec["ntimes"],
                                  rec["agg_type"])
                except KeyError:
                    continue
                family_seen = family_seen or rec_family == family
                if rec == key:
                    done.add(int(comm))
        if family_seen:
            return done

    if fault:
        return set()
    names = {METHODS[m].name for m in ids}
    try:
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
    except FileNotFoundError:
        return set()
    cfg = (nprocs, cb_nodes, data_size, ntimes, agg_type)
    cnt: Counter = Counter()
    comms = set()
    for r in rows:
        try:
            row_cfg = (int(r["# of processes"]), int(r["# of aggregators"]),
                       int(r["data size"]), int(r["ntimes"]),
                       int(r["aggregator type"]))
            name, comm = r["Method"], int(r["max comm"])
        except (KeyError, ValueError, TypeError):
            continue
        if row_cfg == cfg:
            cnt[(name, comm)] += 1
            comms.add(comm)
    return {c for c in comms if all(cnt[(n, c)] >= iters for n in names)}


def _parse_sweep_faults(specs) -> list:
    """The fault axis: canonical specs, None for the healthy cell
    (``none``, ``healthy`` or an empty spec)."""
    from tpu_aggcomm_torch.faults import FaultSpecError, parse_fault
    if not specs:
        return [None]
    faults: list = []
    for fs in specs:
        if fs.strip().lower() in ("", "none", "healthy"):
            faults.append(None)
            continue
        try:
            spec = parse_fault(fs)
        except FaultSpecError as e:
            raise SystemExit(f"sweep --fault: {e}")
        faults.append(None if spec.empty else spec.canonical())
    return faults


def _check_measured_depth(args, grid) -> None:
    """Validate the WHOLE grid's round depth before any cell runs: a
    mid-grid refusal after earlier cells recorded rows is the partial
    CSV the upfront guards exist to prevent."""
    from tpu_aggcomm_torch.core.methods import METHODS, compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.harness.chained import MAX_MEASURED_ROUNDS
    ids = ([args.method] if args.method else
           [m for m in METHODS if METHODS[m].dispatched])
    for c in grid:
        for m in ids:
            if METHODS[m].tam:
                continue
            sched = compile_method(m, AggregatorPattern(
                nprocs=args.nprocs, cb_nodes=args.cb_nodes,
                data_size=max(args.data_size, 1),
                proc_node=args.proc_node, comm_size=c,
                placement=args.agg_type))
            if sched.collective:
                continue
            depth = len({int(e[4]) for e in sched.data_edges()})
            if depth > MAX_MEASURED_ROUNDS:
                raise SystemExit(
                    f"--measured-phases: grid cell c={c} method {m} "
                    f"has {depth} throttle rounds (> "
                    f"{MAX_MEASURED_ROUNDS}); trim --comm-sizes or "
                    f"use --chained for the deep cells")


def _run_sweep(args) -> int:
    """One experiment per throttle value (and fault scenario); rows
    accumulate in results.csv exactly like repeated ``./test`` runs. The
    port of ``tpu_aggcomm/cli.py:_run_sweep``."""
    import json
    import time

    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    from tpu_aggcomm_torch.faults import FaultSpecError, RepairError
    from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,
                                                  run_experiment)
    from tpu_aggcomm_torch.obs import ledger
    from tpu_aggcomm_torch.resilience import (CancelledAtBoundary,
                                              RunJournal, check_boundary,
                                              safe_cancellation)

    for flag, on in (("--auto", args.auto),
                     ("--tune-root", args.tune_root),
                     ("--metrics-port", args.metrics_port is not None)):
        if on:
            raise NotPortedError(
                f"sweep {flag} is not ported to tpu_aggcomm_torch yet "
                f"(ROADMAP.md queue A item 6); run it on the reference "
                f"package")
    if args.comm_sizes:
        grid = [int(x) for x in args.comm_sizes.split(",") if x.strip()]
        if not grid:
            raise SystemExit("--comm-sizes: no valid throttle values")
    else:
        grid = list(THETA_COMM_SIZES)
    faults = _parse_sweep_faults(args.fault)
    if args.measured_phases and any(faults):
        raise SystemExit("sweep: --measured-phases is not supported with "
                         "--fault (round-prefix truncation would replay "
                         "the injected delay once per prefix); use "
                         "--chained for faulted cells")
    if args.measured_phases:
        _check_measured_depth(args, grid)

    def cell_key(fs, c) -> dict:
        key = _sweep_key(args.nprocs, args.cb_nodes, args.data_size,
                         args.method, args.iters, args.ntimes,
                         args.agg_type, args.proc_node, args.backend,
                         args.chained, args.measured_phases, fs,
                         args.device)
        key["comm"] = c
        return key

    # crash-safe run journal next to the legacy sweep sidecar: entries
    # carry the manifest fingerprint, so --resume re-runs (and NAMES the
    # drift) after a change of torch, CUDA or card
    journal = fp = man = None
    if args.results_csv:
        journal = RunJournal(_sweep_journal(args.results_csv))
        man = ledger.manifest()
        fp = journal.begin_session(man)
    try:
        with _tracing(args.trace), safe_cancellation():
            for fs in faults:
                cells = grid
                if args.resume:
                    done = _completed_throttles(
                        args.results_csv, args.nprocs, args.cb_nodes,
                        args.data_size, args.method, args.iters,
                        args.ntimes, args.agg_type, args.proc_node,
                        args.backend, args.chained, args.measured_phases,
                        fs, args.device)
                    skipped, todo, drift_msgs = [], [], []
                    for c in cells:
                        # the journal is authoritative for cells it has
                        # seen (fingerprint-checked); the sidecar and the
                        # CSV cover sweeps it has not
                        if journal is not None \
                                and journal.seen(cell_key(fs, c)):
                            ok, reason = journal.completed(
                                cell_key(fs, c), fingerprint=fp,
                                manifest=man)
                            (skipped if ok else todo).append(c)
                            if reason:
                                drift_msgs.append(
                                    f"resume: comm size {c}: {reason}")
                        elif c in done:
                            skipped.append(c)
                        else:
                            todo.append(c)
                    cells = todo
                    if skipped:
                        tag = f" [fault {fs}]" if fs else ""
                        print(f"resume: skipping already-recorded comm "
                              f"sizes {skipped}{tag}")
                    for msg in drift_msgs:
                        print(msg)
                for c in cells:
                    check_boundary(f"sweep:c{c}")
                    ftag = f" --fault {fs}" if fs else ""
                    print(f"RUN_OPTS: -a {args.cb_nodes} "
                          f"-d {args.data_size} -c {c} -m {args.method} "
                          f"-i {args.iters}{ftag}")
                    cfg = ExperimentConfig(
                        nprocs=args.nprocs, cb_nodes=args.cb_nodes,
                        method=args.method, data_size=args.data_size,
                        comm_size=c, iters=args.iters, ntimes=args.ntimes,
                        proc_node=args.proc_node, agg_type=args.agg_type,
                        backend=args.backend, device=args.device,
                        verify=args.verify, results_csv=args.results_csv,
                        chained=args.chained,
                        measured_phases=args.measured_phases, fault=fs)
                    t_cell = time.perf_counter()
                    try:
                        records = run_experiment(cfg)
                    except (FaultSpecError, RepairError) as e:
                        raise SystemExit(f"sweep --fault: {e}")
                    if args.results_csv:
                        # checkpoint: the completed throttle with its
                        # FULL config
                        with open(_sweep_sidecar(args.results_csv),
                                  "a") as f:
                            f.write(json.dumps(cell_key(fs, c)) + "\n")
                        journal.record(
                            cell_key(fs, c), fingerprint=fp,
                            status="done",
                            shape_keys=sorted({r["shape_key"]
                                               for r in records}),
                            artifacts=[args.results_csv],
                            wall_s=time.perf_counter() - t_cell)
    except CancelledAtBoundary as e:
        print(f"sweep: {e}", file=sys.stderr)
        return 130
    return 0


def _tracing(prefix):
    """Context manager enabling the flight recorder for one CLI run and
    flushing ``<prefix>.trace.{jsonl,json}`` on exit. ``prefix=None``
    (tracing off) is a no-op."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        if not prefix:
            yield
            return
        from tpu_aggcomm_torch.obs import trace
        trace.enable()
        try:
            yield
        finally:
            paths = trace.flush(prefix)
            trace.disable()
            if paths:
                print(f"trace written: {paths[0]} (events), "
                      f"{paths[1]} (Perfetto)")

    return cm()


def _run_tam(args) -> int:
    """The DEBUG-driver flow (lustre_driver_test.c:1417-1509):
    static_node_assignment -> initialize_setting -> aggregator_meta_information
    -> engine -> test_correctness. The port of ``tpu_aggcomm/cli.py:
    _run_tam``: every line but the timing values is the reference's. The
    ``sim`` engine runs on the card (``--device cpu`` on the CPU) and is
    checked in one vectorised pass over its flat delivery, which raises
    the VerificationError ``verify_all`` would; the mesh engines are
    refused by name before anything runs."""
    import time

    from tpu_aggcomm_torch.core.meta import aggregator_meta_information
    from tpu_aggcomm_torch.core.topology import static_node_assignment
    from tpu_aggcomm_torch.core.workload import StripeType, initialize_setting
    from tpu_aggcomm_torch.tam.workload_engines import (cw2_local_agg_jax,
                                                        cw3_shared_jax,
                                                        run_workload_engine)

    if args.engine in ("jax", "shared_jax"):
        refused = cw2_local_agg_jax if args.engine == "jax" \
            else cw3_shared_jax
        refused(None, None, None, None)
    na = static_node_assignment(args.nprocs, args.proc_node,
                                args.rank_assignment)
    wl = initialize_setting(na, args.blocklen, StripeType(args.stripe))
    # the reference's rank-0 config banner — FIRST line, byte-identical
    # to the DEBUG driver's printf (l_d_t.c:1454)
    print(f"blocklen = {args.blocklen}, nprocs_node = {args.proc_node}, "
          f"rank_assignment = {args.rank_assignment}, type = {args.stripe}, "
          f"co = {args.co}")
    if args.reorder:
        # reorder_ranklist before the engine (the reference driver's
        # commented-out call site, l_d_t.c:1495-1499): same destination
        # SET, node-interleaved ORDER — engines must handle an unsorted
        # destination list
        from dataclasses import replace as _replace

        from tpu_aggcomm_torch.core.pattern import reorder_ranklist
        new_order = reorder_ranklist(na.node_of, wl.aggregators, na.nnodes)
        wl = _replace(wl, aggregators=new_order)
        print(f"| reordered aggregators = "
              f"{', '.join(str(int(r)) for r in new_order)}")
    meta = aggregator_meta_information(na, wl.aggregators, args.co, args.mode)
    print(f"| nprocs = {args.nprocs}, nodes = {na.nnodes}, "
          f"aggregators = {len(wl.aggregators)}, "
          f"local aggregators = {len(meta.local_aggregators)}, "
          f"total bytes = {wl.total_bytes}")

    if args.engine == "native3":
        from tpu_aggcomm_torch.backends.native import run_workload_cw3
        recv, times = run_workload_cw3(wl, na, meta, ntimes=args.ntimes)
        wl.verify_all(recv)
        print(f"| engine = native shared-window (C++ threads), "
              f"reps = {len(times)}, min rep = {min(times):.6f} s")
    elif args.engine == "sim":
        from tpu_aggcomm_torch.tam.workload_engines import (proxy_route,
                                                            verify_recv_flat)
        flat, times = proxy_route(wl, na, ntimes=args.ntimes,
                                  device=args.device, chained=args.chained)
        verify_recv_flat(wl, flat)
        kind = "chained differenced" if args.chained else "per-dispatch"
        print(f"| engine = single-chip proxy route (compiled, {kind}), "
              f"reps = {len(times)}, min rep = {min(times):.6f} s")
    elif args.engine == "native":
        from tpu_aggcomm_torch.backends.native import run_workload_proxy
        recv, times = run_workload_proxy(wl, na, ntimes=args.ntimes)
        wl.verify_all(recv)
        print(f"| engine = native proxy (C++ threads), reps = {len(times)}, "
              f"min rep = {min(times):.6f} s")
    elif args.engine == "native2":
        from tpu_aggcomm_torch.backends.native import run_workload_cw2
        recv, times = run_workload_cw2(wl, meta, ntimes=args.ntimes)
        wl.verify_all(recv)
        print(f"| engine = native two-level (C++ threads), "
              f"reps = {len(times)}, min rep = {min(times):.6f} s")
    else:
        times = []
        stats = None
        for _ in range(max(args.ntimes, 1)):
            t0 = time.perf_counter()
            recv, stats = run_workload_engine(args.engine, wl, na, meta)
            times.append(time.perf_counter() - t0)
        wl.verify_all(recv)
        print(f"| engine = {args.engine}, reps = {len(times)}, "
              f"min rep = {min(times):.6f} s")
        print(f"| route bytes: gather = {stats.gather_bytes}, "
              f"exchange intra/inter = {stats.exchange_intra_bytes}/"
              f"{stats.exchange_inter_bytes}, "
              f"delivery = {stats.delivery_bytes}, "
              f"direct = {stats.direct_bytes}, staged = {stats.staged_bytes}")
    print("| correctness: PASSED")
    return 0


def _run(args) -> int:
    from tpu_aggcomm_torch.harness.runner import (ExperimentConfig,
                                                  run_experiment)
    cfg = ExperimentConfig(
        nprocs=args.nprocs, cb_nodes=args.cb_nodes, method=args.method,
        data_size=args.data_size, comm_size=args.comm_size, iters=args.iters,
        ntimes=args.ntimes, proc_node=args.proc_node, agg_type=args.agg_type,
        barrier_type=args.barrier_type, backend=args.backend,
        device=args.device, verify=args.verify,
        results_csv=args.results_csv, chained=args.chained,
        profile_rounds=args.profile_rounds,
        measured_phases=args.measured_phases, xprof=args.xprof,
        fault=args.fault)
    with _tracing(args.trace):
        run_experiment(cfg)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from tpu_aggcomm_torch.backends.cuda_dma import (DmaCapacityError,
                                                     DmaProtocolError)
    from tpu_aggcomm_torch.backends.cuda_fused import FusedBackendError
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    from tpu_aggcomm_torch.device import NoCudaDeviceError
    from tpu_aggcomm_torch.faults import FaultSpecError, RepairError
    from tpu_aggcomm_torch.native.fuse import UnfusableScheduleError
    try:
        if args.command == "tam":
            return _run_tam(args)
        if args.command == "sweep":
            return _run_sweep(args)
        return _run(args)
    except (FaultSpecError, RepairError) as e:
        # a malformed spec or an unrepairable fault is a usage error:
        # one line naming the offending token/edge, never a traceback
        raise SystemExit(f"--fault: {e}")
    except (NoCudaDeviceError, FusedBackendError, NotPortedError,
            DmaCapacityError, DmaProtocolError,
            UnfusableScheduleError) as e:
        # an environment or scope refusal: one line naming it, no traceback
        raise SystemExit(f"{type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.exit(main())
