"""Command-line interface, flag-compatible with the reference ``./test``.

The port of ``tpu_aggcomm/cli.py``'s ``run`` command: reference grammar
``"hp:c:m:d:a:i:k:t:b:"`` (mpi_test.c:2130-2166) plus ``-n`` (rank count;
the reference gets it from ``mpiexec -n``), ``--backend``, ``--verify``,
``--chained``, ``--profile-rounds``, ``--measured-phases``, ``--device``
and ``--results-csv``. It runs on the CUDA device unless ``--device cpu``
is given.

Examples::

    python -m tpu_aggcomm_torch.cli -m 1 -a 14 -d 2048 -c 3 --backend torch_sim --verify
    python -m tpu_aggcomm_torch.cli -n 8 -m 1 -a 3 -d 256 -c 2 --device cpu --verify
    python -m tpu_aggcomm_torch.cli -m 0 -a 14 -d 2048 -c 3 --backend cuda_fused --chained
    python -m tpu_aggcomm_torch.cli -m 1 -a 14 -d 2048 -c 3 --backend cuda_dma_conc --verify
    python -m tpu_aggcomm_torch.cli -m 2 -a 14 -d 2048 -c 3 --measured-phases --verify
    python -m tpu_aggcomm_torch.cli -m 15 -a 14 -d 2048 -p 4 --measured-phases --verify
"""

from __future__ import annotations

import argparse
import sys

from tpu_aggcomm_torch.backends.registry import BACKENDS

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpu_aggcomm_torch",
        description="aggregator-communication benchmark on one CUDA device "
                    "(the reference MPI ./test harness's run command)")
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
                         "asked for")
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
    ap.add_argument("--results-csv", default="results.csv")
    # reference flags whose machinery is not ported yet: accepted so the
    # refusal is named, never an argparse usage error
    ap.add_argument("--xprof", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from tpu_aggcomm_torch.backends.cuda_dma import (DmaCapacityError,
                                                     DmaProtocolError)
    from tpu_aggcomm_torch.backends.cuda_fused import FusedBackendError
    from tpu_aggcomm_torch.backends.torch_sim import NotPortedError
    from tpu_aggcomm_torch.device import NoCudaDeviceError
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
    try:
        run_experiment(cfg)
    except (NoCudaDeviceError, FusedBackendError, NotPortedError,
            DmaCapacityError, DmaProtocolError) as e:
        # an environment or scope refusal: one line naming it, no traceback
        raise SystemExit(f"{type(e).__name__}: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
