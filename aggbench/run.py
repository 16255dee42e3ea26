"""Run one cell of the benchmark and print its result line.

    python3 -m aggbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json`` and the
port. Exits 2 without the CUDA devices the cell asks for and 3 if JAX or
the JAX package was loaded, printing no result; otherwise the last line
of standard output is the result's JSON and the last lines of standard
error the numbers compared, each beside its limit.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``perf_counter`` reading at which this process started (from
    ``/proc``, to 10 ms), or now where ``/proc`` cannot tell."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aggbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from aggbench import harness

    bench = harness.Bench()
    cell = bench.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"aggbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    session = harness.Session(bench, args.workload, "cuda", t0=T0)
    rec, checks, failed = session.measure(args.seed, args.seconds,
                                          bool(args.trace))
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"aggbench: loaded {forbidden}, which the benchmark's "
              f"process must not", file=sys.stderr)
        return 3
    out = harness.result(bench, cell, rec, checks, failed, bool(args.trace))
    print("# setup " + json.dumps(rec.split), flush=True)
    print("\n".join(harness.check_lines(checks)), file=sys.stderr,
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
