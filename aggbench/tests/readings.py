"""A test helper, run on the card by hand: readings for the limits of
``correct``, the program's and the control's compared numbers over many
seeds, each seed a short window at the cell's own size, in one process.

    python3 -m aggbench.tests.readings --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--backend control]

Without ``--backend`` the cell's own program runs, built once for every
seed (its set-up is paid once); ``--backend control`` puts the control
(:mod:`aggbench.backends.control`, the plain exchange with self slabs
left out) in its place. One JSON line a seed: the seed, the exchanges of
its window and its seconds, ``correct`` and the numbers compared. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m aggbench.tests.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from aggbench import harness

    bench = harness.Bench()
    session = harness.Session(bench, args.workload, args.device,
                              backend=args.backend)
    print(f"# setup {json.dumps(session.split)}", flush=True)
    for seed in args.seeds:
        rec, checks, failed = session.measure(seed, args.seconds, False,
                                              release=False)
        print(json.dumps({"seed": seed, "exchanges": rec.exchanges,
                          "window_s": rec.window_s,
                          "correct": harness.passed(checks),
                          "failed": failed, "checks": checks}), flush=True)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"aggbench: loaded {forbidden}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
