"""Headline benchmark on one CUDA card, printing ONE JSON line.

``python -m tpu_aggcomm_torch.bench``

The port of ``bench.py``'s measurement: the reference README's flagship
all-to-many exchange (32 ranks x 14 aggregator slabs x 2048 B; baseline
0.029803 s per rep, reference README.md:64) run as kernel K1
(``csrc/exchange.cu``) on the card. The 32 logical ranks live on the
device as a leading axis, and one rep is the slab exchange
send[rank, slab] -> recv[aggregator, source] with aggregator rows in
ascending rank order, XOR-perturbed by the rep index so serial reps are
irreducible.

Correctness is checked three ways before anything is timed: (1) one
rep's row layout against an independent rank -> aggregator mapping
(``p.agg_index``), (2) the whole 9-rep chain replayed exactly on the host
in numpy, (3) the kernel chain against the plain torch chain on the card,
byte for byte.

Measurement: reps run strictly serially (rep r+1 reads rep r's output),
a whole chain is ONE kernel launch (a grid-wide barrier between reps, as
the reference's chain is one ``lax.scan`` inside one jitted program),
completion is forced by a checksum readback, and the fixed per-chain
overhead (launch, readback) cancels by differencing two chain lengths
(harness/chained.py). The value is therefore the device time per rep of
a chain running on the card, not a host launch rate. ``kernel_launches``
counts chain launches and ``reps`` the reps they ran; ``manifest`` and
``compile_seconds`` are the reference's run-ledger fields.

There is no CPU fallback: without a card the line is
``{"metric": ..., "error": ...}`` and the exit code is 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np

BASELINE_S = 0.029803   # reference README.md:64, all-to-many max total time
PROCS, CB_NODES, DATA_SIZE = 32, 14, 2048
ITERS_SMALL, ITERS_BIG = 2000, 102000
TRIALS = 5
WINDOWS = 3
VERIFY_ITERS = 9
METRIC = (f"all_to_many max total time per rep "
          f"(n={PROCS} a={CB_NODES} d={DATA_SIZE})")


class CorrectnessError(Exception):
    """The exchange produced wrong bytes (immune to ``python -O``)."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise CorrectnessError(msg)


def power_limit_w() -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def measure() -> dict:
    """Run the checks and the differenced timing on the CUDA card;
    returns the JSON record. Raises ``NoCudaDeviceError`` without a
    card."""
    import torch

    from tpu_aggcomm_torch.backends.cuda_local import (exchange,
                                                       exchange_chain,
                                                       exchange_plain,
                                                       host_replay,
                                                       make_chain)
    from tpu_aggcomm_torch.backends.lanes import from_reference, to_reference
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.device import resolve_device
    from tpu_aggcomm_torch.harness.chained import differenced_trials
    from tpu_aggcomm_torch.obs import ledger

    dev = resolve_device("cuda")
    p = AggregatorPattern(nprocs=PROCS, cb_nodes=CB_NODES,
                          data_size=DATA_SIZE, comm_size=3)
    W = DATA_SIZE // 4
    torch.cuda.reset_peak_memory_stats(dev)
    exchange.launches = 0
    exchange.reps = 0
    send_np = np.arange(PROCS * CB_NODES * W, dtype=np.uint32).reshape(
        PROCS, CB_NODES, W)
    send0 = from_reference(send_np, dev)

    # correctness 1: one rep's placement semantics against an independent
    # mapping — after one rep (XOR word 0 = identity), recv row j must
    # hold, for every source r, the slab addressed to the j-th aggregator
    # by rank order (slab index = agg_index of that aggregator rank)
    recv1 = to_reference(exchange_chain(p, send0, 1)).reshape(
        CB_NODES, PROCS, W)
    agg_index = np.asarray(p.agg_index)
    for j, a in enumerate(sorted(int(x) for x in p.rank_list)):
        _check(np.array_equal(recv1[j], send_np[:, agg_index[a]]),
               f"aggregator row {j} (rank {a}) has wrong slabs")

    # correctness 2: exact replay of the whole chain on the host
    got = to_reference(exchange_chain(p, send0, VERIFY_ITERS))
    _check(np.array_equal(got, host_replay(p, send_np, VERIFY_ITERS)),
           "chained exchange produced wrong slabs")

    # correctness 3: kernel chain vs the plain torch chain, on the card
    plain = to_reference(exchange_chain(p, send0, VERIFY_ITERS,
                                        step=exchange_plain))
    _check(np.array_equal(got, plain), "kernel chain != plain chain")

    per_reps = differenced_trials(lambda it: make_chain(p, it), send0,
                                  iters_small=ITERS_SMALL,
                                  iters_big=ITERS_BIG, trials=TRIALS,
                                  windows=WINDOWS)
    per_rep = statistics.median(per_reps)
    return {
        "metric": METRIC,
        "value": per_rep,
        "unit": "s",
        "vs_baseline": BASELINE_S / per_rep,
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(dev),
        "power_limit_w": power_limit_w(),
        "samples": per_reps,
        "hbm_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
        "kernel_launches": exchange.launches,
        "reps": exchange.reps,
        # the reference's parsed-schema v3 fields: the environment the
        # value was taken on (torch, CUDA, nvcc, the card) and the host
        # walls of the chain's warm-up (kernel build included)
        "manifest": ledger.manifest(device=dev),
        "compile_seconds": ledger.total_compile_seconds(),
    }


def main() -> int:
    from tpu_aggcomm_torch.device import NoCudaDeviceError
    try:
        rec = measure()
    except (NoCudaDeviceError, CorrectnessError) as e:
        print(json.dumps({"metric": METRIC, "value": None, "unit": "s",
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(rec))
    gbps = PROCS * CB_NODES * DATA_SIZE / rec["value"] / 1e9
    print(f"# effective bandwidth: {gbps:.2f} GB/s pattern-bytes on "
          f"{rec['device_kind']} ({rec['power_limit_w']} W limit); "
          f"trials(us/rep)={[t * 1e6 for t in rec['samples']]}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
