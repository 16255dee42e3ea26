"""The Theta flagship shape on one CUDA card through the sharded tier.

The reference's defining configuration is 16,384 ranks x 256 aggregators
(script_theta_all_to_many_256.sh:3,11). This runs that exact rank and
aggregator count on one card through ``torch_shard`` with no process
group (the single-device block lowering): its compacted send/recv
layouts (rows only for ranks that send or receive) are what fit the
4.19M-slab pattern, where ``torch_sim``'s dense per-rank recv arena
would need about 34 GB at d=256.

The argv and the cells are ``scripts/tpu_flagship.py``'s. With no
arguments: n=16384 a=256 d=256, m=1 unthrottled, m=1 ``-c 2048`` (8
rounds, the Theta grid's deep-throttle point), m=8 dense, and m=15 TAM
(``-p 64``, the Theta ranks per node) on the blocked two-level engine's
chain. ``N A D [c ...]`` runs exactly the m=1 cells at those throttles,
e.g. ``16384 256 2048 999999999`` (the full Theta payload: 8.59 GB send
and recv arenas) or ``4096 256 2048 999999999 1024 64``.

Every cell is verified (each of its slabs byte-checked on the host) and
chained-timed with the serial-chain differenced scaffold (CUDA graph
replays; chains of 10 and 110 reps, 2 trials, 2 windows, as the
reference's script), and prints one ``# cell {json}`` line: the chained
per-rep time, the ``torch_shard`` roofline floor of a chained rep (on
one card a row-delivery launch a round; the rep's bytes plus the token
and XOR at 3.35 TB/s) and the ratio, the
peak device memory of the plain rep and of the chain, and the host
seconds of the schedule build, the tables, the rep and read-back, and
the verification. The card's name and power limit come first and last.

    python scripts/torch_flagship.py
    python scripts/torch_flagship.py 16384 256 2048 999999999
    python scripts/torch_flagship.py 4096 256 2048 999999999 1024 64

Run from the repository root (or with it on ``PYTHONPATH``); it needs a
CUDA card.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# default: the exact Theta rank/aggregator shape at d=256; override with
# `N A D [c ...]`, which runs EXACTLY the requested m=1 cells
N, A, D = 16384, 256, 256
CELLS = [(1, 999_999_999), (1, 2048), (8, 999_999_999)]
TAM_CELL = True
if len(sys.argv) > 3:
    N, A, D = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    cs = [int(c) for c in sys.argv[4:]] or [999_999_999]
    CELLS = [(1, c) for c in cs]
    TAM_CELL = False
elif len(sys.argv) > 1:
    sys.exit(f"usage: {sys.argv[0]} [N A D [c ...]] — need all of N A D")

CHAIN = dict(iters_small=10, iters_big=110, trials=2, windows=2)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cell(backend, m: int, c: int, p_node: int = 1) -> dict:
    """Build, run, verify and chain-time one cell; its ``# cell`` row."""
    import torch

    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.harness import roofline
    from tpu_aggcomm_torch.harness.verify import verify_recv

    p = AggregatorPattern(nprocs=N, cb_nodes=A, data_size=D, comm_size=c,
                          proc_node=p_node)
    t0 = time.perf_counter()
    sched = compile_method(m, p)
    row = dict(m=m, n=N, a=A, d=D, c=c, p=p_node,
               compile_s=time.perf_counter() - t0)
    tam = m in (15, 16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if tam:
        # one verified rep seeds the blocked engine's chain (tables and
        # rep inside), as the reference's TAM cell
        t0 = time.perf_counter()
        _recv, timers = backend.run(sched, ntimes=1, verify=True,
                                    chained=True)
        row.update(run_verify_chain_s=time.perf_counter() - t0,
                   per_rep_s=timers[0].total_time)
        rb = roofline.tam_rep_bytes(sched, lowering="torch_shard")
    else:
        t0 = time.perf_counter()
        built = backend._compiled(sched)
        row["tables_s"] = time.perf_counter() - t0
        row["rounds"] = len(built.rounds)
        t0 = time.perf_counter()
        recv, _timers = backend.run(sched, ntimes=1, verify=False)
        row["rep_readback_s"] = time.perf_counter() - t0
        row["rep_peak_bytes"] = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        verify_recv(sched.pattern, recv, 0)
        row["verify_s"] = time.perf_counter() - t0
        del recv
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row["per_rep_s"] = backend.measure_per_rep(sched, **CHAIN)
        row["chain_s"] = time.perf_counter() - t0
        row["samples_s"] = list(backend.last_samples)
        rb = roofline.rep_bytes(sched, lowering="torch_shard")
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    chained = rb.total() + roofline.chain_overhead_bytes(
        sched, lowering="torch_shard")
    row.update(bytes_per_rep=chained,
               floor_s=roofline.floor_seconds(chained),
               rep_floor_s=rb.floor_seconds())
    row["ratio"] = row["per_rep_s"] / row["floor_s"]
    row["gb_per_s_payload"] = N * A * D / row["per_rep_s"] / 1e9
    return row


def main() -> int:
    import torch

    from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend

    card = smi()
    print(card, flush=True)
    print(f"# device {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    backend = TorchShardBackend("cuda")
    rows = []
    todo = [(m, c, 1) for m, c in CELLS] + ([(15, 999_999_999, 64)]
                                             if TAM_CELL else [])
    for m, c, p_node in todo:
        row = cell(backend, m, c, p_node)
        rows.append(row)
        print(f"m={m} c={c}{f' p={p_node}' if p_node > 1 else ''}: "
              f"verified {N}x{A} d={D}; chained "
              f"{row['per_rep_s'] * 1e3:.3f} ms/rep, floor "
              f"{row['floor_s'] * 1e3:.3f} ms/rep (ratio "
              f"{row['ratio']:.2f}), {row['gb_per_s_payload']:.1f} GB/s "
              f"payload, peak {row['peak_bytes'] / 1e9:.2f} GB", flush=True)
        print("# cell " + json.dumps(row), flush=True)
        if row["floor_s"] >= row["per_rep_s"]:
            print(f"FAILED: floor not below the measured time: {row}",
                  file=sys.stderr)
            return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
