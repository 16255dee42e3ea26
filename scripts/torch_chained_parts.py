#!/usr/bin/env python3
"""The port's chained per-rep time at the README shape, beside its parts,
on one CUDA card.

Run from the repository root, against the tree whose ``tpu_aggcomm_torch``
is first on ``PYTHONPATH`` (this script's own directory comes first on
``sys.path``, so the package is found through ``PYTHONPATH``)::

    env PYTHONPATH=. python scripts/torch_chained_parts.py --label change
    env PYTHONPATH=path/to/other/tree python scripts/torch_chained_parts.py --label parent

It prints the card's name and power limit (``nvidia-smi``) and one JSON
line. Times are microseconds, m=1 at n=32 a=14 d=2048 c=3:

- ``chained_us``: ``measure_per_rep`` on ``torch_sim`` and ``cuda_fused``
  (serial chains of 50 and 1050 reps differenced, median of three trials:
  what ``cli run --chained`` reports), with each trial's sample;
- ``k2_graph_us``: one K2 launch (``fused_rep``), device time: 50
  launches captured in one CUDA graph and replayed;
- ``sim_rep_graph_us``: one ``torch_sim`` rep, device time, the same way;
- ``token_xor_graph_us``: the chain's token and XOR alone, after a K2 rep,
  the tree's own operations (``chain_step``'s in-place XOR of a word from
  a table and its device rep counter where the tree has it, else the word
  XOR of ``xor_word``), 50 in one CUDA graph, replayed.

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def graph_us(fn, iters: int = 50, replays: int = 5) -> float:
    """Device microseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, one replay to warm up, then CUDA events over
    ``replays`` replays."""
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
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e3 / (replays * iters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_chained_parts: no CUDA device", file=sys.stderr)
        return 2
    import tpu_aggcomm_torch
    from tpu_aggcomm_torch.backends.cuda_fused import CudaFusedBackend
    from tpu_aggcomm_torch.backends.torch_sim import TorchSimBackend
    from tpu_aggcomm_torch.core.methods import compile_method
    from tpu_aggcomm_torch.core.pattern import AggregatorPattern
    from tpu_aggcomm_torch.harness import chained

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    s = compile_method(1, AggregatorPattern(32, 14, data_size=2048,
                                            comm_size=3))
    n_recv = s.pattern.nprocs
    out = {"label": args.label, "package": tpu_aggcomm_torch.__file__,
           "card": smi, "chained_us": {}, "samples_us": {}}
    reps = {}
    for name, cls in (("torch_sim", TorchSimBackend),
                      ("cuda_fused", CudaFusedBackend)):
        b = cls(device="cuda")
        out["chained_us"][name] = b.measure_per_rep(s) * 1e6
        out["samples_us"][name] = [v * 1e6 for v in b.last_samples]
        reps[name] = (b.one_rep(s), b._global_send(s.pattern, 0))

    k2, send = reps["cuda_fused"]
    sim, _ = reps["torch_sim"]
    out["k2_graph_us"] = graph_us(lambda: k2(send))
    out["sim_rep_graph_us"] = graph_us(lambda: sim(send))

    recv = k2(send)
    carry = send.clone()
    if hasattr(chained, "chain_step"):
        r = torch.zeros((), dtype=torch.int64, device=send.device)

        def token_xor():
            chained.chain_step(carry, recv, n_recv, r)
            r.add_(1)
        out["token_xor_ops"] = "chain_step (word-table XOR, device counter)"
    else:
        held = [carry, 0]

        def token_xor():
            tok = chained.chain_token(recv, n_recv, held[1])
            held[0] = held[0] ^ chained.xor_word(tok, carry.dtype)
            held[1] += 1
        out["token_xor_ops"] = "chain_token + xor_word (word XOR)"
    out["token_xor_graph_us"] = graph_us(token_xor)
    out["parts_us"] = out["k2_graph_us"] + out["token_xor_graph_us"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
