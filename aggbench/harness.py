"""One run of one cell: set-up, the measured window, the traced slice,
and the judgement of what the window delivered.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``);
the traffic names the backend, whose adapter is ``backends/<name>.py``.
The metrics a cell reports are every ``end_to_end`` (``--trace 0``) or
``per_layer`` (``--trace 1``) metric of ``BENCHMARK.json`` whose
``workloads``, if it has the key, list the cell; each is read by
``metrics/<name>.py``.

The loop is closed, one caller: an exchange is one call of the
backend's rep on a send arena, then a synchronize; the next starts when
it has returned. The window takes each exchange's wall on the host
clock. A seeded reservoir keeps a sample of the window's outputs
(``sample_outputs``) with the arena each was made from; once the window
has closed, the peak memory read and the program's state dropped, every
kept output is judged against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from aggbench import payload, tracing
from aggbench.reference.exchange import wrong_slabs
from aggbench.reference.roles import roles as cell_roles

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_aggcomm")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / "aggbench"

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise LookupError(f"BENCHMARK.json has no {key} entry {name!r}; "
                          f"have {[e['name'] for e in self.spec[key]]}")

    def cell(self, workload: str) -> "Cell":
        w = self._entry("workloads", workload)
        cfg = self._entry("configs", w["config"])
        config = json.loads((self.root / cfg["file"]).read_text())
        traffic = self.traffic(w["traffic"])

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        return Cell(workload, w["chips"], config, traffic,
                    [m for m in self.spec["end_to_end"] if applies(m)],
                    [m for m in self.spec["per_layer"] if applies(m)])

    def traffic(self, name: str) -> dict:
        path = self.pkg / "traffic" / f"{name}.json"
        if not path.is_file():
            raise LookupError(f"no traffic file {path}")
        return json.loads(path.read_text())

    def plugin(self, kind: str, name: str):
        """``aggbench/<kind>/<name>.py`` as module ``aggbench.<kind>.<name>``.
        A metric split by a suffix (``host_dispatch_us.theta``) is read by
        its own file if it has one, else by its quantity's
        (``host_dispatch_us.py``)."""
        path = self.pkg / kind / f"{name}.py"
        if kind == "metrics" and not path.is_file() and "." in name:
            name = name.split(".", 1)[0]
            path = self.pkg / kind / f"{name}.py"
        modname = f"aggbench.{kind}.{name}"
        if modname in sys.modules:
            return sys.modules[modname]
        if not path.is_file():
            have = sorted(p.stem for p in (self.pkg / kind).glob("*.py")
                          if p.stem != "__init__")
            raise LookupError(f"no {kind} file {path}; have {have}")
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class Record:
    """What one run measured; the metric readers' input."""

    config: dict
    device_kind: str
    setup_s: float = 0.0
    split: dict = field(default_factory=dict)
    window_s: float = 0.0
    exchanges: int = 0
    walls_s: list = field(default_factory=list)
    dispatch_s: list | None = None
    profile: dict | None = None
    memory_peak_bytes: int = 0


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``rng`` (Li's algorithm L: one comparison for most items)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.kept = k, rng, []
        self.w = math.exp(math.log(self._u()) / k)
        self.next = k + int(math.log(self._u()) / math.log(1 - self.w))

    def _u(self) -> float:
        u = 0.0
        while u == 0.0:
            u = self.rng.random()
        return u

    def offer(self, i: int, item) -> None:
        if i < self.k:
            self.kept.append(item)
        elif i == self.next:
            self.kept[self.rng.randrange(self.k)] = item
            self.w *= math.exp(math.log(self._u()) / self.k)
            self.next += int(math.log(self._u()) / math.log(1 - self.w)) + 1


def loaded_forbidden() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Session:
    """A cell's program, built once: imports, CUDA init, the kernel
    library, the schedule and tables. :meth:`measure` then runs one seed.
    ``backend`` puts another adapter in the traffic's (the control)."""

    def __init__(self, bench: Bench, workload: str, device="cuda",
                 backend: str | None = None, t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.cell = bench.cell(workload)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        tr = self.cell.traffic
        self.roles = cell_roles(self.cell.config, tr["direction"])
        mod = bench.plugin("backends", backend or tr["backend"])
        self.adapter = mod.Adapter(self.cell.config, tr, self.roles,
                                   self.device)
        split = {"import_s": time.perf_counter() - self.t0}
        mark = time.perf_counter()
        if cuda:
            torch.zeros(1, device=self.device)
            self.sync()
        split["cuda_init_s"] = time.perf_counter() - mark
        mark = time.perf_counter()
        self.adapter.library()
        split["library_s"] = time.perf_counter() - mark
        mark = time.perf_counter()
        self.adapter.build()
        self.sync()
        split["tables_s"] = time.perf_counter() - mark
        self.split = split
        self.kind = (torch.cuda.get_device_name(self.device) if cuda
                     else "cpu")

    def _arenas(self, seed: int) -> list:
        r, ad = self.roles, self.adapter
        arenas = []
        for k in range(self.cell.traffic["send"]["arenas"]):
            arena = ad.new_send()
            for i0, i1, block in payload.blocks(
                    seed, k, len(r.senders), len(r.receivers), r.data_size,
                    self.device):
                ad.put_send(arena, i0, i1, block)
            arenas.append(arena)
        self.sync()
        return arenas

    def measure(self, seed: int, seconds: float, trace: bool,
                release: bool = True):
        """One run: send fill, warm-up, the window, the traced slice when
        ``trace``, then the judgement. Returns ``(record, checks,
        failed)``; ``release`` drops the program before judging."""
        tr, ad, sync = self.cell.traffic, self.adapter, self.sync
        rec = Record(self.cell.config, self.kind, split=dict(self.split))
        mark = time.perf_counter()
        arenas = self._arenas(seed)
        rec.split["send_s"] = time.perf_counter() - mark

        mark = time.perf_counter()
        k = tr["sample_outputs"]
        held = []
        for i in range(tr["warmup_exchanges"] + k):
            held.append(ad.rep(arenas[i % len(arenas)]))
            held = held[-k:]
            sync()
        del held
        rec.split["warmup_s"] = time.perf_counter() - mark

        rep, narenas = ad.rep, len(arenas)
        sample = Reservoir(k, random.Random(seed))
        walls = rec.walls_s
        dispatch = [] if trace else None
        perf = time.perf_counter
        i = 0
        start = perf()
        rec.setup_s = start - self.t0
        deadline = start + seconds
        while True:
            t0 = perf()
            out = rep(arenas[i % narenas])
            if dispatch is not None:
                dispatch.append(perf() - t0)
            sync()
            t1 = perf()
            walls.append(t1 - t0)
            sample.offer(i, (i % narenas, out))
            del out
            i += 1
            if t1 >= deadline:
                break
        rec.window_s, rec.exchanges, rec.dispatch_s = t1 - start, i, dispatch

        if trace:
            rec.profile = tracing.profile_slice(
                rep, arenas, tr["profile_skip"], tr["profile_exchanges"],
                sync)
        if self.device.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        health = ad.health()
        del arenas, rep
        if release:
            ad.close()
        mark = time.perf_counter()
        bad = stray = failed = 0
        kept = sample.kept
        judged = len(kept)
        while kept:
            arena, out = kept.pop()
            b = wrong_slabs(ad.recv_view(out), seed, arena,
                            len(self.roles.senders),
                            len(self.roles.receivers), self.roles.data_size)
            s = ad.stray_bytes(out)
            del out
            bad, stray, failed = bad + b, stray + s, failed + (b + s > 0)
        sync()
        rec.split["reference_s"] = time.perf_counter() - mark
        checks = {"judged": {"value": judged, "min": 1},
                  "wrong_slabs": {"value": bad, "limit": 0},
                  "stray_bytes": {"value": stray, "limit": 0}}
        for name, value in health.items():
            checks[name] = {"value": value, "limit": 0}
        return rec, checks, failed


def passed(checks: dict) -> bool:
    return all(c["value"] >= c["min"] if "min" in c
               else c["value"] <= c["limit"] for c in checks.values())


def result(bench: Bench, cell: Cell, rec: Record, checks: dict,
           failed: int, trace: bool) -> dict:
    """The result line: the cell's metrics for the mode, read from the
    record; ``checks`` last."""
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = bench.plugin("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if rec.device_kind != "cpu" else "cpu",
              "kind": rec.device_kind, "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": passed(checks), "attempted": rec.exchanges,
           "failed": failed, "metrics": metrics, "device": device}
    if trace and rec.profile:
        device["busy_s"] = rec.profile["busy_s"]
        device["window_s"] = rec.profile["window_s"]
        out["breakdown"] = {"device_ops": rec.profile["device_ops"],
                            "idle_gaps": rec.profile["idle_gaps"]}
    out["checks"] = checks
    return out


def check_lines(checks: dict) -> list[str]:
    return [f"check {name} {c['value']} "
            + (f"min {c['min']}" if "min" in c else f"limit {c['limit']}")
            for name, c in checks.items()]
