"""Build and load the port's CUDA kernels.

Every ``*.cu`` source listed in :data:`SOURCES` has a plain C interface.
``nvcc`` compiles each one for ``sm_90a`` into an object, all of them in
parallel (one ``nvcc`` per source, started together), then links the
objects into ONE shared library under ``build/torch_kernels/`` at the
repository root, loaded with :mod:`ctypes`. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged tree reuses the library. A failed build or load raises
:class:`KernelBuildError`; nothing falls back.

Nothing here runs at import: the CPU test suite imports every module of
the port on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "KernelBuildError", "build", "load",
           "ptxas_report"]

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "torch_kernels"

#: the kernel sources in this directory, one object each
SOURCES = ("exchange.cu", "fused_rep.cu", "dma_steps.cu", "signal_probe.cu",
           "slow_delay.cu", "deliver_rows.cu")
#: headers the sources include; part of the library's hash
HEADERS = ("sync.cuh", "rows.cuh")

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler",
                 "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """The CUDA kernel library could not be built or loaded."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda): the port's CUDA kernels build on a host with "
        "the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libaggcomm_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: dict) -> dict:
    """Start every command at once; wait for all; raise naming each
    failure. Returns ``{key: combined output}``."""
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, cmd in cmds.items()}
    logs, failures = {}, []
    for k, proc in procs.items():
        logs[k], _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{k} (nvcc exit {proc.returncode}):\n"
                            f"{logs[k][-4000:]}")
    if failures:
        raise KernelBuildError("kernel build failed: " + "\n".join(failures))
    return logs


def build() -> Path:
    """Build the library if it is missing and return its path. Each
    source's ``-Xptxas -v`` report is kept beside the library."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES}
    logs = _run_all({src: [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj),
                           str(CSRC / src)]
                     for src, obj in objs.items()})
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    _run_all({"link": [nvcc, *ARCH, "-shared", "-o", str(tmp),
                       *map(str, objs.values())]})
    lib.with_suffix(".ptxas.txt").write_text(
        "".join(f"== {src}\n{logs[src]}" for src in SOURCES))
    os.replace(tmp, lib)
    for obj in objs.values():
        obj.unlink()
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing."""
    path = build()
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e


def ptxas_report() -> list[str]:
    """The ``ptxas info`` lines of the current build: registers, shared
    memory and spills per kernel instantiation."""
    path = library_path().with_suffix(".ptxas.txt")
    if not path.exists():
        return []
    return [ln.strip() for ln in path.read_text().splitlines()
            if "ptxas info" in ln or "spill" in ln]
