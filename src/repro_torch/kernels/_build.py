"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is compiled from the sources in this package into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch_kernels/`` at the repository root.
A library is keyed by a hash of its sources and the flags, so an edited
source builds anew and an unchanged one is reused. Nothing is built when
a module is imported: the first launch builds, and ``build()`` builds
every kernel at once (one nvcc per library, all started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"l2_gather": ("l2_gather/csrc/l2_gather.cu",),
           "pq_adc": ("pq_adc/csrc/pq_adc.cu",),
           "row_gather": ("row_gather/csrc/row_gather.cu",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc output (ptxas register report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _target(name: str) -> tuple[list[Path], Path]:
    srcs = [KERNELS_DIR / s for s in SOURCES[name]]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    return srcs, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile each named kernel library that is not built yet; raise
    with nvcc's output if one fails. Returns {name: nvcc output} (empty
    for a library that was already built)."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = [(name, *_target(name)) for name in names]
        todo = [t for t in todo if not t[2].exists()]
        nvcc = _nvcc() if todo else None
        procs = {}
        try:
            for name, srcs, so in todo:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs[name] = (so, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for name, (so, tmp, proc) in procs.items():
                out, _ = proc.communicate()
                build_logs[name] = out
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name} "
                                       f"(exit {proc.returncode}):\n{out}")
                os.replace(tmp, so)
        finally:
            for _, tmp, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return {name: build_logs.get(name, "") for name in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return lib
