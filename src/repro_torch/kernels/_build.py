"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is compiled from the sources in this package into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch_kernels/`` at the repository root.
A library is keyed by a hash of its sources and the flags, so an edited
source builds anew and an unchanged one is reused. Nothing is built when
a module is imported: the first launch builds, and ``build()`` builds
every kernel at once (one nvcc per library, all started together).
``launch`` calls a library's C entry point on a tensor's card.

``HOST_SOURCES`` are host loops of the port (sources under the package,
not under ``kernels/``), built the same way with the host's C++ compiler
and loaded with ``load``; ``build()`` builds them only when named.
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
SOURCES = {"e_in_count": ("e_in_count/csrc/e_in_count.cu",),
           "l2_gather": ("l2_gather/csrc/l2_gather.cu",),
           "pq_adc": ("pq_adc/csrc/pq_adc.cu",),
           "row_gather": ("row_gather/csrc/row_gather.cu",),
           "topk_merge": ("topk_merge/csrc/topk_merge.cu",)}
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
HOST_SOURCES = {"reverse_edges": ("core/csrc/reverse_edges.cpp",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # compiler output (ptxas register report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or g++) found: the port's "
                           "host loops build only where one is installed")
    return cxx


def _recipe(name: str):
    """(compiler lookup, flags, sources) of library ``name``."""
    if name in HOST_SOURCES:
        return (_cxx, CXX_FLAGS,
                [KERNELS_DIR.parent / s for s in HOST_SOURCES[name]])
    return _nvcc, NVCC_FLAGS, [KERNELS_DIR / s for s in SOURCES[name]]


def _target(name: str) -> tuple[list[Path], Path]:
    _, flags, srcs = _recipe(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.read_bytes())
    return srcs, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile each named library (by default every CUDA kernel) that is
    not built yet; raise with the compiler's output if one fails. Returns
    {name: compiler output} (empty for a library that was already
    built)."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        todo = [(name, *_target(name)) for name in names]
        todo = [t for t in todo if not t[2].exists()]
        cmds = {}
        for name, _, _ in todo:
            compiler, flags, _ = _recipe(name)
            cmds[name] = [compiler(), *flags]
        procs = {}
        try:
            for name, srcs, so in todo:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                procs[name] = (so, tmp, subprocess.Popen(
                    [*cmds[name], "-o", str(tmp), *map(str, srcs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for name, (so, tmp, proc) in procs.items():
                out, _ = proc.communicate()
                build_logs[name] = out
                if proc.returncode != 0:
                    raise RuntimeError(f"{cmds[name][0]} failed for {name} "
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
    """The library ``name`` (a kernel or a host loop), built on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return lib


def launch(name: str, fns, device, *args) -> None:
    """Call kernel ``name``'s C entry point (``fns`` is its (launch,
    error string) pair) as ``launch(*args, stream)`` on ``device``'s
    current stream, with ``device`` the current card for the call alone:
    the calling thread's current card is the same afterwards, so one
    thread can drive several cards. Raises on a CUDA error."""
    import torch
    fn, err = fns
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name} launch failed: {err(code).decode()} "
                           f"(cudaError {code})")
