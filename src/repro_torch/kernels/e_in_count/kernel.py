"""Wrapper of the Hopper ``e_in_count`` kernel (``csrc/e_in_count.cu``).

Replaces no Pallas TPU kernel: it computes ``build.compute_e_in``, the
in-degree of every id in a neighbour table, in one pass that skips the
empty (-1) slots, where the plain version (``ref.py``) sends each of
them to bin 0 with an atomic add of zero. The source says why it exists,
what bounds it and how it is laid out; ``launch_geometry`` sizes its
grid. The library is built with nvcc on the first launch
(``kernels/_build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_THREADS = 256                    # threads a block (kThreads)
_BLOCKS_PER_SM = 8                # a persistent grid: 2,048 threads an SM
_MAX_ID = 2 ** 31 - 1             # ids are int32
_fns = None


def launch_geometry(total, sms):
    """Blocks for a table of ``total`` ids on a card of ``sms`` SMs: one
    16-byte vector a thread at most, and no more than _BLOCKS_PER_SM
    blocks an SM (the threads then stride over the rest)."""
    vecs = -(-total // 4)
    return max(1, min(sms * _BLOCKS_PER_SM, -(-vecs // _THREADS)))


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("e_in_count")
        fn = lib.e_in_count_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.e_in_count_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = (fn, err)
    return _fns


def _check(nbrs, n_max):
    if not nbrs.is_cuda:
        raise ValueError(f"e_in_count: nbrs must be a CUDA tensor, got "
                         f"{nbrs.device}")
    if not nbrs.is_contiguous():
        raise ValueError("e_in_count: nbrs must be contiguous")
    if nbrs.dtype != torch.int32:
        raise TypeError(f"e_in_count: nbrs must be int32, got {nbrs.dtype}")
    if not 0 <= n_max <= _MAX_ID:
        raise ValueError(f"e_in_count: n_max {n_max} outside [0, "
                         f"{_MAX_ID}]")


def e_in_count(nbrs, n_max):
    """nbrs: an int32 table of ids (-1 = empty slot), any shape,
    contiguous on a CUDA device -> [n_max] int32, the number of slots
    that hold each id; an id >= n_max is not counted. Launches on the
    current stream; no host sync."""
    global launches
    _check(nbrs, n_max)
    out = torch.zeros((n_max,), dtype=torch.int32, device=nbrs.device)
    total = nbrs.numel()
    if total == 0 or n_max == 0:
        return out
    sms = torch.cuda.get_device_properties(
        nbrs.device).multi_processor_count
    _build.launch("e_in_count", _launcher(), nbrs.device, nbrs.data_ptr(),
                  total, out.data_ptr(), n_max, launch_geometry(total, sms))
    launches += 1
    return out
