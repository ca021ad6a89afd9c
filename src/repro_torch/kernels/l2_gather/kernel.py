"""Wrapper of the Hopper ``l2_gather`` kernel (``csrc/l2_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/l2_gather/kernel.py``
(``l2_gather``, body ``_kernel``): squared L2 of gathered table rows
against each query, +inf where the id is below 0. The source says what
bounds it and how it is laid out. The library is built with nvcc on the
first launch (``kernels/_build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 48 * 1024 // 4           # query row in static-limit shared memory
_MAX_K = 65535 * 64               # grid.y holds K / 64 chunks
_fns = None


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("l2_gather")
        fn = lib.l2_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.l2_gather_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = (fn, err)
    return _fns


def _check(table, ids, queries):
    for name, t in (("table", table), ("ids", ids), ("queries", queries)):
        if not t.is_cuda:
            raise ValueError(f"l2_gather: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != table.device:
            raise ValueError(f"l2_gather: {name} is on {t.device}, the "
                             f"table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"l2_gather: {name} must be contiguous")
    if table.dtype not in _DTYPES:
        raise TypeError(f"l2_gather: table must be float32 or bfloat16, "
                        f"got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"l2_gather: ids must be int32, got {ids.dtype}")
    if queries.dtype != torch.float32:
        raise TypeError(f"l2_gather: queries must be float32, got "
                        f"{queries.dtype}")
    if table.dim() != 2 or ids.dim() != 2 or queries.dim() != 2:
        raise ValueError("l2_gather: expects table [N,D], ids [B,K], "
                         "queries [B,D]")
    (N, D), (B, K) = table.shape, ids.shape
    if queries.shape != (B, D):
        raise ValueError(f"l2_gather: queries {tuple(queries.shape)} do "
                         f"not match ids {B} x table width {D}")
    if N < 1 or D > _MAX_D or K > _MAX_K or B >= 2 ** 31:
        raise ValueError(f"l2_gather: unsupported shape N={N} D={D} "
                         f"B={B} K={K}")


def l2_gather(table, ids, queries):
    """table [N, D] fp32|bf16; ids [B, K] int32 (-1 = invalid lane);
    queries [B, D] fp32, all contiguous on one CUDA device -> [B, K]
    fp32, +inf on invalid lanes. Launches on the current stream."""
    global launches
    _check(table, ids, queries)
    (N, D), (B, K) = table.shape, ids.shape
    out = torch.empty((B, K), dtype=torch.float32, device=table.device)
    if B == 0 or K == 0:
        return out
    fn, err = _launcher()
    width = 16 // table.element_size()
    vec = int(D % width == 0 and table.data_ptr() % 16 == 0)
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(table.data_ptr(), _DTYPES[table.dtype], ids.data_ptr(),
              queries.data_ptr(), out.data_ptr(), B, K, N, D, vec, dev,
              stream)
    if code != 0:
        raise RuntimeError(f"l2_gather launch failed: "
                           f"{err(code).decode()} (cudaError {code})")
    launches += 1
    return out
