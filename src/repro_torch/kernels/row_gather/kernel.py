"""Wrapper of the Hopper ``row_gather`` kernel (``csrc/row_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/row_gather/kernel.py``
(``row_gather``, body ``_kernel``): adjacency rows of frontier ids through
the device-resident topology cache, the whole row -1 where the id is
idle or not resident. The source says what bounds it and how it is laid
out. The library is built with nvcc on the first launch
(``kernels/_build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_MAX_LANES = (2 ** 31 - 1) * 8    # grid.x holds B*W / 8 warps' blocks
_fns = None


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("row_gather")
        fn = lib.row_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.row_gather_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = (fn, err)
    return _fns


def _check(table, h2s, ids):
    for name, t in (("table", table), ("h2s", h2s), ("ids", ids)):
        if not t.is_cuda:
            raise ValueError(f"row_gather: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != table.device:
            raise ValueError(f"row_gather: {name} is on {t.device}, the "
                             f"table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"row_gather: {name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"row_gather: {name} must be int32, got "
                            f"{t.dtype}")
    if table.dim() != 2 or h2s.dim() != 1 or ids.dim() != 2:
        raise ValueError("row_gather: expects table [S,R], h2s [N], ids "
                         "[B,W]")
    if table.shape[0] < 1 or h2s.shape[0] < 1 or ids.numel() > _MAX_LANES:
        raise ValueError(f"row_gather: unsupported shape table "
                         f"{tuple(table.shape)} h2s {tuple(h2s.shape)} ids "
                         f"{tuple(ids.shape)}")


def row_gather(table, h2s, ids):
    """table [S, R] int32; h2s [N] int32 (-1 = non-resident); ids [B, W]
    int32 (-1 = idle lane), all contiguous on one CUDA device -> [B, W, R]
    int32, -1 rows on idle and non-resident lanes. Launches on the current
    stream."""
    global launches
    _check(table, h2s, ids)
    (S, R), (B, W), N = table.shape, ids.shape, h2s.shape[0]
    out = torch.empty((B, W, R), dtype=torch.int32, device=table.device)
    if B * W == 0 or R == 0:
        return out
    fn, err = _launcher()
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(table.data_ptr(), h2s.data_ptr(), ids.data_ptr(),
              out.data_ptr(), B * W, S, N, R, dev, stream)
    if code != 0:
        raise RuntimeError(f"row_gather launch failed: {err(code).decode()} "
                           f"(cudaError {code})")
    launches += 1
    return out
