"""Wrapper of the Hopper ``row_gather`` kernel (``csrc/row_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/row_gather/kernel.py``
(``row_gather``, body ``_kernel``): adjacency rows of frontier ids through
the device-resident topology cache, the whole row -1 where the id is
idle or not resident. The source says what bounds it and how it is laid
out; ``launch_geometry`` chooses between its two paths. The library is
built with nvcc on the first launch (``kernels/_build.py``), never at
import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_LANE_WARPS = 8                   # lanes path: lanes a block (kLaneWarps)
_TILE_WARPS = 2                   # tiles path: 32-lane tiles a block
_MAX_TILE_R = 128                 # tiles path: 32 16-byte vectors a row
_MAX_BLOCKS = 2 ** 31 - 1         # grid.x
_MAX_LANES = _MAX_BLOCKS * _LANE_WARPS    # the lanes path's grid
_fns = None

LANES, TILES = 0, 1               # the source's path numbers


class Geometry(NamedTuple):
    """One launch. TILES: a warp per 32 consecutive lanes, a group of
    ``group`` threads per row (16-byte vectors), ``per_step`` rows a step.
    LANES: a warp per lane (``group`` 32, ``per_step`` 1)."""
    path: int
    group: int
    per_step: int
    block: int
    grid: int


def launch_geometry(lanes, R, aligned=True):
    """Launch geometry for ``lanes`` = B*W frontier lanes and rows of R
    ints; ``aligned``: table and output both start on 16 bytes. The tiles
    path takes every R that is a multiple of 4 up to _MAX_TILE_R, with
    the smallest power-of-two group that covers a row's R/4 vectors;
    anything else takes the lanes path."""
    if aligned and R % 4 == 0 and 0 < R <= _MAX_TILE_R:
        group = 1 << max(0, (R // 4 - 1).bit_length())
        return Geometry(TILES, group, 32 // group, _TILE_WARPS * 32,
                        _cdiv(_cdiv(lanes, 32), _TILE_WARPS))
    return Geometry(LANES, 32, 1, _LANE_WARPS * 32, _cdiv(lanes, _LANE_WARPS))


def _cdiv(a, b):
    return -(-a // b)


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("row_gather")
        fn = lib.row_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
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
    geo = launch_geometry(B * W, R, table.data_ptr() % 16 == 0
                          and out.data_ptr() % 16 == 0)
    _build.launch("row_gather", _launcher(), table.device, table.data_ptr(),
                  h2s.data_ptr(), ids.data_ptr(), out.data_ptr(), B * W, S, N,
                  R, geo.path, geo.group.bit_length() - 1, geo.grid)
    launches += 1
    return out
