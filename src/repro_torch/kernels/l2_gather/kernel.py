"""Wrapper of the Hopper ``l2_gather`` kernel (``csrc/l2_gather.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/l2_gather/kernel.py``
(``l2_gather``, body ``_kernel``): squared L2 of gathered table rows
against each query, +inf where the id is below 0. The source says what
bounds it and how it is laid out. The library is built with nvcc on the
first launch (``kernels/_build.py``), never at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 48 * 1024 // 4           # rows path: query in static shared memory
_MAX_K = 65535 * 64               # rows path: grid.y holds K / 64 chunks
_MAX_BLOCKS = 2 ** 31 - 1         # groups path: grid.x
_WARPS = 8                        # warps per block (kWarps in the source)
_MAX_PER_LANE = 4                 # 16-byte vectors per lane (kMaxPerLane)
_CHUNK = 64                       # rows path: candidates per block (kChunk)
_fns = None


ROWS, ROWS_VEC, GROUPS = 0, 1, 2   # the source's path numbers


class Geometry(NamedTuple):
    """One launch. ``path`` GROUPS: a group of ``group`` lanes per
    candidate, ``per_lane`` 16-byte vectors a lane, ``per_warp``
    candidates scored at once by a warp. ROWS_VEC / ROWS: a warp per
    candidate, the query in shared memory, 16-byte / element row loads
    (``per_lane`` loads a lane)."""
    path: int
    group: int
    per_lane: int
    per_warp: int
    block: int
    grid: tuple


def launch_geometry(B, K, D, elem_size, aligned=True):
    """Launch geometry for ids [B, K] over a table of width D with
    ``elem_size``-byte elements (4 fp32, 2 bf16); ``aligned``: table and
    queries both start on 16 bytes. The groups path takes every D that is
    a whole number of 16-byte vectors, at most 32 * _MAX_PER_LANE of them,
    with the narrowest group (most candidates per warp) that needs at most
    _MAX_PER_LANE vectors a lane; anything else takes the rows path."""
    width = 16 // elem_size
    vec = aligned and D % width == 0
    n = D // width if vec else D         # loads per row
    if vec and n <= 32 * _MAX_PER_LANE:
        group = next(g for g in (1, 2, 4, 8, 16, 32)
                     if _cdiv(n, g) <= _MAX_PER_LANE)
        blocks = _cdiv(B * _cdiv(K, 32), _WARPS)
        if blocks > _MAX_BLOCKS:
            raise ValueError(f"l2_gather: {blocks} blocks for B={B} K={K} "
                             "exceed the grid")
        return Geometry(GROUPS, group, _cdiv(n, group), 32 // group,
                        _WARPS * 32, (blocks, 1))
    return Geometry(ROWS_VEC if vec else ROWS, 32, _cdiv(n, 32), 1,
                    _WARPS * 32, (B, _cdiv(K, _CHUNK)))


def _cdiv(a, b):
    return -(-a // b)


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("l2_gather")
        fn = lib.l2_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
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
    geo = launch_geometry(B, K, D, table.element_size(),
                          table.data_ptr() % 16 == 0
                          and queries.data_ptr() % 16 == 0)
    _build.launch("l2_gather", _launcher(), table.device, table.data_ptr(),
                  _DTYPES[table.dtype], ids.data_ptr(), queries.data_ptr(),
                  out.data_ptr(), B, K, N, D, geo.path,
                  geo.group.bit_length() - 1, geo.per_lane, geo.grid[0])
    launches += 1
    return out
