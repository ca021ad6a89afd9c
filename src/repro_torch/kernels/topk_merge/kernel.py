"""Wrapper of the Hopper ``topk_merge`` kernel (``csrc/topk_merge.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/topk_merge/kernel.py``
(``topk_merge``, network ``_bitonic``, body ``_kernel``): the best L of a
candidate pool merged with new candidates, in the plain version's order
(``ref.py``: distance, then id, then lane). The source says what bounds
it and how it is laid out; ``launch_geometry`` chooses between its two
paths. The library is built with nvcc on the first launch
(``kernels/_build.py``), never at import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

MAX_LANES = 16384       # P = next_pow2(L + R): 12 bytes of shared memory
#                         per lane, 16 lanes per thread at most
MAX_WARP_L = 256        # warp path: the running list, at most 8 keys a lane
_ROWS = 4               # warp path: rows (one warp each) a block
_fns = None

WARP, BLOCK = 0, 1      # the source's path numbers


class Geometry(NamedTuple):
    """One launch. WARP: a warp per row, ``per_lane`` items a thread of a
    running list of ``lanes`` = max(32, next_pow2(L)), the row walked in
    chunks of as many lanes. BLOCK: a block of ``block`` threads per row
    sorting all ``lanes`` = next_pow2(L + R), ``per_lane`` lanes a
    thread."""
    path: int
    lanes: int
    per_lane: int
    block: int
    grid: int


def _pow2(n):
    return 1 << max(0, (n - 1).bit_length())


def launch_geometry(B, L, R):
    """Launch geometry for a [B, L] pool and [B, R] new candidates. The
    warp path takes every L up to MAX_WARP_L; a longer list takes the
    block path (a bitonic sort of all L + R lanes in one block)."""
    if L <= MAX_WARP_L:
        M = max(32, _pow2(L))
        return Geometry(WARP, M, M // 32, _ROWS * 32, -(-B // _ROWS))
    P = _pow2(L + R)
    E = max(1, P // 1024)
    return Geometry(BLOCK, P, E, P // E, B)


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("topk_merge")
        fn = lib.topk_merge_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.topk_merge_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = (fn, err)
    return _fns


def _check(pool_d, pool_i, pool_v, new_d, new_i):
    args = (("pool_d", pool_d, torch.float32), ("pool_i", pool_i, torch.int32),
            ("pool_v", pool_v, torch.bool), ("new_d", new_d, torch.float32),
            ("new_i", new_i, torch.int32))
    for name, t, dtype in args:
        if not t.is_cuda:
            raise ValueError(f"topk_merge: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.device != pool_d.device:
            raise ValueError(f"topk_merge: {name} is on {t.device}, pool_d "
                             f"on {pool_d.device}")
        if not t.is_contiguous():
            raise ValueError(f"topk_merge: {name} must be contiguous")
        if t.dtype != dtype:
            raise TypeError(f"topk_merge: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"topk_merge: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
    (B, L), (Bn, R) = pool_d.shape, new_d.shape
    if pool_i.shape != (B, L) or pool_v.shape != (B, L) \
            or new_i.shape != (Bn, R) or Bn != B:
        raise ValueError("topk_merge: expects pool_d/pool_i/pool_v [B,L] "
                         "and new_d/new_i [B,R]")
    if L + R > MAX_LANES or B >= 2 ** 31:
        raise ValueError(f"topk_merge: unsupported shape B={B} L={L} R={R}: "
                         f"L+R pads to more than {MAX_LANES} lanes, which "
                         "one block's shared memory does not hold")


def topk_merge(pool_d, pool_i, pool_v, new_d, new_i):
    """pool_d [B, L] fp32, pool_i [B, L] int32, pool_v [B, L] bool, new_d
    [B, R] fp32, new_i [B, R] int32, all contiguous on one CUDA device ->
    (d [B, L] fp32, id [B, L] int32, visited [B, L] bool), the best L by
    (d, id, lane). Launches on the current stream."""
    global launches
    _check(pool_d, pool_i, pool_v, new_d, new_i)
    (B, L), R = pool_d.shape, new_d.shape[1]
    dev_ = pool_d.device
    out_d = torch.empty((B, L), dtype=torch.float32, device=dev_)
    out_i = torch.empty((B, L), dtype=torch.int32, device=dev_)
    out_v = torch.empty((B, L), dtype=torch.bool, device=dev_)
    if B == 0 or L == 0:
        return out_d, out_i, out_v
    geo = launch_geometry(B, L, R)
    _build.launch("topk_merge", _launcher(), dev_, pool_d.data_ptr(),
                  pool_i.data_ptr(), pool_v.data_ptr(), new_d.data_ptr(),
                  new_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                  out_v.data_ptr(), B, L, R, geo.path, geo.lanes,
                  geo.per_lane, geo.grid)
    launches += 1
    return out_d, out_i, out_v
