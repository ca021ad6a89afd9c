"""Wrapper of the Hopper ``pq_adc`` kernel (``csrc/pq_adc.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pq_adc/kernel.py``
(``pq_adc``, body ``_kernel``): the asymmetric PQ distance of gathered
code rows against each query's lookup table, +inf where the id is below
0. The source says what bounds it and how it is laid out. The library is
built with nvcc on the first launch (``kernels/_build.py``), never at
import.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0    # kernel launches since the last reset (read by chip_smoke)

_MAX_SMEM = 232_448               # a block's shared memory on an H100
_MAX_C = 65535 * 512              # grid.y holds C / 512 chunks
_MAX_THREADS = 256                # threads per block (kMaxThreads)
_MAX_PER_THREAD = 2               # candidates per thread
_fns = None


class Geometry(NamedTuple):
    """One launch: blocks of ``block`` threads with ``per_thread``
    candidates each; grid (queries, chunks of block * per_thread)."""
    block: int
    per_thread: int
    grid: tuple


def launch_geometry(B, C):
    """Launch geometry for ids [B, C]: the block is sized to C (32 to
    _MAX_THREADS threads, whole warps), with up to _MAX_PER_THREAD
    candidates a thread, so that a round (C=512) is one block of 256 x 2
    per query and the entry (C=64) one of 64 x 1. The LUT's size sets
    only the shared memory, which the source computes."""
    block = min(_MAX_THREADS, max(32, -(-C // 32) * 32))
    per_thread = min(_MAX_PER_THREAD, -(-C // block))
    return Geometry(block, per_thread, (B, -(-C // (block * per_thread))))


def _launcher():
    global _fns
    if _fns is None:
        lib = _build.load("pq_adc")
        fn = lib.pq_adc_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.pq_adc_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns = (fn, err)
    return _fns


def _check(codes, lut, ids):
    for name, t in (("codes", codes), ("lut", lut), ("ids", ids)):
        if not t.is_cuda:
            raise ValueError(f"pq_adc: {name} must be a CUDA tensor, got "
                             f"{t.device}")
        if t.device != codes.device:
            raise ValueError(f"pq_adc: {name} is on {t.device}, the codes "
                             f"on {codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"pq_adc: {name} must be contiguous")
    if codes.dtype != torch.uint8:
        raise TypeError(f"pq_adc: codes must be uint8, got {codes.dtype}")
    if lut.dtype != torch.float32:
        raise TypeError(f"pq_adc: lut must be float32, got {lut.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"pq_adc: ids must be int32, got {ids.dtype}")
    if codes.dim() != 2 or lut.dim() != 3 or ids.dim() != 2:
        raise ValueError("pq_adc: expects codes [N,m], lut [B,m,K], ids "
                         "[B,C]")
    (N, m), (B, C), K = codes.shape, ids.shape, lut.shape[2]
    if lut.shape[:2] != (B, m):
        raise ValueError(f"pq_adc: lut {tuple(lut.shape)} does not match "
                         f"ids {B} x codes width {m}")
    if N < 1 or not 1 <= K <= 256 or m * K * 4 > _MAX_SMEM \
            or C > _MAX_C or B >= 2 ** 31:
        raise ValueError(f"pq_adc: unsupported shape N={N} m={m} K={K} "
                         f"B={B} C={C}")


def pq_adc(codes, lut, ids):
    """codes [N, m] uint8; lut [B, m, K] fp32; ids [B, C] int32 (-1 =
    invalid lane), all contiguous on one CUDA device -> [B, C] fp32, +inf
    on invalid lanes. Launches on the current stream."""
    global launches
    _check(codes, lut, ids)
    (N, m), (B, C), K = codes.shape, ids.shape, lut.shape[2]
    out = torch.empty((B, C), dtype=torch.float32, device=codes.device)
    if B == 0 or C == 0:
        return out
    geo = launch_geometry(B, C)
    vec16 = int(m == 16 and codes.data_ptr() % 16 == 0)
    lut_async = int(m * K % 4 == 0 and lut.data_ptr() % 16 == 0)
    _build.launch("pq_adc", _launcher(), codes.device, codes.data_ptr(),
                  lut.data_ptr(), ids.data_ptr(), out.data_ptr(), B, C, N, m,
                  K, vec16, lut_async, geo.block, geo.per_thread)
    launches += 1
    return out
