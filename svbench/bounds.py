"""Peaks of one NVIDIA H100 SXM and the bytes and operations a kernel
call needs, the benchmark's own copy.

The arithmetic is frozen from ``chip_smoke.py`` (PR 24 tree):
``l2_call`` from ``l2_gather_bound_ms`` (``chip_smoke.py:286``) and
``adc_call`` from the bound of ``phase_kernel_pq`` (``chip_smoke.py:431``).
Each input byte is counted once and each output byte once: the unique
valid table rows a call reads, its ids, its queries or LUT, and its
output, whatever the kernel reads again. The unique rows are counted on
the device (a sort), so that a call's accounting never waits for it.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores


def unique_valid(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Number of distinct ids in [0, n_rows), as a device scalar."""
    flat = ids.reshape(-1)
    s = torch.sort(torch.where((flat >= 0) & (flat < n_rows), flat,
                               flat.new_full((), -1))).values
    first = s[:1] >= 0
    step = (s[1:] != s[:-1]) & (s[1:] >= 0)
    return first.sum() + step.sum()


def l2_call(table, ids, queries):
    """(bytes, fp32 operations) of one ``gather_l2(table, ids, queries)``:
    rows * D * element size + ids and output (B * K * 4 each) + queries
    (B * D * 4); 3 * B * K * D operations. Bytes are a device scalar."""
    B, K = ids.shape
    D = table.shape[1]
    rows = unique_valid(ids, table.shape[0])
    nbytes = rows * (D * table.element_size()) + B * K * 4 * 2 + B * D * 4
    return nbytes, 3 * B * K * D


def adc_call(codes, lut, ids):
    """(bytes, operations) of one ``adc_gather(codes, lut, ids)``: rows *
    m code bytes + ids and output (B * C * 4 each) + the LUT (B * m * K *
    4); B * C * m operations (one gather-add a subspace)."""
    B, C = ids.shape
    m = codes.shape[1]
    rows = unique_valid(ids, codes.shape[0])
    nbytes = (rows * (m * codes.element_size()) + B * C * 4 * 2
              + lut.numel() * lut.element_size())
    return nbytes, B * C * m


def least_seconds(nbytes, ops):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the fp32 rate, whichever is larger (a device scalar
    when ``nbytes`` is one)."""
    t = torch.as_tensor(nbytes, dtype=torch.float64) / HBM_BYTES_PER_S
    return torch.clamp(t, min=ops / FP32_FLOPS)
