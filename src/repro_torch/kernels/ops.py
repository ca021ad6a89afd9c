"""Public kernel entry points of the port, dispatched on the tensors'
device (twin of ``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, which raises on anything it does not take. There is
no fallback from one to the other. ``pool_merge`` (``topk_merge``) has no
caller in the engine, as in the reference.
"""
from __future__ import annotations

from repro_torch.kernels.e_in_count import kernel as e_in_count_kernel
from repro_torch.kernels.e_in_count.ref import e_in_count_ref
from repro_torch.kernels.l2_gather import kernel as l2_gather_kernel
from repro_torch.kernels.l2_gather.ref import l2_gather_ref
from repro_torch.kernels.pq_adc import kernel as pq_adc_kernel
from repro_torch.kernels.pq_adc.ref import pq_adc_ref
from repro_torch.kernels.row_gather import kernel as row_gather_kernel
from repro_torch.kernels.row_gather.ref import row_gather_ref
from repro_torch.kernels.topk_merge import kernel as topk_merge_kernel
from repro_torch.kernels.topk_merge.ref import topk_merge_ref


def _on_cpu(name, first, *rest):
    """True when ``first`` lies on the CPU; raises if it does but another
    operand lies on a CUDA device."""
    if first.is_cuda:
        return False
    if any(t.is_cuda for t in rest):
        raise ValueError(f"{name}: the first operand is on the CPU but "
                         "another is on a CUDA device")
    return True


def gather_l2(table, ids, queries):
    """Squared-L2 distances from gathered table rows. [B,K] fp32."""
    if _on_cpu("gather_l2", table, ids, queries):
        return l2_gather_ref(table, ids, queries)
    return l2_gather_kernel.l2_gather(table, ids, queries)


def adc_gather(codes, lut, ids):
    """Asymmetric PQ distances (LUT gather) from gathered code rows — the
    code-lane twin of ``gather_l2``. [B,K] fp32, +inf on invalid lanes."""
    if _on_cpu("adc_gather", codes, lut, ids):
        return pq_adc_ref(codes, lut, ids)
    return pq_adc_kernel.pq_adc(codes, lut, ids)


def gather_rows(table, h2s, ids):
    """Adjacency rows for frontier ids through the device-resident
    topology cache (h2s directory -> cached row table). [B,W,R] int32,
    -1 rows on non-resident and idle lanes."""
    if _on_cpu("gather_rows", table, h2s, ids):
        return row_gather_ref(table, h2s, ids)
    return row_gather_kernel.row_gather(table, h2s, ids)


def in_degree(nbrs, n_max):
    """In-degree of every id below ``n_max`` in the neighbour table
    ``nbrs`` (-1 = empty slot). [n_max] int32."""
    if _on_cpu("in_degree", nbrs):
        return e_in_count_ref(nbrs, n_max)
    return e_in_count_kernel.e_in_count(nbrs, n_max)


def pool_merge(pool_d, pool_i, pool_v, new_d, new_i):
    """Merge candidate pool with new distances, keep best-L by (d, id):
    (d [B,L] fp32, id [B,L] int32, visited [B,L] bool)."""
    if _on_cpu("pool_merge", pool_d, pool_i, pool_v, new_d, new_i):
        return topk_merge_ref(pool_d, pool_i, pool_v, new_d, new_i)
    return topk_merge_kernel.topk_merge(pool_d, pool_i, pool_v, new_d, new_i)
