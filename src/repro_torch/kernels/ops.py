"""Public kernel entry points of the port, dispatched on the tensors'
device (twin of ``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel, which raises on anything it does not take. There is
no fallback from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.l2_gather import kernel as l2_gather_kernel
from repro_torch.kernels.l2_gather.ref import l2_gather_ref


def gather_l2(table, ids, queries):
    """Squared-L2 distances from gathered table rows. [B,K] fp32."""
    if table.is_cuda:
        return l2_gather_kernel.l2_gather(table, ids, queries)
    if ids.is_cuda or queries.is_cuda:
        raise ValueError("gather_l2: table is on the CPU but ids or "
                         "queries are on a CUDA device")
    return l2_gather_ref(table, ids, queries)
