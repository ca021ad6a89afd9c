"""SVFusion's own production configuration (the paper's architecture).

Deep1B (paper Table 2): N=1,000,000,000 vectors, D=96 (image descriptors),
fixed out-degree 32 KNN graph, pool L=64, k=10, 10,240-query batches.
MSTuring-200M (D=100) is the second config. This module exposes them in
the configs namespace alongside the LM architectures and provides the
reduced smoke setup. The same data as the reference's
``configs/svfusion_deep1b.py``, with ``SearchParams`` from the port.
"""
from repro_torch.core.types import SearchParams

DEEP1B = dict(
    name="svfusion_deep1b",
    n=1_000_000_000, dim=96, degree=32,
    query_batch=10_240,
    cache_slots_per_chip=131_072,
    search=SearchParams(k=10, pool=64, max_iters=64),
)

MSTURING = dict(
    name="svfusion_msturing",
    n=200_000_000, dim=100, degree=32,
    query_batch=1_024,
    cache_slots_per_chip=131_072,
    search=SearchParams(k=10, pool=64, max_iters=64),
)


def smoke_config() -> dict:
    """Reduced same-family setup (small N, same algorithms end to end)."""
    return dict(name="svfusion_smoke", n=2_000, dim=16, degree=8,
                query_batch=32, cache_slots_per_chip=64,
                search=SearchParams(k=10, pool=48, max_iters=64))
