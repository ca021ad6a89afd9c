"""Index construction (twin of ``repro.core.build``, single-partition
path).

The KNN graph comes from brute-force distance GEMMs in row chunks on the
device (exact, full fp32), then a host pass adds reverse edges with the
reference's numpy random stream, then the cache tier is warmed with the
highest in-degree vectors. ``build_tiered_backend`` spills the graph to
the disk tier. The partitioned build and ``rank_based_reorder`` are not
ported yet.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core.tiers import DiskTier, TieredBackend, TieredStore
from repro_torch.core.topk import largest_k, smallest_k
from repro_torch.core.types import (GraphState, IndexState, init_cache_state,
                                    init_graph_state, init_stats)


def pairwise_l2(a, b):
    """Squared L2 distances [n, m] via the GEMM form ||a||² - 2ab + ||b||²,
    summed in the reference's order; updated in place to hold one [n, m]
    block at a time."""
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return (a @ b.T).mul_(-2.0).add_(a2).add_(b2.T)


def _exact_knn(vectors, k, chunk=2048):
    """Top-k neighbor ids for every row (excluding self). Chunked GEMMs.
    If the dataset has fewer than k+1 rows, pads with -1."""
    # full fp32 products: TF32 keeps ~3 digits and would reorder near-ties
    torch.backends.cuda.matmul.allow_tf32 = False
    n = vectors.shape[0]
    k_eff = max(1, min(k, n - 1))
    ids = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = pairwise_l2(vectors[s:e], vectors)
        rows = torch.arange(e - s, device=d.device)
        d[rows, rows + s] = math.inf
        ids.append(smallest_k(d, k_eff)[1].to(torch.int32))
        del d
    out = torch.cat(ids, dim=0)
    if k_eff < k:
        out = torch.cat([out, out.new_full((n, k - k_eff), -1)], dim=1)
    return out


def _add_reverse_edges(nbrs_np: np.ndarray, n: int, rng: np.random.Generator):
    """Host-side exact reverse-edge pass (build time): for each edge u->v add
    v->u if v has a free slot, else replace a random slot with prob 1/2.
    Makes the reference's random draws in the reference's order, over
    Python lists (a per-element numpy call costs ~100x more)."""
    R = nbrs_np.shape[1]
    rows = nbrs_np[:n].tolist()
    for u in range(n):
        for v in rows[u]:
            if v < 0:
                continue
            row = rows[v]
            if u in row:
                continue
            if -1 in row:
                row[row.index(-1)] = u
            elif rng.random() < 0.5:
                row[rng.integers(R)] = u
    nbrs_np[:n] = np.asarray(rows, np.int32).reshape(n, R)
    return nbrs_np


def compute_e_in(nbrs, n_max):
    flat = nbrs.reshape(-1)
    valid = flat >= 0
    return torch.zeros((n_max,), dtype=torch.int32, device=nbrs.device) \
        .index_add_(0, flat.clamp(0, n_max - 1), valid.to(torch.int32))


def _as_device_vectors(vectors, device):
    """float32 tensor on ``device``; by default the tensor's own device,
    and the card for anything that is not a tensor."""
    if device is None:
        device = vectors.device if torch.is_tensor(vectors) else "cuda"
    return torch.as_tensor(vectors, dtype=torch.float32, device=device)


def build_graph(vectors, degree, n_max=None, *, n_partitions=1,
                cross_samples=128, seed=0, reverse_edges=True, device=None,
                timings=None) -> GraphState:
    """Build a fixed-out-degree KNN graph. Returns GraphState on
    ``device``. ``timings``, when a dict, receives the seconds of the
    device KNN pass (``knn_s``) and of the host reverse-edge pass
    (``reverse_edges_s``)."""
    if n_partitions > 1:
        raise NotImplementedError(
            "partitioned build (n_partitions > 1) is not ported yet: "
            "ROADMAP queue A")
    vectors = _as_device_vectors(vectors, device)
    n, dim = vectors.shape
    n_max = n_max or n
    rng = np.random.default_rng(seed)

    t0 = time.perf_counter()
    knn = _exact_knn(vectors, degree).cpu().numpy()
    t1 = time.perf_counter()
    nbrs = np.full((n_max, degree), -1, np.int32)
    nbrs[:n, :knn.shape[1]] = knn
    if reverse_edges:
        nbrs = _add_reverse_edges(nbrs, n, rng)
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(knn_s=t1 - t0, reverse_edges_s=t2 - t1)

    g = init_graph_state(n_max, dim, degree, device=vectors.device)
    g.vectors[:n] = vectors
    g.alive[:n] = True
    g = g._replace(nbrs=torch.from_numpy(nbrs).to(vectors.device),
                   n=torch.tensor(n, dtype=torch.int32,
                                  device=vectors.device))
    return g._replace(e_in=compute_e_in(g.nbrs, n_max))


def build_index(vectors, degree=32, cache_slots=1024, n_max=None,
                theta=1.0, alpha=1.0, beta=1.0, warm=True, device=None,
                **kw) -> IndexState:
    """Build graph + cache tiers. Cold-start warm-up (paper §4.4) preloads
    the top-F_lambda (== top in-degree at build time) vectors."""
    g = build_graph(vectors, degree, n_max=n_max, device=device, **kw)
    dev = g.vectors.device
    c = init_cache_state(g.capacity, cache_slots, g.vectors.shape[1],
                         theta=theta, alpha=alpha, beta=beta, device=dev)
    if warm:
        score = torch.where(g.alive, torch.log1p(g.e_in.float()), -math.inf)
        m = min(cache_slots, int(g.n))
        top = largest_k(score, m)[1]
        c.vectors[:m] = g.vectors[top]
        c.slot_hid[:m] = top.to(torch.int32)
        c.h2d[top] = torch.arange(m, dtype=torch.int32, device=dev)
    return IndexState(graph=g, cache=c, stats=init_stats(dev))


def build_tiered_backend(vectors, degree, disk_path, *, disk_capacity=None,
                         host_window=None, device=None, timings=None, **kw):
    """Build the full graph on ``device``, spill vectors and rows to the
    disk tier and return a ``tiers.TieredBackend`` (paper Fig. 11: the
    GPU-CPU-disk form of the index). Only the per-id metadata (alive,
    e_in, version) stays host-resident afterwards."""
    vectors = np.asarray(vectors, np.float32)
    n, dim = vectors.shape
    cap = disk_capacity or n
    if cap < n:
        raise ValueError(f"disk_capacity {cap} < initial dataset {n}")
    window = host_window or max(64, cap // 4)
    g = build_graph(vectors, degree, n_max=n, device=device, timings=timings,
                    **kw)
    disk = DiskTier(disk_path, cap, dim, degree)
    disk.write(np.arange(n), vectors, g.nbrs[:n].cpu().numpy())
    backend = TieredBackend(TieredStore(disk, window), n)
    backend.alive[:n] = g.alive[:n].cpu().numpy()
    backend.e_in[:n] = g.e_in[:n].cpu().numpy()
    return backend
