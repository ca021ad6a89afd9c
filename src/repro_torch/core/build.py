"""Index construction (twin of ``repro.core.build``, paper §4.2).

The KNN graph comes from brute-force distance GEMMs in row chunks on the
device (exact, full fp32), then a compiled host pass adds reverse edges
with the reference's numpy random stream, then the cache tier is warmed
with the highest in-degree vectors. With ``n_partitions > 1`` each
partition gets its own exact KNN subgraph, and the partitions are merged
within a bounded window: each row's candidates are its local neighbours
and its nearest of a sampled set of global columns, scored by the
``l2_gather`` kernel and pruned by ``rank_based_reorder``, a chunk of
rows at a time.
``build_tiered_backend`` spills the graph to the disk tier.
``rank_based_reorder`` also prunes an insert's candidates to the
out-degree.
"""
from __future__ import annotations

import ctypes
import math
import time

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.tiers import DiskTier, TieredBackend, TieredStore
from repro_torch.core.topk import argsort, largest_k, smallest_k
from repro_torch.core.types import (GraphState, IndexState, init_cache_state,
                                    init_graph_state, init_stats)
from repro_torch.kernels import _build
from repro_torch.kernels.ops import gather_l2, in_degree

MERGE_CHUNK = 2048     # rows merged at once: rank_based_reorder's [rows,
#                        C, R, C] comparison is 268 MB at C=64, R=32
_reverse_edges_c = None   # the compiled pass's entry point, once loaded


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


def rank_based_reorder(cand_ids, cand_dists, nbrs, degree):
    """Paper §5.1: sort candidates by detourable-path count (ascending).

    For candidate i, count occurrences of cand[i] in the neighbor lists of
    earlier candidates j < i; fewer detours = more valuable direct edge.
    cand_ids [B, C] sorted by distance; nbrs [N, R]. Returns [B, degree]
    int32. The sort key is the reference's float32 ``detours * 1e6 +
    rank``: from 17 detours on it rounds (ulp 2), and the stable argsort
    then breaks the tie by position, as the reference's does."""
    B, C = cand_ids.shape
    cids = cand_ids.to(torch.int32)
    cn = nbrs[cids.clamp(0, nbrs.shape[0] - 1)]                # [B, C, R]
    # eq[b, j, i]: cids[i] is in the row of cids[j]
    eq = (cn[:, :, :, None] == cids[:, None, None, :]).any(2)  # [B, C, C]
    before = torch.ones((C, C), dtype=torch.bool,
                        device=cids.device).triu(1)            # j < i at [j, i]
    detours = (eq & before).sum(1)                             # [B, C]
    detours = torch.where(cids < 0, C + 1, detours)
    rank = argsort(argsort(cand_dists))
    order = argsort(detours.float() * 1e6 + rank.float())
    take = min(degree, C)
    o = order[:, :take]
    sel = torch.where(detours.gather(1, o) > C, -1, cids.gather(1, o))
    if take < degree:   # fewer candidates than out-degree: pad
        sel = torch.cat([sel, sel.new_full((B, degree - take), -1)], dim=1)
    return sel


def _reverse_edges_fn():
    global _reverse_edges_c
    if _reverse_edges_c is None:
        fn = _build.load("reverse_edges").reverse_edges
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int64
        _reverse_edges_c = fn
    return _reverse_edges_c


def _add_reverse_edges(nbrs_np: np.ndarray, n: int, rng: np.random.Generator):
    """Host-side exact reverse-edge pass (build time): for each edge u->v add
    v->u if v has a free slot, else replace a random slot with prob 1/2.
    One call into a compiled loop (``csrc/reverse_edges.cpp``, built with
    the host's C++ compiler on the first call) that makes the reference's
    draws from ``rng``'s own bit generator in the reference's order: the
    table, and ``rng``'s next draw, are the reference's. Updates
    ``nbrs_np`` in place and returns it."""
    if not (isinstance(nbrs_np, np.ndarray) and nbrs_np.dtype == np.int32
            and nbrs_np.ndim == 2 and nbrs_np.flags.c_contiguous
            and nbrs_np.flags.writeable):
        raise ValueError("_add_reverse_edges: the neighbour table must be a "
                         "writable C-contiguous [rows, R] int32 array, got "
                         f"{getattr(nbrs_np, 'dtype', type(nbrs_np))} "
                         f"{getattr(nbrs_np, 'shape', '')}")
    rows, R = nbrs_np.shape
    if not 0 <= n <= min(rows, 2 ** 31 - 1):
        raise ValueError(f"_add_reverse_edges: n={n} outside the table's "
                         f"{rows} rows")
    fn = _reverse_edges_fn()
    bits = rng.bit_generator
    c = bits.ctypes
    with bits.lock:
        bad = fn(nbrs_np.ctypes.data, rows, n, R, c.state_address,
                 ctypes.cast(c.next_double, ctypes.c_void_p),
                 ctypes.cast(c.next_uint32, ctypes.c_void_p))
    if bad >= 0:
        raise IndexError(f"_add_reverse_edges: row {bad // R} holds id "
                         f"{nbrs_np.flat[bad]}, past the table's {rows} rows")
    return nbrs_np


def compute_e_in(nbrs, n_max):
    with trace.span("update.e_in"):
        return in_degree(nbrs, n_max)


def _as_device_vectors(vectors, device):
    """float32 tensor on ``device``; by default the tensor's own device,
    and the card for anything that is not a tensor."""
    if device is None:
        device = vectors.device if torch.is_tensor(vectors) else "cuda"
    return torch.as_tensor(vectors, dtype=torch.float32, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _merge_partition(vectors, local, cross, s, degree, chunk):
    """The bounded-window merge of one partition's rows ``s + [0, rows)``:
    candidates ``[local | cross]`` scored against their row, the row's own
    id and every repeat of an id (after its first occurrence) at +inf and
    repeats set to -1, a stable sort by distance, then
    ``rank_based_reorder`` against the empty graph, ``chunk`` rows at a
    time (every step is per row, so the chunk changes no id). Returns
    [rows, degree] int32."""
    rows = local.shape[0]
    # every row of the reference's all -1 graph is the same -1 row
    empty = torch.full((1, degree), -1, dtype=torch.int32,
                       device=vectors.device)
    out = []
    for c0 in range(0, rows, chunk):
        c1 = min(c0 + chunk, rows)
        cand = torch.cat([local[c0:c1], cross[c0:c1]], dim=1)   # [b, C]
        d = gather_l2(vectors, cand, vectors[s + c0:s + c1])
        own = torch.arange(s + c0, s + c1, dtype=torch.int32,
                           device=cand.device)
        d = torch.where(cand == own[:, None], math.inf, d)
        # dup[b, i]: some j < i holds the same id (keep first occurrence)
        dup = (cand[:, :, None] == cand[:, None, :]).triu(1).any(1)
        d = torch.where(dup, math.inf, d)
        cand = torch.where(dup, -1, cand)
        order = argsort(d)
        out.append(rank_based_reorder(cand.gather(1, order),
                                      d.gather(1, order), empty, degree))
    return torch.cat(out, dim=0)


def _partitioned_knn(vectors, degree, n_partitions, cross_samples, rng,
                     timings):
    """The partitioned build's pruned candidate lists [n, degree] int32
    (reference ``build.py:114-146``): per partition an exact KNN
    subgraph, ``cross_samples`` global columns drawn with ``rng``, and the
    merge (``_merge_partition``). The draws come in partition order, as
    the reference's do."""
    n = vectors.shape[0]
    if n_partitions > n:
        raise ValueError(f"n_partitions={n_partitions} > n={n} leaves an "
                         "empty partition")
    dev = vectors.device
    bounds = np.linspace(0, n, n_partitions + 1).astype(int)
    knn_s = merge_s = 0.0
    out = []
    for p in range(n_partitions):
        s, e = int(bounds[p]), int(bounds[p + 1])
        t0 = time.perf_counter()
        local = _exact_knn(vectors[s:e], min(degree, e - s - 1)) + s
        _sync(dev)
        t1 = time.perf_counter()
        samp = rng.choice(n, size=min(cross_samples, n), replace=False)
        samp = torch.as_tensor(samp, device=dev)
        d_cross = pairwise_l2(vectors[s:e], vectors[samp])
        ci = smallest_k(d_cross, min(degree, samp.numel()))[1]
        cross = samp[ci].to(torch.int32)
        del d_cross
        out.append(_merge_partition(vectors, local, cross, s, degree,
                                    MERGE_CHUNK))
        _sync(dev)
        knn_s += t1 - t0
        merge_s += time.perf_counter() - t1
    timings.update(knn_s=knn_s, merge_s=merge_s)
    return torch.cat(out, dim=0)


def build_graph(vectors, degree, n_max=None, *, n_partitions=1,
                cross_samples=128, seed=0, reverse_edges=True, device=None,
                timings=None) -> GraphState:
    """Build a fixed-out-degree KNN graph. Returns GraphState on
    ``device``.

    n_partitions > 1 takes the partitioned build and merge (bounded
    memory window, ``MERGE_CHUNK`` rows at a time); 1 = single-partition
    exact build. ``timings``, when a dict, receives the seconds of the
    device KNN pass (``knn_s``), of the partitions' merge (``merge_s``,
    0 for one partition) and of the host reverse-edge pass
    (``reverse_edges_s``)."""
    vectors = _as_device_vectors(vectors, device)
    n, dim = vectors.shape
    n_max = n_max or n
    rng = np.random.default_rng(seed)
    times = {"merge_s": 0.0}

    t0 = time.perf_counter()
    if n_partitions <= 1:
        knn = _exact_knn(vectors, degree)
    else:
        knn = _partitioned_knn(vectors, degree, n_partitions, cross_samples,
                               rng, times)
    knn = knn.cpu().numpy()
    t1 = time.perf_counter()
    nbrs = np.full((n_max, degree), -1, np.int32)
    nbrs[:n, :knn.shape[1]] = knn
    if reverse_edges:
        nbrs = _add_reverse_edges(nbrs, n, rng)
    t2 = time.perf_counter()
    times.setdefault("knn_s", t1 - t0)
    times["reverse_edges_s"] = t2 - t1
    if timings is not None:
        timings.update(times)

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
