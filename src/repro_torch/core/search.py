"""Hop-batched frontier executor, device arm (twin of the device half of
``repro.core.search``).

A beam of ``sp.beam`` frontier candidates is expanded per round; their
neighborhoods are scored in bulk through ``kernels.ops.gather_l2`` (the
capacity table, overlaid with the bandwidth-tier copy on cache hits),
merged into each query's candidate pool and the next frontier selected.
The reference fuses all rounds into one ``lax.while_loop``; here the
rounds are a Python loop whose condition ("does any query still have a
frontier?") is one device-to-host read per round, counted in
``SearchResult.host_syncs``. The loop runs exactly the reference's
rounds: an extra masked round would not be a no-op, because merging an
all-INF batch re-orders equal-distance pool entries through the packed
path.

Every top-k and argsort goes through ``core.topk`` (lower index first on
ties, as ``lax.top_k``), and every gather clips its ids first, as the
reference's gathers clamp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.topk import argsort, smallest_k
from repro_torch.core.types import (CacheState, GraphState, IndexState,
                                    SearchParams)
from repro_torch.kernels.ops import gather_l2

INF = float("inf")


class SearchResult(NamedTuple):
    ids: torch.Tensor        # [B, k]
    dists: torch.Tensor      # [B, k]
    acc_ids: torch.Tensor    # [B, rounds*beam*R] accessed vertex ids (-1 pad)
    acc_hit: torch.Tensor    # [B, rounds*beam*R] cache-hit flags
    iters: torch.Tensor      # [B] expansion rounds used
    host_syncs: int = 0      # device-to-host reads the executor made


def _n_rounds(sp: SearchParams) -> int:
    """Round budget: ceil(total hop budget / beam width)."""
    beam = max(1, sp.beam)
    return max(1, -(-sp.max_iters // beam))


def _clip(ids, n: int):
    """Gather index for ``ids`` into a table of ``n`` rows."""
    return ids.clamp(0, n - 1)


# ---------------------------------------------------------------------------
# Executor core, batched over queries
# ---------------------------------------------------------------------------

def _lane_bits(width: int) -> int:
    return max(1, (width - 1).bit_length())


def _packable(id_bound, width: int) -> bool:
    """True when (id, lane) pairs over ``width`` lanes pack exactly into an
    int32 key: ids below ``id_bound`` shifted left still fit, and -1 pad
    lanes keep distinct negative keys (arithmetic shift recovers the id)."""
    return (id_bound is not None
            and int(id_bound) < (1 << (31 - _lane_bits(width))))


def _take(a, idx):
    return torch.gather(a, -1, idx)


def dup_mask_jnp(a, id_bound=None):
    """Later-occurrence duplicate flags for id batches [..., C] (the first
    occurrence survives). When ``id_bound`` packs, ONE sort of the int32
    keys ``id << bits | lane``; otherwise a stable argsort."""
    C = a.shape[-1]
    if _packable(id_bound, C):
        bits = _lane_bits(C)
        lead = a.shape[:-1]
        flat = a.reshape(-1, C).to(torch.int32)
        iota = torch.arange(C, dtype=torch.int32, device=a.device)
        s = torch.sort((flat << bits) | iota, dim=-1).values
        sid = s >> bits                      # arithmetic shift: -1 pads ok
        dup_sorted = torch.cat(
            [torch.zeros((flat.shape[0], 1), dtype=torch.bool,
                         device=a.device),
             sid[:, 1:] == sid[:, :-1]], dim=-1)
        pos = (s & ((1 << bits) - 1)).long()
        out = torch.zeros(flat.shape, dtype=torch.bool, device=a.device)
        return out.scatter_(1, pos, dup_sorted).reshape(*lead, C)
    order = argsort(a)
    srt = _take(a, order)
    dup_sorted = torch.cat(
        [torch.zeros(srt.shape[:-1] + (1,), dtype=torch.bool,
                     device=a.device),
         srt[..., 1:] == srt[..., :-1]], dim=-1)
    return torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)


def select_frontier(pool_ids, pool_d, visited, beam: int):
    """Pick the best ``beam`` unvisited finite pool slots per query and
    mark them visited. Returns (curr [B, beam] ids, -1 for idle lanes;
    visited')."""
    sel = torch.where(visited | ~torch.isfinite(pool_d), INF, pool_d)
    vals, order = smallest_k(sel, beam)
    ok = torch.isfinite(vals)
    curr = torch.where(ok, _take(pool_ids, order), -1)
    upd = _take(visited, order) | ok
    return curr, visited.scatter(1, order, upd)


def merge_round(pool_ids, pool_d, visited, cand_ids, cand_d, id_bound=None):
    """Merge one round's candidate batch [B, C] into the pool [B, L].
    ``cand_d`` must already be INF on invalid/dead lanes; duplicates
    within the batch and ids already pooled are dropped.

    Packed path: pool and candidate ids sort together as ONE int32 key
    sort; within a sorted id run pool lanes (lane < L) come first, so a
    candidate lane continuing a run is a duplicate. The top-L selection
    then runs in that id-sorted lane order, as the reference's does (ties
    between distinct ids resolve by id, not by original lane). Fallback
    for id ranges that do not pack: an O(C·L) compare and a stable
    top-L in original lane order."""
    L = pool_ids.shape[1]
    all_ids = torch.cat([pool_ids, cand_ids], dim=1)
    T = all_ids.shape[1]
    all_vis = torch.cat(
        [visited, torch.zeros_like(cand_ids, dtype=torch.bool)], dim=1)
    if _packable(id_bound, T):
        bits = _lane_bits(T)
        iota = torch.arange(T, dtype=torch.int32, device=all_ids.device)
        s = torch.sort((all_ids.to(torch.int32) << bits) | iota, dim=-1).values
        sid = s >> bits
        pos = (s & ((1 << bits) - 1)).long()
        cont = torch.cat(
            [torch.zeros((s.shape[0], 1), dtype=torch.bool, device=s.device),
             sid[:, 1:] == sid[:, :-1]], dim=-1)
        all_d = torch.cat([pool_d, cand_d], dim=1)
        d_srt = torch.where(cont & (pos >= L), INF, _take(all_d, pos))
        vals, keep = smallest_k(d_srt, L)
        return _take(sid, keep), vals, _take(all_vis, _take(pos, keep))
    in_pool = (cand_ids[:, :, None] == pool_ids[:, None, :]).any(-1)
    cand_d = torch.where(in_pool | dup_mask_jnp(cand_ids, id_bound),
                         INF, cand_d)
    all_d = torch.cat([pool_d, cand_d], dim=1)
    vals, keep = smallest_k(all_d, L)
    return _take(all_ids, keep), vals, _take(all_vis, keep)


def init_pool(entry_ids, entry_d, id_bound=None):
    """Sort the (deduped) entry pool into executor state."""
    d = torch.where(dup_mask_jnp(entry_ids, id_bound), INF, entry_d)
    vals, order = smallest_k(d, d.shape[1])
    return (_take(entry_ids, order), vals,
            torch.zeros(entry_ids.shape, dtype=torch.bool,
                        device=entry_ids.device))


def _run_fused_rounds(state, r_stop, beam, id_bound, row_fn, dist_fn):
    """Run rounds of row gather -> distance -> merge -> next-frontier
    select until the round budget ``r_stop``, until no query has a
    frontier left, or until a row lookup stalls.

    ``state``: (r, pool_ids, pool_d, visited, curr, acc_ids [B, rounds,
    C], acc_hit, iters [B], stall). ``row_fn(curr [B, beam]) -> (nb [B,
    beam, R], resident [B, beam])``; a live frontier id that is not
    resident stalls the loop before the round is applied, so the caller
    re-enters at the same state. ``dist_fn(nb [B, C]) -> (d, hit,
    valid)`` scores a flattened candidate batch, +inf on invalid lanes.
    The round logs ``acc_ids``/``acc_hit`` are written in place.

    Returns (state', host_syncs): one device-to-host read per loop test.
    """
    r, ids, dists, visited, curr, acc_ids, acc_hit, iters, stall = state
    B, C = acc_ids.shape[0], acc_ids.shape[2]
    syncs = 0
    while r < r_stop and not stall:
        nb, res_ok = row_fn(curr)                     # [B, beam, R]
        live = curr >= 0
        work, stall = torch.stack(
            [live.any(), (live & ~res_ok).any()]).tolist()
        syncs += 1
        if not work or stall:
            break
        nb = torch.where(live[..., None], nb, -1).reshape(B, C)
        d, hit, valid = dist_fn(nb)
        active = live.any(1)                          # [B]
        ids, dists, visited = merge_round(ids, dists, visited, nb, d,
                                          id_bound)
        curr, visited = select_frontier(ids, dists, visited, beam)
        acc_ids[:, r] = torch.where(valid, nb, -1)
        acc_hit[:, r] = hit & valid
        iters = iters + active.to(torch.int32)
        r += 1
    return (r, ids, dists, visited, curr, acc_ids, acc_hit, iters,
            bool(stall)), syncs


# ---------------------------------------------------------------------------
# Device arm: both tiers resident on the device
# ---------------------------------------------------------------------------

def _device_distances(graph: GraphState, cache: CacheState, ids, queries):
    """Distances for an id batch [B, C] through the two device tiers: the
    ``l2_gather`` kernel against the capacity table, overlaid with the
    bandwidth-tier copy on cache hits. Invalid ids (< 0) come back +inf.
    Returns (dists [B, C] fp32, device_hit [B, C])."""
    slot = cache.h2d[_clip(ids, cache.h2d.shape[0])]
    hit = (slot >= 0) & (ids >= 0)
    d_cap = gather_l2(graph.vectors, ids, queries)
    d_dev = gather_l2(cache.vectors, torch.where(hit, slot, -1), queries)
    return torch.where(hit, d_dev, d_cap), hit


def _frontier_search(graph: GraphState, cache: CacheState, queries, entries,
                     sp: SearchParams) -> SearchResult:
    """Hop-batched frontier executor, device arm. queries [B, D], entries
    [B, L] int32."""
    B = queries.shape[0]
    L, R = sp.pool, graph.degree
    beam = max(1, min(sp.beam, L))
    rounds = _n_rounds(sp)
    C = beam * R
    cap = graph.capacity
    id_bound = cap                       # drives the packed dedup
    dev = graph.vectors.device
    queries = queries.to(graph.vectors.dtype)
    entries = entries.to(torch.int32)

    d0, _ = _device_distances(graph, cache, entries, queries)
    d0 = torch.where(graph.alive[_clip(entries, cap)] & (entries >= 0),
                     d0, INF)
    pool_ids0, pool_d0, visited0 = init_pool(entries, d0, id_bound)
    curr0, visited0 = select_frontier(pool_ids0, pool_d0, visited0, beam)

    def row_fn(curr):
        nb = graph.nbrs[_clip(curr, cap)]             # always resident
        return nb, torch.ones(curr.shape, dtype=torch.bool, device=dev)

    def dist_fn(nb):
        valid = (nb >= 0) & graph.alive[_clip(nb, cap)]
        d, hit = _device_distances(graph, cache, nb, queries)
        return torch.where(valid, d, INF), hit, valid

    state0 = (0, pool_ids0, pool_d0, visited0, curr0,
              torch.full((B, rounds, C), -1, dtype=torch.int32, device=dev),
              torch.zeros((B, rounds, C), dtype=torch.bool, device=dev),
              torch.zeros((B,), dtype=torch.int32, device=dev), False)
    (_, ids, dists, _, _, acc_ids, acc_hit, iters, _), syncs = \
        _run_fused_rounds(state0, rounds, beam, id_bound, row_fn, dist_fn)

    topk_ids = torch.where(torch.isfinite(dists[:, :sp.k]), ids[:, :sp.k], -1)
    return SearchResult(topk_ids, dists[:, :sp.k], acc_ids.reshape(B, -1),
                        acc_hit.reshape(B, -1), iters, syncs)


def frontier_search(state: IndexState, queries, entries, sp: SearchParams
                    ) -> SearchResult:
    """Executor entry with caller-chosen entry points [B, pool] (parity
    tests and the engine's own draws pass them here)."""
    return _frontier_search(state.graph, state.cache, queries.float(),
                            entries, sp)


def search_batch(state: IndexState, queries, key: torch.Generator,
                 sp: SearchParams) -> SearchResult:
    """Batched ANNS with random entry points drawn from ``key`` (a
    generator on the state's device; paper §4.2: no seed maintenance
    under updates). queries [B, D]."""
    B = queries.shape[0]
    n = max(int(state.graph.n), 1)
    entries = torch.randint(0, n, (B, sp.pool), generator=key,
                            dtype=torch.int32, device=queries.device)
    res = frontier_search(state, queries, entries, sp)
    return res._replace(host_syncs=res.host_syncs + 1)   # the read of n


def dedup_mask(a):
    """Per-row duplicate flags for an int array [B, C] (any one occurrence
    survives). Host (numpy) twin of ``dup_mask_jnp``."""
    order = np.argsort(a, axis=1, kind="stable")
    srt = np.take_along_axis(a, order, axis=1)
    dup_sorted = np.concatenate(
        [np.zeros((a.shape[0], 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1)
    dup = np.empty_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return dup


def effective_rerank_depth(rerank_depth: int, k: int, pool: int) -> int:
    """Resolve the ``rerank_depth`` knob to the concrete pool prefix an
    exact re-rank pulls vectors for: ``<= 0`` is the whole-pool sentinel,
    anything else clamps to ``[k, pool]``."""
    return pool if rerank_depth <= 0 else max(k, min(rerank_depth, pool))


def brute_force_topk(graph: GraphState, queries, k):
    """Exact ground truth over alive vectors (recall oracle). Returns
    (ids [B, k] int32, dists [B, k])."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full-fp32 GEMM
    v = graph.vectors
    d = (2.0 * queries) @ v.T
    d = d.neg_().add_((queries ** 2).sum(1, keepdim=True)) \
        .add_((v ** 2).sum(1)[None, :])
    d.masked_fill_(~graph.alive[None, :], INF)
    vals, idx = smallest_k(d, k)
    return idx.to(torch.int32), vals


def recall_at_k(found_ids, true_ids):
    """found/true [B, k] -> mean fraction of true ids found."""
    hits = (found_ids[:, :, None] == true_ids[:, None, :]).any(1)
    return hits.float().mean()
