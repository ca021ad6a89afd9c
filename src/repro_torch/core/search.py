"""Hop-batched frontier executor (twin of ``repro.core.search``), both
arms.

A beam of ``sp.beam`` frontier candidates is expanded per round; their
neighborhoods are scored in bulk, merged into each query's candidate pool
and the next frontier selected. The reference fuses rounds into one
``lax.while_loop``; here ``_run_fused_rounds`` is a Python loop whose
condition ("does any query still have a frontier?") is one device-to-host
read per round. It runs exactly the reference's rounds: an extra masked
round would not be a no-op, because merging an all-INF batch re-orders
equal-distance pool entries through the packed path.

* **Device arm** (``frontier_search``/``search_batch``): distances from
  ``kernels.ops.gather_l2`` over the capacity table, overlaid with the
  bandwidth-tier copy on cache hits; the read count is
  ``SearchResult.host_syncs``.
* **Tiered arm** (``search_tiered``): the host owns traversal over the
  disk-backed store and the device runs the dispatches. In the PQ lane
  candidates are scored by ``kernels.ops.adc_gather`` (``pq_adc``) from
  device-resident codes, and with a topology cache the rounds fuse into
  one dispatch that reads adjacency through ``kernels.ops.gather_rows``
  (``row_gather``). The reference overlaps its speculative host stage
  with the in-flight dispatch; the port's fused loop reads back every
  round, so here the stage runs after the dispatch. Results are the same.
  A filter (``core/filters.py``) joins the invalid-lane masking of
  either lane; below the selectivity threshold a query takes the
  brute-force scan over the matched ids instead (``pq_adc`` over
  ``[B, Mp]`` ids in the PQ lane, then the exact re-rank).

Every top-k and argsort goes through ``core.topk`` (lower index first on
ties, as ``lax.top_k``), and every gather clips its ids first, as the
reference's gathers clamp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.cache import payload_rows
from repro_torch.core.quant import adc_lut
from repro_torch.core.topk import argsort, smallest_k
from repro_torch.core.types import (CacheState, GraphState, IndexState,
                                    SearchParams)
from repro_torch.kernels.ops import adc_gather, gather_l2, gather_rows

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
        with trace.span("engine.sync"):
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
    with trace.span("engine.sync"):
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


# ---------------------------------------------------------------------------
# Tiered arm: the host owns traversal and residency over the disk-backed
# store; the device runs one dispatch per round (or, with a topology
# cache, one fused dispatch over many rounds), and a speculative stage
# prepares the next round's rows between dispatches
# ---------------------------------------------------------------------------

def _batch_sqdist(x, q):
    """[B, C, D] gathered rows vs [B, D] queries -> [B, C] fp32 distances,
    in the reference's expansion form ‖x‖² − 2x·q + ‖q‖²."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full-fp32 products
    xq = torch.matmul(x, q[:, :, None])[..., 0]
    x2 = torch.einsum("bcd,bcd->bc", x, x)
    q2 = torch.einsum("bd,bd->b", q, q)[:, None]
    return x2 - 2.0 * xq + q2


def _tiered_entry_dispatch(entry_ids, entry_vecs, entry_valid, queries,
                           beam, id_bound):
    """Entry-pool distances + dedup + sort + first frontier selection. Pool
    state stays on the device across rounds; only the [B, beam] frontier
    crosses back to the host."""
    d = torch.where(entry_valid, _batch_sqdist(entry_vecs, queries), INF)
    pool_ids, pool_d, visited = init_pool(entry_ids, d, id_bound)
    curr, visited = select_frontier(pool_ids, pool_d, visited, beam)
    return pool_ids, pool_d, visited, curr


def _tiered_round_dispatch(pool_ids, pool_d, visited, cand_ids, uniq_vecs,
                           cand_inv, cand_valid, queries, beam, id_bound):
    """One exact round: the host ships the round's unique vectors
    ``uniq_vecs [U, D]`` and the lane->unique map ``cand_inv [B, C]``;
    the candidate matrix is gathered, scored, merged and the next
    frontier selected here."""
    d = _batch_sqdist(uniq_vecs[cand_inv], queries)
    d = torch.where(cand_valid, d, INF)
    pool_ids, pool_d, visited = merge_round(pool_ids, pool_d, visited,
                                            cand_ids, d, id_bound)
    curr, visited = select_frontier(pool_ids, pool_d, visited, beam)
    return pool_ids, pool_d, visited, curr


def _pq_entry_dispatch(entry_ids, entry_valid, codes, centroids, queries,
                       beam, id_bound):
    """Entry-pool ADC scan (``pq_adc``) + dedup + sort + first frontier
    selection; builds the per-query LUTs that every later round reuses."""
    lut = adc_lut(centroids, queries)
    d = torch.where(entry_valid, adc_gather(codes, lut, entry_ids), INF)
    pool_ids, pool_d, visited = init_pool(entry_ids, d, id_bound)
    curr, visited = select_frontier(pool_ids, pool_d, visited, beam)
    return pool_ids, pool_d, visited, curr, lut


def _pq_round_dispatch(pool_ids, pool_d, visited, cand_ids, cand_valid,
                       codes, lut, beam, id_bound):
    """One PQ round with host-shipped candidate ids: scored from the
    resident codes (``pq_adc``), merged, next frontier selected."""
    d = torch.where(cand_valid, adc_gather(codes, lut, cand_ids), INF)
    pool_ids, pool_d, visited = merge_round(pool_ids, pool_d, visited,
                                            cand_ids, d, id_bound)
    curr, visited = select_frontier(pool_ids, pool_d, visited, beam)
    return pool_ids, pool_d, visited, curr


def _pq_fused_dispatch(pool_ids, pool_d, visited, curr, r, acc_ids,
                       topo_rows, topo_h2s, codes, lut, alive, r_stop,
                       beam, id_bound):
    """Consecutive PQ rounds from round ``r`` up to ``r_stop`` over the
    device-resident topology cache: row gather (``row_gather``) ->
    ``pq_adc`` -> merge -> select, through ``_run_fused_rounds``. A
    frontier id whose row is not cached stalls the loop before its round
    is applied; the host shell installs the row and re-enters at the
    returned ``r``. ``acc_ids`` [B, rounds, C] is written in place.
    Returns (pool_ids, pool_d, visited, curr, r, acc_ids)."""
    n_dir, n_alive = topo_h2s.shape[0], alive.shape[0]

    def row_fn(c):
        nb = gather_rows(topo_rows, topo_h2s, c)       # [B, beam, R]
        slot = topo_h2s[_clip(c, n_dir)]
        return nb, (slot >= 0) | (c < 0)               # idle lanes never stall

    def dist_fn(nb):
        valid = (nb >= 0) & alive[_clip(nb, n_alive)]
        d = adc_gather(codes, lut, nb)
        # code-lane rounds log no device hits: the result's hit flags come
        # from exact-cache residency at the end
        return torch.where(valid, d, INF), torch.zeros_like(valid), valid

    B = pool_ids.shape[0]
    state0 = (r, pool_ids, pool_d, visited, curr, acc_ids,
              torch.zeros(acc_ids.shape, dtype=torch.bool,
                          device=acc_ids.device),
              torch.zeros((B,), dtype=torch.int32, device=acc_ids.device),
              False)
    (r1, ids1, d1, vis1, curr1, acc1, _, _, _), _ = _run_fused_rounds(
        state0, r_stop, beam, id_bound, row_fn, dist_fn)
    return ids1, d1, vis1, curr1, r1, acc1


def _fused_topo_shell(store, topo, spec, alive, f_lam, pq, codes,
                      codes_epoch, lut, pool_ids, pool_d, visited, curr_t,
                      beam, rounds, id_bound, fused_rounds, stage_width=0,
                      alive_t=None):
    """Host shell around ``_pq_fused_dispatch``: the round loop when a
    topology cache is attached. Steady state is ONE fused dispatch over
    every remaining round; the host re-enters on a topology-cache miss
    (install the frontier's missing rows, re-enter at the same round) or
    at the K-round budget (``fused_rounds``; 0 = uncapped). When the
    missing rows cannot be installed (cache too small, or every slot
    protected by the live frontier) one per-round ``_pq_round_dispatch``
    runs with host-shipped ids. With speculation, the host stages store
    rows of the hottest non-resident next-hop candidates after each fused
    dispatch, so a later miss is a memo hit instead of disk IO.
    ``alive_t``, when given, is the fused rounds' device alive mask (a
    filtered search's ``alive & predicate``); otherwise ``alive`` is read
    afresh at every dispatch.

    Returns (pool_ids, pool_d, acc [B, rounds, C] np.int32, rounds
    executed, dispatches issued, topo hits, topo misses)."""
    dev = pool_ids.device
    B = pool_ids.shape[0]
    R = topo.degree
    C = beam * R
    K = fused_rounds if fused_rounds > 0 else rounds
    acc_t = torch.full((B, rounds, C), -1, dtype=torch.int32, device=dev)
    acc_np = None
    fb_rounds: list = []
    dispatches = hits = misses = 0
    r = 0
    curr = curr_t.cpu().numpy()
    no_progress = 0
    while r < rounds and (curr >= 0).any():
        topo.validate(store)
        ep = store.write_epoch
        if ep != codes_epoch:       # concurrent insert: fold fresh codes
            codes_epoch = ep
            codes = pq.synced_codes()
        ucur = np.unique(curr[curr >= 0])
        cached_rows, resm = topo.lookup(ucur)
        need = ucur[~resm]
        hits += int(resm.sum())
        topo.hits += int(resm.sum())
        rows_need = None
        installed = True
        if need.size:
            misses += int(need.size)
            topo.misses += int(need.size)
            if spec is not None:
                spec.validate()
                rows_need = spec.rows_for(need)
            else:
                rows_need = store.fetch_rows(need, f_lam)
            # the live frontier is protected: an install never evicts the
            # rows the dispatch it feeds is about to gather
            installed = topo.install(need, rows_need, f_lam, protect=ucur)
        if installed and no_progress < 3:
            rows_t, h2s_t = topo.synced()
            out = _pq_fused_dispatch(
                pool_ids, pool_d, visited, curr_t, r, acc_t, rows_t, h2s_t,
                codes, lut, (alive_t if alive_t is not None
                             else torch.as_tensor(alive, device=dev)),
                min(r + K, rounds), beam, id_bound)
            dispatches += 1
            if spec is not None:
                # topology prefetch one cache miss ahead: stage store rows
                # of the hottest non-resident candidates of this frontier
                if rows_need is not None:
                    cached_rows[~resm] = rows_need
                nxt = np.unique(cached_rows[cached_rows >= 0])
                nxt = nxt[topo.h2s[nxt] < 0]
                if nxt.size:
                    w = max(stage_width, 1) * B
                    if nxt.size > w:
                        nxt = nxt[np.argpartition(-f_lam[nxt], w - 1)[:w]]
                    spec.stage(nxt)
            pool_ids, pool_d, visited, curr_t, new_r, acc_t = out
            curr = curr_t.cpu().numpy()
            # a dispatch that advanced no round means residency changed
            # under us (concurrent install/evict): bounded retries, then
            # the per-round fallback, so the shell always progresses
            no_progress = no_progress + 1 if new_r == r else 0
            r = new_r
        else:
            if rows_need is not None:
                cached_rows[~resm] = rows_need
            nb = np.full((B, beam, R), -1, np.int32)
            okm = curr >= 0
            nb[okm] = cached_rows[np.searchsorted(ucur, curr[okm])]
            nb = nb.reshape(B, C)
            valid = (nb >= 0) & alive[np.clip(nb, 0, None)]
            pool_ids, pool_d, visited, curr_t = _pq_round_dispatch(
                pool_ids, pool_d, visited, torch.as_tensor(nb, device=dev),
                torch.as_tensor(valid, device=dev), codes, lut, beam,
                id_bound)
            dispatches += 1
            if acc_np is None:
                acc_np = np.full((B, rounds, C), -1, np.int32)
            acc_np[:, r] = np.where(valid, nb, -1)
            fb_rounds.append(r)
            curr = curr_t.cpu().numpy()
            r += 1
            no_progress = 0
    acc = acc_t.cpu().numpy().copy()
    if fb_rounds:   # overlay host-logged fallback rounds onto the device log
        acc[:, fb_rounds] = acc_np[:, fb_rounds]
    return pool_ids, pool_d, acc, r, dispatches, hits, misses


def _pq_rerank_dispatch(top_ids, uniq_vecs, cand_inv, valid, queries, k):
    """Exact re-rank of the top ADC-ranked pool entries: their exact
    vectors (shipped as unique rows + lane->unique map) re-scored with
    ``_batch_sqdist`` and re-sorted, ties lower lane first."""
    d = _batch_sqdist(uniq_vecs[cand_inv], queries)
    d = torch.where(valid, d, INF)
    ds, order = smallest_k(d, d.shape[1])
    ids = torch.where(torch.isfinite(ds), _take(top_ids, order), -1)
    return ids[:, :k], ds[:, :k]


class TieredSearchResult(NamedTuple):
    ids: np.ndarray       # [B, k]
    dists: np.ndarray     # [B, k]
    acc_ids: np.ndarray   # [B, rounds*beam*R] accessed vertex ids (-1 pad)
    acc_hit: np.ndarray   # [B, rounds*beam*R] device-cache-hit flags
    iters: int            # expansion rounds executed
    dispatches: int       # device dispatches issued (per-round: 1 + iters
    #                       (+ re-rank); fused: entry + fused re-entries +
    #                       fallback rounds + re-rank)
    spec_hits: int = 0    # frontier rows already staged at read-back
    spec_misses: int = 0  # frontier rows delta-fetched after read-back
    topo_hits: int = 0    # frontier ids resident in the topology cache
    topo_misses: int = 0  # frontier ids delta-fetched + installed
    filter_path: str = "none"        # "none" | "graph" | "fallback"
    filter_selectivity: float = 1.0  # admission-time sampled estimate

    @property
    def spec_hit_rate(self) -> float:
        t = self.spec_hits + self.spec_misses
        return self.spec_hits / t if t else 0.0

    @property
    def topo_hit_rate(self) -> float:
        t = self.topo_hits + self.topo_misses
        return self.topo_hits / t if t else 0.0


def _resolve_unique_vectors(ids, h2d, cache_vec, store, f_lam):
    """Vectors for a batch of *unique* non-negative ids through the
    cascade device cache (mirror) -> host window -> disk. Returns
    (vectors [U, D] fp32, device_hit [U])."""
    out = np.empty((len(ids), store.disk.dim), np.float32)
    slot = h2d[ids]
    hit = slot >= 0
    if hit.any():
        out[hit] = payload_rows(cache_vec, slot[hit])
    miss = ~hit
    if miss.any():
        out[miss] = store.fetch(ids[miss], f_lam)[0]
    return out, hit


def _host_sqdist(x, q):
    """Numpy twin of ``_batch_sqdist`` for host-side frontier prediction:
    [B, C, D] vs [B, D] -> [B, C]."""
    diff = x - q[:, None, :]
    return np.einsum("bcd,bcd->bc", diff, diff)


def predict_frontier(ids, valid, f_lam, width, d_host=None):
    """Ranked next-frontier guess [B, width] (-1 = no guess): per query,
    the top-``width`` valid candidates by host-side score — exact host
    distances when given (the entry stage), else the WAVP F_λ probe."""
    score = (-d_host if d_host is not None
             else f_lam[np.clip(ids, 0, None)])
    score = np.where(valid, score, -np.inf)
    w = min(width, ids.shape[1])
    part = np.argpartition(-score, w - 1, axis=1)[:, :w]
    got = np.take_along_axis(ids, part, axis=1)
    ok = np.isfinite(np.take_along_axis(score, part, axis=1))
    return np.where(ok, got, -1)


class _StageMap:
    """Append-only id -> payload staging memo (speculative buffers):
    dense ``loc`` directory, doubling buffer, and wholesale invalidation
    (the write-epoch check flushes it rather than patching it)."""

    __slots__ = ("loc", "buf", "hit", "n", "_installed")

    def __init__(self, capacity: int, width: int, dtype, track_hit=False):
        self.loc = np.full((capacity,), -1, np.int64)
        self.buf = np.empty((0, width), dtype)
        self.hit = np.empty((0,), bool) if track_hit else None
        self.n = 0
        self._installed: list = []

    def add(self, ids, rows, hit=None):
        m = len(ids)
        if not m:
            return
        need = self.n + m
        if need > len(self.buf):
            cap = max(need, 2 * len(self.buf), 256)
            buf = np.empty((cap, self.buf.shape[1]), self.buf.dtype)
            buf[:self.n] = self.buf[:self.n]
            self.buf = buf
            if self.hit is not None:
                h = np.empty((cap,), bool)
                h[:self.n] = self.hit[:self.n]
                self.hit = h
        self.buf[self.n:need] = rows
        if self.hit is not None:
            self.hit[self.n:need] = hit
        self.loc[ids] = np.arange(self.n, need)
        self._installed.append(np.asarray(ids))
        self.n = need

    def clear(self):
        for blk in self._installed:
            self.loc[blk] = -1
        self._installed.clear()
        self.n = 0


class _SpecPipeline:
    """Speculative stage of the tiered arm (§4.4): after round N's
    dispatch the host stages the predicted round-N+1 frontier (adjacency
    rows of the predicted ids, vectors of their neighborhoods, an async
    disk prefetch one hop further). At read-back, staged ids feed the next
    dispatch; mispredictions cost a delta fetch. Both memos are validated
    against the store's write epoch every round, so a staged payload is
    always what the demand path would fetch and results do not depend on
    the prediction."""

    def __init__(self, backend, h2d, cache_vec, f_lam, *,
                 prefetch_budget=0, probe=8, stage_vectors=True):
        self.store = backend.store
        self.h2d, self.cache_vec, self.f_lam = h2d, cache_vec, f_lam
        self.prefetch_budget = prefetch_budget
        self.probe = probe
        self.stage_vectors = stage_vectors   # False: PQ code lane — rows
        #                                      (+ disk prefetch) only
        cap = backend.capacity
        self.rows = _StageMap(cap, backend.degree, np.int32)
        self.vecs = _StageMap(cap, backend.dim, np.float32, track_hit=True)
        self.epoch = self.store.write_epoch
        self.hits = 0
        self.misses = 0

    def validate(self):
        ep = self.store.write_epoch
        if ep != self.epoch:
            self.rows.clear()
            self.vecs.clear()
            self.epoch = ep

    def rows_for(self, uids, *, speculative=False):
        """Adjacency rows aligned with ``uids`` (unique, >= 0): staged ids
        come from the memo, the rest are delta-fetched and installed.
        Demand reads (``speculative=False``) score the hit rate."""
        loc = self.rows.loc[uids]
        miss = loc < 0
        if not speculative:
            self.hits += int((~miss).sum())
            self.misses += int(miss.sum())
        if miss.any():
            mids = uids[miss]
            self.rows.add(mids, self.store.fetch_rows(mids, self.f_lam))
            loc = self.rows.loc[uids]
        return self.rows.buf[loc]

    def vectors_for(self, uids):
        """(vectors [U, D], device_hit [U]) aligned with unique ids."""
        loc = self.vecs.loc[uids]
        miss = loc < 0
        if miss.any():
            mids = uids[miss]
            v, h = _resolve_unique_vectors(mids, self.h2d, self.cache_vec,
                                           self.store, self.f_lam)
            self.vecs.add(mids, v, h)
            loc = self.vecs.loc[uids]
        return self.vecs.buf[loc], self.vecs.hit[loc]

    def stage(self, pred):
        """Speculative stage of the predicted ids ``pred``."""
        ids = np.unique(pred[pred >= 0])
        if not ids.size:
            return
        self.validate()
        rows = self.rows_for(ids, speculative=True)
        nxt = np.unique(rows[rows >= 0])
        if not nxt.size:
            return
        if self.stage_vectors:
            self.vectors_for(nxt)
        if self.prefetch_budget > 0:
            self._prefetch_two_ahead(nxt)

    def _prefetch_two_ahead(self, cand):
        """Async disk prefetch one hop past the staged frontier: peek the
        hottest staged candidates' adjacency and enqueue their cold
        neighbors."""
        if cand.size > self.probe:
            cand = cand[np.argpartition(-self.f_lam[cand],
                                        self.probe - 1)[:self.probe]]
        hrows = self.store.peek_rows(cand)
        nxt = np.unique(hrows[hrows >= 0])
        nxt = nxt[self.store.loc[nxt] < 0]
        if nxt.size:
            b = self.prefetch_budget
            if nxt.size > b:
                nxt = nxt[np.argpartition(-self.f_lam[nxt], b - 1)[:b]]
            self.store.prefetch(nxt, self.f_lam)


def _predict_prefetch(store, nb, valid, f_lam, budget, probe=8):
    """Predicted next-frontier prefetch for the non-speculative path: peek
    the hottest candidates' adjacency and enqueue their non-resident
    neighbors to the background prefetcher."""
    cand = np.unique(nb[valid])
    if not cand.size:
        return
    if cand.size > probe:
        cand = cand[np.argpartition(-f_lam[cand], probe - 1)[:probe]]
    hrows = store.peek_rows(cand)
    nxt = np.unique(hrows[hrows >= 0])
    nxt = nxt[store.loc[nxt] < 0]
    if nxt.size:
        if nxt.size > budget:
            nxt = nxt[np.argpartition(-f_lam[nxt], budget - 1)[:budget]]
        store.prefetch(nxt, f_lam)


def _ship_unique_vectors(ids, valid, resolve):
    """The executor's ship-unique protocol, shared by the exact round
    dispatch and the PQ re-rank: dedup a [B, C] id matrix (invalid lanes
    collapse onto placeholder id 0, whose distances the dispatch masks),
    resolve vectors for the unique ids through ``resolve``. The reference
    pads the unique rows to power-of-four buckets to bound XLA compiles;
    the padded rows are never referenced, so the port ships none.
    Returns (uvec [U, D], uhit [U], inv [B, C] int32)."""
    B, C = ids.shape
    uc, inv = np.unique(np.where(valid, ids, 0).reshape(-1),
                        return_inverse=True)
    uvec, uhit = resolve(uc)
    return uvec, uhit, inv.reshape(B, C).astype(np.int32)


def _pow2_bucket(u: int, floor: int = 512) -> int:
    """The reference's power-of-four bucket (512 floor) for a count; the
    filtered scan pads its matched ids to it."""
    b = floor
    while b < u:
        b *= 4
    return b


def _pq_filtered_scan_dispatch(codes, centroids, queries, cand_ids, depth):
    """Brute-force ADC scan over a filtered id set, the fallback's coarse
    stage: one ``pq_adc`` launch scores every matching id (``cand_ids``
    [B, Mp] int32, -1 padded: +inf there) and keeps the top ``depth``
    for the exact re-rank, ties to the lower lane. Returns (ids [B,
    depth], -1 where the distance is not finite, and distances)."""
    lut = adc_lut(centroids, queries)
    d = adc_gather(codes, lut, cand_ids)
    d = torch.where(cand_ids >= 0, d, INF)
    dd, idx = smallest_k(d, depth)
    ids = _take(cand_ids, idx)
    return torch.where(torch.isfinite(dd), ids, -1), dd


def _filtered_brute_force(backend, queries, qt, hmask, alive_snap, sp, pq,
                          rerank_depth, h2d, cache_vec, f_lam, filter_sel,
                          dev) -> TieredSearchResult:
    """The selectivity fallback of ``search_tiered``: exact search over
    the matched id set, no traversal. PQ lane: one ``pq_adc`` scan of
    every match keeps the top ``rerank_depth``, then the exact re-rank;
    exact lane: the re-rank alone over every match. The matched ids are
    padded to a power-of-four bucket ``Mp`` and materialized as a
    contiguous [B, Mp] int32 matrix, the shape the kernel reads."""
    B = queries.shape[0]
    k = sp.k
    n = max(backend.n, 1)
    matched = np.where(alive_snap[:n] & hmask[:n])[0]
    if matched.size == 0:
        z = np.zeros((B, 0), np.int32)
        return TieredSearchResult(
            np.full((B, k), -1, np.int32),
            np.full((B, k), np.inf, np.float32),
            z, z.astype(bool), 0, 0,
            filter_path="fallback", filter_selectivity=filter_sel)
    Mp = _pow2_bucket(matched.size)
    cand = np.full((Mp,), -1, np.int64)
    cand[:matched.size] = matched
    dispatches = 0
    if pq is not None:
        codes = pq.synced_codes()
        depth = min(effective_rerank_depth(rerank_depth, k, sp.pool), Mp)
        cand_t = torch.as_tensor(cand.astype(np.int32), device=dev)
        top_t, _ = _pq_filtered_scan_dispatch(
            codes, pq.codebook.centroids, qt,
            cand_t.expand(B, Mp).contiguous(), depth)
        dispatches += 1
        top_ids = top_t.cpu().numpy().astype(np.int64)
    else:
        top_ids = np.broadcast_to(cand, (B, Mp))
    valid_r = top_ids >= 0
    uvec, _, inv = _ship_unique_vectors(
        top_ids, valid_r,
        lambda u: _resolve_unique_vectors(u, h2d, cache_vec, backend.store,
                                          f_lam))
    ids_k, d_k = _pq_rerank_dispatch(
        torch.as_tensor(top_ids.astype(np.int32), device=dev),
        torch.as_tensor(uvec, device=dev), torch.as_tensor(inv, device=dev),
        torch.as_tensor(valid_r, device=dev), qt, k)
    dispatches += 1
    ids_np = ids_k.cpu().numpy().astype(np.int32)
    d_np = d_k.cpu().numpy().astype(np.float32)
    if ids_np.shape[1] < k:      # fewer matches than k: pad the tail
        pad = k - ids_np.shape[1]
        ids_np = np.pad(ids_np, ((0, 0), (0, pad)), constant_values=-1)
        d_np = np.pad(d_np, ((0, 0), (0, pad)), constant_values=np.inf)
    acc = np.where(valid_r, top_ids, -1).astype(np.int32)
    acc_hit = (h2d[np.clip(acc, 0, None)] >= 0) & (acc >= 0)
    return TieredSearchResult(ids_np, d_np, acc, acc_hit, 0, dispatches,
                              filter_path="fallback",
                              filter_selectivity=filter_sel)


def search_tiered(backend, cache_mirror, queries, seed, sp: SearchParams,
                  *, f_lam=None, prefetch_budget: int = 0,
                  entry_ids=None, speculate: bool = True,
                  spec_width: int = 0, spec_rank: str = "flam",
                  spec_predict=None, pq=None, rerank_depth: int = 0,
                  topo=None, fused_rounds: int = 0, filter=None,
                  filter_fallback_selectivity: float = 0.0,
                  filter_sample: int = 1024,
                  device="cuda") -> TieredSearchResult:
    """Hop-batched frontier search over a disk-backed graph (paper
    Algorithm 1 in its GPU-CPU-disk form), the twin of
    ``repro.core.search.search_tiered``. Per round: one bulk (delta) row
    fetch, one unique-id vector cascade, one distance+merge dispatch on
    ``device``; a speculative stage (``_SpecPipeline``) prepares the next
    round's rows and vectors, so at read-back only mispredicted ids need
    IO. Speculation is transparent: results equal ``speculate=False``.

    backend: ``tiers.TieredBackend``; cache_mirror: ``cache.HostPlacement``.
    ``entry_ids`` [B, pool] overrides the random entry pool, which is
    otherwise drawn from ``np.random.default_rng(seed)`` as the reference
    draws it. ``spec_width``: predicted frontier ids staged per query per
    round (0 -> beam). ``spec_rank``: ``"flam"`` ranks round predictions
    by the F_λ probe, ``"dist"`` by exact host distances over the staged
    vectors. ``spec_predict``: prediction hook with the signature of
    ``predict_frontier``.

    ``pq``: a ``quant.PQCodes`` lane on ``device``. Rounds then score
    candidates from the resident codes (``pq_adc``); only adjacency rows
    cross tiers, and a final stage re-ranks the top ``rerank_depth`` pool
    entries (<= 0: the whole pool; clamped to [k, pool]) with exact
    vectors from the cascade. ``topo``: a ``cache.TopoCache`` on
    ``device`` (PQ lane only): the round loop runs through the fused
    dispatch (``_pq_fused_dispatch``, ``_fused_topo_shell``) with at most
    ``fused_rounds`` rounds per dispatch (0 = uncapped); results equal
    the per-round executor's.

    ``filter``: a ``filters.FilterSpec``; needs ``backend.attrs``. Its
    selectivity is sampled over ``filter_sample`` ids, deterministic in
    ``seed``: at or above ``filter_fallback_selectivity`` the predicate
    joins the executor's invalid-lane masking (filtered-out candidates
    never enter the pool), below it the query takes the brute-force scan
    over the matched set (``_filtered_brute_force``). The path and the
    estimate ride the result (``filter_path``, ``filter_selectivity``).
    """
    dev = torch.device(device)
    store = backend.store
    alive = backend.alive
    # ONE snapshot read: h2d and vectors from the same publish
    view = cache_mirror.view
    h2d, cache_vec = view.h2d, view.vectors
    if f_lam is None:
        f_lam = cache_mirror.scores(backend.e_in)

    queries = np.asarray(queries, np.float32)
    B, D = queries.shape
    L, R, k = sp.pool, backend.degree, sp.k
    beam = max(1, min(sp.beam, L))
    rounds = _n_rounds(sp)
    C = beam * R
    n = max(backend.n, 1)
    id_bound = int(backend.capacity)
    qt = torch.as_tensor(queries, device=dev)

    # --- predicate lane (core/filters.py) -------------------------------
    filter_path, filter_sel = "none", 1.0
    alive_t = None
    if filter is not None:
        from repro_torch.core.filters import (compile_filter,
                                              device_pass_mask,
                                              estimate_selectivity,
                                              host_pass)
        attrs = backend.attrs
        if attrs is None:
            raise ValueError("filtered search requires an attached "
                             "attribute store (EngineConfig.attributes)")
        cf = compile_filter(filter, attrs.schema)
        hmask = host_pass(cf, attrs.tags, attrs.nums)
        filter_sel = estimate_selectivity(cf, attrs, alive, backend.n,
                                          sample=filter_sample, seed=seed)
        if filter_sel < filter_fallback_selectivity:
            # a graph walk would starve: brute-force scan the matched set
            return _filtered_brute_force(backend, queries, qt, hmask, alive,
                                         sp, pq, rerank_depth, h2d,
                                         cache_vec, f_lam, filter_sel, dev)
        filter_path = "graph"
        # the predicate folds into the executor's invalid-lane masking
        # (entry pool, every round's valid lanes); the fused rounds read
        # its device twin, ANDed from the attribute mirror
        alive = alive & hmask                         # np copy, not a view
        if pq is not None and topo is not None:
            alive_t = torch.as_tensor(backend.alive, device=dev) \
                & device_pass_mask(attrs, cf)

    if entry_ids is None:
        rng = np.random.default_rng(seed)
        entry_ids = rng.integers(0, n, (B, L))
    entry_ids = np.asarray(entry_ids, np.int64)

    use_pq = pq is not None
    if use_pq:
        # epoch read BEFORE the sync: a write racing the sync re-syncs
        # next round rather than never
        codes_epoch = store.write_epoch
        codes = pq.synced_codes()
        depth = effective_rerank_depth(rerank_depth, k, L)

    spec = None
    if speculate:
        spec = _SpecPipeline(backend, h2d, cache_vec, f_lam,
                             prefetch_budget=prefetch_budget,
                             stage_vectors=not use_pq)
        spec.validate()
        width = spec_width if spec_width > 0 else beam
        predict = spec_predict if spec_predict is not None else \
            predict_frontier

    entry_alive = alive[entry_ids]
    entry_t = torch.as_tensor(entry_ids.astype(np.int32), device=dev)
    if use_pq:
        # entry pool scored from the resident codes: no vector fetch
        pool_ids, pool_d, visited, curr_t, lut = _pq_entry_dispatch(
            entry_t, torch.as_tensor(entry_alive, device=dev), codes,
            pq.codebook.centroids, qt, beam, id_bound)
        dispatches = 1
        if spec is not None:
            # no host vectors in the code lane: the entry prediction uses
            # the F_λ probe (rows-only staging)
            spec.stage(predict(entry_ids, entry_alive, f_lam, width))
    else:
        # entry pool: one unique-id cascade + one entry dispatch
        ue, inv_e = np.unique(entry_ids.reshape(-1), return_inverse=True)
        if spec is not None:
            uev, _ = spec.vectors_for(ue)
        else:
            uev, _ = _resolve_unique_vectors(ue, h2d, cache_vec, store,
                                             f_lam)
        ev = uev[inv_e].reshape(B, L, D)
        pool_ids, pool_d, visited, curr_t = _tiered_entry_dispatch(
            entry_t, torch.as_tensor(ev, device=dev),
            torch.as_tensor(entry_alive, device=dev), qt, beam, id_bound)
        dispatches = 1
        if spec is not None:
            # the entry vectors are host-resident, so the first frontier
            # is predicted from exact host distances
            pred = predict(entry_ids, entry_alive, f_lam, width,
                           d_host=_host_sqdist(ev, queries))
            spec.stage(pred)
    curr = curr_t.cpu().numpy()               # [B, beam], -1 = idle lane

    acc_ids = np.full((B, rounds, C), -1, np.int32)
    acc_hit = np.zeros((B, rounds, C), bool)
    it = 0
    topo_hits = topo_misses = 0
    if use_pq and topo is not None:
        (pool_ids, pool_d, acc_ids, it, extra, topo_hits,
         topo_misses) = _fused_topo_shell(
            store, topo, spec, alive, f_lam, pq, codes, codes_epoch,
            lut, pool_ids, pool_d, visited, curr_t, beam, rounds,
            id_bound, fused_rounds,
            stage_width=(width if spec is not None else 0), alive_t=alive_t)
        dispatches += extra
    else:
        for _ in range(rounds):
            ok = curr >= 0
            if not ok.any():
                break
            # ONE bulk row fetch for the whole beam; staged rows from the
            # speculative stage make it a delta fetch
            ucur = np.unique(curr[ok])
            if spec is not None:
                spec.validate()
                urows = spec.rows_for(ucur)
            else:
                urows = store.fetch_rows(ucur, f_lam)
            nb = np.full((B, beam, R), -1, np.int32)
            nb[ok] = urows[np.searchsorted(ucur, curr[ok])]
            nb = nb.reshape(B, C)

            valid = (nb >= 0) & alive[np.clip(nb, 0, None)]
            nb_t = torch.as_tensor(nb, device=dev)
            valid_t = torch.as_tensor(valid, device=dev)
            if use_pq:
                ep = store.write_epoch
                if ep != codes_epoch:   # concurrent insert: fold fresh codes
                    codes_epoch = ep
                    codes = pq.synced_codes()
                # only the id matrix crosses to the device
                pool_ids, pool_d, visited, curr_t = _pq_round_dispatch(
                    pool_ids, pool_d, visited, nb_t, valid_t, codes, lut,
                    beam, id_bound)
                dispatches += 1
                acc_ids[:, it] = np.where(valid, nb, -1)
                if spec is not None:
                    if it + 1 < rounds:
                        spec.stage(predict(nb, valid, f_lam, width))
                elif prefetch_budget > 0:
                    _predict_prefetch(store, nb, valid, f_lam,
                                      prefetch_budget)
                curr = curr_t.cpu().numpy()        # the round's sync point
                it += 1
                continue
            uvec, uhit, inv = _ship_unique_vectors(
                nb, valid,
                spec.vectors_for if spec is not None else
                (lambda u: _resolve_unique_vectors(u, h2d, cache_vec, store,
                                                   f_lam)))
            pool_ids, pool_d, visited, curr_t = _tiered_round_dispatch(
                pool_ids, pool_d, visited, nb_t,
                torch.as_tensor(uvec, device=dev),
                torch.as_tensor(inv, device=dev), valid_t, qt, beam,
                id_bound)
            dispatches += 1
            acc_ids[:, it] = np.where(valid, nb, -1)
            acc_hit[:, it] = uhit[inv] & valid
            if spec is not None:
                if it + 1 < rounds:   # the last round has no next to stage
                    d_host = None
                    if spec_rank == "dist":
                        # re-rank by exact host distances over the unique
                        # vectors already on the host
                        d_host = _host_sqdist(uvec[inv], queries)
                    spec.stage(predict(nb, valid, f_lam, width,
                                       d_host=d_host))
            elif prefetch_budget > 0:
                _predict_prefetch(store, nb, valid, f_lam, prefetch_budget)
            curr = curr_t.cpu().numpy()            # the round's sync point
            it += 1

    spec_hits = spec.hits if spec else 0
    spec_misses = spec.misses if spec else 0
    if use_pq:
        # device-hit flags for the placement pass: in the code lane an
        # access "hits" when its id sits in the exact-vector cache (the
        # tier the re-rank reads)
        flat = acc_ids.reshape(B, -1)
        acc_hit_flat = (h2d[np.clip(flat, 0, None)] >= 0) & (flat >= 0)

        # exact re-rank of the top ADC-ranked pool entries
        top_ids = pool_ids[:, :depth].cpu().numpy()
        valid_r = (top_ids >= 0) \
            & np.isfinite(pool_d[:, :depth].cpu().numpy())
        uvec, _, inv = _ship_unique_vectors(
            top_ids, valid_r,
            lambda u: _resolve_unique_vectors(u, h2d, cache_vec, store,
                                              f_lam))
        ids_k, d_k = _pq_rerank_dispatch(
            torch.as_tensor(top_ids, device=dev),
            torch.as_tensor(uvec, device=dev),
            torch.as_tensor(inv, device=dev),
            torch.as_tensor(valid_r, device=dev), qt, k)
        dispatches += 1
        return TieredSearchResult(
            ids_k.cpu().numpy(), d_k.cpu().numpy(), flat, acc_hit_flat, it,
            dispatches, spec_hits, spec_misses, topo_hits, topo_misses,
            filter_path, filter_sel)

    pool_ids, pool_d = pool_ids.cpu().numpy(), pool_d.cpu().numpy()
    topk_ids = np.where(np.isfinite(pool_d[:, :k]), pool_ids[:, :k], -1)
    return TieredSearchResult(topk_ids.astype(np.int32), pool_d[:, :k],
                              acc_ids.reshape(B, -1),
                              acc_hit.reshape(B, -1), it, dispatches,
                              spec_hits, spec_misses,
                              filter_path=filter_path,
                              filter_selectivity=filter_sel)


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
