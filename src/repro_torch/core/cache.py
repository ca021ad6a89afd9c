"""Workload-Aware Vector Placement, device tier (twin of the device half
of ``repro.core.cache``).

F_λ(x) = α·F_recent(x,t) + β·log(1+E_in(x)) reduces the gain test to
F_λ(x) > θ. Placement runs once per search batch: misses whose score
clears θ are promoted into empty slots first, then into slots whose
clock bit is 0, in ascending F_λ; the batch's hits refresh the clock
bits; θ adapts to the miss pressure. Baselines: LRU, LFU, LRFU, ``never``
(misses always computed on the capacity tier), ``always``.

One deliberate difference: the reference scatters the host->slot map
from every promotion lane, and the lanes that do not write all land on
index 0 with whatever value they read, so after host id 0 is evicted
its map entry may survive (the write that wins depends on order). Here
only the lanes that really write scatter, which keeps the map and
``slot_hid`` a bijection.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.topk import argsort, largest_k
from repro_torch.core.types import (CacheState, GraphState, IndexState,
                                    SearchParams, Stats)


def f_lambda(cache: CacheState, graph: GraphState):
    """F_λ(x) = α·F_recent + β·log(1+E_in) (paper eq. 2)."""
    return (cache.alpha * cache.f_recent
            + cache.beta * torch.log1p(graph.e_in.float()))


def f_lambda_np(f_recent, e_in, alpha=1.0, beta=1.0):
    """Host-side F_λ over numpy mirrors."""
    return (np.float32(alpha) * np.asarray(f_recent, np.float32)
            + np.float32(beta) * np.log1p(np.asarray(e_in, np.float32)))


def _policy_scores(policy, cache, graph):
    """Higher score = more worth caching. f_recent holds the policy's own
    statistic: timestamps for LRU, raw counts for LFU, decayed counts (CRF)
    for LRFU/WAVP."""
    if policy in ("wavp", "always"):
        return f_lambda(cache, graph)
    return cache.f_recent


def _pad1(x, fill):
    """``x`` with one extra leading-axis row of ``fill``: the row that
    masked-out scatter lanes write to."""
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)])


def apply_wavp(state: IndexState, acc_ids, acc_hit, sp: SearchParams,
               now=0) -> IndexState:
    """Post-batch placement pass (Algorithm 2, batched).

    acc_ids [B, rounds·beam·R] accessed ids (-1 pad) from the frontier
    executor's round logs, acc_hit [B, rounds·beam·R] hit flags.
    Returns a new state; the input state is not modified.
    """
    graph, cache, stats = state.graph, state.cache, state.stats
    N = graph.capacity
    M = cache.n_slots
    i32 = torch.int32

    ids = acc_ids.reshape(-1)
    hit = acc_hit.reshape(-1)
    valid = ids >= 0
    cid = ids.clamp(0, N - 1)

    counts = torch.zeros((N,), dtype=torch.float32, device=ids.device) \
        .index_add_(0, cid, valid.float())
    miss_counts = torch.zeros((N,), dtype=torch.float32, device=ids.device) \
        .index_add_(0, cid, (valid & ~hit).float())

    if sp.policy == "lru":
        f_recent = torch.where(counts > 0, float(np.float32(now)) + 1.0,
                               cache.f_recent)
    else:
        decay = 1.0 if sp.policy == "lfu" else sp.decay
        f_recent = cache.f_recent * decay + counts
    cache = cache._replace(f_recent=f_recent)

    n_acc = valid.sum()
    n_hit = (valid & hit).sum()
    stats = stats._replace(
        accesses=stats.accesses + n_acc.to(i32),
        hits=stats.hits + n_hit.to(i32),
        misses=stats.misses + (n_acc - n_hit).to(i32),
    )

    if sp.policy == "never":
        stats = stats._replace(cpu_computed=stats.cpu_computed
                               + (n_acc - n_hit).to(i32))
        return IndexState(graph, cache, stats)

    score = _policy_scores(sp.policy, cache, graph)

    # ---- selective prefetch (Alg. 2 lines 1-2): F_λ(x) > θ to promote ----
    thr = cache.theta if sp.policy == "wavp" else -torch.inf
    cand_mask = (miss_counts > 0) & (cache.h2d < 0) & graph.alive \
        & (score > thr)
    cand_score = torch.where(cand_mask, score, -torch.inf)
    P = min(sp.max_promote, M)
    prom_score, prom_ids = largest_k(cand_score, P)
    prom_ids = prom_ids.to(i32)
    prom_valid = torch.isfinite(prom_score)

    # ---- predictive replacement (Alg. 2 lines 3-11), vectorized clock ----
    occ_score = torch.where(cache.slot_hid >= 0,
                            score[cache.slot_hid.clamp(0, N - 1)], -torch.inf)
    # eviction priority: empty slots first, then ref==0 by ascending F_λ;
    # ref==1 slots are protected this sweep (second chance).
    empty = cache.slot_hid < 0
    protected = (cache.ref > 0) & ~empty
    evict_key = torch.where(empty, -torch.inf,
                            torch.where(protected, torch.inf, occ_score))
    victims = argsort(evict_key)[:P]
    victim_ok = ~protected[victims]
    # only evict a victim whose score is lower than the incomer's
    improves = prom_valid & victim_ok & (
        (evict_key[victims] < prom_score) | empty[victims])

    vslot = torch.where(improves, victims, M)      # M = scatter no-op row
    old_hid = torch.where(improves, cache.slot_hid[victims], -1)
    new_hid = torch.where(improves, prom_ids, -1)

    # host -> slot map: only the lanes that evict / promote write
    h2d = _pad1(cache.h2d, -1)
    h2d[torch.where(old_hid >= 0, old_hid, N)] = -1
    h2d[torch.where(new_hid >= 0, new_hid, N)] = \
        torch.where(new_hid >= 0, vslot.to(i32), -1)
    h2d = h2d[:N]

    slot_hid = _pad1(cache.slot_hid, -1)
    slot_hid[vslot] = torch.where(improves, new_hid, -1)
    vectors = _pad1(cache.vectors, 0)
    vectors[vslot] = graph.vectors[new_hid.clamp(0, N - 1)].to(
        cache.vectors.dtype)
    slot_ver = _pad1(cache.slot_ver, 0)
    slot_ver[vslot] = graph.version[new_hid.clamp(0, N - 1)]

    # clock ref refresh: slots hit this batch get a second chance. Every
    # lane that is not a hit writes slot 0's bit, as in the reference: all
    # writes are 1, so the outcome is the reference's whatever the order,
    # and slot 0 is always referenced.
    hit_slot = torch.where(valid & hit, cache.h2d[cid], -1)
    ref = torch.zeros((M + 1,), dtype=torch.int8, device=ids.device)
    ref[hit_slot.clamp(min=0)] = 1
    ref[vslot] = 1                                 # fresh entries referenced

    n_prom = improves.sum().to(i32)
    n_evict = (improves & (old_hid >= 0)).sum().to(i32)
    cache = cache._replace(vectors=vectors[:M], slot_hid=slot_hid[:M],
                           h2d=h2d, ref=ref[:M], slot_ver=slot_ver[:M])

    # ---- θ adaptation (paper §4.4): more selective when misses rise with
    # high predicted demand ----
    if sp.policy == "wavp":
        miss_rate = (n_acc - n_hit) / n_acc.clamp(min=1)
        mean_f = torch.where(cand_mask, score, 0.0).sum() \
            / cand_mask.sum().clamp(min=1)
        pressure = miss_rate * mean_f
        theta = (cache.theta * 0.95 + 0.05 * pressure).clamp(1e-3, 1e6)
        cache = cache._replace(theta=theta)

    stats = stats._replace(
        promotions=stats.promotions + n_prom,
        evictions=stats.evictions + n_evict,
        transfers=stats.transfers + n_prom,
        cpu_computed=stats.cpu_computed
        + (n_acc - n_hit).to(i32) - n_prom)
    return IndexState(graph, cache, stats)


def miss_rate(stats: Stats) -> float:
    a = max(int(stats.accesses), 1)
    return float(stats.misses) / a
