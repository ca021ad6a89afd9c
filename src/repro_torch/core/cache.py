"""Workload-Aware Vector Placement (twin of ``repro.core.cache``): the
device-mode pass ``apply_wavp`` over index-state tensors, and for the
three-tier engine the host mirrors (``HostPlacement``, the numpy pass
``apply_wavp_host``) and the device-resident topology row cache
(``TopoCache``).

F_λ(x) = α·F_recent(x,t) + β·log(1+E_in(x)) reduces the gain test to
F_λ(x) > θ. Placement runs once per search batch: misses whose score
clears θ are promoted into empty slots first, then into slots whose
clock bit is 0, in ascending F_λ; the batch's hits refresh the clock
bits; θ adapts to the miss pressure. Baselines: LRU, LFU, LRFU, ``never``
(misses always computed on the capacity tier), ``always``.

One deliberate difference in ``apply_wavp``: the reference scatters the host->slot map
from every promotion lane, and the lanes that do not write all land on
index 0 with whatever value they read, so after host id 0 is evicted
its map entry may survive (the write that wins depends on order). Here
only the lanes that really write scatter, which keeps the map and
``slot_hid`` a bijection.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# Host-side placement for the tiered (disk-backed) engine
# ---------------------------------------------------------------------------

class CacheView(NamedTuple):
    """Immutable (h2d, vectors) pair readers resolve device hits against.
    Published as ONE attribute so a concurrent placement pass can never
    pair an old mapping with new payloads (torn read)."""
    h2d: np.ndarray
    vectors: torch.Tensor


def payload_rows(vectors, slots) -> np.ndarray:
    """fp32 rows ``slots`` of an exact-cache payload (fp32 or bf16 CPU
    tensor) as numpy."""
    idx = torch.from_numpy(np.asarray(slots, np.int64))
    return vectors[idx].float().numpy()


class HostPlacement:
    """Host mirror of CacheState + Stats for the three-tier engine (twin
    of ``repro.core.cache.HostPlacement``).

    The bookkeeping is numpy, as in the reference. The exact-vector
    payload is a CPU tensor of ``dtype`` (float32 or bfloat16): the
    reference keeps a bf16 payload as an ``ml_dtypes`` numpy array, which
    the port does without; both round fp32 to bf16 to nearest even, so
    the payload bits are the reference's. Readers take ``self.view`` once;
    the update pass builds fresh arrays and publishes them through one
    ``view`` assignment. WAVP manages exact-vector slots only; PQ codes
    are unconditionally device-resident and never appear here."""

    def __init__(self, n_ids: int, n_slots: int, dim: int, *, theta=1.0,
                 alpha=1.0, beta=1.0, dtype=torch.float32):
        self.vectors = torch.zeros((n_slots, dim), dtype=dtype)
        self.slot_hid = np.full((n_slots,), -1, np.int32)
        self.h2d = np.full((n_ids,), -1, np.int32)
        self.ref = np.zeros((n_slots,), np.int8)
        self.slot_ver = np.zeros((n_slots,), np.int32)
        self.f_recent = np.zeros((n_ids,), np.float32)
        self.theta = float(theta)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.counters = {f: 0 for f in Stats._fields}
        self.view = CacheView(self.h2d, self.vectors)

    @property
    def n_slots(self) -> int:
        return self.vectors.shape[0]

    @property
    def vector_bytes(self) -> int:
        """Exact-vector payload bytes (the WAVP-managed slots)."""
        return self.vectors.numel() * self.vectors.element_size()

    def scores(self, e_in):
        return f_lambda_np(self.f_recent, e_in, self.alpha, self.beta)

    def warm(self, ids, vectors):
        """Cold-start preload (paper §4.4): fill slots [0, len(ids))."""
        m = min(len(ids), self.n_slots)
        self.vectors[:m] = torch.from_numpy(
            np.asarray(vectors[:m], np.float32)).to(self.vectors.dtype)
        self.slot_hid[:m] = np.asarray(ids[:m], np.int32)
        self.h2d[np.asarray(ids[:m])] = np.arange(m, dtype=np.int32)
        self.view = CacheView(self.h2d, self.vectors)

    def to_cache_state(self, device="cuda") -> CacheState:
        """The CacheState view on ``device`` (for ``engine.state``)."""
        def t(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=device)
        return CacheState(
            vectors=self.vectors.to(device), slot_hid=t(self.slot_hid),
            h2d=t(self.h2d), ref=t(self.ref), slot_ver=t(self.slot_ver),
            f_recent=t(self.f_recent), theta=t(self.theta, torch.float32),
            alpha=t(self.alpha, torch.float32),
            beta=t(self.beta, torch.float32))

    def to_stats(self, device="cuda") -> Stats:
        return Stats(*(torch.tensor(self.counters[f], dtype=torch.int32,
                                    device=device) for f in Stats._fields))


class TopoCache:
    """Device-resident topology tier (twin of
    ``repro.core.cache.TopoCache``): a row-slot lane caching adjacency
    rows so the fused multi-round executor walks the graph without a host
    round trip per round.

    Residency is ordered by F_λ: admission is demand-driven (the fused
    shell installs the frontier's missing rows) and eviction takes the
    lowest-F_λ residents first, the live frontier protected. ``validate``
    fences on the store's write epoch: when it moved, every resident row
    is re-read in one bulk ``peek_rows``. Host arrays are the truth;
    ``synced`` publishes (rows, h2s) tensors on ``device``, both together,
    re-copied in full after a change. All mutation happens under one
    lock."""

    def __init__(self, capacity: int, slots: int, degree: int,
                 device="cuda"):
        self.capacity = int(capacity)
        self.slots = int(slots)
        self.degree = int(degree)
        self.device = torch.device(device)
        self.rows = np.full((max(self.slots, 1), degree), -1, np.int32)
        self.slot_hid = np.full((max(self.slots, 1),), -1, np.int64)
        self.h2s = np.full((capacity,), -1, np.int32)
        self.epoch = None            # set on first validate()
        self.hits = 0                # frontier ids found resident
        self.misses = 0              # frontier ids needing a delta fetch
        self.installs = 0
        self.evictions = 0
        self.flushes = 0             # epoch-fence wholesale refreshes
        self._cursor = 0             # slots allotted once, like TieredStore
        self._dirty = True
        self._rows_t = None
        self._h2s_t = None
        self._lock = threading.Lock()

    @property
    def row_bytes(self) -> int:
        """Device-resident topology payload (bytes_per_tier reporting)."""
        return int(self.rows.nbytes + self.h2s.nbytes) if self.slots else 0

    @property
    def resident(self) -> int:
        return int((self.slot_hid >= 0).sum())

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0

    def validate(self, store) -> None:
        """Epoch fence: when the store's write epoch moved, re-read every
        resident row wholesale (one bulk peek) and republish."""
        ep = store.write_epoch
        with self._lock:
            if self.epoch is None:
                self.epoch = ep
                return
            if ep == self.epoch:
                return
            occ = self.slot_hid >= 0
            if occ.any():
                self.rows[occ] = store.peek_rows(self.slot_hid[occ])
                self._dirty = True
            self.epoch = ep
            self.flushes += 1

    def install(self, ids, rows, f_lam=None, protect=None) -> bool:
        """Install rows for unique non-resident ``ids``; returns False
        (installing nothing) when they cannot all fit without evicting a
        protected id — the caller falls back to a per-round dispatch.
        Eviction order: free slots first, then ascending F_λ."""
        ids = np.asarray(ids)
        m = len(ids)
        if m == 0:
            return True
        if self.slots == 0 or m > self.slots:
            return False
        with self._lock:
            free = self.slots - self._cursor
            spill = max(0, m - free)
            take = m - spill
            slots = np.empty((m,), np.int64)
            if spill:
                occ_ids = self.slot_hid
                if f_lam is not None:
                    key = np.asarray(f_lam, np.float64)[
                        np.clip(occ_ids, 0, None)].copy()
                else:
                    key = np.arange(len(occ_ids), dtype=np.float64)
                key[occ_ids < 0] = np.inf       # unpublished slots
                if protect is not None:
                    ps = self.h2s[np.asarray(protect)]
                    key[ps[ps >= 0]] = np.inf
                victims = np.argpartition(key, spill - 1)[:spill]
                if not np.isfinite(key[victims]).all():
                    return False                # would evict a protected row
                old = occ_ids[victims]
                self.h2s[old[old >= 0]] = -1
                slots[take:] = victims
                self.evictions += int(spill)
            if take:
                slots[:take] = np.arange(self._cursor, self._cursor + take)
                self._cursor += take
            self.rows[slots] = np.asarray(rows, np.int32)
            self.slot_hid[slots] = ids
            self.h2s[ids] = slots.astype(np.int32)
            self.installs += m
            self._dirty = True
            return True

    def lookup(self, ids):
        """(rows [m, R], resident [m]) host snapshot for unique ids — one
        locked read, so a concurrent install can never pair an id with
        another id's just-evicted slot contents."""
        ids = np.asarray(ids)
        with self._lock:
            s = self.h2s[ids]
            ok = s >= 0
            rows = np.full((len(ids), self.degree), -1, np.int32)
            rows[ok] = self.rows[s[ok]]
            return rows, ok

    def synced(self):
        """Publish (rows, h2s) tensors on the cache's device; both
        republished together so a dispatch can never pair an old directory
        with new rows."""
        with self._lock:
            if self._dirty or self._rows_t is None:
                self._rows_t = torch.tensor(self.rows, device=self.device)
                self._h2s_t = torch.tensor(self.h2s, device=self.device)
                self._dirty = False
            return self._rows_t, self._h2s_t


def warm_topo_cache(backend, slots: int, device="cuda") -> TopoCache:
    """Build, warm and attach the topology row cache for a tiered
    backend: full residency when ``slots`` covers the capacity (0 = the
    capacity), else the top-E_in live rows."""
    cap = backend.capacity
    slots = slots or cap
    topo = TopoCache(cap, slots, backend.degree, device=device)
    topo.validate(backend.store)
    live = np.flatnonzero(backend.alive[:backend.n])
    if live.size > slots:          # partial cache: warm the hottest rows
        live = live[np.argsort(-backend.e_in[live], kind="stable")[:slots]]
    if live.size:
        topo.install(live, backend.store.peek_rows(live))
    backend.attach_topo(topo)
    return topo


def apply_wavp_host(hp: HostPlacement, acc_ids, acc_hit, sp: SearchParams,
                    *, alive, e_in, fetch_vectors, now=0,
                    cascade_promote: bool = True) -> None:
    """Post-batch placement (Algorithm 2) over host mirrors — the tiered
    twin of ``apply_wavp`` with the reference's decision rules.

    acc_ids/acc_hit: [B, rounds·beam·R] accessed ids (-1 pad) and
    device-hit flags. alive/e_in: host graph metadata. fetch_vectors(ids)
    resolves promoted payloads through the host-window/disk cascade.
    ``cascade_promote``: clock protection orders the eviction sweep, but
    a protected resident yields to a strictly hotter incomer (otherwise
    batched serving re-protects every resident each pass and promotion
    freezes at the cold-start set).
    """
    N = hp.h2d.shape[0]
    M = hp.n_slots
    ids = np.asarray(acc_ids).reshape(-1)
    hit = np.asarray(acc_hit).reshape(-1)
    valid = ids >= 0

    counts = np.bincount(ids[valid], minlength=N).astype(np.float32)
    miss_counts = np.bincount(ids[valid & ~hit],
                              minlength=N).astype(np.float32)

    if sp.policy == "lru":
        f_recent = np.where(counts > 0, np.float32(now) + 1.0, hp.f_recent)
    else:
        decay = np.float32(1.0 if sp.policy == "lfu" else sp.decay)
        f_recent = hp.f_recent * decay + counts
    hp.f_recent = f_recent.astype(np.float32)

    n_acc = int(valid.sum())
    n_hit = int((valid & hit).sum())
    c = hp.counters
    c["accesses"] += n_acc
    c["hits"] += n_hit
    c["misses"] += n_acc - n_hit

    if sp.policy == "never":
        c["cpu_computed"] += n_acc - n_hit
        return

    if sp.policy in ("wavp", "always"):
        score = hp.scores(e_in)
    else:
        score = hp.f_recent

    thr = hp.theta if sp.policy == "wavp" else -np.inf
    cand_mask = (miss_counts > 0) & (hp.h2d < 0) & np.asarray(alive, bool) \
        & (score > thr)
    cand_ids = np.where(cand_mask)[0]
    P = min(sp.max_promote, M, cand_ids.size)
    n_prom = n_evict = 0
    # copy-on-write: readers resolve hits through hp.view
    h2d, slot_hid = hp.h2d.copy(), hp.slot_hid.copy()
    vectors, slot_ver = hp.vectors, hp.slot_ver
    vslot = np.empty((0,), np.int64)
    if P > 0:
        top = cand_ids[np.argpartition(-score[cand_ids], P - 1)[:P]]
        top = top[np.argsort(-score[top])]
        prom_score = score[top]

        occ = hp.slot_hid >= 0
        occ_score = np.where(occ, score[np.clip(hp.slot_hid, 0, None)],
                             -np.inf)
        protected = (hp.ref > 0) & occ
        if cascade_promote:
            # empty first, then ref==0 ascending F_λ, then ref==1
            # ascending F_λ; any occupant yields to a strictly hotter
            # incomer
            victims = np.lexsort((occ_score, protected))[:P]
            improves = ~occ[victims] | (occ_score[victims] < prom_score)
        else:
            evict_key = np.where(~occ, -np.inf,
                                 np.where(protected, np.inf, occ_score))
            victims = np.argsort(evict_key, kind="stable")[:P]
            improves = ~protected[victims] & (
                (evict_key[victims] < prom_score) | ~occ[victims])

        vslot = victims[improves]
        new_hid = top[improves]
        old_hid = hp.slot_hid[vslot]
        evicted = old_hid[old_hid >= 0]
        vectors, slot_ver = hp.vectors.clone(), hp.slot_ver.copy()
        h2d[evicted] = -1
        payload = np.asarray(fetch_vectors(new_hid), np.float32)
        vectors[torch.from_numpy(vslot)] = torch.from_numpy(payload).to(
            vectors.dtype)
        slot_hid[vslot] = new_hid.astype(np.int32)
        h2d[new_hid] = vslot.astype(np.int32)
        slot_ver[vslot] = 0
        n_prom = int(improves.sum())
        n_evict = int(evicted.size)

    # clock ref refresh EVERY batch: hits this batch + fresh entries get a
    # second chance
    ref = np.zeros((M,), np.int8)
    hit_ids = ids[valid & hit]
    hit_slots = h2d[hit_ids]
    ref[hit_slots[hit_slots >= 0]] = 1
    ref[vslot] = 1
    hp.vectors, hp.slot_hid, hp.h2d = vectors, slot_hid, h2d
    hp.slot_ver, hp.ref = slot_ver, ref
    hp.view = CacheView(h2d, vectors)

    if sp.policy == "wavp":
        mr = (n_acc - n_hit) / max(n_acc, 1)
        mean_f = (float(score[cand_mask].sum()) / max(int(cand_mask.sum()), 1))
        hp.theta = float(np.clip(hp.theta * 0.95 + 0.05 * mr * mean_f,
                                 1e-3, 1e6))

    c["promotions"] += n_prom
    c["evictions"] += n_evict
    c["transfers"] += n_prom
    c["cpu_computed"] += (n_acc - n_hit) - n_prom
