"""Baseline ANNS indexes for the paper's comparison set (§6.1; twin of
``repro.core.baselines``).

* ``HNSW`` — hierarchical navigable small world (Malkov & Yashunin), the
  paper's CPU baseline. M=48, ef=128 defaults as in the paper. Deletions
  are mark-only (no repair) — reproducing the paper's observation that
  HNSW recall decays under churn. Host numpy, a copy of the reference's
  with the same ``default_rng(seed)`` draws.
* ``Vamana`` — DiskANN/FreshDiskANN-style graph with RobustPrune
  (α=1.2, R=64, L=128 per the paper's FreshDiskANN config) + lazy delete +
  consolidation at a deletion threshold. Host numpy, a copy as well.
* ``CagraStatic`` — static GPU-style index: full rebuild on update batches
  (amortized), search always on the device graph; models the
  GPU-baselines' update cost. It runs the port's ``build_index`` and
  ``search_batch`` on ``device`` (the card by default); its entry points
  come from a ``torch.Generator`` on that device where the reference
  splits a ``jax.random`` key, or from the caller (``search(entries=)``).
* The reference's docstring also names ``UVMEmulated`` (promote every
  miss: the unified-virtual-memory behaviour of CAGRA/GGNN beyond device
  memory). It is no class there either: it is the ``policy="always"``
  placement of ``core/cache.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.build import build_index
from repro_torch.core.search import frontier_search, search_batch
from repro_torch.core.types import SearchParams


def _l2(a, b):
    return ((a - b) ** 2).sum(-1)


class HNSW:
    def __init__(self, dim, M=16, ef_construction=128, ef_search=128,
                 seed=0, max_elements=1 << 20):
        self.dim, self.M, self.efc, self.efs = dim, M, ef_construction, ef_search
        self.ml = 1.0 / math.log(M)
        self.rng = np.random.default_rng(seed)
        self.vecs = np.zeros((0, dim), np.float32)
        self.levels: list[int] = []
        self.links: list[dict[int, list[int]]] = []   # per node: level->nbrs
        self.alive: list[bool] = []
        self.entry = -1
        self.max_level = -1

    # -- internals ------------------------------------------------------
    def _search_layer(self, q, entry, level, ef):
        visited = {entry}
        d0 = float(_l2(self.vecs[entry], q))
        cand = [(d0, entry)]
        best = [(d0, entry)]
        while cand:
            cand.sort()
            d, u = cand.pop(0)
            if d > max(b[0] for b in best) and len(best) >= ef:
                break
            nbrs = [v for v in self.links[u].get(level, []) if v not in visited]
            visited.update(nbrs)
            if not nbrs:
                continue
            ds = _l2(self.vecs[nbrs], q)
            for dv, v in zip(ds, nbrs):
                worst = max(b[0] for b in best)
                if len(best) < ef or dv < worst:
                    best.append((float(dv), v))
                    cand.append((float(dv), v))
                    if len(best) > ef:
                        best.sort()
                        best = best[:ef]
        best.sort()
        return best

    def _select(self, cands, M):
        return [v for _, v in sorted(cands)[:M]]

    # -- api -------------------------------------------------------------
    def insert(self, vectors):
        ids = []
        for vec in np.asarray(vectors, np.float32):
            nid = len(self.levels)
            self.vecs = np.vstack([self.vecs, vec[None]])
            lvl = int(-math.log(self.rng.random() + 1e-12) * self.ml)
            self.levels.append(lvl)
            self.links.append({})
            self.alive.append(True)
            if self.entry < 0:
                self.entry, self.max_level = nid, lvl
                ids.append(nid)
                continue
            cur = self.entry
            for level in range(self.max_level, lvl, -1):
                cur = self._search_layer(vec, cur, level, 1)[0][1]
            for level in range(min(lvl, self.max_level), -1, -1):
                cands = self._search_layer(vec, cur, level, self.efc)
                M = self.M * 2 if level == 0 else self.M
                sel = self._select(cands, M)
                self.links[nid][level] = list(sel)
                for v in sel:
                    row = self.links[v].setdefault(level, [])
                    row.append(nid)
                    if len(row) > M:
                        ds = _l2(self.vecs[row], self.vecs[v])
                        order = np.argsort(ds)[:M]
                        self.links[v][level] = [row[i] for i in order]
                cur = cands[0][1]
            if lvl > self.max_level:
                self.max_level, self.entry = lvl, nid
            ids.append(nid)
        return np.asarray(ids)

    def delete(self, ids):
        for i in np.asarray(ids).ravel():
            if 0 <= i < len(self.alive):
                self.alive[int(i)] = False

    def search(self, queries, k=10):
        out = np.full((len(queries), k), -1, np.int64)
        for qi, q in enumerate(np.asarray(queries, np.float32)):
            if self.entry < 0:
                continue
            cur = self.entry
            for level in range(self.max_level, 0, -1):
                cur = self._search_layer(q, cur, level, 1)[0][1]
            best = self._search_layer(q, cur, 0, self.efs)
            hits = [v for _, v in best if self.alive[v]][:k]
            out[qi, :len(hits)] = hits
        return out


class Vamana:
    """FreshDiskANN-style single-layer graph (R=64, L=128, alpha=1.2)."""

    def __init__(self, dim, R=32, L=64, alpha=1.2, seed=0,
                 consolidate_at=0.2):
        self.dim, self.R, self.L, self.alpha = dim, R, L, alpha
        self.rng = np.random.default_rng(seed)
        self.vecs = np.zeros((0, dim), np.float32)
        self.nbrs: list[np.ndarray] = []
        self.alive: list[bool] = []
        self.consolidate_at = consolidate_at
        self.n_deleted = 0

    def _greedy(self, q, L):
        n = len(self.nbrs)
        if n == 0:
            return []
        start = int(self.rng.integers(n))
        visited = set()
        pool = [(float(_l2(self.vecs[start], q)), start)]
        while True:
            unv = [(d, u) for d, u in pool if u not in visited]
            if not unv:
                break
            d, u = min(unv)
            visited.add(u)
            nb = [v for v in self.nbrs[u] if v >= 0 and v not in visited
                  and v not in {x for _, x in pool}]
            if nb:
                ds = _l2(self.vecs[nb], q)
                pool.extend((float(dv), v) for dv, v in zip(ds, nb))
            pool.sort()
            pool = pool[:L]
        return pool

    def _robust_prune(self, p_vec, cands):
        cands = sorted(set(cands), key=lambda v: float(_l2(self.vecs[v], p_vec)))
        out = []
        for v in cands:
            if len(out) >= self.R:
                break
            dv = float(_l2(self.vecs[v], p_vec))
            ok = True
            for u in out:
                if self.alpha * float(_l2(self.vecs[u], self.vecs[v])) < dv:
                    ok = False
                    break
            if ok:
                out.append(v)
        return np.asarray(out + [-1] * (self.R - len(out)), np.int64)

    def insert(self, vectors):
        ids = []
        for vec in np.asarray(vectors, np.float32):
            nid = len(self.nbrs)
            self.vecs = np.vstack([self.vecs, vec[None]])
            self.alive.append(True)
            pool = self._greedy(vec, self.L)
            cands = [u for _, u in pool if self.alive[u]]
            self.nbrs.append(self._robust_prune(vec, cands)
                             if cands else np.full(self.R, -1, np.int64))
            for v in self.nbrs[nid]:
                if v < 0:
                    continue
                row = [x for x in self.nbrs[v] if x >= 0] + [nid]
                if len(row) > self.R:
                    self.nbrs[v] = self._robust_prune(self.vecs[v], row)
                else:
                    self.nbrs[v] = np.asarray(
                        row + [-1] * (self.R - len(row)), np.int64)
            ids.append(nid)
        return np.asarray(ids)

    def delete(self, ids):
        for i in np.asarray(ids).ravel():
            if 0 <= i < len(self.alive) and self.alive[int(i)]:
                self.alive[int(i)] = False
                self.n_deleted += 1
        if self.n_deleted > self.consolidate_at * max(len(self.alive), 1):
            self.consolidate()

    def consolidate(self):
        for u in range(len(self.nbrs)):
            if not self.alive[u]:
                continue
            row = self.nbrs[u]
            dead = [v for v in row if v >= 0 and not self.alive[v]]
            if not dead:
                continue
            cands = [v for v in row if v >= 0 and self.alive[v]]
            for p in dead:
                cands += [w for w in self.nbrs[p] if w >= 0
                          and self.alive[w] and w != u]
            self.nbrs[u] = self._robust_prune(self.vecs[u], cands) \
                if cands else np.full(self.R, -1, np.int64)
        self.n_deleted = 0

    def search(self, queries, k=10):
        out = np.full((len(queries), k), -1, np.int64)
        for qi, q in enumerate(np.asarray(queries, np.float32)):
            pool = self._greedy(q, self.L)
            hits = [u for _, u in pool if self.alive[u]][:k]
            out[qi, :len(hits)] = hits
        return out


class CagraStatic:
    """Static device-resident index; updates buffer then trigger a full
    rebuild (GPU baselines' behavior under streaming updates)."""

    def __init__(self, dim, degree=32, rebuild_every=4096, seed=0,
                 device="cuda"):
        self.sp = SearchParams(k=10, pool=64, max_iters=96, policy="never")
        self.dim, self.degree = dim, degree
        self.rebuild_every = rebuild_every
        self.device = torch.device(device)
        self.pending = np.zeros((0, dim), np.float32)
        self.data = np.zeros((0, dim), np.float32)
        self.deleted: set[int] = set()
        self.state = None
        self.rebuilds = 0
        self._key = torch.Generator(device=self.device).manual_seed(seed)

    def _maybe_rebuild(self, force=False):
        if len(self.pending) == 0 and not force:
            return
        if not force and len(self.pending) < self.rebuild_every \
                and self.state is not None:
            return
        keep = np.asarray([i for i in range(len(self.data))
                           if i not in self.deleted], np.int64)
        self.data = np.concatenate([self.data[keep], self.pending])
        self.deleted = set()
        self.pending = np.zeros((0, self.dim), np.float32)
        if len(self.data) >= 8:
            cap = max(1024, 1 << int(np.ceil(np.log2(len(self.data) + 1))))
            self.state = build_index(self.data, degree=self.degree,
                                     cache_slots=64, n_max=cap, warm=False,
                                     device=self.device)
            self.rebuilds += 1

    def insert(self, vectors):
        base = len(self.data) + len(self.pending)
        self.pending = np.concatenate(
            [self.pending, np.asarray(vectors, np.float32)])
        self._maybe_rebuild()
        return np.arange(base, base + len(vectors))

    def delete(self, ids):
        self.deleted.update(int(i) for i in np.asarray(ids).ravel())

    def search(self, queries, k=10, entries=None):
        """Ids [B, k], -1 for none. ``entries`` [B, pool], when given,
        replaces the drawn entry points."""
        self._maybe_rebuild(force=self.state is None)
        if self.state is None:
            return np.full((len(queries), k), -1, np.int64)
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        sp = self.sp._replace(k=k)
        if entries is None:
            res = search_batch(self.state, q, self._key, sp)
        else:
            res = frontier_search(self.state, q, torch.tensor(
                np.asarray(entries, np.int32), device=self.device), sp)
        ids = res.ids.cpu().numpy()
        # mask deleted-but-not-rebuilt
        mask = np.isin(ids, np.asarray(list(self.deleted), np.int64)) \
            if self.deleted else np.zeros_like(ids, bool)
        return np.where(mask, -1, ids)
