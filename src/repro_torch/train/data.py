"""Data pipelines (a copy of ``repro.train.data``, which is numpy only:
for a seed, both packages give the same batches and the same stream
ops, byte for byte). One departure: ``TokenPipeline`` never drops a
batch, so that its sequence does not depend on how fast it is read
(the reference's drops one each time its queue stays full for 0.1 s).

* ``TokenPipeline`` — deterministic synthetic LM token stream with a
  background prefetch thread (double-buffered host->device).
* Streaming-vector workload generators (paper §6.1): SlidingWindow,
  ExpirationTime, Clustered, MSTuring-IH — each yields a sequence of
  (op, payload) steps over a base vector dataset, mirroring the 2023
  Big ANN Challenge streaming track semantics at reduced scale.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------

class TokenPipeline:
    """Synthetic-but-structured token batches (Zipfian unigram + repeated
    n-grams so the loss actually falls) with background prefetch."""

    def __init__(self, vocab: int, batch: int, seq: int, seed=0,
                 prefetch=2):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._worker, daemon=True)
        self._th.start()

    def _make(self):
        toks = self.rng.choice(self.vocab, size=(self.batch, self.seq),
                               p=self.probs).astype(np.int32)
        # inject learnable bigram structure: even positions predict odd
        toks[:, 1::2] = (toks[:, 0::2] * 7 + 13) % self.vocab
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                "mask": np.ones((self.batch, self.seq), np.float32)}

    def _worker(self):
        # a batch waits for its place in the queue: the reference's worker
        # drops a batch whose put times out (a consumer slower than 0.1 s
        # a batch skips batches), so that its sequence depends on timing
        batch = None
        while not self._stop.is_set():
            if batch is None:
                batch = self._make()
            try:
                self._q.put(batch, timeout=0.1)
                batch = None
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._th.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Streaming SANNS workloads (paper §6.1)
# ---------------------------------------------------------------------------

@dataclass
class StreamOp:
    kind: str                   # insert | delete | search
    vectors: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    queries: Optional[np.ndarray] = None


def _base_data(n, dim, seed, clustered=False, n_clusters=64):
    rng = np.random.default_rng(seed)
    if not clustered:
        return rng.normal(size=(n, dim)).astype(np.float32), None
    centers = rng.normal(scale=4.0, size=(n_clusters, dim))
    assign = rng.integers(n_clusters, size=n)
    data = (centers[assign] + rng.normal(size=(n, dim))).astype(np.float32)
    return data, assign


def sliding_window(n=20000, dim=32, t_max=200, queries_per_step=8, seed=0
                   ) -> Iterator[StreamOp]:
    """Insert one of T_max segments per step; from T_max/2+1 delete the
    segment inserted T_max/2 steps earlier (paper SlidingWindow)."""
    data, _ = _base_data(n, dim, seed)
    rng = np.random.default_rng(seed + 1)
    seg = n // t_max
    bounds = [(i * seg, (i + 1) * seg) for i in range(t_max)]
    for t in range(t_max):
        s, e = bounds[t]
        yield StreamOp("insert", vectors=data[s:e])
        if t >= t_max // 2:
            ds, de = bounds[t - t_max // 2]
            yield StreamOp("delete", ids=np.arange(ds, de))
        if t > t_max // 2:
            q = data[rng.integers(bounds[max(0, t - 50)][0], e,
                                  queries_per_step)]
            yield StreamOp("search", queries=q
                           + rng.normal(scale=0.05, size=(queries_per_step,
                                                          dim)).astype(np.float32))


def expiration_time(n=20000, dim=32, t_max=100, queries_per_step=8, seed=0
                    ) -> Iterator[StreamOp]:
    """Lifetimes short(10):long(50):permanent(100) in 10:2:1 ratio."""
    data, _ = _base_data(n, dim, seed)
    rng = np.random.default_rng(seed + 1)
    per_step = n // t_max
    life_choices = np.array([10, 50, 100])
    life_probs = np.array([10, 2, 1], np.float64)
    life_probs /= life_probs.sum()
    expiry: dict[int, list] = {}
    nxt = 0
    for t in range(t_max):
        ids = np.arange(nxt, min(nxt + per_step, n))
        nxt += per_step
        if len(ids) == 0:
            break
        yield StreamOp("insert", vectors=data[ids])
        lives = rng.choice(life_choices, size=len(ids), p=life_probs)
        for lid, lf in zip(ids, lives):
            expiry.setdefault(t + int(lf), []).append(lid)
        if t in expiry:
            yield StreamOp("delete", ids=np.asarray(expiry.pop(t)))
        if t > 3:
            q = data[rng.integers(0, nxt, queries_per_step)]
            yield StreamOp("search", queries=q + rng.normal(
                scale=0.05, size=q.shape).astype(np.float32))


def clustered(n=20000, dim=32, rounds=5, n_clusters=64, queries_per_step=8,
              seed=0) -> Iterator[StreamOp]:
    """k-means clusters; each round inserts then deletes random cluster
    subsets -> strong distribution shift (paper Clustered)."""
    data, assign = _base_data(n, dim, seed, clustered=True,
                              n_clusters=n_clusters)
    rng = np.random.default_rng(seed + 1)
    inserted = np.zeros(n, bool)
    next_free = 0
    id_of = np.full(n, -1, np.int64)
    for r in range(rounds):
        for c in range(n_clusters):
            members = np.where((assign == c) & ~inserted)[0]
            take = members[:max(1, len(members) // (rounds - r))]
            if len(take):
                id_of[take] = np.arange(next_free, next_free + len(take))
                next_free += len(take)
                inserted[take] = True
                yield StreamOp("insert", vectors=data[take])
            if c % 8 == 7 and inserted.any():   # interleave searches so
                # truncated replays still measure recall (paper runs full)
                q_src = np.where(inserted)[0]
                if len(q_src) >= queries_per_step:
                    q = data[rng.choice(q_src, queries_per_step,
                                        replace=False)]
                    yield StreamOp("search", queries=q + rng.normal(
                        scale=0.05, size=q.shape).astype(np.float32))
        # delete a random fraction of some clusters
        for c in rng.choice(n_clusters, size=n_clusters // 4, replace=False):
            members = np.where((assign == c) & inserted)[0]
            drop = members[rng.random(len(members)) < 0.3]
            if len(drop):
                inserted[drop] = False
                yield StreamOp("delete", ids=id_of[drop])
        q_src = np.where(inserted)[0]
        if len(q_src) >= queries_per_step:
            q = data[rng.choice(q_src, queries_per_step, replace=False)]
            yield StreamOp("search", queries=q + rng.normal(
                scale=0.05, size=q.shape).astype(np.float32))


def msturing_ih(n_start=2000, n_final=20000, dim=32, n_ops=200,
                insert_ratio=0.9, batch=128, seed=0) -> Iterator[StreamOp]:
    """Insert-heavy growth: 90% inserts / 10% searches (MSTuring-IH)."""
    data, _ = _base_data(n_final, dim, seed)
    rng = np.random.default_rng(seed + 1)
    yield StreamOp("insert", vectors=data[:n_start])
    nxt = n_start
    for _ in range(n_ops):
        if rng.random() < insert_ratio and nxt < n_final:
            take = min(batch, n_final - nxt)
            yield StreamOp("insert", vectors=data[nxt:nxt + take])
            nxt += take
        else:
            q = data[rng.integers(0, nxt, 8)]
            yield StreamOp("search", queries=q + rng.normal(
                scale=0.05, size=q.shape).astype(np.float32))


WORKLOADS = {
    "sliding_window": sliding_window,
    "expiration_time": expiration_time,
    "clustered": clustered,
    "msturing_ih": msturing_ih,
}
