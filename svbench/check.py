"""The comparison that decides ``correct``: the program's answers against
the plain reference (``svbench/reference/exact.py``).

Every answer the window produced is judged for its ids and distances; a
sample of them, drawn from the seed, for recall. The rows of each insert,
searched for right after its acknowledgement, have to find themselves
(read after write). After the window every
acknowledged write is read back from the index: in device mode from the
engine's published state, in three-tier mode from its disk directory
reopened through the program's recovery. Each number is printed beside
its limit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from svbench.reference.exact import Mirror, full_fp32, sq_l2, topk_alive


@dataclass
class Answers:
    """Answers of search requests, one row a query: query ``qidx[i]`` of
    ``pool`` was submitted at ``ts[i]`` and answered at ``te[i]``."""
    pool: np.ndarray        # [P, D] float32
    qidx: np.ndarray        # [Q] int64
    ts: np.ndarray          # [Q] submit time
    te: np.ndarray          # [Q] answer time
    ids: np.ndarray         # [Q, k] int64
    dists: np.ndarray       # [Q, k] float32
    request: np.ndarray     # [Q] index of the request

    def queries(self, rows) -> np.ndarray:
        return self.pool[self.qidx[rows]]


def _blocks(n, size):
    for s in range(0, n, size):
        yield slice(s, min(s + size, n))


def wrong_ids(ans: Answers, ins_start, del_ack) -> int:
    """Returned ids that are no answer: -1, never written, deleted before
    the request was submitted, inserted after it was answered, or twice
    in one answer."""
    ids = ans.ids
    R = len(ins_start)
    bad = (ids < 0) | (ids >= R)
    c = np.clip(ids, 0, R - 1)
    bad |= del_ack[c] < ans.ts[:, None]
    bad |= ins_start[c] > ans.te[:, None]
    s = np.sort(ids, axis=1)
    dup = (s[:, 1:] == s[:, :-1]).sum()
    return int(bad.sum() + dup)


def dist_gap(ans: Answers, vectors, dev, block=1 << 16) -> float:
    """Widest gap between a returned distance and the reference's float32
    distance of the same id to the same query, over every returned id that
    was ever written, as a share of the larger of that reference distance
    and the median one (a row's own distance to itself is 0)."""
    R = vectors.shape[0]
    ok = (ans.ids >= 0) & (ans.ids < R)
    qi, j = np.nonzero(ok)
    if not len(qi):
        return 0.0
    ref = torch.empty(len(qi))
    with full_fp32():
        for sl in _blocks(len(qi), block):
            q = torch.as_tensor(ans.queries(qi[sl]), device=dev)
            x = vectors[torch.as_tensor(ans.ids[qi[sl], j[sl]], device=dev)]
            ref[sl] = sq_l2(q, x).cpu()
    got = torch.as_tensor(ans.dists[qi, j], dtype=torch.float32)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    scale = torch.clamp(ref, min=float(ref.median()))
    if float(scale.max()) == 0.0:
        return float((got - ref).abs().max())
    return float(((got - ref).abs() / scale.clamp(min=1e-30)).max())


def recall(ans: Answers, rows, vectors, times, k, dev, block=256):
    """Mean recall@k of the queries ``rows`` of ``ans`` against the exact
    top-k over the rows alive for each; rows that a write overlapped are
    dropped from the answer and from the truth."""
    ins_start, ins_ack, del_start, del_ack = (
        torch.as_tensor(t, device=dev) for t in times)
    hits, total = 0, 0
    for sl in _blocks(len(rows), block):
        r = rows[sl]
        ts = torch.as_tensor(ans.ts[r], device=dev)[:, None]
        te = torch.as_tensor(ans.te[r], device=dev)[:, None]
        alive = (ins_ack[None, :] < ts) & (del_start[None, :] > te)
        absent = (del_ack[None, :] < ts) | (ins_start[None, :] > te)
        q = torch.as_tensor(ans.queries(r), device=dev)
        truth = topk_alive(q, vectors, alive, k)
        got = torch.as_tensor(ans.ids[r], device=dev)
        R = alive.shape[1]
        c = got.clamp(0, R - 1)
        certain = (got >= 0) & (got < R) & (
            alive.gather(1, c) | absent.gather(1, c))
        got = torch.where(certain, got, -2)
        match = (got[:, :, None] == truth[:, None, :]) & (
            truth[:, None, :] >= 0)
        hits += int(match.any(1).sum())
        total += int((truth >= 0).sum())
    return hits / max(total, 1)


def lost_writes(view, inserted, deleted) -> int:
    """Acknowledged writes the index does not hold: an inserted row past
    its high-water mark, with other bytes, or not alive (unless deleted);
    a deleted row alive. ``view`` reads the program's index after the
    window (``n``, ``vectors(ids)``, ``alive(ids)``)."""
    lost = 0
    dead = np.concatenate(deleted) if deleted else np.zeros(0, np.int64)
    for ids, vecs in inserted:
        ids = np.asarray(ids, np.int64)
        inside = ids < view.n
        lost += int((~inside).sum())
        ids, vecs = ids[inside], np.asarray(vecs)[inside]
        if not len(ids):
            continue
        same = (np.asarray(view.vectors(ids), np.float32) == vecs).all(1)
        lost += int((~same).sum())
        lost += int((view.alive(ids) != ~np.isin(ids, dead)).sum())
    dead = dead[dead < view.n]
    lost += int(view.alive(dead).sum())
    return lost


def fresh_self_miss(probes) -> float:
    """Share of freshly acknowledged rows that their own vector, searched
    right after the acknowledgement, did not find among its answers. A
    row is its own nearest neighbour at distance 0, so an engine that
    publishes an insert when it acknowledges it finds most of them; one
    that publishes later finds none."""
    m = sum(len(p.ids) for p in probes)
    hits = sum(int((p.found == p.ids[:, None]).any(1).sum()) for p in probes)
    return 1.0 - hits / m


def judge(checks: dict) -> bool:
    """True when every number is within its limit."""
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        if v is None or not np.isfinite(v):
            return False
        if (v < lim) if c["must"] == ">=" else (v > lim):
            return False
    return True


def entry(value, limit, must="<="):
    return {"value": value, "limit": limit, "must": must}


def compare(mirror: Mirror, window: Answers, unanswered: int,
            limits: dict, stated: dict, k: int, sample: int, seed: int, dev,
            lost=None, probes=()) -> dict:
    """All numbers of a run, each with its limit. ``limits`` comes from the
    cell's limits file, ``stated`` from the configuration (the floors it
    states); ``lost`` is (name, count) of ``lost_writes``; ``probes`` the
    writer's read-after-write searches."""
    vec_np, ins_start, ins_ack, del_start, del_ack = mirror.arrays()
    vectors = torch.as_tensor(vec_np, device=dev)
    rng = np.random.default_rng(seed)
    reqs = np.unique(window.request)
    per_req = max(1, len(window.request) // max(len(reqs), 1))
    chosen = rng.choice(reqs, size=min(len(reqs), max(1, sample // per_req)),
                        replace=False)
    rows = np.nonzero(np.isin(window.request, chosen))[0]
    out = {
        "unanswered": entry(unanswered, 0),
        "reused_ids": entry(mirror.reused(), 0),
        "wrong_ids": entry(wrong_ids(window, ins_start, del_ack), 0),
        "dist_gap": entry(dist_gap(window, vectors, dev),
                          limits["dist_gap"]),
        "recall_at_10": entry(
            recall(window, rows, vectors, (ins_start, ins_ack, del_start,
                                           del_ack), k, dev),
            stated["recall_at_10_min"], ">="),
    }
    if probes:
        out["fresh_self_miss"] = entry(fresh_self_miss(probes),
                                       limits["fresh_self_miss"])
    if lost is not None:
        out[lost[0]] = entry(lost[1], 0)
    return out
