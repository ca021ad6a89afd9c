"""Plain reference of the served semantics: exact top-k by squared L2
over the rows alive when a request was submitted.

It works its state out from the operations the benchmark issued (the
initial rows, then each acknowledged insert and delete with its times)
and imports nothing of the program. Distances are float32 with TF32 off,
in blocks of queries so that a block's [queries, rows] matrix fits.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

INF = float("inf")
NEVER = float("inf")


@contextlib.contextmanager
def full_fp32():
    """TF32 off for the duration (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Mirror:
    """Every row the benchmark ever wrote, with the times of its writes.

    ``ins_start``/``ins_ack`` and ``del_start``/``del_ack`` are host-clock
    seconds; the initial rows were acknowledged at minus infinity and a
    row never deleted is deleted at infinity. A row is *alive* for a
    request submitted at ``ts`` and answered at ``te`` when its insert was
    acknowledged before ``ts`` and its delete had not started by ``te``;
    *absent* when its delete was acknowledged before ``ts`` or its insert
    had not started by ``te``; otherwise a write overlapped the request and
    the row counts on neither side."""

    def __init__(self, vectors: np.ndarray):
        self.blocks = [np.asarray(vectors, np.float32)]
        n = len(vectors)
        self.ids = [np.arange(n, dtype=np.int64)]
        self.times = {k: [np.full(n, v)] for k, v in (
            ("ins_start", -INF), ("ins_ack", -INF))}
        self.deletes = []          # (ids, t_start, t_ack)

    def insert(self, ids, vectors, t_start, t_ack):
        ids = np.asarray(ids, np.int64)
        self.blocks.append(np.asarray(vectors, np.float32))
        self.ids.append(ids)
        self.times["ins_start"].append(np.full(len(ids), t_start))
        self.times["ins_ack"].append(np.full(len(ids), t_ack))

    def delete(self, ids, t_start, t_ack):
        self.deletes.append((np.asarray(ids, np.int64), t_start, t_ack))

    def reused(self) -> int:
        """Ids handed out by more than one insert."""
        ids = np.concatenate(self.ids)
        return len(ids) - len(np.unique(ids))

    def arrays(self):
        """(vectors [R, D], ins_start, ins_ack, del_start, del_ack) indexed
        by id; ids never written read as absent (insert at infinity). An
        id handed out twice keeps its last insert (``reused`` counts
        them)."""
        ids = np.concatenate(self.ids)
        R = int(ids.max()) + 1
        vec = np.zeros((R, self.blocks[0].shape[1]), np.float32)
        vec[ids] = np.concatenate(self.blocks)
        out = [vec]
        for k in ("ins_start", "ins_ack"):
            t = np.full(R, NEVER)
            t[ids] = np.concatenate(self.times[k])
            out.append(t)
        for j in (1, 2):
            t = np.full(R, NEVER)
            for d in self.deletes:
                t[d[0]] = np.minimum(t[d[0]], d[j])
            out.append(t)
        return tuple(out)


def sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared distance of paired rows, summed in float32."""
    return ((x - q) ** 2).sum(-1)


def topk_alive(queries, vectors, alive, k, block_rows=1 << 20):
    """Exact top-``k`` ids [Q, k] over the rows where ``alive`` [Q, R] is
    true (float32 GEMM expansion with TF32 off; -1 where fewer rows are
    alive). Rows are scanned in blocks and the running best merged."""
    Q = queries.shape[0]
    best_d = torch.full((Q, k), INF, device=queries.device)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=queries.device)
    qq = (queries ** 2).sum(1, keepdim=True)
    with full_fp32():
        for s in range(0, vectors.shape[0], block_rows):
            v = vectors[s:s + block_rows]
            d = qq - 2.0 * (queries @ v.T) + (v ** 2).sum(1)[None, :]
            d = d.masked_fill(~alive[:, s:s + block_rows], INF)
            cat_d = torch.cat([best_d, d], 1)
            cat_i = torch.cat([best_i, torch.arange(
                s, s + v.shape[0], device=v.device).expand(Q, -1)], 1)
            best_d, j = torch.topk(cat_d, k, dim=1, largest=False,
                                   sorted=True)
            best_i = cat_i.gather(1, j)
    return torch.where(torch.isfinite(best_d), best_i, -1)
