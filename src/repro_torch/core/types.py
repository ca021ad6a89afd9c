"""Index state of the port (twin of ``repro.core.types``).

NamedTuples of tensors, one per tier: ``GraphState`` is the capacity tier
(vectors, the fixed-out-degree graph, alive flags, in-degrees, versions),
``CacheState`` the bandwidth tier (hot vectors, the slot <-> host-id
mapping, clock bits, decayed access counts, the promotion threshold θ),
``Stats`` the placement counters. Every tensor of one state lives on one
device; scalars are 0-d tensors. ``IndexState.tiered`` is always None in
the port so far (the disk tier is not ported).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


class GraphState(NamedTuple):
    vectors: torch.Tensor     # [N_max, D] float32
    nbrs: torch.Tensor        # [N_max, R] int32, -1 padding
    alive: torch.Tensor       # [N_max] bool
    e_in: torch.Tensor        # [N_max] int32 in-degree
    version: torch.Tensor     # [N_max] int32 per-vertex version
    n: torch.Tensor           # [] int32 high-water mark

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def degree(self) -> int:
        return self.nbrs.shape[1]


class CacheState(NamedTuple):
    vectors: torch.Tensor     # [M, D] float32 cached hot vectors
    slot_hid: torch.Tensor    # [M] int32 slot -> host id (-1 empty)
    h2d: torch.Tensor         # [N_max] int32 host id -> slot (-1 = not cached)
    ref: torch.Tensor         # [M] int8 clock reference bits
    slot_ver: torch.Tensor    # [M] int32 cached copy's version
    f_recent: torch.Tensor    # [N_max] float32 decayed access count
    theta: torch.Tensor       # [] float32 promotion threshold
    alpha: torch.Tensor       # [] float32 weight of F_recent
    beta: torch.Tensor        # [] float32 weight of log(1+E_in)

    @property
    def n_slots(self) -> int:
        return self.vectors.shape[0]


class Stats(NamedTuple):
    accesses: torch.Tensor    # [] int32 counters
    hits: torch.Tensor
    misses: torch.Tensor
    promotions: torch.Tensor
    evictions: torch.Tensor
    transfers: torch.Tensor   # vectors moved host->device
    cpu_computed: torch.Tensor  # miss accesses resolved on the capacity tier


class IndexState(NamedTuple):
    graph: GraphState
    cache: CacheState
    stats: Stats
    tiered: Optional[Any] = None


class SearchParams(NamedTuple):
    k: int = 10
    pool: int = 64          # candidate pool size L >= k
    max_iters: int = 96     # total hop (expansion) budget per query
    decay: float = 0.9      # F_recent sliding-window decay per batch
    max_promote: int = 2048 # transfer batch (paper amortizes over 2048)
    policy: str = "wavp"    # wavp | lru | lfu | lrfu | never | always
    beam: int = 16          # frontier expansions batched per round; the
    #                         executor runs ceil(max_iters/beam) rounds


def init_stats(device="cuda") -> Stats:
    return Stats(*(torch.zeros((), dtype=torch.int32, device=device)
                   for _ in range(7)))


def init_cache_state(n_max: int, n_slots: int, dim: int,
                     theta: float = 1.0, alpha: float = 1.0,
                     beta: float = 1.0, device="cuda") -> CacheState:
    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)
    return CacheState(
        vectors=torch.zeros((n_slots, dim), dtype=torch.float32,
                            device=device),
        slot_hid=torch.full((n_slots,), -1, dtype=torch.int32, device=device),
        h2d=torch.full((n_max,), -1, dtype=torch.int32, device=device),
        ref=torch.zeros((n_slots,), dtype=torch.int8, device=device),
        slot_ver=torch.zeros((n_slots,), dtype=torch.int32, device=device),
        f_recent=torch.zeros((n_max,), dtype=torch.float32, device=device),
        theta=scalar(theta), alpha=scalar(alpha), beta=scalar(beta),
    )


def init_graph_state(n_max: int, dim: int, degree: int,
                     device="cuda") -> GraphState:
    return GraphState(
        vectors=torch.zeros((n_max, dim), dtype=torch.float32, device=device),
        nbrs=torch.full((n_max, degree), -1, dtype=torch.int32,
                        device=device),
        alive=torch.zeros((n_max,), dtype=torch.bool, device=device),
        e_in=torch.zeros((n_max,), dtype=torch.int32, device=device),
        version=torch.zeros((n_max,), dtype=torch.int32, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
    )
