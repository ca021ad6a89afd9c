"""Sharded SVFusion search over ``torch.distributed`` (twin of
``repro.core.distributed``, paper §4.2's partitioned index across
devices).

Layout: the capacity tier (vectors, graph, alive bitset) and each
shard's hot cache are split over the data axes of a grid of ranks, so
that each rank owns N/P vectors and their subgraph; queries are either
split over a query axis or replicated (``query_axis=None``, the Deep1B
layout). Each rank searches its own shard with the frontier executor
(``search._frontier_search``) and offsets its ids to global ones; then,
one data axis at a time and in the reference's order, the ranks of that
axis all-gather their [B, k] results and keep the k best (only results
cross the wire: k·8 bytes a query a shard).

The grid is a ``RankMesh``: the world's ranks numbered row-major, as a
JAX mesh numbers its devices, so rank r holds what device r holds in the
reference's mesh. ``convert.shard_rows`` cuts a rank's rows out of the
global index arrays. Under NCCL the collectives run on the card's
tensors; under gloo, which has no CUDA all-gather, on CPU copies.

Entry points: the reference draws each shard's with
``jax.random.fold_in(key, shard)`` inside the step, which torch cannot
reproduce. Here the caller passes them, or the step draws them from a
``torch.Generator`` seeded from (seed, shard) on the shard's device
(``shard_entries``): the port's own draw.

One process can also hold one index over several cards
(``SVFusionEngine`` with ``cards > 1``): the rows are interleaved over
the cards (``interleave_route``, ``interleave_ids``), each card's answers
are merged by ``merge_shard_results``, and ``InterleavedGraph`` reads the
cards' published graphs by global id.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.search import _frontier_search
from repro_torch.core.topk import smallest_k
from repro_torch.core.types import GraphState, SearchParams, init_cache_state

INDEX_FIELDS = ("vectors", "nbrs", "alive", "e_in", "cache_vectors",
                "slot_hid", "h2d", "f_recent")


def shard_index_arrays(n_total, dim, degree, n_shards, cache_slots,
                       vec_dtype=torch.float32):
    """Shapes and dtypes of the sharded index as tensors on the ``meta``
    device (no storage). vec_dtype=bf16 halves the stored footprint and
    the gather traffic of the memory-bound beam search."""
    f32, i32 = torch.float32, torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return {
        "vectors": meta((n_total, dim), vec_dtype),
        "nbrs": meta((n_total, degree), i32),
        "alive": meta((n_total,), torch.bool),
        "e_in": meta((n_total,), i32),
        "cache_vectors": meta((n_shards * cache_slots, dim), vec_dtype),
        "slot_hid": meta((n_shards * cache_slots,), i32),
        "h2d": meta((n_total,), i32),
        "f_recent": meta((n_total,), f32),
    }


class RankMesh:
    """The world's ranks as a grid of named axes, numbered row-major.

    Every rank of the world must construct it, with the same arguments
    and in the same order as any other process group, because it creates
    one group per line of ranks along each axis (``dist.new_group`` is
    collective)."""

    def __init__(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        world = dist.get_world_size()
        if int(np.prod(self.shape)) != world:
            raise ValueError(f"mesh {self.shape} does not hold the world of "
                             f"{world} ranks")
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.shape))
        grid = np.arange(world).reshape(self.shape)
        self.groups = {}
        for i, ax in enumerate(self.axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, self.shape[i]):
                group = dist.new_group(line.tolist())
                if self.rank in line:
                    self.groups[ax] = group

    def index(self, axis) -> int:
        return self.coords[self.axis_names.index(axis)]

    def size(self, axis) -> int:
        return self.shape[self.axis_names.index(axis)]

    def linear_index(self, axes) -> int:
        """This rank's position in the row-major order of ``axes``."""
        lin = 0
        for ax in axes:
            lin = lin * self.size(ax) + self.index(ax)
        return lin

    def block(self, x, axis):
        """This rank's block of ``x`` along its first dimension, split
        evenly over ``axis``."""
        m = x.shape[0] // self.size(axis)
        i = self.index(axis)
        return x[i * m:(i + 1) * m]


def shard_seed(seed, shard) -> int:
    """A seed derived from (seed, shard)."""
    return int(np.random.SeedSequence([seed, shard]).generate_state(1)[0])


def shard_generator(seed, shard, device):
    """A ``torch.Generator`` on ``device`` seeded from (seed, shard)."""
    return torch.Generator(device=device).manual_seed(shard_seed(seed, shard))


def shard_entries(seed, shard, batch, pool, n_local, device):
    """Entry points [batch, pool] int32 of shard ``shard``, from
    ``shard_generator(seed, shard, device)``."""
    return torch.randint(0, n_local, (batch, pool),
                         generator=shard_generator(seed, shard, device),
                         dtype=torch.int32, device=device)


def search_shard(idx, queries, entries, sp: SearchParams, offset=0):
    """One shard's search: ``idx`` holds the shard's arrays
    (``INDEX_FIELDS``, local ids), queries [B, D], entries [B, pool].
    Returns (global ids [B, k] int32, -1 where none; dists [B, k])."""
    vecs = idx["vectors"]
    n_local, dim = vecs.shape
    dev = vecs.device
    graph = GraphState(
        vectors=vecs, nbrs=idx["nbrs"], alive=idx["alive"], e_in=idx["e_in"],
        version=torch.zeros((n_local,), dtype=torch.int32, device=dev),
        n=torch.tensor(n_local, dtype=torch.int32, device=dev))
    cache = init_cache_state(n_local, idx["cache_vectors"].shape[0], dim,
                             device=dev)
    cache = cache._replace(vectors=idx["cache_vectors"],
                           slot_hid=idx["slot_hid"], h2d=idx["h2d"],
                           f_recent=idx["f_recent"])
    res = _frontier_search(graph, cache, queries.float(), entries, sp)
    return torch.where(res.ids >= 0, res.ids + offset, -1), res.dists


def merge_shard_results(ids, dists, k):
    """Per-shard results [S, B, k'] (shard order) -> the k best of each
    query [B, k]: the lanes laid out shard-major ([B, S·k'], the
    reference's ``moveaxis``), ties to the lower lane."""
    S, B = ids.shape[:2]
    ai = ids.movedim(0, 1).reshape(B, -1)
    ad = dists.movedim(0, 1).reshape(B, -1)
    d, sel = smallest_k(ad, k)
    return ai.gather(1, sel), d


def interleave_route(ids, cards):
    """Global ids -> (card, local row) in the interleaved layout of one
    index over ``cards`` cards (``SVFusionEngine`` with ``cards > 1``):
    id g lives on card g % cards at row g // cards, so the ids stay dense
    from 0 and each card's rows stay dense too. numpy arrays or tensors."""
    return ids % cards, ids // cards


def interleave_ids(local, card, cards):
    """Card ``card``'s local rows (numpy) -> global ids; -1 stays -1."""
    local = np.asarray(local, np.int64)
    return np.where(local >= 0, local * cards + card, -1)


class InterleavedColumn:
    """One table of the cards' graphs (``vectors`` or ``alive``) read by
    global id: ``col[ids]`` takes a tensor of ids on ``device`` and
    returns the rows that hold them, in the order of ``ids``, on that
    device."""

    def __init__(self, parts, device):
        self.parts, self.device = list(parts), torch.device(device)

    def __getitem__(self, ids):
        ids = torch.as_tensor(ids, device=self.device)
        card, local = interleave_route(ids.long(), len(self.parts))
        first = self.parts[0]
        out = torch.empty(tuple(ids.shape) + tuple(first.shape[1:]),
                          dtype=first.dtype, device=ids.device)
        for c, part in enumerate(self.parts):
            on = card == c
            out[on] = part[local[on].to(part.device)].to(ids.device)
        return out


class InterleavedGraph(NamedTuple):
    """The published graphs of the cards as one index: ``n`` is one past
    the largest global id handed out."""
    n: int
    vectors: InterleavedColumn
    alive: InterleavedColumn

    @staticmethod
    def of(n, graphs):
        dev = graphs[0].vectors.device
        return InterleavedGraph(
            int(n), InterleavedColumn([g.vectors for g in graphs], dev),
            InterleavedColumn([g.alive for g in graphs], dev))


def _all_gather(x, group):
    """[group size, *x.shape]: ``x`` from every rank of ``group``, in
    group rank order (the axis's order)."""
    dev = x.device
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack(out).to(dev)


def make_distributed_search(mesh: RankMesh, sp: SearchParams,
                            data_axes=("pod", "data"), query_axis="model"):
    """Builds the sharded search step. Returns fn(idx, queries,
    entries=None, seed=0) -> (ids [B, k], dists [B, k]) with globally
    valid ids, where ``idx`` is this rank's shard (``convert.shard_rows``
    at ``mesh.linear_index`` of the data axes present), ``queries`` this
    rank's block of the batch (``mesh.block(queries, query_axis)``, or
    the whole batch when ``query_axis`` is None) and the result is that
    block's. ``entries`` [B, pool] default to ``shard_entries(seed,
    shard)``."""
    present = [a for a in data_axes if a in mesh.axis_names]
    if query_axis is not None and query_axis not in mesh.axis_names:
        raise ValueError(f"query axis {query_axis!r} is not in the mesh")

    def step(idx, queries, entries=None, seed=0):
        n_local = idx["vectors"].shape[0]
        shard = mesh.linear_index(present)
        if entries is None:
            entries = shard_entries(seed, shard, queries.shape[0], sp.pool,
                                    n_local, idx["vectors"].device)
        ids, d = search_shard(idx, queries, entries, sp,
                              offset=shard * n_local)
        # hierarchical top-k merge over the data axes
        for ax in present:
            group = mesh.groups[ax]
            ids, d = merge_shard_results(_all_gather(ids, group),
                                         _all_gather(d, group), sp.k)
        return ids, d

    return step


def analytical_search_flops(sp: SearchParams, batch, dim, degree):
    """MODEL_FLOPS analogue for the search step (while-loop bodies are
    counted once by HLO cost analysis; this is the true per-step count):
    per query-iteration: R gathered rows × (3D flops for ||x-q||²) +
    pool merge sort ~ (L+R)·log(L+R) comparisons."""
    per_iter = degree * 3 * dim + (sp.pool + degree) * 12
    return batch * sp.max_iters * per_iter
