"""Index updates (twin of ``repro.core.update``, paper §5): batched
insertion with rank-based candidate reordering + reverse edges;
three-stage deletion (logical bitset -> localized topology-aware repair
-> global consolidation).

Device half: state in, state out, as in the reference. The port builds
new tensors rather than writing the published ones in place, so a search
that read the previous state keeps a consistent view. ``insert_batch``
takes its entry pool as an argument (``entries``), as ``frontier_search``
does: the reference draws it with ``jax.random``, which torch cannot
reproduce. Its candidate search, and consolidation's scoring, run through
``l2_gather``.

Tiered half: the reference's numpy, through the port's ``search_tiered``
on ``device`` (exact lane). Each op computes its full effect, appends it
to the backend's write-ahead log when one is attached (``core/wal.py``;
an insert's record carries its attribute columns when a store is
attached) and then applies it through the function that recovery
replays.

Two rules keep the card and the CPU on the reference's answers:
- Several reverse edges can land on one (row, slot): the reference keeps
  the last write (JAX's scatter and numpy's fancy assignment on the
  CPU). The port resolves such conflicts explicitly, last lane wins,
  before one scatter without duplicates (``_scatter_last``, and in
  numpy ``reverse_edge_rows_host``): ``index_put_`` leaves the winner
  undefined.
- Every top-k and argsort goes through ``core.topk`` (ties to the lower
  index, as ``lax.top_k``; ``jnp.argsort`` is stable).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.build import compute_e_in, rank_based_reorder
from repro_torch.core.search import (_clip, _frontier_search, dedup_mask,
                                     dup_mask_jnp, search_tiered)
from repro_torch.core.topk import argsort, largest_k, smallest_k
from repro_torch.core.types import GraphState, IndexState, SearchParams
from repro_torch.core.wal import (REC_DELETE, REC_INSERT, crash_point)
from repro_torch.kernels.ops import gather_l2

INF = float("inf")


class RevLog(NamedTuple):
    """Reverse-edge triplets (paper §5.3 'Reverse Edge Integration'):
    tensors in device mode, numpy arrays in tiered mode."""
    v: object         # [E] existing vertex receiving the edge
    v_new: object     # [E] newly inserted vertex
    d: object         # [E] precomputed distance


def _scatter_last(flat, idx, vals):
    """A copy of the 1-D ``flat`` with ``flat[idx] = vals``, the last lane
    winning where ``idx`` repeats (the reference's scatter order): a
    stable sort groups repeats in lane order, and only the last lane of
    each group is written."""
    out = flat.clone()
    if idx.numel():
        s, perm = torch.sort(idx.long(), stable=True)
        last = torch.ones(s.shape, dtype=torch.bool, device=s.device)
        last[:-1] = s[1:] != s[:-1]
        win = perm[last]
        out[s[last]] = vals[win]
    return out


def _sqdist_rows(vectors, ids, centers, chunk=1 << 14):
    """Squared L2 distance [E, K] between the rows ``ids`` [E, K] (clipped)
    and ``centers`` [E, D], elementwise as the reference sums it; in
    chunks of ``chunk`` lanes so the [E, K, D] gather stays bounded."""
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    cap = vectors.shape[0]
    for s in range(0, ids.shape[0], chunk):
        x = vectors[_clip(ids[s:s + chunk], cap)]
        out[s:s + chunk] = ((x - centers[s:s + chunk, None, :]) ** 2).sum(-1)
    return out


def _reverse_edge_scatter(graph: GraphState, targets, new_ids, dists):
    """Vectorized reverse-edge insertion. For each edge (targets[e] ->
    new_ids[e]): use a free slot if any, else replace the current worst
    (farthest) neighbor if the new edge is closer. Write conflicts resolve
    last-writer-wins, as in the reference. Returns the new nbrs."""
    R, cap = graph.degree, graph.capacity
    t = _clip(targets, cap)
    rows = graph.nbrs[t]                                   # [E, R]
    nb_d = _sqdist_rows(graph.vectors, rows, graph.vectors[t])
    nb_d = torch.where(rows >= 0, nb_d, -INF)              # free slots win
    worst = torch.where(rows < 0, INF, nb_d).argmax(1)
    free = rows < 0
    has_free = free.any(1)
    free_idx = free.to(torch.int8).argmax(1)
    slot = torch.where(has_free, free_idx, worst)
    improves = has_free | (dists < nb_d.max(1).values)
    ok = (targets >= 0) & improves
    lin = t.long() * R + slot
    return _scatter_last(graph.nbrs.reshape(-1), lin[ok],
                         new_ids.to(torch.int32)[ok]).reshape(cap, R)


def insert_batch(state: IndexState, new_vecs, entries, sp: SearchParams):
    """Insert a batch; ``entries`` [Bi, sp.pool] are the candidate
    search's entry points (the reference draws them with
    ``jax.random.randint(key, (Bi, pool), 0, max(n, 1))``). Returns
    (state, new_ids, RevLog)."""
    graph, cache, stats = state.graph, state.cache, state.stats
    dev = graph.vectors.device
    new_vecs = torch.as_tensor(new_vecs, device=dev).float()
    Bi = new_vecs.shape[0]
    n = int(graph.n)
    if n + Bi > graph.capacity:
        raise ValueError(f"index full: {n}+{Bi} > {graph.capacity}")
    ids = n + torch.arange(Bi, dtype=torch.int32, device=dev)
    lid = ids.long()

    # phase 1 (paper §5.1): candidate search on the current graph, through
    # the shared hop-batched frontier executor (l2_gather)
    res = _frontier_search(graph, cache, new_vecs,
                           torch.as_tensor(entries, device=dev),
                           sp._replace(k=sp.pool))
    # phase 2: heuristic (rank-based) reordering then edge establishment
    sel = rank_based_reorder(res.ids, res.dists, graph.nbrs, graph.degree)

    vectors = graph.vectors.clone()
    vectors[lid] = new_vecs
    nbrs = graph.nbrs.clone()
    nbrs[lid] = sel
    alive = graph.alive.clone()
    alive[lid] = True
    version = graph.version.clone()
    version[lid] = 1
    graph = graph._replace(vectors=vectors, nbrs=nbrs, alive=alive,
                           version=version, n=graph.n + Bi)

    # reverse edges (flattened over the batch)
    flat_t = sel.reshape(-1)
    flat_new = ids.repeat_interleave(graph.degree)
    d_rev = ((vectors[_clip(flat_t, graph.capacity)]
              - vectors[flat_new.long()]) ** 2).sum(-1)
    d_rev = torch.where(flat_t >= 0, d_rev, INF)
    nbrs = _reverse_edge_scatter(graph, flat_t, flat_new, d_rev)
    version = version.index_add(0, _clip(flat_t, graph.capacity),
                                (flat_t >= 0).to(torch.int32))
    graph = graph._replace(nbrs=nbrs, version=version,
                           e_in=compute_e_in(nbrs, graph.capacity))
    return (IndexState(graph, cache, stats), ids,
            RevLog(flat_t, flat_new, d_rev))


def delete_batch(state: IndexState, ids):
    """Stage 1 (paper §5.2.1): logical deletion. The bitset is shared by all
    tiers; searches/insertions skip marked rows. As in the reference, a
    read clamps ids to the table and a write past it is dropped, and a
    repeated id (a -1 lane clips to id 0) keeps its last lane's write."""
    graph, cache, stats = state.graph, state.cache, state.stats
    cap = graph.capacity
    ids = torch.as_tensor(ids, device=graph.alive.device).to(torch.int32)
    cid = ids.clamp(min=0)
    was = graph.alive[_clip(cid, cap)]
    ok = (ids >= 0) & was
    inb = cid < cap
    alive = _scatter_last(graph.alive, cid[inb],
                          torch.where(ok, False, was)[inb])
    version = graph.version.index_add(0, cid[inb].long(),
                                      ok[inb].to(torch.int32))
    return IndexState(graph._replace(alive=alive, version=version),
                      cache, stats)


def deleted_fraction(graph: GraphState) -> torch.Tensor:
    within = torch.arange(graph.capacity, device=graph.alive.device) \
        < graph.n
    dead = within & ~graph.alive
    return dead.sum() / graph.n.clamp(min=1)


def affected_fraction(graph: GraphState):
    """Per-vertex fraction of deleted out-neighbors."""
    nb = graph.nbrs
    valid = nb >= 0
    dead = valid & ~graph.alive[_clip(nb, graph.capacity)]
    return dead.sum(1) / valid.sum(1).clamp(min=1)


def repair_affected(state: IndexState, *, max_repair=256, c=2,
                    threshold=0.5):
    """Stage 2 (paper §5.2.2): localized topology-aware repair. For the most
    affected alive vertices (deleted-neighbor fraction > threshold), each
    deleted neighbor p contributes at most ``c`` of its own alive
    out-neighbors (nearest to v) as replacement edges. Returns (state,
    number repaired as a 0-d tensor)."""
    graph, cache, stats = state.graph, state.cache, state.stats
    cap, R = graph.capacity, graph.degree
    frac = affected_fraction(graph)
    score = torch.where(graph.alive & (frac > threshold), frac, -1.0)
    svals, vsel = largest_k(score, max_repair)
    do = svals > 0
    v = vsel                                              # [M] distinct
    row = graph.nbrs[v]                                   # [M, R]
    valid = row >= 0
    dead = valid & ~graph.alive[_clip(row, cap)]
    hop2 = graph.nbrs[_clip(row, cap)]                    # [M, R, R]
    M = v.shape[0]
    d2 = _sqdist_rows(graph.vectors, hop2.reshape(M, R * R),
                      graph.vectors[v]).reshape(M, R, R)
    ok2 = (hop2 >= 0) & graph.alive[_clip(hop2, cap)] \
        & (hop2 != v[:, None, None]) & dead[:, :, None]   # only via deleted p
    # not already a live neighbor
    live_row = torch.where(dead, -1, row)
    dup = (hop2[..., None] == live_row[:, None, None, :]).any(-1)
    d2 = torch.where(ok2 & ~dup, d2, INF)
    # at most c per deleted neighbor
    cd, itop = smallest_k(d2, c)                          # [M, R, c]
    cand = hop2.gather(2, itop).reshape(M, R * c)
    cd = cd.reshape(M, R * c)
    # dedup candidates (later copies of an id dropped)
    cd = torch.where(torch.isfinite(cd) & ~dup_mask_jnp(cand), cd, INF)
    order = argsort(cd)
    cand, cd = cand.gather(1, order), cd.gather(1, order)
    # fill dead slots with best candidates
    slot_rank = (dead.cumsum(1) - 1).clamp(0, R * c - 1)
    fill = torch.where(torch.isfinite(cd.gather(1, slot_rank)),
                       cand.gather(1, slot_rank), -1)
    new_row = torch.where(dead, fill, row)
    new_rows = torch.where(do[:, None], new_row, row)
    nbrs = graph.nbrs.clone()
    nbrs[v] = new_rows
    version = graph.version.index_add(0, v, do.to(torch.int32))
    graph = graph._replace(nbrs=nbrs, version=version,
                           e_in=compute_e_in(nbrs, cap))
    return IndexState(graph, cache, stats), do.sum()


def consolidate(state: IndexState, *, chunk=2048):
    """Stage 3 (paper §5.2.2): global consolidation. For every alive vertex,
    rebuild its neighbor list from {alive out-neighbors} ∪ {alive
    out-neighbors of its deleted out-neighbors}, pruned to degree by
    distance. Dead rows are cleared. Runs on a snapshot in the engine
    (MVCC) so foreground ops never block on it. Rows at or past the
    high-water mark hold no alive vertex and come out all -1, as the
    reference's do, without being computed.

    Each row is computed alone, so the result does not depend on
    ``chunk``. The loop's ~40 launches a chunk take the interpreter lock
    from the writer and the dispatcher on every call, so the port takes
    4x the reference's 512 rows a chunk: on one H100 at 2^21 x 32 that
    cut a consolidation from 4-8 s to 0.7-1.9 s. A row's candidates are
    scored through ``l2_gather`` (as the partitioned build's merge
    scores its own): the plain version sums as ``_sqdist_rows`` does,
    and the kernel reads only the valid lanes' rows."""
    graph, cache, stats = state.graph, state.cache, state.stats
    R, N = graph.degree, graph.capacity
    dev = graph.nbrs.device
    n = int(graph.n)
    nbrs = torch.full((N, R), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        v = torch.arange(s, min(s + chunk, n), device=dev)
        V = v.shape[0]
        row = graph.nbrs[v]
        valid = row >= 0
        dead = valid & ~graph.alive[_clip(row, N)]
        hop2 = graph.nbrs[_clip(row, N)]                  # [V, R, R]
        hop2 = torch.where(dead[:, :, None], hop2, -1)    # only via deleted
        cand = torch.cat([torch.where(dead, -1, row),
                          hop2.reshape(V, R * R)], dim=1)
        okc = (cand >= 0) & graph.alive[_clip(cand, N)] & (cand != v[:, None])
        # only the valid lanes are scored: most hop2 lanes are -1 (a row
        # has few deleted neighbours), and l2_gather reads no row for them
        d = gather_l2(graph.vectors, torch.where(okc, cand, -1),
                      graph.vectors[v])
        d = torch.where(dup_mask_jnp(cand, N), INF, d)
        nd, it = smallest_k(d, R)
        new_row = torch.where(torch.isfinite(nd), cand.gather(1, it), -1)
        nbrs[v] = torch.where(graph.alive[v][:, None], new_row, -1)
    graph = graph._replace(nbrs=nbrs, version=graph.version + 1,
                           e_in=compute_e_in(nbrs, N))
    return IndexState(graph, cache, stats)


# ---------------------------------------------------------------------------
# Tiered (disk-backed) update path: numpy twins of the device transforms,
# streaming through the TieredStore so the working set stays bounded
# ---------------------------------------------------------------------------

def rank_based_reorder_host(cand_ids, cand_d, cand_rows, degree):
    """Numpy twin of ``build.rank_based_reorder`` for the tiered path:
    the candidates' neighbor rows arrive pre-fetched (``cand_rows``
    [B, C, R]). Its key is float64, as the reference's."""
    B, C = cand_ids.shape
    eq = (cand_rows[:, :, :, None] == cand_ids[:, None, None, :]).any(axis=2)
    tri = np.tril(np.ones((C, C), bool), k=-1).T         # j < i mask at [j, i]
    detours = (eq & tri[None]).sum(axis=1)               # [B, C_i]
    invalid = cand_ids < 0
    detours = np.where(invalid, C + 1, detours)
    rank_d = np.argsort(np.argsort(cand_d, axis=1, kind="stable"),
                        axis=1, kind="stable")
    order = np.argsort(detours.astype(np.float64) * 1e6 + rank_d,
                       axis=1, kind="stable")
    take = min(degree, C)
    sel_ids = np.take_along_axis(cand_ids, order[:, :take], axis=1)
    sel_det = np.take_along_axis(detours, order[:, :take], axis=1)
    sel = np.where(sel_det > C, -1, sel_ids).astype(np.int32)
    if take < degree:
        sel = np.concatenate(
            [sel, np.full((B, degree - take), -1, np.int32)], axis=1)
    return sel


def reverse_edge_rows_host(trow, tvec, nbr_vecs, inv, new_ids, d_edge):
    """One-shot reverse-edge application over fetched target rows — the
    numpy twin of ``_reverse_edge_scatter`` shared by ``insert_tiered``
    and the tiered MVCC merge. For edge e (target ``inv[e]`` -> vertex
    ``new_ids[e]`` at distance ``d_edge[e]``): use a free slot if any,
    else replace the current worst neighbor if the new edge is closer;
    write conflicts resolve last-writer-wins, made explicit here (numpy
    does not promise an order for repeated fancy-assignment indices).
    Returns the updated rows [U, R] (``trow`` is not mutated)."""
    R = trow.shape[1]
    nb_d = ((nbr_vecs - tvec[:, None, :]) ** 2).sum(-1)          # [U, R]
    occ = trow >= 0
    worst = np.argmax(np.where(occ, nb_d, -np.inf), axis=1)
    has_free = (~occ).any(axis=1)
    free_idx = np.argmax(~occ, axis=1)
    slot = np.where(has_free, free_idx, worst)
    max_d = np.where(occ, nb_d, -np.inf).max(axis=1)
    improves = has_free[inv] | (d_edge < max_d[inv])
    lin = (inv * R + slot[inv])[improves]
    vals = np.asarray(new_ids)[improves].astype(np.int32)
    # last write per (row, slot): first occurrence in the reversed order
    _, first = np.unique(lin[::-1], return_index=True)
    win = lin.size - 1 - first
    out = trow.copy()
    out.reshape(-1)[lin[win]] = vals[win]
    return out


def insert_tiered(backend, cache_mirror, new_vecs, sp: SearchParams, seed,
                  attributes=None, device="cuda"):
    """Batched insertion against the disk-backed capacity tier (paper §5.1
    over the three-tier hierarchy): the candidate search cascades through
    the store (``search_tiered``, exact lane, on ``device``), new rows are
    written through the host window, and reverse edges are applied to
    the fetched target rows with the same free-slot / replace-worst /
    last-writer-wins semantics as ``insert_batch``. Returns ``(new_ids,
    RevLog)`` (numpy arrays), consumed by the tiered MVCC merge when a
    consolidation snapshot is in flight. Caller serializes (engine update
    stream).

    The op's full effect (selected rows and reverse-edge triplets) is
    computed against the unmutated store, logged to ``backend.wal`` when
    one is attached, then applied by ``apply_insert_tiered``, which WAL
    replay shares. ``attributes`` (a dict of per-field columns, a
    ``(tags, nums)`` pair, or None for the schema's defaults) needs an
    attached ``backend.attrs`` store."""
    store = backend.store
    new_vecs = np.asarray(new_vecs, np.float32)
    Bi = new_vecs.shape[0]
    R = backend.degree
    n0 = backend.n
    if n0 + Bi > backend.capacity:
        raise ValueError(f"disk tier full: {n0}+{Bi} > {backend.capacity}")
    ids = (n0 + np.arange(Bi)).astype(np.int64)
    # one O(capacity) F_λ pass shared by the candidate search, the row
    # fetches and the reverse-edge pass below
    f_lam = cache_mirror.scores(backend.e_in)

    # phase 1: candidate search on the current graph
    res = search_tiered(backend, cache_mirror, new_vecs, seed,
                        sp._replace(k=sp.pool), f_lam=f_lam, device=device)
    cand_ids, cand_d = res.ids.astype(np.int64), res.dists

    # phase 2: rank-based reorder over the candidates' (fetched) rows
    uc = np.unique(np.clip(cand_ids, 0, None))
    _, urows = store.fetch(uc, f_lam)
    cand_rows = urows[np.searchsorted(uc, np.clip(cand_ids, 0, None))]
    cand_rows[cand_ids < 0] = -1
    sel = rank_based_reorder_host(cand_ids, cand_d, cand_rows, R)

    # reverse-edge triplets, pre-mutation (targets all pre-exist: their
    # vectors are immutable and the distances are computable now)
    flat_t = sel.reshape(-1).astype(np.int64)
    flat_new = np.repeat(ids, R)
    ok = flat_t >= 0
    flat_t, flat_new = flat_t[ok], flat_new[ok]
    d_edge = np.zeros((0,), np.float32)
    if flat_t.size:
        ut, inv = np.unique(flat_t, return_inverse=True)
        tvec, _ = store.fetch(ut, f_lam)
        d_edge = ((tvec[inv] - new_vecs[(flat_new - n0)]) ** 2).sum(-1)
    rev = RevLog(flat_t.astype(np.int64), flat_new.astype(np.int64),
                 np.asarray(d_edge, np.float32))

    # attribute columns, coerced through the index schema so that the
    # log record and the live apply share one validated form
    tags = nums = None
    if backend.attrs is not None:
        tags, nums = backend.attrs.schema.coerce(attributes, Bi)
    elif attributes is not None:
        raise ValueError("attributes passed but no attribute store is "
                         "attached (set EngineConfig.attributes)")

    if backend.wal is not None:
        # numpy arrays only: the record must read back without torch
        payload = {"ids": ids, "vecs": new_vecs, "sel": sel,
                   "rev_v": rev.v, "rev_vn": rev.v_new, "rev_d": rev.d}
        if tags is not None:
            payload["tags"], payload["nums"] = tags, nums
        backend.wal.append(REC_INSERT, payload)
    apply_insert_tiered(backend, ids, new_vecs, sel, rev, f_lam=f_lam,
                        tags=tags, nums=nums)
    return ids, rev


def apply_insert_tiered(backend, ids, new_vecs, sel, rev: RevLog,
                        f_lam=None, tags=None, nums=None) -> None:
    """Mutation half of ``insert_tiered``, shared with WAL replay
    (``wal.recover``): establish the new vertices, encode their PQ codes
    against the frozen codebook, write their attribute columns, then
    apply the reverse edges onto freshly fetched target rows. Replayed
    over the snapshot, it walks the store through the live run's
    writes."""
    store = backend.store
    ids = np.asarray(ids, np.int64)
    new_vecs = np.asarray(new_vecs, np.float32)
    if not len(ids):
        return
    n0 = int(ids[0])
    if n0 != backend.n:
        raise ValueError(f"insert applied out of order: batch starts at id "
                         f"{n0}, store high-water mark is {backend.n}")
    R = backend.degree

    # establish new vertices (write-through keeps the overlay coherent);
    # the PQ code lane encodes incrementally against its frozen codebook
    store.write(ids, new_vecs, sel)
    crash_point("mid_memmap_write")   # new rows written, reverse edges not
    if backend.pq is not None:
        backend.pq.encode_write(ids, new_vecs)
    if backend.attrs is not None and tags is not None:
        backend.attrs.write(ids, tags, nums)
    backend.alive[ids] = True
    backend.version[ids] = 1
    sel = np.asarray(sel, np.int32)
    np.add.at(backend.e_in, sel[sel >= 0], 1)
    backend.n = int(n0 + len(ids))

    # reverse edges (flattened over the batch, original-rows semantics)
    v = np.asarray(rev.v, np.int64)
    if v.size:
        v_new = np.asarray(rev.v_new, np.int64)
        d_edge = np.asarray(rev.d, np.float32)
        ut, inv = np.unique(v, return_inverse=True)
        tvec, trow = store.fetch(ut, f_lam)
        rvec, _ = store.peek(np.clip(trow, 0, None).reshape(-1))
        new_rows = reverse_edge_rows_host(
            trow, tvec, rvec.reshape(ut.size, R, -1), inv, v_new, d_edge)
        np.add.at(backend.e_in, trow[trow >= 0], -1)
        np.add.at(backend.e_in, new_rows[new_rows >= 0], 1)
        store.write(ut, None, new_rows)
        backend.version[ut] += 1


def delete_tiered(backend, ids) -> np.ndarray:
    """Logical deletion on the tiered backend (stage 1, paper §5.2.1):
    bounds-filter, drop already-dead ids, log the surviving set, then
    flip the bitset. Returns the ids actually deleted. Caller serializes
    (engine update stream)."""
    ids_np = np.asarray(ids, np.int64)
    ids_np = ids_np[(ids_np >= 0) & (ids_np < backend.n)]
    ids_np = ids_np[backend.alive[ids_np]]
    if backend.wal is not None and ids_np.size:
        backend.wal.append(REC_DELETE, {"ids": ids_np})
    apply_delete_tiered(backend, ids_np)
    return ids_np


def apply_delete_tiered(backend, ids_np) -> None:
    """Mutation half of ``delete_tiered`` (ids are pre-filtered)."""
    ids_np = np.asarray(ids_np, np.int64)
    backend.alive[ids_np] = False
    backend.version[ids_np] += 1


def consolidate_tiered(backend, chunk=256, *, snapshot=None):
    """Stage 3 (paper §5.2.2) for the disk tier, MVCC form (paper §5.3):
    global consolidation computed against a frozen topology snapshot
    while inserts/deletes/searches continue on the active store. Per
    snapshot-alive vertex, the neighbor list is rebuilt from {alive
    out-neighbors} ∪ {alive out-neighbors of deleted out-neighbors},
    pruned to degree by distance; dead rows are cleared. Returns the
    rebuilt rows [snapshot.n, R] without publishing them (callers publish
    through ``mvcc.merge_consolidated_tiered``). When ``snapshot`` is
    None a snapshot is taken and the result merged in place."""
    from repro_torch.core import mvcc
    serial = snapshot is None
    if serial:
        snapshot = mvcc.snapshot_tiered(backend)
    store = backend.store
    R = backend.degree
    snap_rows, snap_alive = snapshot.rows, snapshot.alive
    snap_n = snapshot.n
    new_rows = snap_rows.copy()
    for s in range(0, snap_n, chunk):
        ids = np.arange(s, min(s + chunk, snap_n))
        C = ids.size
        rows = snap_rows[ids]
        valid = rows >= 0
        dead = valid & ~snap_alive[np.clip(rows, 0, None)]
        if not dead.any() and bool(snap_alive[ids].all()):
            continue
        svec, _ = store.peek(ids)
        hop2 = np.full((C, R, R), -1, np.int32)
        if dead.any():
            hop2[dead] = snap_rows[rows[dead]]       # frozen topology
        cand = np.concatenate(
            [np.where(dead, -1, rows), hop2.reshape(C, R * R)], axis=1)
        okc = (cand >= 0) & snap_alive[np.clip(cand, 0, None)] \
            & (cand != ids[:, None])
        cu = np.unique(np.clip(cand, 0, None))
        cvec, _ = store.peek(cu)
        clut = np.zeros((int(cu.max()) + 2,), np.int64)
        clut[cu] = np.arange(cu.size)
        d = ((cvec[clut[np.clip(cand, 0, None)]]
              - svec[:, None, :]) ** 2).sum(-1)
        d = np.where(okc & ~dedup_mask(cand), d, np.inf)
        top = np.argpartition(d, min(R, d.shape[1]) - 1, axis=1)[:, :R]
        dtop = np.take_along_axis(d, top, axis=1)
        o = np.argsort(dtop, axis=1, kind="stable")
        top = np.take_along_axis(top, o, axis=1)
        dtop = np.take_along_axis(dtop, o, axis=1)
        out = np.where(np.isfinite(dtop),
                       np.take_along_axis(cand, top, axis=1),
                       -1).astype(np.int32)
        out[~snap_alive[ids]] = -1
        new_rows[ids] = out
    if serial:
        mvcc.merge_consolidated_tiered(backend, snapshot, new_rows, [])
    return new_rows
