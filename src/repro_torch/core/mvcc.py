"""Multi-version mechanism (twin of ``repro.core.mvcc``, paper §5.3).

A consolidation runs on an immutable snapshot G_t0 while foreground
inserts/deletes/searches continue on the active graph G_t1. At
completion the background result G'_t0 is merged:

* **Incremental subgraph appending** — vertices inserted after the
  snapshot (id >= snapshot_n) keep their active-graph rows verbatim.
* **Reverse-edge integration** — reverse-edge triplets (v, v_new, d)
  logged during the window are re-applied onto the consolidated rows of
  old vertices.
* deletions that happened during the window stay authoritative (the
  alive bitset is taken from the active graph). In device mode, as in
  the reference, consolidated rows keep their edges to vertices deleted
  during the window (searches skip them through the bitset; the next
  consolidation removes them); the disk-tier merge scrubs them.

The disk-tier form (``TieredSnapshot`` / ``snapshot_tiered`` /
``merge_consolidated_tiered``) freezes only adjacency rows and the alive
bitset; vectors are immutable per id and keep streaming from the live
store. The merge collects its edit set first, logs it as one record to
the backend's write-ahead log when one is attached, and applies it with
``apply_merge_edits``, which WAL replay shares.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.build import compute_e_in
from repro_torch.core.types import IndexState
from repro_torch.core.update import (RevLog, _reverse_edge_scatter,
                                     reverse_edge_rows_host)
from repro_torch.core.wal import REC_CONSOLIDATE, crash_point


def merge_consolidated(consolidated: IndexState, active: IndexState,
                       snapshot_n, rev_log: RevLog) -> IndexState:
    """Merge background-consolidated snapshot into the active state."""
    gc, ga = consolidated.graph, active.graph
    N = ga.capacity
    dev = ga.nbrs.device
    is_new = torch.arange(N, device=dev) >= int(snapshot_n)

    # old rows from the consolidated graph, new rows appended from active
    nbrs = torch.where(is_new[:, None], ga.nbrs, gc.nbrs)
    graph = ga._replace(nbrs=nbrs)

    # re-apply window reverse edges onto consolidated old rows
    v = torch.as_tensor(rev_log.v, device=dev)
    v_new = torch.as_tensor(rev_log.v_new, device=dev)
    apply_mask = (v >= 0) & (v < int(snapshot_n)) \
        & graph.alive[v.clamp(0, N - 1)] & graph.alive[v_new.clamp(0, N - 1)]
    targets = torch.where(apply_mask, v, -1)
    nbrs = _reverse_edge_scatter(graph, targets, v_new,
                                 torch.as_tensor(rev_log.d, device=dev))
    graph = graph._replace(nbrs=nbrs, e_in=compute_e_in(nbrs, N),
                           version=torch.maximum(ga.version, gc.version) + 1)
    return IndexState(graph, active.cache, active.stats)


def empty_rev_log(device="cuda") -> RevLog:
    z = torch.zeros((0,), dtype=torch.int32, device=device)
    return RevLog(z, z, torch.zeros((0,), dtype=torch.float32, device=device))


def concat_rev_logs(logs, device="cuda") -> RevLog:
    logs = [lg for lg in logs if lg.v.shape[0]]
    if not logs:
        return empty_rev_log(device)
    return RevLog(torch.cat([lg.v for lg in logs]),
                  torch.cat([lg.v_new for lg in logs]),
                  torch.cat([lg.d for lg in logs]))


# ---------------------------------------------------------------------------
# Disk-tier form: snapshot / merge for the streaming consolidation
# ---------------------------------------------------------------------------

class TieredSnapshot(NamedTuple):
    """Frozen view of the disk-tier graph metadata at snapshot time.
    Vectors are immutable per id and deliberately not copied."""
    n: int                # high-water mark at snapshot time
    rows: np.ndarray      # [n, R] int32 adjacency at snapshot time
    alive: np.ndarray     # [n] bool alive bitset at snapshot time


def snapshot_tiered(backend, chunk=4096) -> TieredSnapshot:
    """Freeze the topology + alive bitset for a background consolidation.
    Rows stream through ``peek_rows`` in bounded chunks (no window
    thrash). Caller serializes with the update stream."""
    n = backend.n
    rows = np.empty((n, backend.degree), np.int32)
    for s in range(0, n, chunk):
        ids = np.arange(s, min(s + chunk, n))
        rows[ids] = backend.store.peek_rows(ids)
    return TieredSnapshot(int(n), rows, backend.alive[:n].copy())


def merge_consolidated_tiered(backend, snap: TieredSnapshot, new_rows,
                              rev_logs, chunk=4096) -> None:
    """Publish a background tiered consolidation (the disk-tier twin of
    ``merge_consolidated``): window deletions stay authoritative (dead
    rows cleared, edges to window-dead vertices scrubbed), window
    reverse-edge triplets are re-applied onto the consolidated rows with
    ``insert_batch``'s free-slot / replace-worst / last-writer-wins
    semantics, vertices inserted after the snapshot (id >= snap.n) keep
    their active-store rows verbatim, and e_in is rebuilt over the merged
    graph. ``rev_logs`` is the sequence of per-insert-batch RevLogs
    logged during the window, replayed batch by batch (slots are
    recomputed between batches, exactly as the live path applied them).
    Caller serializes with the update stream."""
    store = backend.store
    R = backend.degree
    alive = backend.alive
    rows = np.asarray(new_rows, np.int32).copy()

    # reverse-edge integration: both endpoints must still be alive
    for log in rev_logs:
        v = np.asarray(log.v, np.int64)
        v_new = np.asarray(log.v_new, np.int64)
        d = np.asarray(log.d, np.float32)
        ok = (v >= 0) & (v < snap.n) & alive[np.clip(v, 0, None)] \
            & alive[np.clip(v_new, 0, None)]
        v, v_new, d = v[ok], v_new[ok], d[ok]
        if not v.size:
            continue
        ut, inv = np.unique(v, return_inverse=True)
        trow = rows[ut]
        tvec, _ = store.peek(ut)
        rvec, _ = store.peek(np.clip(trow, 0, None).reshape(-1))
        rows[ut] = reverse_edge_rows_host(
            trow, tvec, rvec.reshape(ut.size, R, -1), inv, v_new, d)

    # window deletions are authoritative on the consolidated rows
    rows[(rows >= 0) & ~alive[np.clip(rows, 0, None)]] = -1
    rows[~alive[:snap.n]] = -1

    # the edit set names only rows the rebuild/replay/scrub changed vs
    # the frozen topology; untouched rows keep their live store contents
    # (live-applied window reverse edges on an untouched row equal the
    # replay's result)
    changed = np.where((rows != snap.rows).any(axis=1))[0]
    edits = [(changed, rows[changed])]
    is_changed = np.zeros((snap.n,), bool)
    is_changed[changed] = True

    # live rows untouched by the rebuild may still carry reverse edges to
    # vertices inserted and then deleted within the window; every such
    # row is named as a target by the logs. The scrub reads the state the
    # changed-group writes will leave.
    stale = np.unique(np.concatenate(
        [np.asarray(log.v, np.int64)[
            ~alive[np.clip(np.asarray(log.v_new, np.int64), 0, None)]]
         for log in rev_logs] or [np.zeros((0,), np.int64)]))
    stale = stale[(stale >= 0) & (stale < snap.n)]
    s_ids, s_rows = [], []
    for s in range(0, stale.size, chunk):
        ids = stale[s:s + chunk]
        r = store.peek_rows(ids)
        m = is_changed[ids]
        if m.any():
            r[m] = rows[ids[m]]
        dead = (r >= 0) & ~alive[np.clip(r, 0, None)]
        if dead.any():
            r[dead] = -1
            sel = dead.any(axis=1)
            s_ids.append(ids[sel])
            s_rows.append(r[sel])
    if s_ids:
        edits.append((np.concatenate(s_ids), np.concatenate(s_rows)))

    # incremental subgraph appending: rows past the snapshot stay
    # verbatim except that window deletions are authoritative there too
    n = backend.n
    a_ids, a_rows = [], []
    for s in range(snap.n, n, chunk):
        ids = np.arange(s, min(s + chunk, n))
        r = store.peek_rows(ids)
        dead = (r >= 0) & ~alive[np.clip(r, 0, None)]
        if dead.any():
            r[dead] = -1
            sel = dead.any(axis=1)
            a_ids.append(ids[sel])
            a_rows.append(r[sel])
    if a_ids:
        edits.append((np.concatenate(a_ids), np.concatenate(a_rows)))

    if backend.wal is not None:
        backend.wal.append(REC_CONSOLIDATE, {
            "ids": [np.asarray(g[0], np.int64) for g in edits],
            "rows": [np.asarray(g[1], np.int32) for g in edits]})
    apply_merge_edits(backend, edits, chunk=chunk)


def apply_merge_edits(backend, edits, chunk=4096) -> None:
    """Mutation half of ``merge_consolidated_tiered``, shared with WAL
    replay: write each (ids, rows) edit group in order, with incremental
    e_in accounting against the rows being replaced. e_in is published
    in one assignment at the end."""
    store = backend.store
    e_in = backend.e_in.copy()
    first = True
    for gids, grows in edits:
        gids = np.asarray(gids, np.int64)
        grows = np.asarray(grows, np.int32)
        for s in range(0, gids.size, chunk):
            ids = gids[s:s + chunk]
            new = grows[s:s + chunk]
            old = store.peek_rows(ids)
            np.subtract.at(e_in, old[old >= 0], 1)
            np.add.at(e_in, new[new >= 0], 1)
            store.write(ids, None, new)
            backend.version[ids] += 1
            if first:               # merge partly written, the rest pending
                crash_point("mid_consolidation_merge")
                first = False
    backend.e_in = e_in
