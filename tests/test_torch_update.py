"""The port's device-mode write path against the reference, step by step:
``insert_batch`` (entry pool recomputed from the reference's key),
``delete_batch``, ``repair_affected``, ``consolidate`` and
``merge_consolidated`` leave every ``GraphState`` field equal, with
colliding reverse edges and rank keys past 17 detours among the cases.
Then the reference's own invariants (``tests/test_core.py``) run
against the port, and the device-mode engine's write path.

Vectors are integer-valued where fields must match, so fp32 distances
are exact in both frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mvcc as JM
from repro.core import update as JU
from repro.core.build import build_index as jax_build_index
from repro.core.build import rank_based_reorder as jax_reorder
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch import convert
from repro_torch.core import engine as TE
from repro_torch.core import mvcc as TM
from repro_torch.core import update as TU
from repro_torch.core.build import build_index, compute_e_in
from repro_torch.core.build import rank_based_reorder
from repro_torch.core.search import brute_force_topk, frontier_search
from repro_torch.core.types import SearchParams

N, D, DEG, CAP = 300, 12, 8, 512
SP = SearchParams(k=5, pool=16, max_iters=24, beam=2)


def to_port(st):
    return convert.index_state_from_arrays(
        *({f: np.asarray(x) for f, x in part._asdict().items()}
          for part in (st.graph, st.cache, st.stats)), device="cpu")


def same_graph(got, want):
    for f in got.graph._fields:
        np.testing.assert_array_equal(
            getattr(got.graph, f).numpy(), np.asarray(getattr(want.graph, f)),
            err_msg=f)


def jax_entries(key, bi, n, pool=SP.pool):
    """The entry pool the reference's ``insert_batch`` draws from ``key``."""
    return np.array(jax.random.randint(key, (bi, pool), 0, max(n, 1),
                                         dtype=jnp.int32))


def insert_both(st, pst, vecs, seed):
    key = jax.random.PRNGKey(seed)
    want = JU.insert_batch(st, jnp.asarray(vecs), key, JaxSearchParams(*SP))
    got = TU.insert_batch(pst, torch.from_numpy(vecs),
                          torch.from_numpy(jax_entries(key, len(vecs),
                                                       int(st.graph.n))), SP)
    same_graph(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(convert.rev_log_to_arrays(got[2]), want[2]):
        np.testing.assert_array_equal(g, np.asarray(w))
    return want, got


@pytest.fixture(scope="module")
def base():
    rng = np.random.default_rng(5)
    vecs = rng.integers(-5, 6, (N, D)).astype(np.float32)
    st = jax_build_index(vecs, degree=DEG, cache_slots=32, n_max=CAP)
    return st, to_port(st), rng


def test_insert_delete_repair_consolidate_match_reference(base):
    st, pst, rng = base
    # two insert batches; the second has 8 copies of one vector, so its
    # reverse edges collide on the same (row, slot)
    (st, _, _), (pst, _, _) = insert_both(
        st, pst, rng.integers(-5, 6, (24, D)).astype(np.float32), 1)
    dup = np.repeat(rng.integers(-5, 6, (1, D)), 8, 0).astype(np.float32)
    two = np.concatenate([dup, rng.integers(-5, 6, (8, D))]).astype(
        np.float32)
    (st, ids, rev), (pst, _, _) = insert_both(st, pst, two, 2)
    # deletes: a clustered block, repeats, -1 and out-of-range ids
    dead = np.concatenate([np.arange(0, 120, dtype=np.int32),
                           [5, 5, -1, CAP + 7, int(ids[0])]]).astype(np.int32)
    st = JU.delete_batch(st, jnp.asarray(dead))
    pst = TU.delete_batch(pst, torch.from_numpy(dead))
    same_graph(pst, st)
    np.testing.assert_allclose(float(TU.deleted_fraction(pst.graph)),
                               float(JU.deleted_fraction(st.graph)))
    np.testing.assert_array_equal(TU.affected_fraction(pst.graph).numpy(),
                                  np.asarray(JU.affected_fraction(st.graph)))
    st_r, nrep = JU.repair_affected(st, max_repair=64, threshold=0.3)
    pst_r, pnrep = TU.repair_affected(pst, max_repair=64, threshold=0.3)
    same_graph(pst_r, st_r)
    assert int(pnrep) == int(nrep) > 0
    want = JU.consolidate(st_r, chunk=128)
    got = TU.consolidate(pst_r, chunk=128)
    same_graph(got, want)


@pytest.mark.parametrize("chunk", [None, 7, 128, 1024])
def test_consolidate_does_not_depend_on_chunk(base, chunk):
    """Each row is consolidated alone: the port's default chunk (2048
    rows), a chunk that splits the rows unevenly and chunks below and
    past the row count all equal the reference at its 512."""
    st, pst, _ = base
    dead = np.arange(0, N, 3, dtype=np.int32)
    st = JU.delete_batch(st, jnp.asarray(dead))
    pst = TU.delete_batch(pst, torch.from_numpy(dead))
    want = JU.consolidate(st)
    got = TU.consolidate(pst) if chunk is None \
        else TU.consolidate(pst, chunk=chunk)
    same_graph(got, want)


def test_merge_consolidated_with_a_window_log(base):
    """A snapshot consolidated while the active graph takes a delete and
    two insert batches; the window's concatenated log is re-applied at
    the merge, the reference's log carried across with ``convert``."""
    st, pst, rng = base
    snap_n = int(st.graph.n)
    act = JU.delete_batch(st, jnp.arange(0, 60, dtype=jnp.int32))
    pact = TU.delete_batch(pst, torch.arange(0, 60, dtype=torch.int32))
    logs = []
    for seed in (3, 4):
        v = rng.integers(-5, 6, (16, D)).astype(np.float32)
        (act, _, rev), (pact, _, _) = insert_both(act, pact, v, seed)
        logs.append(rev)
    act = JU.delete_batch(act, jnp.asarray([N + 1, 70], jnp.int32))
    pact = TU.delete_batch(pact, torch.tensor([N + 1, 70], dtype=torch.int32))
    log = JM.concat_rev_logs(logs)
    want = JM.merge_consolidated(JU.consolidate(st), act,
                                 jnp.asarray(snap_n, jnp.int32), log)
    plog = convert.rev_log_from_arrays(*map(np.asarray, log), device="cpu")
    got = TM.merge_consolidated(TU.consolidate(pst), pact, snap_n, [plog])
    same_graph(got, want)
    assert np.isin(np.arange(N, N + 32), got.graph.nbrs[:snap_n].numpy()).any()


def test_merge_consolidated_replays_window_batches_in_order(base):
    """Given the window's per-batch logs, the port's merge re-applies
    them one scatter a batch: the reference's merge applied once per
    batch, each on the rows the one before left (the merge of batch b
    takes the merge of batch b-1 as its consolidated graph), with one
    version step for the whole merge. Here the batches share target
    rows, so one scatter over the concatenated log differs."""
    st, pst, rng = base
    snap_n = int(st.graph.n)
    act = JU.delete_batch(st, jnp.arange(0, 60, dtype=jnp.int32))
    pact = TU.delete_batch(pst, torch.arange(0, 60, dtype=torch.int32))
    logs, plogs = [], []
    for seed in (5, 6, 7):
        v = rng.integers(-5, 6, (16, D)).astype(np.float32)
        (act, _, rev), (pact, _, prev) = insert_both(act, pact, v, seed)
        logs.append(rev)
        plogs.append(prev)
    sn = jnp.asarray(snap_n, jnp.int32)
    want = JU.consolidate(st)
    for log in logs:
        want = JM.merge_consolidated(want, act, sn, log)
    cons = TU.consolidate(pst)
    got = TM.merge_consolidated(cons, pact, snap_n, plogs)
    for f in got.graph._fields:
        if f != "version":
            np.testing.assert_array_equal(
                getattr(got.graph, f).numpy(),
                np.asarray(getattr(want.graph, f)), err_msg=f)
    assert torch.equal(got.graph.version, torch.maximum(
        pact.graph.version, cons.graph.version) + 1)
    once = TM.merge_consolidated(cons, pact, snap_n, [
        convert.rev_log_from_arrays(*map(np.asarray, JM.concat_rev_logs(
            logs)), device="cpu")])
    assert not torch.equal(once.graph.nbrs, got.graph.nbrs)


def test_reverse_edge_conflicts_keep_the_last_write(base):
    """Five edges into one target row: the first finds a free slot, the
    rest collide on it; the last one's id is what the row keeps, as in
    the reference."""
    st, pst, _ = base
    nbrs = np.asarray(st.graph.nbrs).copy()
    nbrs[3, -2:] = -1                                    # two free slots
    st = st._replace(graph=st.graph._replace(nbrs=jnp.asarray(nbrs)))
    pst = pst._replace(graph=pst.graph._replace(nbrs=torch.from_numpy(nbrs)))
    targets = np.array([3, 3, 3, -1, 3, 4], np.int32)
    new_ids = np.array([200, 201, 202, 203, 204, 205], np.int32)
    d = np.array([1, 2, 3, 4, 5, 0], np.float32)
    want = JU._reverse_edge_scatter(st.graph, *map(jnp.asarray,
                                                   (targets, new_ids, d)))
    got = TU._reverse_edge_scatter(pst.graph, *map(torch.from_numpy,
                                                   (targets, new_ids, d)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3, DEG - 2] == 204 and got[3, DEG - 1] == -1


@pytest.mark.parametrize("ids,alive0", [([0, -1], True), ([-1, 0], False)])
def test_delete_batch_keeps_the_reference_order_on_id_zero(base, ids,
                                                           alive0):
    """A -1 lane clips to id 0 and writes back id 0's old flag; the last
    lane wins, so after [0, -1] id 0 is still alive (its version moved),
    in the reference and in the port alike (ROADMAP C)."""
    st, pst, _ = base
    want = JU.delete_batch(st, jnp.asarray(ids, jnp.int32))
    got = TU.delete_batch(pst, torch.tensor(ids, dtype=torch.int32))
    same_graph(got, want)
    assert bool(got.graph.alive[0]) is alive0
    assert int(got.graph.version[0]) == int(pst.graph.version[0]) + 1


@pytest.mark.parametrize("C,deg", [(40, 12), (24, 32), (6, 4)])
def test_rank_based_reorder_matches_past_17_detours(C, deg):
    """Every candidate lists every other in its row, so candidate i has i
    detours: from 17 on the reference's float32 key rounds and ties fall
    to position. Random rows and -1 candidates in the other rows."""
    rng = np.random.default_rng(C)
    cand = rng.permutation(200)[:C].astype(np.int32)
    nbrs = rng.integers(-1, 200, (256, 48)).astype(np.int32)
    nbrs[cand[:, None], np.arange(C)[None, :]] = cand[None, :]
    cands = np.stack([cand, rng.permutation(200)[:C].astype(np.int32)])
    cands[1, ::5] = -1
    dists = rng.integers(0, 4, (2, C)).astype(np.float32)
    want = jax_reorder(jnp.asarray(cands), jnp.asarray(dists),
                       jnp.asarray(nbrs), deg)
    got = rank_based_reorder(torch.from_numpy(cands), torch.from_numpy(dists),
                             torch.from_numpy(nbrs), deg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_core.py) against the port
# ---------------------------------------------------------------------------

NI, DI, RI = 3000, 24, 16
SPI = SearchParams(k=10, pool=64, max_iters=96)


@pytest.fixture(scope="module")
def index():
    vecs = np.random.default_rng(0).normal(size=(NI, DI)).astype(np.float32)
    return build_index(vecs, degree=RI, cache_slots=384, n_max=8192,
                       device="cpu")


def search(st, q, seed):
    n = int(st.graph.n)
    entries = torch.randint(0, n, (len(q), SPI.pool), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(seed))
    return frontier_search(st, q, entries, SPI)


def insert(st, v, seed):
    entries = torch.randint(0, int(st.graph.n), (len(v), SPI.pool),
                            dtype=torch.int32,
                            generator=torch.Generator().manual_seed(seed))
    return TU.insert_batch(st, v, entries, SPI)


def test_invariant_read_after_write(index):
    newv = torch.from_numpy(np.random.default_rng(7).normal(
        size=(64, DI)).astype(np.float32))
    st2, ids, rev = insert(index, newv, 8)
    res = search(st2, newv, 9)
    assert float((res.ids[:, 0] == ids).float().mean()) > 0.9
    assert rev.v.shape[0] == 64 * RI
    assert torch.equal(compute_e_in(st2.graph.nbrs, st2.graph.capacity),
                       st2.graph.e_in)


def test_invariant_deleted_ids_never_returned(index):
    q = torch.from_numpy(np.random.default_rng(10).normal(
        size=(16, DI)).astype(np.float32))
    truth, _ = brute_force_topk(index.graph, q, 1)
    st2 = TU.delete_batch(index, truth[:, 0])
    found = search(st2, q, 11).ids
    assert not torch.isin(truth[:, 0], found).any()


def test_invariant_repair_lowers_the_affected_fraction():
    vecs = np.random.default_rng(0).normal(size=(2000, DI)).astype(np.float32)
    st = build_index(vecs, degree=RI, cache_slots=256, n_max=4096,
                     device="cpu")
    d = ((st.graph.vectors[:2000] - st.graph.vectors[0]) ** 2).sum(1)
    st = TU.delete_batch(st, torch.argsort(d)[:500].to(torch.int32))
    before = TU.affected_fraction(st.graph)[:2000]
    alive = st.graph.alive[:2000]
    assert int(((before > 0.5) & alive).sum()) > 0
    st2, nrep = TU.repair_affected(st, max_repair=512)
    after = TU.affected_fraction(st2.graph)[:2000]
    assert int(nrep) > 0
    assert float(after[alive].mean()) < float(before[alive].mean())


def test_invariant_consolidate_leaves_no_dead_edge(index):
    st3 = TU.consolidate(TU.delete_batch(index, torch.arange(600)))
    nb, alive = st3.graph.nbrs, st3.graph.alive
    assert int(((nb >= 0) & ~alive[nb.clamp(min=0)]).sum()) == 0
    assert torch.equal(compute_e_in(nb, st3.graph.capacity), st3.graph.e_in)


def test_invariant_merge_keeps_new_vertices_and_window_deletions(index):
    snap_n = int(index.graph.n)
    active = TU.delete_batch(index, torch.arange(400))
    newv = torch.from_numpy(np.random.default_rng(12).normal(
        size=(32, DI)).astype(np.float32))
    active, ids, rev = insert(active, newv, 13)
    merged = TM.merge_consolidated(TU.consolidate(index), active, snap_n,
                                 [rev])
    res = search(merged, newv, 14)
    assert float((res.ids[:, 0] == ids).float().mean()) > 0.85
    assert not bool(merged.graph.alive[:400].any())
    assert torch.isin(ids, merged.graph.nbrs[:snap_n]).any()


# ---------------------------------------------------------------------------
# the device-mode engine's write path
# ---------------------------------------------------------------------------

def engine(vecs, **kw):
    return TE.SVFusionEngine(vecs, TE.EngineConfig(
        degree=RI, cache_slots=256, capacity=4096, device="cpu",
        search=SearchParams(k=1, pool=48, max_iters=64), **kw))


@pytest.mark.parametrize("sync,expect", [(True, 0.9), (False, 0.5)],
                         ids=["sync", "stale"])
def test_engine_consistency_modes(sync, expect):
    """The reference's bar (``tests/test_core.py``): with sync, inserted
    vectors find themselves; the stale-snapshot ablation mostly not."""
    rng = np.random.default_rng(0)
    eng = engine(rng.normal(size=(800, DI)).astype(np.float32), sync=sync,
                 stale_refresh=64)
    try:
        hits = []
        for _ in range(6):
            newv = rng.normal(size=(8, DI)).astype(np.float32)
            ids = eng.insert(newv)
            found, _ = eng.search(newv)
            hits.append(float((found[:, 0] == ids).mean()))
        assert (np.mean(hits) > expect) if sync else \
            (np.mean(hits) < expect)
    finally:
        eng.close()


def test_engine_insert_matches_insert_batch_on_its_draw():
    """The engine's insert is ``insert_batch`` on entries drawn from a
    generator split off its own, chunk by chunk."""
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(400, DI)).astype(np.float32)
    newv = rng.normal(size=(40, DI)).astype(np.float32)
    eng = engine(vecs, coalesce=False, seed=4)
    try:
        st = eng.state
        key_state = eng._key.get_state()
        ids = eng.insert(newv, chunk=32)
        eng._key.set_state(key_state)
        for s in (0, 32):
            part = torch.from_numpy(newv[s:s + 32])
            entries = torch.randint(0, int(st.graph.n),
                                    (len(part), eng.cfg.search.pool),
                                    generator=eng._next_key(),
                                    dtype=torch.int32)
            st, _, _ = TU.insert_batch(st, part, entries, eng.cfg.search)
        np.testing.assert_array_equal(ids, np.arange(400, 440))
        for f in ("nbrs", "vectors", "alive", "version", "e_in"):
            assert torch.equal(getattr(eng.state.graph, f),
                               getattr(st.graph, f)), f
    finally:
        eng.close()


def test_engine_bootstrap_delete_repair_and_background_consolidation(
        monkeypatch):
    """A near-empty index is bootstrapped by the exact-KNN stitch; deletes
    past the threshold start a background consolidation on a snapshot,
    held back here until an insert has landed in its window; after
    ``wait_background`` the window's inserts are alive and found, and no
    edge reaches a vertex that was dead at the snapshot."""
    import threading
    release = threading.Event()
    consolidate = TU.consolidate

    def held(state, **kw):
        release.wait(60)
        return consolidate(state, **kw)
    monkeypatch.setattr(TU, "consolidate", held)
    rng = np.random.default_rng(2)
    eng = engine(rng.normal(size=(20, DI)).astype(np.float32),
                 consolidate_threshold=0.25, repair_every=2)
    try:
        ids0 = eng.insert(rng.normal(size=(200, DI)).astype(np.float32),
                          chunk=100)
        assert list(ids0[:3]) == [20, 21, 22]
        eng.delete(np.arange(0, 40))
        assert eng._snapshot_n is None
        eng.delete(np.arange(40, 80))       # past the threshold
        assert eng._snapshot_n == 220
        late = rng.normal(size=(16, DI)).astype(np.float32)
        ids = eng.insert(late)              # lands in the window
        assert len(eng._rev_logs) == 1
        release.set()
        eng.wait_background()
        st = eng.state.graph
        assert eng.stats()["consolidations"] == 1
        assert eng._snapshot_n is None and eng._active_versions == 0
        assert bool(st.alive[torch.from_numpy(ids)].all())
        assert not bool(st.alive[:80].any())
        found, _ = eng.search(late)
        assert float((found[:, 0] == ids).mean()) > 0.9
        nb = st.nbrs
        assert not bool(((nb >= 0) & (nb < 80)).any())
        assert torch.isin(torch.from_numpy(ids), nb[:220]).any()
        assert torch.equal(compute_e_in(nb, st.capacity), st.e_in)
        assert len(eng.latencies["insert"]) == 2
        assert len(eng.latencies["delete"]) == 2
    finally:
        release.set()
        eng.close()


def test_engine_merge_keeps_the_window_inserts_findable(monkeypatch):
    """A consolidation merged after eight insert chunks of its window:
    the merge replays the window chunk by chunk, so each chunk's rows
    still find themselves as they did before it (one scatter over the
    concatenated log keeps one edge per target row, and the first
    chunks fall to ~0.6)."""
    import threading
    release = threading.Event()
    consolidate = TU.consolidate
    merge = TM.merge_consolidated
    seen = []

    def held(state, **kw):
        release.wait(60)
        return consolidate(state, **kw)

    def logged(cons, active, snap_n, logs):
        seen.append(len(logs))
        return merge(cons, active, snap_n, logs)
    monkeypatch.setattr(TU, "consolidate", held)
    monkeypatch.setattr(TM, "merge_consolidated", logged)
    rng = np.random.default_rng(1)
    eng = engine(rng.normal(size=(2000, DI)).astype(np.float32),
                 consolidate_threshold=0.2)
    try:
        eng.delete(np.arange(0, 500))
        assert eng._snapshot_n == 2000
        new = rng.normal(size=(1024, DI)).astype(np.float32)
        ids = eng.insert(new, chunk=128)

        def found_share():
            found, _ = eng.search(new)
            return (found[:, 0] == ids).reshape(8, 128).mean(1)
        before = found_share()
        release.set()
        eng.wait_background()
        after = found_share()
        assert seen == [8] and eng.stats()["consolidations"] == 1
        assert after.mean() >= before.mean() - 0.03, (before, after)
        assert after.min() >= 0.8, after
    finally:
        release.set()
        eng.close()
