"""The port's frontier executor against the reference's, exactly.

Inputs come from seeded numpy and are integer-valued where ids must
match, so fp32 distances are exact in both frameworks and every tie is
a real tie that the two must break the same way (lower index first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as JS
from repro.core.build import build_index as jax_build_index
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch.convert import index_state_from_arrays
from repro_torch.core import search as TS
from repro_torch.core import topk
from repro_torch.core.build import build_index
from repro_torch.core.types import SearchParams
from repro_torch.kernels.ops import gather_l2
from test_executor import per_hop_reference


def to_port(st):
    return index_state_from_arrays(
        *({f: np.asarray(x) for f, x in part._asdict().items()}
          for part in (st.graph, st.cache, st.stats)), device="cpu")


def jsp(sp):
    return JaxSearchParams(*sp)


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def tie_pool(rng, B=6, L=24, id_hi=40):
    """Pool state with duplicate distances, INF lanes and -1 ids."""
    ids = rng.integers(-1, id_hi, (B, L)).astype(np.int32)
    d = rng.integers(0, 5, (B, L)).astype(np.float32)
    d[rng.random((B, L)) < 0.2] = np.inf
    vis = rng.random((B, L)) < 0.3
    return ids, d, vis


@pytest.mark.parametrize("id_bound", [64, None], ids=["packed", "argsort"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dup_mask_matches(seed, id_bound):
    a = np.random.default_rng(seed).integers(-1, 6, (5, 40)).astype(np.int32)
    eq(TS.dup_mask_jnp(torch.from_numpy(a), id_bound),
       JS.dup_mask_jnp(jnp.asarray(a), id_bound))
    eq(TS.dup_mask_jnp(torch.from_numpy(a.reshape(5, 2, 20)), id_bound),
       JS.dup_mask_jnp(jnp.asarray(a.reshape(5, 2, 20)), id_bound))


@pytest.mark.parametrize("beam", [1, 4, 24])
def test_select_frontier_matches(beam):
    ids, d, vis = tie_pool(np.random.default_rng(beam))
    got = TS.select_frontier(torch.from_numpy(ids), torch.from_numpy(d),
                             torch.from_numpy(vis), beam)
    want = JS.select_frontier(jnp.asarray(ids), jnp.asarray(d),
                              jnp.asarray(vis), beam)
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("id_bound", [64, None], ids=["packed", "fallback"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_round_matches(seed, id_bound):
    """Both merge paths, on tie-heavy pools and candidate batches with
    repeated ids, ids already pooled, -1 lanes and INF lanes. The packed
    path keeps the reference's id-sorted selection order."""
    rng = np.random.default_rng(seed)
    pool_ids, pool_d, vis = tie_pool(rng, L=16)
    cand = rng.integers(-1, 40, (6, 48)).astype(np.int32)
    cand[:, :8] = pool_ids[:, :8]                  # already pooled
    cand_d = rng.integers(0, 5, (6, 48)).astype(np.float32)
    cand_d[cand < 0] = np.inf
    assert TS._packable(id_bound, 16 + 48) == (id_bound is not None)
    got = TS.merge_round(*map(torch.from_numpy,
                              (pool_ids, pool_d, vis, cand, cand_d)),
                         id_bound)
    want = JS.merge_round(*map(jnp.asarray,
                               (pool_ids, pool_d, vis, cand, cand_d)),
                          id_bound)
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("id_bound", [64, None])
def test_init_pool_matches(id_bound):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 30, (4, 32)).astype(np.int32)
    d = rng.integers(0, 6, (4, 32)).astype(np.float32)
    got = TS.init_pool(torch.from_numpy(ids), torch.from_numpy(d), id_bound)
    want = JS.init_pool(jnp.asarray(ids), jnp.asarray(d), id_bound)
    for g, w in zip(got, want):
        eq(g, w)


def test_packed_keys_hold_the_main_path_capacity():
    """Capacity 2^20 at pool 64 + beam 16 x degree 32 = 576 lanes packs
    (10 lane bits: ids below 2^21); one more capacity bit does not."""
    assert TS._lane_bits(64 + 16 * 32) == 10
    assert TS._packable(1 << 20, 576)
    assert not TS._packable(1 << 21, 576)
    a = torch.tensor([[(1 << 20) - 1, -1, 5, (1 << 20) - 1]],
                     dtype=torch.int32)
    np.testing.assert_array_equal(TS.dup_mask_jnp(a, 1 << 20).numpy(),
                                  [[False, False, False, True]])


@pytest.fixture(scope="module")
def int_index():
    """A small integer-valued index built by the reference (warm cache,
    so the overlay path carries real hits) and its port copy."""
    rng = np.random.default_rng(11)
    n, d = 700, 12
    vecs = rng.integers(-6, 7, (n, d)).astype(np.float32)
    st = jax_build_index(vecs, degree=8, cache_slots=96, n_max=1024)
    queries = rng.integers(-6, 7, (10, d)).astype(np.float32)
    return st, to_port(st), queries, rng


@pytest.mark.parametrize("sp", [
    SearchParams(k=10, pool=32, max_iters=32, beam=4),
    SearchParams(k=5, pool=16, max_iters=24, beam=1),
    SearchParams(k=10, pool=24, max_iters=40, beam=16),
], ids=["beam4", "beam1", "beam16"])
def test_frontier_search_matches_reference(int_index, sp):
    st, pst, queries, rng = int_index
    entries = rng.integers(0, 700, (len(queries), sp.pool)).astype(np.int32)
    entries[0, :3] = -1                            # padded entry lanes
    want = JS.frontier_search(st, jnp.asarray(queries), jnp.asarray(entries),
                              jsp(sp))
    got = TS.frontier_search(pst, torch.from_numpy(queries),
                             torch.from_numpy(entries), sp)
    for f in ("ids", "dists", "acc_ids", "acc_hit", "iters"):
        eq(getattr(got, f), getattr(want, f))
    assert np.asarray(want.acc_hit).any()          # the overlay was used
    rounds = int(got.iters.max())
    assert rounds <= got.host_syncs <= rounds + 1


def test_device_executor_matches_per_hop_reference():
    """beam=1: one expansion per round is the classic greedy search."""
    rng = np.random.default_rng(3)
    n = 150
    vecs = rng.normal(size=(n, 12)).astype(np.float32)
    queries = rng.normal(size=(4, 12)).astype(np.float32)
    sp = SearchParams(k=5, pool=16, max_iters=24, beam=1)
    entries = rng.integers(0, n, (4, sp.pool))
    st = build_index(vecs, degree=6, cache_slots=16, n_max=n, warm=False,
                     device="cpu")
    q = torch.from_numpy(queries)

    def dist_fn(ids):
        return gather_l2(st.graph.vectors,
                         torch.from_numpy(np.asarray(ids, np.int32)),
                         q).numpy()

    want = per_hop_reference(st.graph.nbrs.numpy(), st.graph.alive.numpy(),
                             queries, entries, sp, dist_fn)
    got = TS.frontier_search(st, q, torch.from_numpy(entries), sp)
    np.testing.assert_array_equal(got.ids.numpy(), want)


def test_search_batch_draws_entries_from_generator(int_index):
    _, pst, queries, _ = int_index
    sp = SearchParams(k=10, pool=32, max_iters=32, beam=4)
    q = torch.from_numpy(queries)
    a = TS.search_batch(pst, q, torch.Generator().manual_seed(4), sp)
    entries = torch.randint(0, 700, (len(queries), sp.pool),
                            generator=torch.Generator().manual_seed(4),
                            dtype=torch.int32)
    b = TS.frontier_search(pst, q, entries, sp)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.acc_ids, b.acc_ids)
    assert a.host_syncs == b.host_syncs + 1


def test_brute_force_and_recall_match(int_index):
    st, pst, queries, _ = int_index
    want_ids, want_d = JS.brute_force_topk(st.graph, jnp.asarray(queries), 10)
    got_ids, got_d = TS.brute_force_topk(pst.graph, torch.from_numpy(queries),
                                         10)
    eq(got_ids, want_ids)
    eq(got_d, want_d)
    found = np.asarray(want_ids).copy()
    found[:, ::3] = -1
    assert float(TS.recall_at_k(torch.from_numpy(found), got_ids)) == \
        pytest.approx(float(JS.recall_at_k(jnp.asarray(found), want_ids)))


def test_dedup_mask_and_rerank_depth_match():
    a = np.random.default_rng(2).integers(-1, 5, (4, 30))
    np.testing.assert_array_equal(TS.dedup_mask(a), JS.dedup_mask(a))
    for depth in (-1, 0, 3, 10, 40, 100):
        assert TS.effective_rerank_depth(depth, 10, 64) == \
            JS.effective_rerank_depth(depth, 10, 64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_threshold_path_matches_lax_top_k(seed, monkeypatch):
    """The large-row path (k-th value, then lowest-index ties) picks what
    lax.top_k picks, on rows with many ties at the k-th value."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, (7, 300)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.inf
    monkeypatch.setattr(topk, "_SORT_NUMEL", 0)
    for k in (1, 9, 64):
        v, i = topk.smallest_k(torch.from_numpy(x), k)
        wv, wi = jax.lax.top_k(-jnp.asarray(x), k)
        eq(i, wi)
        eq(v, -wv)
        v, i = topk.largest_k(torch.from_numpy(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        eq(i, wi)
        eq(v, wv)
