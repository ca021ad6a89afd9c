"""The port's partitioned build (``build_graph(n_partitions > 1)``) against
the reference's, exactly.

Integer-valued vectors make every distance exact in both frameworks, so
the per-partition KNN rows, the sampled cross columns (the same numpy
draws), the merge and its dedup, the rank-based pruning and the reverse
edges must give the same graph. The merge runs in row chunks; no chunk
size may change an id.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as JB
from repro.core import engine as JE
from repro.core.search import _frontier_search as jax_frontier_search
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch.core import build as TB
from repro_torch.core import engine as TE
from repro_torch.core.search import frontier_search
from repro_torch.core.types import SearchParams


def ints(seed, n, d, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)) \
        .astype(np.float32)


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


CASES = {   # n, d, degree, partitions, cross_samples, reverse_edges
    "p3_cross_below_n": (300, 8, 12, 3, 64, True),
    "p2_cross_above_n_no_reverse": (200, 6, 8, 2, 500, False),
    "p4_partitions_below_degree": (40, 4, 16, 4, 32, True),
    "p4_two_row_partitions": (9, 4, 8, 4, 5, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_graph_matches_the_reference(case):
    n, d, R, P, cs, rev = CASES[case]
    v = ints(n, n, d)
    kw = dict(n_max=n + 10, n_partitions=P, cross_samples=cs, seed=3,
              reverse_edges=rev)
    want = JB.build_graph(v, R, **kw)
    timings = {}
    got = TB.build_graph(v, R, device="cpu", timings=timings, **kw)
    for f in ("vectors", "nbrs", "alive", "e_in", "version", "n"):
        eq(getattr(got, f), getattr(want, f))
    assert set(timings) == {"knn_s", "merge_s", "reverse_edges_s"}


def test_an_empty_partition_fails_in_both_packages():
    v = ints(0, 3, 4)
    with pytest.raises(ValueError):
        JB.build_graph(v, 4, n_partitions=4)
    with pytest.raises(ValueError, match="empty partition"):
        TB.build_graph(v, 4, n_partitions=4, device="cpu")


@pytest.mark.parametrize("data", ["integer", "normal"])
def test_chunked_merge_changes_no_id(data, monkeypatch):
    """Every merge step is per row, so any chunk gives the one-chunk
    graph, on integer data and on real-valued data alike."""
    rng = np.random.default_rng(8)
    v = (ints(8, 500, 6) if data == "integer"
         else rng.normal(size=(500, 6)).astype(np.float32))
    kw = dict(n_partitions=3, cross_samples=100, seed=1, device="cpu")
    monkeypatch.setattr(TB, "MERGE_CHUNK", 10_000)
    whole = TB.build_graph(v, 10, **kw)
    for chunk in (1, 7, 64, 167):
        monkeypatch.setattr(TB, "MERGE_CHUNK", chunk)
        g = TB.build_graph(v, 10, **kw)
        eq(g.nbrs, whole.nbrs)
        eq(g.e_in, whole.e_in)


def test_tiered_engine_partitioned_build_matches_the_reference(tmp_path):
    """A three-tier engine with ``build_partitions=2``: the disk tier's
    rows, the in-degrees and the answers equal the reference engine's."""
    rng = np.random.default_rng(5)
    vecs = rng.integers(-6, 7, (300, 12)).astype(np.float32)
    q = rng.integers(-6, 7, (10, 12)).astype(np.float32)
    kw = dict(degree=8, cache_slots=32, capacity=512, disk_capacity=512,
              host_window=80, seed=4, coalesce=False, prefetch=False,
              spec_rank="flam", build_partitions=2, build_cross_samples=48)
    je = JE.SVFusionEngine(vecs, JE.EngineConfig(
        disk_path=str(tmp_path / "j"),
        search=JaxSearchParams(k=6, pool=24, max_iters=32), **kw))
    te = TE.SVFusionEngine(vecs, TE.EngineConfig(
        disk_path=str(tmp_path / "t"),
        search=SearchParams(k=6, pool=24, max_iters=32), device="cpu", **kw))
    try:
        jb, tb = je._backend, te._backend
        eq(tb.store.disk.nbr[:300], jb.store.disk.nbr[:300])
        eq(tb.e_in, jb.e_in)
        single = JB.build_graph(vecs, 8, seed=4)
        assert not np.array_equal(np.asarray(single.nbrs),
                                  jb.store.disk.nbr[:300])
        a, b = je.search(q), te.search(q)
        eq(b[0], a[0])
        eq(b[1], a[1])
    finally:
        je.close()
        te.close()


def test_device_engine_partitioned_build_matches_the_reference_build():
    """A device-mode engine with ``build_partitions=2`` holds the
    reference's partitioned ``build_index``. The reference's device-mode
    engine drops the knob and builds one partition (ROADMAP C): this
    test shows that too."""
    rng = np.random.default_rng(6)
    vecs = rng.integers(-6, 7, (300, 12)).astype(np.float32)
    kw = dict(degree=8, cache_slots=32, capacity=512, build_partitions=2,
              build_cross_samples=48, coalesce=False)
    te = TE.SVFusionEngine(vecs, TE.EngineConfig(
        search=SearchParams(k=6, pool=24, max_iters=32), device="cpu", **kw))
    je = JE.SVFusionEngine(vecs, JE.EngineConfig(
        search=JaxSearchParams(k=6, pool=24, max_iters=32), **kw))
    try:
        want = JB.build_index(vecs, degree=8, cache_slots=32, n_max=512,
                              n_partitions=2, cross_samples=48)
        got = te.state
        for f in ("nbrs", "e_in", "alive", "n"):
            eq(getattr(got.graph, f), getattr(want.graph, f))
        for f, x in want.cache._asdict().items():
            eq(getattr(got.cache, f), x)
        # the reference engine built one partition instead
        single = JB.build_index(vecs, degree=8, cache_slots=32, n_max=512)
        eq(je.state.graph.nbrs, single.graph.nbrs)
        assert not np.array_equal(np.asarray(single.graph.nbrs),
                                  np.asarray(want.graph.nbrs))
        # and the engine's index answers as the reference's does
        q = rng.integers(-6, 7, (8, 12)).astype(np.float32)
        entries = rng.integers(0, 300, (8, 24)).astype(np.int32)
        sp = dict(k=6, pool=24, max_iters=32)
        a = jax_frontier_search(want.graph, want.cache, jnp.asarray(q),
                                jnp.asarray(entries), JaxSearchParams(**sp))
        b = frontier_search(got, torch.from_numpy(q),
                            torch.from_numpy(entries), SearchParams(**sp))
        eq(b.ids, a.ids)
        eq(b.dists, a.dists)
    finally:
        je.close()
        te.close()
