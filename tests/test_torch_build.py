"""The port's index build against the reference's, exactly.

Integer-valued vectors make every GEMM distance exact in both
frameworks, so the KNN rows (ties included), the reverse-edge pass (same
numpy seed, same draws), the in-degrees and the warm cache must match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as JB
from repro_torch.core import build as TB
from repro_torch.core import topk


def ints(seed, n, d, lo=-3, hi=4):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)) \
        .astype(np.float32)


def eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pairwise_l2_matches():
    a, b = ints(0, 40, 9), ints(1, 70, 9)
    eq(TB.pairwise_l2(torch.from_numpy(a), torch.from_numpy(b)),
       JB.pairwise_l2(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("force_select", [False, True],
                         ids=["sort", "threshold"])
@pytest.mark.parametrize("n,k,chunk", [(300, 8, 2048), (300, 8, 64),
                                       (6, 8, 2048)])
def test_exact_knn_matches(n, k, chunk, force_select, monkeypatch):
    """Tie-heavy rows (few distinct distances), chunked or not, and the
    n-1 < k padding case; also through the large-row top-k path."""
    if force_select:
        monkeypatch.setattr(topk, "_SORT_NUMEL", 0)
    v = ints(2, n, 6, -2, 3)
    eq(TB._exact_knn(torch.from_numpy(v), k, chunk=chunk),
       JB._exact_knn(jnp.asarray(v), k, chunk=chunk))


def test_add_reverse_edges_matches():
    """Same seed, same draws: free slots, full rows, reciprocal edges."""
    rng = np.random.default_rng(3)
    n, R = 400, 10
    nbrs = rng.integers(0, n, (n + 50, R)).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.2] = -1
    nbrs[n:] = -1
    got = TB._add_reverse_edges(nbrs.copy(), n, np.random.default_rng(7))
    want = JB._add_reverse_edges(nbrs.copy(), n, np.random.default_rng(7))
    eq(got, want)


def test_compute_e_in_matches():
    nbrs = np.random.default_rng(4).integers(-1, 90, (100, 7)) \
        .astype(np.int32)
    eq(TB.compute_e_in(torch.from_numpy(nbrs), 128),
       JB.compute_e_in(jnp.asarray(nbrs), 128))


def test_build_graph_matches():
    v = ints(5, 500, 8)
    want = JB.build_graph(v, 12, n_max=600, seed=3)
    got = TB.build_graph(v, 12, n_max=600, seed=3, device="cpu")
    for f in ("vectors", "nbrs", "alive", "e_in", "version", "n"):
        eq(getattr(got, f), getattr(want, f))


def test_build_index_warm_cache_matches():
    """Warm-up ranks log1p(in-degree), which ties everywhere: the warm
    set and its slot order follow lax.top_k's lower-index-first ties."""
    v = ints(6, 500, 8)
    want = JB.build_index(v, degree=10, cache_slots=64, n_max=512)
    got = TB.build_index(v, degree=10, cache_slots=64, n_max=512,
                         device="cpu")
    eq(got.graph.nbrs, want.graph.nbrs)
    eq(got.graph.e_in, want.graph.e_in)
    for f, x in want.cache._asdict().items():
        eq(getattr(got.cache, f), x)
    for f, x in want.stats._asdict().items():
        eq(getattr(got.stats, f), x)


def test_build_timings_and_unported_partitioned_path():
    v = ints(7, 120, 4)
    timings = {}
    g = TB.build_graph(v, 6, device="cpu", timings=timings)
    assert set(timings) == {"knn_s", "reverse_edges_s"}
    assert g.vectors.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="partitioned"):
        TB.build_graph(v, 6, n_partitions=4, device="cpu")
