"""The port's index build against the reference's, exactly.

Integer-valued vectors make every GEMM distance exact in both
frameworks, so the KNN rows (ties included), the reverse-edge pass (same
numpy seed, same draws), the in-degrees and the warm cache must match.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as JB
from repro_torch.core import build as TB
from repro_torch.core import topk
from repro_torch.kernels import _build

SRC = Path(__file__).resolve().parents[1] / "src"


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


def reverse_edge_table(seed, n, rows, R, p_free):
    """[rows, R] int32: the first n rows hold ids below n with a share
    ``p_free`` of free (-1) slots, the rows past n are free."""
    rng = np.random.default_rng(seed)
    nbrs = np.full((rows, R), -1, np.int32)
    if n:
        nbrs[:n] = rng.integers(0, n, (n, R))
        nbrs[:n][rng.random((n, R)) < p_free] = -1
    return nbrs


@pytest.mark.parametrize("n,rows,R,p_free", [
    (400, 450, 10, 0.2),       # free slots and rows past n
    (2000, 2000, 32, 0.05),    # the cells' out-degree
    (2000, 2000, 7, 0.1),      # an odd R
    (3000, 3000, 32, 0.0),     # no free slot: every add takes the draw
    (300, 1000, 12, 0.0),      # n well below the table's rows
    (500, 500, 1, 0.0),        # R = 1: numpy draws no slot
    (0, 64, 8, 0.0),           # an empty graph
    (100, 100, 8, 1.0),        # rows without edges
], ids=["400x10", "R32", "R7_odd", "no_free_slot", "n_below_rows", "R1",
        "empty", "no_edges"])
def test_add_reverse_edges_matches(n, rows, R, p_free):
    """Same seed, same draws: the table and the generator's state after
    the pass (so its next draw) are the reference's."""
    nbrs = reverse_edge_table(3, n, rows, R, p_free)
    g_rng, w_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = TB._add_reverse_edges(nbrs.copy(), n, g_rng)
    want = JB._add_reverse_edges(nbrs.copy(), n, w_rng)
    eq(got, want)
    assert g_rng.bit_generator.state == w_rng.bit_generator.state
    assert g_rng.random() == w_rng.random()
    assert g_rng.integers(R or 1) == w_rng.integers(R or 1)


@pytest.mark.parametrize("table,n", [
    (np.full((50, 8), -1, np.int64), 50),                 # not int32
    (np.full((50, 16), -1, np.int32)[:, ::2], 50),        # strided
    (np.asfortranarray(np.full((50, 8), -1, np.int32)), 50),
    (np.full(400, -1, np.int32), 50),                     # not 2-D
    (np.full((50, 8), -1, np.int32), 51),                 # n past rows
    (np.full((50, 8), -1, np.int32), -1),
], ids=["int64", "strided", "fortran", "flat", "n_past_rows", "n_negative"])
def test_add_reverse_edges_refuses_bad_tables(table, n):
    """The compiled pass takes a raw pointer: what it cannot walk safely
    is refused before the call, and the generator is left untouched."""
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    with pytest.raises(ValueError, match="_add_reverse_edges"):
        TB._add_reverse_edges(table, n, rng)
    assert rng.bit_generator.state == state


def test_add_reverse_edges_refuses_ids_past_the_table():
    nbrs = np.full((10, 4), -1, np.int32)
    nbrs[3, 2] = 10
    with pytest.raises(IndexError, match="row 3 holds id 10"):
        TB._add_reverse_edges(nbrs, 10, np.random.default_rng(0))


def test_reverse_edges_without_a_compiler_raises(tmp_path, monkeypatch):
    """No fallback: with no library built and no C++ compiler the pass
    raises, as a kernel does without nvcc."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(TB, "_reverse_edges_c", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        TB._add_reverse_edges(np.full((4, 2), -1, np.int32), 4,
                              np.random.default_rng(0))
    assert not any(tmp_path.iterdir())


def test_importing_build_builds_nothing():
    """The host loop builds on the first pass, never at import: an import
    with no compiler on the PATH loads no library."""
    code = ("from repro_torch.core import build; "
            "from repro_torch.kernels import _build; "
            "assert not _build._libs and build._reverse_edges_c is None; "
            "assert set(_build.HOST_SOURCES) == {'reverse_edges'}; "
            "assert not set(_build.HOST_SOURCES) & set(_build.SOURCES); "
            "assert all((_build.KERNELS_DIR.parent / f).exists() "
            "for fs in _build.HOST_SOURCES.values() for f in fs)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(SRC), "PATH": "/nonexistent"})


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
    """Both paths report their timings; the partitioned path, once
    unported, now builds the reference's graph
    (``test_torch_build_partitioned.py`` holds it case by case)."""
    v = ints(7, 120, 4)
    timings = {}
    g = TB.build_graph(v, 6, device="cpu", timings=timings)
    assert set(timings) == {"knn_s", "merge_s", "reverse_edges_s"}
    assert timings["merge_s"] == 0.0
    assert g.vectors.device.type == "cpu"
    timings = {}
    g = TB.build_graph(v, 6, n_partitions=4, device="cpu", timings=timings)
    assert set(timings) == {"knn_s", "merge_s", "reverse_edges_s"}
    eq(g.nbrs, JB.build_graph(v, 6, n_partitions=4).nbrs)
