"""The port's baselines against the reference's, exactly.

``HNSW`` and ``Vamana`` are host numpy in both packages: the same script
of inserts, deletes (Vamana's consolidation included) and searches must
give the same answers, the same internal state and the same random
stream. ``CagraStatic`` runs the port's build and search on the CPU; the
reference draws its entry points from a ``jax.random`` key chain, so the
port is given the same draws through ``search(entries=)``. Integer-valued
vectors keep every distance exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import baselines as JB
from repro_torch.core import baselines as TB

D = 8


def ints(rng, n, lo=-4, hi=5):
    return rng.integers(lo, hi, (n, D)).astype(np.float32)


def _same_hnsw(a, b):
    np.testing.assert_array_equal(a.vecs, b.vecs)
    assert a.levels == b.levels and a.links == b.links
    assert a.alive == b.alive
    assert (a.entry, a.max_level) == (b.entry, b.max_level)
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


def _same_vamana(a, b):
    np.testing.assert_array_equal(a.vecs, b.vecs)
    assert len(a.nbrs) == len(b.nbrs)
    for x, y in zip(a.nbrs, b.nbrs):
        np.testing.assert_array_equal(x, y)
    assert a.alive == b.alive and a.n_deleted == b.n_deleted
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


@pytest.mark.parametrize("name", ["HNSW", "Vamana"])
def test_host_baselines_match_the_reference(name):
    rng = np.random.default_rng(1)
    if name == "HNSW":
        kw, same = dict(M=6, ef_construction=24, ef_search=24, seed=2), \
            _same_hnsw
    else:
        kw, same = dict(R=8, L=20, seed=2), _same_vamana
    ref, port = getattr(JB, name)(D, **kw), getattr(TB, name)(D, **kw)
    q = ints(rng, 12)
    for step in range(3):
        x = ints(rng, 60)
        np.testing.assert_array_equal(port.insert(x), ref.insert(x))
        dead = rng.choice(60 * (step + 1), 15, replace=False)
        ref.delete(dead)
        port.delete(dead)
        same(ref, port)
        np.testing.assert_array_equal(port.search(q, k=5),
                                      ref.search(q, k=5))
    same(ref, port)
    if name == "Vamana":             # 45 of 180 deleted: consolidated
        assert ref.n_deleted < 45
        port.consolidate()
        ref.consolidate()
        same(ref, port)


def test_cagra_static_matches_the_reference_on_its_entry_draws():
    rng = np.random.default_rng(4)
    kw = dict(degree=8, rebuild_every=64, seed=5)
    ref, port = JB.CagraStatic(D, **kw), TB.CagraStatic(D, device="cpu",
                                                         **kw)
    key = jax.random.PRNGKey(5)            # the reference's key chain

    def search(q):
        nonlocal key
        want = ref.search(q)
        if ref.state is None:
            entries = None
        else:
            key, sub = jax.random.split(key)
            entries = np.asarray(jax.random.randint(
                sub, (len(q), ref.sp.pool), 0,
                max(int(ref.state.graph.n), 1), dtype=jnp.int32))
        got = port.search(q, entries=entries)
        np.testing.assert_array_equal(got, want)
        return got

    q = ints(rng, 16)
    assert (search(q) == -1).all()                 # nothing built yet
    for rows, dead in ((200, 30), (30, 10), (40, 0), (5, 20)):
        x = ints(rng, rows)
        np.testing.assert_array_equal(port.insert(x), ref.insert(x))
        ids = rng.choice(len(ref.data), dead, replace=False)
        ref.delete(ids)
        port.delete(ids)
        got = search(q)
        assert not np.isin(got, list(port.deleted)).any()
        assert port.rebuilds == ref.rebuilds
        np.testing.assert_array_equal(port.data, ref.data)
        np.testing.assert_array_equal(port.pending, ref.pending)
        assert port.deleted == ref.deleted
    assert port.rebuilds == 2                      # 200, then 30 + 40
