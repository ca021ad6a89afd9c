"""The port's WAVP placement pass against the reference's.

Every ``CacheState`` and ``Stats`` field must match after three chained
batches for each policy; θ and ``f_recent`` are float sums whose order
may differ between XLA and PyTorch in the last bit, so those two compare
at rtol=1e-6. Host id 0 is kept out of those batches: the reference
mishandles its map entry (see the last test), and the port does not
copy that fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core.types import CacheState as JCacheState
from repro.core.types import GraphState as JGraphState
from repro.core.types import IndexState as JIndexState
from repro.core.types import SearchParams as JSearchParams
from repro.core.types import init_stats as jax_init_stats
from repro_torch.convert import index_state_from_arrays
from repro_torch.core import cache as TC
from repro_torch.core.types import SearchParams

N, M, D = 256, 32, 4
FLOAT_FIELDS = ("f_recent", "theta")


def make_state(seed, *, cached):
    """A reference IndexState whose cache holds ``cached`` host ids in
    slots 0.. (the rest empty)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    alive = rng.random(N) < 0.95
    graph = JGraphState(
        vectors=jnp.asarray(vecs),
        nbrs=jnp.full((N, 4), -1, jnp.int32),
        alive=jnp.asarray(alive),
        e_in=jnp.asarray(rng.integers(0, 12, N).astype(np.int32)),
        version=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        n=jnp.asarray(N, jnp.int32))
    slot_hid = np.full(M, -1, np.int32)
    slot_hid[:len(cached)] = cached
    h2d = np.full(N, -1, np.int32)
    h2d[cached] = np.arange(len(cached), dtype=np.int32)
    cache = JCacheState(
        vectors=jnp.asarray(np.where(slot_hid[:, None] >= 0,
                                     vecs[np.clip(slot_hid, 0, None)], 0)),
        slot_hid=jnp.asarray(slot_hid), h2d=jnp.asarray(h2d),
        ref=jnp.asarray((rng.random(M) < 0.4).astype(np.int8)),
        slot_ver=jnp.zeros(M, jnp.int32),
        f_recent=jnp.asarray(rng.integers(0, 4, N).astype(np.float32)),
        theta=jnp.float32(1.0), alpha=jnp.float32(1.0),
        beta=jnp.float32(1.0))
    return JIndexState(graph, cache, jax_init_stats()), rng


def to_port(st):
    return index_state_from_arrays(
        *({f: np.asarray(x) for f, x in part._asdict().items()}
          for part in (st.graph, st.cache, st.stats)), device="cpu")


def access_batch(rng, st, exclude_zero=True, B=8, C=48):
    """Accessed ids (-1 pad) and their hit flags against the current
    cache, as the executor would log them."""
    ids = rng.integers(-1, N, (B, C)).astype(np.int32)
    if exclude_zero:
        ids[ids == 0] = 1
    h2d = np.asarray(st.cache.h2d)
    hit = (ids >= 0) & (h2d[np.clip(ids, 0, None)] >= 0)
    return ids, hit


def assert_same(port, ref):
    for part in ("cache", "stats"):
        for f, want in getattr(ref, part)._asdict().items():
            got = getattr(getattr(port, part), f).numpy()
            want = np.asarray(want)
            if f in FLOAT_FIELDS:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=f"{part}.{f}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{part}.{f}")


@pytest.mark.parametrize("policy",
                         ["wavp", "lru", "lfu", "lrfu", "never", "always"])
def test_apply_wavp_chained_batches_match(policy):
    cached = np.random.default_rng(9).choice(np.arange(1, N), 24,
                                             replace=False).astype(np.int32)
    jst, rng = make_state(1, cached=cached)
    pst = to_port(jst)
    sp = SearchParams(max_promote=16, policy=policy, decay=0.8)
    for i in range(3):
        ids, hit = access_batch(rng, jst)
        jst = JC.apply_wavp(jst, jnp.asarray(ids), jnp.asarray(hit),
                            JSearchParams(*sp), now=i)
        pst = TC.apply_wavp(pst, torch.from_numpy(ids),
                            torch.from_numpy(hit), sp, now=i)
        assert_same(pst, jst)
    if policy != "never":
        assert int(pst.stats.promotions) > 0


def test_f_lambda_matches():
    jst, _ = make_state(2, cached=np.arange(1, 9, dtype=np.int32))
    pst = to_port(jst)
    np.testing.assert_allclose(TC.f_lambda(pst.cache, pst.graph).numpy(),
                               np.asarray(JC.f_lambda(jst.cache, jst.graph)),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        TC.f_lambda_np(np.arange(5), np.arange(5)),
        JC.f_lambda_np(np.arange(5), np.arange(5)))
    assert TC.miss_rate(pst.stats) == JC.miss_rate(jst.stats)


def bijective(slot_hid, h2d):
    occ = slot_hid >= 0
    mapped = np.where(h2d >= 0)[0]
    return (np.array_equal(h2d[slot_hid[occ]], np.where(occ)[0])
            and np.array_equal(slot_hid[h2d[mapped]], mapped))


def test_evicting_host_id_zero_keeps_the_map_bijective():
    """The reference scatters ``h2d`` from every promotion lane; lanes that
    evict nothing all write index 0 with the value they read, so after
    host id 0 is evicted its entry survives and names a slot that now
    holds another id. The port writes only the evicting and promoting
    lanes. If either side changes, this test shows it."""
    # every slot full, none protected, id 0 the coldest resident
    cached = np.arange(0, M, dtype=np.int32)
    jst, rng = make_state(3, cached=cached)
    jst = jst._replace(cache=jst.cache._replace(
        ref=jnp.zeros(M, jnp.int8),
        f_recent=jnp.zeros(N, jnp.float32).at[M:].set(50.0)),
        graph=jst.graph._replace(alive=jnp.ones(N, bool),
                                 e_in=jnp.zeros(N, jnp.int32)))
    pst = to_port(jst)
    ids = np.arange(M, M + 8, dtype=np.int32)[None].repeat(4, 0)
    hit = np.zeros(ids.shape, bool)
    sp = SearchParams(max_promote=M)
    jout = JC.apply_wavp(jst, jnp.asarray(ids), jnp.asarray(hit),
                         JSearchParams(*sp))
    pout = TC.apply_wavp(pst, torch.from_numpy(ids), torch.from_numpy(hit),
                         sp)
    j_slot, j_h2d = np.asarray(jout.cache.slot_hid), np.asarray(
        jout.cache.h2d)
    p_slot, p_h2d = pout.cache.slot_hid.numpy(), pout.cache.h2d.numpy()
    # both evicted host 0 and gave its slot to an incoming id
    assert 0 not in j_slot and 0 not in p_slot
    np.testing.assert_array_equal(p_slot, j_slot)
    # the reference keeps a stale entry for host 0: broken bijection
    assert j_h2d[0] >= 0 and j_slot[j_h2d[0]] != 0
    assert not bijective(j_slot, j_h2d)
    # the port does not
    assert p_h2d[0] == -1
    assert bijective(p_slot, p_h2d)
    mask = np.arange(N) != 0
    np.testing.assert_array_equal(p_h2d[mask], j_h2d[mask])


def test_batched_clock_matches_the_sequential_clock():
    """The reference's clock test (``tests/test_core.py``) on its own
    inputs, held against the port: the sequential clock of Algorithm 2
    (the port's ``clock_reference``) and the port's batched clock in
    ``apply_wavp`` admit a high-value newcomer into the same slot, the
    unreferenced resident of least F_λ, and leave the same occupants."""
    from repro_torch.core.clock_reference import SequentialClock
    rng = np.random.default_rng(0)
    n_slots, n_ids = 8, 64
    f_lam = rng.random(n_ids)
    residents = rng.choice(n_ids, n_slots, replace=False)
    protected = [0, 3]
    incoming = int(np.argmax(f_lam))

    seq = SequentialClock(n_slots)
    for s, rid in enumerate(residents):
        seq.occupant[s] = rid
    for s in protected:
        seq.access(s)
    slot = seq.admit(incoming, f_lam)
    assert slot not in protected
    unref = [s for s in range(n_slots) if s not in protected and s != slot]
    assert f_lam[residents[slot]] <= min(f_lam[residents[s]] for s in unref)

    # the same cache for the batched pass: LFU scores are f_recent, and
    # the newcomer's one missed access adds 1 to its own
    ref = np.zeros(n_slots, np.int8)
    ref[protected] = 1
    h2d = np.full(n_ids, -1, np.int32)
    h2d[residents] = np.arange(n_slots)
    graph = dict(vectors=np.zeros((n_ids, D), np.float32),
                 nbrs=np.full((n_ids, 4), -1, np.int32),
                 alive=np.ones(n_ids, bool), e_in=np.zeros(n_ids, np.int32),
                 version=np.zeros(n_ids, np.int32), n=np.int32(n_ids))
    cache = dict(vectors=np.zeros((n_slots, D), np.float32),
                 slot_hid=residents.astype(np.int32), h2d=h2d, ref=ref,
                 slot_ver=np.zeros(n_slots, np.int32),
                 f_recent=f_lam.astype(np.float32), theta=np.float32(1.0),
                 alpha=np.float32(1.0), beta=np.float32(1.0))
    stats = {f: np.int32(0) for f in jax_init_stats()._fields}
    st = index_state_from_arrays(graph, cache, stats, device="cpu")
    out = TC.apply_wavp(st, torch.tensor([[incoming]], dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.bool),
                        SearchParams(policy="lfu"))
    np.testing.assert_array_equal(out.cache.slot_hid.numpy(), seq.occupant)
    assert int(out.cache.h2d[incoming]) == slot
    assert int(out.cache.h2d[residents[slot]]) == -1
    assert int(out.cache.ref[slot]) == seq.ref[slot] == 1
