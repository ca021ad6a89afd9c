"""The port's three-tier path against the reference: the row_gather
plain version, ``search_tiered`` field by field (exact and PQ lanes,
speculation forced both ways, topology residency forced to 100% and 0%,
K-round budgets), the disk tier, host window and host placement pass,
and the three-tier engine. Integer-valued data and integer-rounded
codebooks make every fp32 distance exact in both packages."""
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core import engine as JE
from repro.core import quant as JQ
from repro.core import tiers as JT
from repro.core.build import build_tiered_backend as jax_build_tiered
from repro.core.search import search_tiered as jax_search_tiered
from repro.core.types import SearchParams as JaxSearchParams
from repro.kernels.row_gather.ref import row_gather_ref as row_gather_jax
from repro_torch import convert
from repro_torch.core import cache as TC
from repro_torch.core import engine as TE
from repro_torch.core import tiers as TT
from repro_torch.core.build import build_tiered_backend
from repro_torch.core.search import brute_force_topk, recall_at_k
from repro_torch.core.search import search_tiered
from repro_torch.core.types import GraphState, SearchParams
from repro_torch.kernels.ops import gather_rows
from repro_torch.kernels.row_gather import kernel as RK

D, DEG, N = 12, 8, 240
SP = SearchParams(k=5, pool=16, max_iters=24, beam=2)


@pytest.mark.parametrize("S,R,n,B,W", [
    (64, 8, 200, 2, 4), (16, 16, 64, 3, 8), (128, 4, 500, 1, 16),
])
def test_row_gather_plain_matches_reference(S, R, n, B, W):
    """Idle (-1) lanes and non-resident ids both come back as -1 rows."""
    rng = np.random.default_rng(S + R)
    table = rng.integers(-1, n, (S, R)).astype(np.int32)
    h2s = np.full((n,), -1, np.int32)
    h2s[rng.permutation(n)[:S]] = np.arange(S)
    ids = rng.integers(0, n, (B, W)).astype(np.int32)
    ids[rng.random((B, W)) < 0.3] = -1
    got = gather_rows(*map(torch.from_numpy, (table, h2s, ids))).numpy()
    want = np.asarray(row_gather_jax(*map(jnp.asarray, (table, h2s, ids))))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    bad = (ids < 0) | (h2s[np.clip(ids, 0, None)] < 0)
    assert (got[bad] == -1).all()
    ok = ~bad
    np.testing.assert_array_equal(got[ok], table[h2s[ids[ok]]])


def test_row_gather_wrapper_refuses_cpu_tensors():
    z = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        RK.row_gather(z, torch.zeros(8, dtype=torch.int32), z)
    assert RK.launches == 0


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """One integer-valued index built by the reference, opened by the
    port from the reference's memmaps, with identical host placements and
    a PQ lane on the reference's codebook rounded to integers."""
    rng = np.random.default_rng(7)
    vecs = rng.integers(-6, 7, (N, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("tier"))
    be = jax_build_tiered(vecs, DEG, path, disk_capacity=4 * N,
                          host_window=60)
    tbe = convert.tiered_backend_from_arrays(
        path, capacity=be.capacity, dim=D, degree=DEG, n=be.n,
        alive=be.alive, e_in=be.e_in, version=be.version, host_window=60)
    hp = JC.HostPlacement(be.capacity, 48, D)
    thp = TC.HostPlacement(be.capacity, 48, D)
    hot = np.argsort(-be.e_in[:N], kind="stable")[:48]
    for p in (hp, thp):
        p.warm(hot, vecs[hot])
    cb = JQ.train_codebook(vecs, m=4, bits=6, iters=5, seed=1)
    cents = np.round(JQ.codebook_to_array(cb))
    codes = JQ.encode(JQ.codebook_from_array(cents), vecs)
    jpq = JQ.PQCodes(JQ.codebook_from_array(cents), be.capacity, codes=codes)
    tpq = convert.pq_codes_from_arrays(cents, codes, be.capacity, "cpu")
    queries = rng.integers(-6, 7, (6, D)).astype(np.float32)
    entries = rng.integers(0, N, (6, SP.pool))
    yield dict(vecs=vecs, be=be, tbe=tbe, hp=hp, thp=thp, jpq=jpq, tpq=tpq,
               queries=queries, entries=entries, path=path)
    be.close()
    tbe.close()


def _predict_all(ids, valid, f_lam, width, d_host=None):
    return np.where(valid, ids, -1)          # forced 0% misprediction


def _predict_none(ids, valid, f_lam, width, d_host=None):
    return np.full((ids.shape[0], 1), -1, np.int64)   # forced 100%


def _both(ix, jax=None, port=None, **kw):
    """(reference result, port result) on the shared index; ``jax`` and
    ``port`` hold the arguments that differ between the two."""
    want = jax_search_tiered(ix["be"], ix["hp"], ix["queries"], 0,
                             JaxSearchParams(*SP), entry_ids=ix["entries"],
                             **(jax or {}), **kw)
    got = search_tiered(ix["tbe"], ix["thp"], ix["queries"], 0, SP,
                        entry_ids=ix["entries"], device="cpu",
                        **(port or {}), **kw)
    return want, got


def _same(want, got):
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("spec", ["off", "flam", "dist", "forced-hit",
                                  "forced-miss"])
def test_exact_lane_matches_reference(index, spec):
    kw = {"off": dict(speculate=False), "flam": {},
          "dist": dict(spec_rank="dist"),
          "forced-hit": dict(spec_predict=_predict_all),
          "forced-miss": dict(spec_predict=_predict_none)}[spec]
    want, got = _both(index, **kw)
    _same(want, got)
    assert got.acc_hit.any() and got.dispatches == got.iters + 1
    if spec == "forced-hit":
        assert got.spec_misses == 0 < got.spec_hits
    if spec == "forced-miss":   # hits here are cross-query memo reuse
        assert got.spec_misses > 0


def _topo(mod, be, kind, **kw):
    if kind == "none":
        return None
    if kind == "zero":                        # forced 0% hit rate
        return mod.TopoCache(be.capacity, 0, DEG, **kw)
    if kind == "demand":                      # filled on demand from cold
        return mod.TopoCache(be.capacity, 64, DEG, **kw)
    topo = mod.TopoCache(be.capacity, be.capacity, DEG, **kw)  # 100%
    topo.validate(be.store)
    live = np.flatnonzero(be.alive[:be.n])
    topo.install(live, be.store.peek_rows(live))
    return topo


@pytest.mark.parametrize("speculate", [False, True], ids=["nospec", "spec"])
@pytest.mark.parametrize("kind,K", [("none", 0)] + [
    (kind, K) for kind in ("warm", "zero", "demand") for K in (1, 2, 4, 0)])
def test_pq_lane_matches_reference(index, kind, K, speculate):
    """Per-round (no topology cache) and fused executors, topology hit
    rate forced to 100% (warm) and 0% (zero slots) or filled on demand,
    K-round budgets 1, 2, 4 and uncapped (0)."""
    want, got = _both(
        index, speculate=speculate, rerank_depth=SP.pool,
        fused_rounds=K,
        jax=dict(pq=index["jpq"], topo=_topo(JC, index["be"], kind)),
        port=dict(pq=index["tpq"],
                  topo=_topo(TC, index["be"], kind, device="cpu")))
    _same(want, got)
    if kind == "warm":
        assert got.topo_hit_rate == 1.0
        if K == 0:
            assert got.dispatches == 3       # entry + fused loop + re-rank
    if kind == "zero":
        assert got.topo_hits == 0 < got.topo_misses


def test_build_tiered_backend_matches_reference(index, tmp_path):
    ix = index
    tbe = build_tiered_backend(ix["vecs"], DEG, str(tmp_path),
                               disk_capacity=4 * N, host_window=60,
                               device="cpu")
    try:
        be = ix["be"]
        for f in ("n", "capacity", "dim", "degree"):
            assert getattr(tbe, f) == getattr(be, f)
        for f in ("alive", "e_in", "version"):
            np.testing.assert_array_equal(getattr(tbe, f), getattr(be, f))
        for f in ("vec", "nbr"):
            np.testing.assert_array_equal(getattr(tbe.store.disk, f),
                                          getattr(be.store.disk, f))
        assert tbe.store.host_slots == be.store.host_slots
    finally:
        tbe.close()


def test_disk_tier_opens_reference_memmaps(tmp_path):
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(50, 6)).astype(np.float32)
    nbrs = rng.integers(-1, 50, (50, 4)).astype(np.int32)
    ref = JT.DiskTier(str(tmp_path), 64, 6, 4)
    ref.write(np.arange(50), vecs, nbrs)
    ref.flush()
    port = TT.DiskTier(str(tmp_path), 64, 6, 4, create=False)
    v, r = port.read(np.array([0, 49, 50, 7]))
    np.testing.assert_array_equal(v[[0, 1, 3]], vecs[[0, 49, 7]])
    np.testing.assert_array_equal(r[[0, 1, 3]], nbrs[[0, 49, 7]])
    assert (r[2] == -1).all() and (v[2] == 0).all()
    port.write(np.array([50]), vecs[:1], nbrs[:1])   # and back
    port.flush()
    np.testing.assert_array_equal(ref.read(np.array([50]))[0], vecs[:1])


def test_tiered_store_fetch_promote_demote_match_reference(tmp_path):
    """The same fetch / write / peek sequence leaves both host windows,
    residency directories and counters identical, demotions by F_λ."""
    n, dim = 128, 8
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n, dim)).astype(np.float32)
    rows = rng.integers(-1, n, (n, 4)).astype(np.int32)
    stores = []
    for mod, sub in ((JT, "j"), (TT, "t")):
        disk = mod.DiskTier(str(tmp_path / sub), n, dim, 4)
        disk.write(np.arange(n), data, rows)
        stores.append(mod.TieredStore(disk, host_slots=16))
    f_lam = JC.f_lambda_np(np.zeros(n), np.arange(n))
    for s in stores:
        s.fetch(np.arange(16), f_lam)
        s.fetch(np.arange(100, 108), f_lam)          # demotes ids 0..7
        s.fetch_rows(np.array([3, 40, 41, 120]), f_lam)
        s.write(np.array([9, 60]), np.full((2, dim), 7.0, np.float32))
        s.peek(np.arange(40, 60))
        s.fetch(np.arange(50, 90)[::-1], f_lam)
    j, t = stores
    for f in ("loc", "slot_id", "host_vec", "host_nbr"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ("hits", "misses", "demotions", "write_epoch", "resident"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.loc[:8] == -1).all() and t.demotions > 8


@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cascade", [True, False])
def test_apply_wavp_host_matches_reference(cache_dtype, cascade):
    """Warm-up and several placement passes leave identical mirrors,
    counters and θ, and the bf16 payload's bits equal the reference's
    (both round to nearest even)."""
    rng = np.random.default_rng(1)
    n, dim, slots = 400, 10, 32
    vecs = rng.normal(size=(n, dim)).astype(np.float32) * 3
    e_in = rng.integers(0, 20, n).astype(np.int32)
    alive = rng.random(n) < 0.95
    jdt = jnp.bfloat16 if cache_dtype == "bf16" else np.float32
    tdt = torch.bfloat16 if cache_dtype == "bf16" else torch.float32
    hp = JC.HostPlacement(n, slots, dim, dtype=jdt)
    thp = TC.HostPlacement(n, slots, dim, dtype=tdt)
    hot = np.argsort(-e_in)[:slots]
    hp.warm(hot, vecs[hot])
    thp.warm(hot, vecs[hot])
    sp = SearchParams(max_promote=12)
    for i in range(4):
        acc = rng.integers(-1, n, (6, 50))
        hit = (hp.h2d[np.clip(acc, 0, None)] >= 0) & (acc >= 0)
        for p, mod in ((hp, JC), (thp, TC)):
            mod.apply_wavp_host(p, acc, hit, sp, alive=alive, e_in=e_in,
                                fetch_vectors=lambda ids: vecs[ids], now=i,
                                cascade_promote=cascade)
        bits = thp.vectors.view(torch.int16).numpy().view(np.uint16) \
            if cache_dtype == "bf16" else thp.vectors.numpy()
        want = np.asarray(hp.vectors).view(np.uint16) \
            if cache_dtype == "bf16" else hp.vectors
        np.testing.assert_array_equal(bits, want)
        for f in ("slot_hid", "h2d", "ref", "slot_ver", "f_recent"):
            np.testing.assert_array_equal(getattr(thp, f), getattr(hp, f))
        assert thp.counters == hp.counters and thp.theta == hp.theta
        assert thp.view.h2d is thp.h2d and thp.view.vectors is thp.vectors
    assert hp.counters["promotions"] > 0
    assert thp.vector_bytes == np.asarray(hp.vectors).nbytes
    np.testing.assert_array_equal(
        TC.payload_rows(thp.vectors, [0, 5]),
        np.asarray(hp.vectors[[0, 5]], np.float32))


def _engine_kw(tmp, tag, **kw):
    return dict(degree=16, cache_slots=128, capacity=4096,
                disk_path=str(tmp / tag), disk_capacity=4096,
                host_window=375, seed=3, wal_enabled=False, **kw)


def test_three_tier_engine_matches_reference_engine(tmp_path):
    """Exact lane, coalescing and prefetch off, same data and seed: the
    same ids and distances request after request, the same placement
    counters and host-window counts, and the reference's stats keys."""
    rng = np.random.default_rng(0)
    vecs = rng.integers(-6, 7, (1500, 16)).astype(np.float32)
    q = rng.integers(-6, 7, (21, 16)).astype(np.float32)
    kw = dict(coalesce=False, prefetch=False, spec_rank="flam")
    je = JE.SVFusionEngine(vecs, JE.EngineConfig(
        search=JaxSearchParams(k=10, pool=32, max_iters=48),
        **_engine_kw(tmp_path, "j", **kw)))
    te = TE.SVFusionEngine(vecs, TE.EngineConfig(
        search=SearchParams(k=10, pool=32, max_iters=48), device="cpu",
        **_engine_kw(tmp_path, "t", **kw)))
    try:
        for s in (slice(0, 5), slice(5, 12), slice(12, 21)):
            a, b = je.search(q[s]), te.search(q[s])
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
        sj, st = je.stats(), te.stats()
        assert set(st) == set(sj) - {"modeled_us_per_access"}
        for k in ("accesses", "hits", "misses", "promotions", "evictions",
                  "transfers", "cpu_computed", "host_hits", "disk_reads",
                  "demotions", "host_resident", "spec_hits", "spec_misses",
                  "search_dispatches_per_batch", "n", "alive",
                  "bytes_per_tier", "spec_rank_resolved"):
            assert st[k] == sj[k], k
        assert st["promotions"] > 0
        cs = te.state.cache
        np.testing.assert_array_equal(cs.h2d.numpy(),
                                      np.asarray(je.state.cache.h2d))
        assert cs.vectors.dtype == torch.bfloat16
    finally:
        je.close()
        te.close()
    assert not te._backend.store._th and te._backend.store._stop.is_set()


def test_pq_engine_recall_and_footprint(tmp_path):
    """The reference's bar (``tests/test_pq.py``): PQ-on serving at
    window = dataset/4 reaches recall@10 >= 0.90 with the device code
    footprint <= 1/8 of the fp32 equivalent."""
    rng = np.random.default_rng(6)
    n, dim = 2400, 32
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, TE.EngineConfig(
        degree=16, cache_slots=256, capacity=8192,
        disk_path=str(tmp_path / "tier"), disk_capacity=8192,
        host_window=n // 4, search=SearchParams(k=10, pool=64, max_iters=96),
        pq_enabled=True, pq_m=16, pq_bits=8, rerank_depth=32,
        wal_enabled=False, device="cpu"))
    try:
        q = rng.normal(size=(32, dim)).astype(np.float32)
        ids, dists = eng.search(q)
        g = GraphState(torch.from_numpy(vecs), None,
                       torch.ones(n, dtype=torch.bool), None, None, None)
        truth, _ = brute_force_topk(g, torch.from_numpy(q), 10)
        rec = float(recall_at_k(torch.from_numpy(ids), truth))
        assert rec >= 0.90, rec
        st = eng.stats()
        assert st["device_footprint_ratio"] <= 1 / 8 + 1e-9
        assert st["bytes_per_tier"]["device_codes"] == n * st["pq_m"]
        assert (st["pq_m"], st["pq_bits"], st["rerank_depth"]) == (16, 8, 32)
        assert (np.diff(dists, axis=1) >= 0).all()
    finally:
        eng.close()


def test_pq_engine_fused_dispatch_budget(tmp_path):
    """The reference's bar (``tests/test_fused.py``): a PQ engine warms
    the topology tier at init, so steady batches cost 3 dispatches with
    every frontier id resident."""
    rng = np.random.default_rng(9)
    n = 500
    vecs = rng.normal(size=(n, 16)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, TE.EngineConfig(
        degree=8, cache_slots=64, capacity=4 * n,
        disk_path=str(tmp_path / "t"), disk_capacity=4 * n,
        host_window=n // 4, search=SearchParams(k=8, pool=32, max_iters=48),
        seed=0, pq_enabled=True, pq_m=4, pq_bits=6, coalesce=False,
        wal_enabled=False, device="cpu"))
    try:
        q = rng.normal(size=(8, 16)).astype(np.float32)
        for _ in range(4):
            eng.search(q)
        st = eng.stats()
        assert st["dispatches_per_query"] <= 3.0
        assert st["topo_hit_rate"] == 1.0 and st["topo_misses"] == 0
        assert st["bytes_per_tier"]["device_topo_rows"] > 0
        assert st["topo_resident"] >= n
        assert st["spec_rank_resolved"] in ("flam", "dist")
        assert st["spec_probe_us_per_row"] > 0
    finally:
        eng.close()


def test_tiered_engine_refuses_what_is_not_ported(tmp_path):
    vecs = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    base = dict(degree=8, cache_slots=16, capacity=128, disk_capacity=128,
                device="cpu")
    with pytest.raises(NotImplementedError, match="A.8"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(
            disk_path=str(tmp_path / "w"), **base))          # WAL default on
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "manifest.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="A.8"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(
            disk_path=str(tmp_path / "m"), wal_enabled=False, **base))
    with pytest.raises(ValueError, match="three-tier"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(pq_enabled=True, **base))
    with pytest.raises(ValueError, match="cache_dtype"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(
            disk_path=str(tmp_path / "d"), wal_enabled=False,
            cache_dtype="fp64", **base))
    with pytest.raises(NotImplementedError, match="A.9"):
        TT.TieredBackend(TT.TieredStore(TT.DiskTier(
            str(tmp_path / "a"), 8, 2, 2), 4), 0).attach_attrs(None)


def test_converted_tiered_state_searches_alike(index):
    """A reference HostPlacement after placement passes (bf16 payload)
    and a demand-filled reference TopoCache, carried across with
    ``convert``, give the port the reference's search results."""
    ix = index
    be, vecs = ix["be"], ix["vecs"]
    hp = JC.HostPlacement(be.capacity, 32, D, dtype=jnp.bfloat16)
    hot = np.argsort(-be.e_in[:N], kind="stable")[:32]
    hp.warm(hot, vecs[hot])
    first = jax_search_tiered(be, hp, ix["queries"], 0, JaxSearchParams(*SP),
                              entry_ids=ix["entries"])
    JC.apply_wavp_host(hp, first.acc_ids, first.acc_hit, SP, alive=be.alive,
                       e_in=be.e_in, fetch_vectors=lambda i: vecs[i])
    topo = _topo(JC, be, "demand")
    jax_search_tiered(be, hp, ix["queries"], 1, JaxSearchParams(*SP),
                      pq=ix["jpq"], topo=topo)           # fill on demand
    thp = convert.host_placement_from_arrays(
        dict(vectors=np.asarray(hp.vectors, np.float32),
             **{f: getattr(hp, f) for f in (
                 "slot_hid", "h2d", "ref", "slot_ver", "f_recent", "theta",
                 "alpha", "beta", "counters")}), dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        thp.vectors.view(torch.int16).numpy().view(np.uint16),
        np.asarray(hp.vectors).view(np.uint16))
    ttopo = convert.topo_cache_from_arrays(
        topo.rows, topo.slot_hid, topo.h2s, slots=topo.slots,
        epoch=topo.epoch, device="cpu")
    assert ttopo.resident == topo.resident > 0
    kw = dict(entry_ids=ix["entries"], rerank_depth=SP.pool)
    want = jax_search_tiered(be, hp, ix["queries"], 0, JaxSearchParams(*SP),
                             pq=ix["jpq"], topo=topo, **kw)
    got = search_tiered(ix["tbe"], thp, ix["queries"], 0, SP, pq=ix["tpq"],
                        topo=ttopo, device="cpu", **kw)
    _same(want, got)
    assert got.topo_hits > 0             # the carried rows were used
    assert (ttopo.slot_hid == topo.slot_hid).all()
    assert (ttopo.h2s == topo.h2s).all()
