"""The port's filtered search against the reference's
(``repro.core.filters`` and the predicate lane of ``search_tiered``):
filter specs, schemas and their compiled forms; the attribute store and
its mirror; the device predicate mask bit for bit against the host pass,
at tag domains 31 and 32 too; the selectivity estimate; filtered
``search_tiered`` in the exact and PQ lanes, on the graph path and the
brute-force path, field by field against the reference on integer data
and against post-filtering an unfiltered scan; parity across inserts
with attributes and deletes; the engine's router, counters, coalescer
demux and device-mode refusal."""
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core import engine as JE
from repro.core import filters as JF
from repro.core import quant as JQ
from repro.core import update as JU
from repro.core.build import build_tiered_backend as jax_build_tiered
from repro.core.search import search_tiered as jax_search_tiered
from repro.core.tiers import AttributeStore as JaxAttrs
from repro.core.types import SearchParams as JaxSP
from repro_torch import convert
from repro_torch.core import cache as TC
from repro_torch.core import engine as TE
from repro_torch.core import filters as TF
from repro_torch.core import update as TU
from repro_torch.core.build import build_tiered_backend
from repro_torch.core.search import search_tiered
from repro_torch.core.tiers import AttributeStore
from repro_torch.core.types import SearchParams

SCHEMA = TF.AttributeSchema(tag_fields=("cat",), num_fields=("score",))
JSCHEMA = JF.AttributeSchema(tag_fields=("cat",), num_fields=("score",))
N, D, DEG, CAP, POOL = 220, 12, 8, 512, 256


def _mk_attrs(n):
    return {"cat": np.arange(n) % 4, "score": np.arange(n) / max(n, 1)}


# the reference's selectivity cases (tests/test_filters.py): 100%, 50%,
# ~1% and no match over cat = i % 4, score = i / n
CASE_ARGS = [
    ("all", dict(ranges={"score": (None, None)})),
    ("half", dict(tags={"cat": {0, 1}})),
    ("one_pct", dict(ranges={"score": (0.0, 0.011)})),
    ("none", dict(ranges={"score": (2.0, 3.0)})),
]
CASES = [(name, TF.FilterSpec(**kw)) for name, kw in CASE_ARGS]
JCASES = [(name, JF.FilterSpec(**kw)) for name, kw in CASE_ARGS]


# ---------------------------------------------------------------------------
# specs, schemas, compiled forms
# ---------------------------------------------------------------------------

def test_filterspec_key_eq_and_schema_meta_match_the_reference():
    for kw in (dict(tags={"cat": {2, 0}}, ranges={"score": (0.1, None)}),
               dict(tags={"cat": [0, 2]}, ranges={"score": (0.1, None)}),
               dict(ranges={"score": (None, 3)}), {}):
        a, b = TF.FilterSpec(**kw), JF.FilterSpec(**kw)
        assert a.key() == b.key() and hash(a) == hash(TF.FilterSpec(**kw))
    a = TF.FilterSpec(tags={"cat": {2, 0}}, ranges={"score": (0.1, None)})
    b = TF.FilterSpec(tags={"cat": {0, 2}}, ranges={"score": (0.1, None)})
    assert a == b and a != TF.FilterSpec(tags={"cat": {0}})
    with pytest.raises(ValueError):
        TF.FilterSpec(tags={"cat": set()})
    with pytest.raises(AttributeError):
        a.tags = {}
    s = TF.AttributeSchema(tag_fields=("a", "b"), num_fields=("x",),
                           tag_domain=16)
    js = JF.AttributeSchema(tag_fields=("a", "b"), num_fields=("x",),
                            tag_domain=16)
    assert s.to_meta() == js.to_meta()
    assert TF.AttributeSchema.from_meta(js.to_meta()) == s
    for bad in (dict(tag_fields=("a",), tag_domain=64),
                dict(tag_fields=("a", "a"))):
        with pytest.raises(ValueError):
            TF.AttributeSchema(**bad)
    for spec in (TF.FilterSpec(tags={"zzz": {0}}),
                 TF.FilterSpec(tags={"a": {16}}),
                 TF.FilterSpec(ranges={"y": (0, 1)})):
        with pytest.raises(ValueError):
            TF.compile_filter(spec, s)
    spec = dict(tags={"b": {1, 15}}, ranges={"x": (-2.5, 7)})
    got = TF.compile_filter(TF.FilterSpec(**spec), s)
    want = JF.compile_filter(JF.FilterSpec(**spec), js)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("payload", ["none", "dict", "pair", "partial"])
def test_coerce_matches_the_reference(payload):
    m = 5
    attrs = {"none": None,
             "dict": {"cat": np.arange(m) % 3, "score": np.linspace(0, 1, m)},
             "pair": (np.arange(m)[:, None] % 4, np.ones((m, 1))),
             "partial": {"score": np.full(m, 0.25)}}[payload]
    for g, w in zip(SCHEMA.coerce(attrs, m), JSCHEMA.coerce(attrs, m)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for bad in ({"cat": np.arange(m + 1)}, {"zzz": np.zeros(m)},
                {"cat": np.full(m, 32)}, (np.zeros((m, 2)), None)):
        with pytest.raises(ValueError):
            SCHEMA.coerce(bad, m)


@pytest.mark.parametrize("domain", [4, 31, 32])
def test_device_pass_mask_equals_host_pass_bit_for_bit(domain):
    """Two tag fields over the whole domain (tag 31 at domain 32 shifts
    the mask's top bit) and a numeric field; random specs, including
    unconstrained fields (all-ones masks)."""
    rng = np.random.default_rng(domain)
    n, cap = 1000, 1200
    s = TF.AttributeSchema(tag_fields=("a", "b"), num_fields=("x",),
                           tag_domain=domain)
    js = JF.AttributeSchema(tag_fields=("a", "b"), num_fields=("x",),
                            tag_domain=domain)
    tags = rng.integers(0, domain, (n, 2)).astype(np.int32)
    tags[:2] = domain - 1
    nums = rng.normal(size=(n, 1)).astype(np.float32)
    store = AttributeStore(s, cap, tags=tags, nums=nums, device="cpu")
    jstore = JaxAttrs(js, cap, tags=tags, nums=nums)
    for t in range(12):
        vals = set(rng.choice(domain, rng.integers(1, domain + 1),
                              replace=False).tolist())
        if t % 3 == 0:
            vals |= {domain - 1}
        kw = dict(tags={"a": vals} if t % 4 else {},
                  ranges={"x": (None, float(rng.normal()))} if t % 2 else {})
        cf = TF.compile_filter(TF.FilterSpec(**kw), s)
        got = TF.device_pass_mask(store, cf)
        assert got.dtype == torch.bool and got.shape == (cap,)
        hm = TF.host_pass(cf, store.tags, store.nums)
        np.testing.assert_array_equal(got.numpy(), hm)
        jcf = JF.compile_filter(JF.FilterSpec(**kw), js)
        np.testing.assert_array_equal(
            hm, JF.host_pass(jcf, jstore.tags, jstore.nums))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JF.device_pass_mask(jstore, jcf)))


@pytest.mark.parametrize("n,dead", [(200, 0), (5000, 0), (5000, 700)])
def test_estimate_selectivity_matches_the_reference(n, dead):
    rng = np.random.default_rng(n + dead)
    tags, nums = SCHEMA.coerce(_mk_attrs(n), n)
    store = AttributeStore(SCHEMA, n + 8, tags=tags, nums=nums, device="cpu")
    jstore = JaxAttrs(JSCHEMA, n + 8, tags=tags, nums=nums)
    alive = np.zeros(n + 8, bool)
    alive[:n] = True
    alive[rng.choice(n, dead, replace=False)] = False
    for kw in (dict(tags={"cat": {0, 1}}), dict(ranges={"score": (0, .3)})):
        for seed in (0, 9):
            got = TF.estimate_selectivity(
                TF.compile_filter(TF.FilterSpec(**kw), SCHEMA), store, alive,
                n, seed=seed)
            want = JF.estimate_selectivity(
                JF.compile_filter(JF.FilterSpec(**kw), JSCHEMA), jstore,
                alive, n, seed=seed)
            assert got == want
    cf = TF.compile_filter(TF.FilterSpec(tags={"cat": {0}}), SCHEMA)
    assert TF.estimate_selectivity(cf, store, alive, 0) == 1.0


def test_attribute_store_mirror_snapshot_and_bytes(tmp_path):
    tags, nums = SCHEMA.coerce(_mk_attrs(10), 10)
    st = AttributeStore(SCHEMA, 16, tags=tags, nums=nums, device="cpu")
    old = st.synced()[0]
    st.write(np.array([10, 11]), np.array([[3], [2]]), np.array([[.5], [.7]]))
    st.write(np.array([11]), np.array([[1]]), np.array([[.9]]))
    t, v = st.synced()
    np.testing.assert_array_equal(t.numpy(), st.tags)
    np.testing.assert_array_equal(v.numpy(), st.nums)
    assert old[10, 0] == 0 and t[11, 0] == 1      # the old mirror stands
    assert st.written == 3 and st.attr_bytes(12) == 12 * 8
    snap = st.snapshot(12)
    np.testing.assert_array_equal(snap[0], st.tags[:12])
    js = JaxAttrs(JSCHEMA, 16, tags=st.tags[:12], nums=st.nums[:12])
    conv = convert.attribute_store_from_arrays(
        JSCHEMA.to_meta(), js.tags, js.nums, 16, device="cpu")
    assert conv.schema == SCHEMA
    np.testing.assert_array_equal(conv.synced()[0].numpy(), js.tags)
    np.testing.assert_array_equal(conv.synced()[1].numpy(), js.nums)
    be = build_tiered_backend(np.random.default_rng(0).normal(
        size=(20, 4)).astype(np.float32), 4, str(tmp_path), disk_capacity=32,
        device="cpu")
    with pytest.raises(ValueError, match="spans"):
        be.attach_attrs(st)
    be.attach_attrs(AttributeStore(SCHEMA, 32, device="cpu"))
    assert be.bytes_per_tier()["host_attrs"] == 20 * 8
    assert be.tier_counts()["attrs_written"] == 0
    be.close()


# ---------------------------------------------------------------------------
# filtered search_tiered: the port against the reference
# ---------------------------------------------------------------------------

def _lossless(vecs):
    """``tests/test_pq.py``'s lossless codebook as arrays: m = D one-dim
    subspaces, centroid k of subspace s is vecs[k, s], code of i is i."""
    n, dim = vecs.shape
    cents = np.full((dim, 256, 1), 1e6, np.float32)
    cents[:, :n, 0] = vecs.T
    return cents, np.tile(np.arange(n, dtype=np.uint8)[:, None], (1, dim))


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    """An integer-valued index built by the reference and opened by the
    port from its memmaps; identical attribute stores, placements and
    lossless PQ lanes."""
    rng = np.random.default_rng(3)
    vecs = rng.integers(-6, 7, (N, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (4, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("filt"))
    be = jax_build_tiered(vecs, DEG, path, host_window=64, disk_capacity=CAP)
    tbe = convert.tiered_backend_from_arrays(
        path, capacity=CAP, dim=D, degree=DEG, n=be.n, alive=be.alive,
        e_in=be.e_in, version=be.version, host_window=64)
    tags, nums = JSCHEMA.coerce(_mk_attrs(N), N)
    be.attach_attrs(JaxAttrs(JSCHEMA, CAP, tags=tags, nums=nums))
    tbe.attach_attrs(convert.attribute_store_from_arrays(
        JSCHEMA.to_meta(), tags, nums, CAP, device="cpu"))
    cents, codes = _lossless(vecs)
    jpq = JQ.PQCodes(JQ.codebook_from_array(cents), CAP, codes=codes)
    tpq = convert.pq_codes_from_arrays(cents, codes, CAP, "cpu")
    ent = np.tile(np.clip(np.arange(POOL), 0, N - 1)[None], (4, 1))
    yield dict(be=be, tbe=tbe, hp=JC.HostPlacement(CAP, 16, D),
               thp=TC.HostPlacement(CAP, 16, D), jpq=jpq, tpq=tpq,
               queries=queries, ent=ent, vecs=vecs)
    be.close()
    tbe.close()


def _same(got, want):
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _post_filter_topk(ids, dists, hmask, k):
    """Post-filter an unfiltered k=pool result row by row, keep the first
    k passing entries, pad with -1/+inf (``tests/test_filters.py``)."""
    B = ids.shape[0]
    out_i = np.full((B, k), -1, np.int64)
    out_d = np.full((B, k), np.inf, np.float32)
    for b in range(B):
        keep = [(i, d) for i, d in zip(ids[b], dists[b])
                if i >= 0 and np.isfinite(d) and hmask[i]][:k]
        for j, (i, d) in enumerate(keep):
            out_i[b, j], out_d[b, j] = i, d
    return out_i, out_d


def _both(ix, spec_i, lane, pq=False, topo=False, **kw):
    """(reference, port) filtered results on the shared index."""
    thresh = 0.0 if lane == "graph" else 1.1
    sp = SearchParams(k=10, pool=POOL, max_iters=8, beam=2)
    jkw, tkw = {}, {}
    if pq:
        jkw = dict(pq=ix["jpq"], rerank_depth=POOL)
        tkw = dict(pq=ix["tpq"], rerank_depth=POOL)
    if topo:
        jkw["topo"] = JC.warm_topo_cache(ix["be"], 0)
        tkw["topo"] = TC.warm_topo_cache(ix["tbe"], 0, device="cpu")
    want = jax_search_tiered(ix["be"], ix["hp"], ix["queries"], 0,
                             JaxSP(*sp), entry_ids=ix["ent"],
                             filter=JCASES[spec_i][1],
                             filter_fallback_selectivity=thresh, **jkw, **kw)
    got = search_tiered(ix["tbe"], ix["thp"], ix["queries"], 0, sp,
                        entry_ids=ix["ent"], filter=CASES[spec_i][1],
                        filter_fallback_selectivity=thresh, device="cpu",
                        **tkw, **kw)
    return want, got


def _post_filter_check(ix, got, spec_i, pq=False):
    spf = SearchParams(k=POOL, pool=POOL, max_iters=8, beam=2)
    kw = dict(pq=ix["tpq"], rerank_depth=POOL) if pq else {}
    ref = search_tiered(ix["tbe"], ix["thp"], ix["queries"], 0, spf,
                        entry_ids=ix["ent"], device="cpu", **kw)
    cf = TF.compile_filter(CASES[spec_i][1], SCHEMA)
    hmask = TF.host_pass(cf, ix["tbe"].attrs.tags, ix["tbe"].attrs.nums)
    wi, wd = _post_filter_topk(ref.ids, ref.dists, hmask, 10)
    np.testing.assert_array_equal(got.ids, wi)
    np.testing.assert_array_equal(got.dists, wd)


@pytest.mark.parametrize("spec_i", range(len(CASES)),
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("lane", ["graph", "fallback"])
def test_filtered_exact_lane_matches_the_reference(index, spec_i, lane):
    want, got = _both(index, spec_i, lane)
    _same(got, want)
    assert got.filter_path == lane
    _post_filter_check(index, got, spec_i)


@pytest.mark.parametrize("lane", ["graph", "fallback"])
@pytest.mark.parametrize("topo", [False, True], ids=["rounds", "fused"])
def test_filtered_pq_lane_matches_the_reference(index, lane, topo):
    """The PQ lane on a lossless codebook at full re-rank depth: the
    per-round and the fused (device predicate mask) graph paths, and the
    filtered ``pq_adc`` scan of the fallback."""
    for spec_i in range(len(CASES)):
        want, got = _both(index, spec_i, lane, pq=True, topo=topo)
        _same(got, want)
        assert got.filter_path == lane
        _post_filter_check(index, got, spec_i, pq=True)


def test_filtered_pq_scan_keeps_the_rerank_depth(index):
    """The fallback's scan at a re-rank depth below the matches: the
    scan's top ``depth`` by ADC distance, ties to the lower id."""
    ix = index
    sp = SearchParams(k=5, pool=16, max_iters=8, beam=2)
    for spec_i in (0, 1):
        want = jax_search_tiered(ix["be"], ix["hp"], ix["queries"], 0,
                                 JaxSP(*sp), pq=ix["jpq"], rerank_depth=8,
                                 filter=JCASES[spec_i][1],
                                 filter_fallback_selectivity=1.1)
        got = search_tiered(ix["tbe"], ix["thp"], ix["queries"], 0, sp,
                            pq=ix["tpq"], rerank_depth=8,
                            filter=CASES[spec_i][1],
                            filter_fallback_selectivity=1.1, device="cpu")
        _same(got, want)
        assert got.acc_ids.shape == (4, 8) and got.dispatches == 2


def test_filter_requires_an_attribute_store(tmp_path):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(100, 8)).astype(np.float32)
    be = build_tiered_backend(vecs, 8, str(tmp_path), host_window=32,
                              disk_capacity=256, device="cpu")
    hp = TC.HostPlacement(be.capacity, 16, 8)
    sp = SearchParams(k=5, pool=32)
    try:
        with pytest.raises(ValueError, match="attribute store"):
            search_tiered(be, hp, vecs[:2], 0, sp, device="cpu",
                          filter=TF.FilterSpec(tags={"cat": {0}}))
        with pytest.raises(ValueError, match="attribute store"):
            TU.insert_tiered(be, hp, vecs[:4], sp, 0, device="cpu",
                             attributes={"cat": np.zeros(4)})
    finally:
        be.close()


def test_port_alone_equals_post_filtering_on_float_data(tmp_path):
    """The reference's own property (``tests/test_filters.py``) on float
    data for the port: both paths of both lanes equal post-filtering."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(220, D)).astype(np.float32)
    queries = rng.normal(size=(4, D)).astype(np.float32)
    be = build_tiered_backend(vecs, DEG, str(tmp_path), host_window=64,
                              disk_capacity=CAP, device="cpu")
    tags, nums = SCHEMA.coerce(_mk_attrs(220), 220)
    be.attach_attrs(AttributeStore(SCHEMA, CAP, tags=tags, nums=nums,
                                   device="cpu"))
    cents, codes = _lossless(vecs)
    pq = convert.pq_codes_from_arrays(cents, codes, CAP, "cpu")
    hp = TC.HostPlacement(CAP, 16, D)
    ent = np.tile(np.clip(np.arange(POOL), 0, 219)[None], (4, 1))
    sp = SearchParams(k=10, pool=POOL, max_iters=8, beam=2)
    spf = SearchParams(k=POOL, pool=POOL, max_iters=8, beam=2)
    try:
        for kw in ({}, dict(pq=pq, rerank_depth=POOL)):
            ref = search_tiered(be, hp, queries, 0, spf, entry_ids=ent,
                                device="cpu", **kw)
            for _, spec in CASES:
                cf = TF.compile_filter(spec, SCHEMA)
                hm = TF.host_pass(cf, be.attrs.tags, be.attrs.nums)
                wi, wd = _post_filter_topk(ref.ids, ref.dists, hm, 10)
                for thresh in (0.0, 1.1):
                    got = search_tiered(be, hp, queries, 0, sp,
                                        entry_ids=ent, filter=spec,
                                        filter_fallback_selectivity=thresh,
                                        device="cpu", **kw)
                    np.testing.assert_array_equal(got.ids, wi)
                    np.testing.assert_array_equal(got.dists, wd)
    finally:
        be.close()


def test_filtered_parity_across_interleaved_updates(tmp_path):
    """Inserts with attributes and deletes between filtered searches, on
    two copies of one index: the port equals the reference at every
    epoch, new ids become filterable at once, deleted ids vanish."""
    rng = np.random.default_rng(5)
    vecs = rng.integers(-6, 7, (180, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (4, D)).astype(np.float32)
    jpath, tpath = tmp_path / "j", tmp_path / "t"
    be = jax_build_tiered(vecs, DEG, str(jpath), host_window=64,
                          disk_capacity=CAP)
    be.store.disk.flush()
    shutil.copytree(jpath, tpath)
    tbe = convert.tiered_backend_from_arrays(
        str(tpath), capacity=CAP, dim=D, degree=DEG, n=be.n, alive=be.alive,
        e_in=be.e_in, version=be.version, host_window=64)
    tags, nums = JSCHEMA.coerce(_mk_attrs(180), 180)
    be.attach_attrs(JaxAttrs(JSCHEMA, CAP, tags=tags, nums=nums))
    tbe.attach_attrs(AttributeStore(SCHEMA, CAP, tags=tags, nums=nums,
                                    device="cpu"))
    hp, thp = JC.HostPlacement(CAP, 16, D), TC.HostPlacement(CAP, 16, D)
    sp = SearchParams(k=10, pool=POOL, max_iters=8, beam=2)
    spec, jspec = (TF.FilterSpec(tags={"cat": {0, 1}}),
                   JF.FilterSpec(tags={"cat": {0, 1}}))
    try:
        def check():
            ent = np.tile(np.clip(np.arange(POOL), 0, be.n - 1)[None],
                          (4, 1))
            want = jax_search_tiered(be, hp, queries, 0, JaxSP(*sp),
                                     entry_ids=ent, filter=jspec)
            got = search_tiered(tbe, thp, queries, 0, sp, entry_ids=ent,
                                filter=spec, device="cpu")
            _same(got, want)
            return got

        check()
        for r in range(2):
            n0 = int(be.n)
            newv = rng.integers(-6, 7, (20, D)).astype(np.float32)
            attrs = {"cat": np.arange(n0, n0 + 20) % 4,
                     "score": np.full(20, 0.5)}
            jids, _ = JU.insert_tiered(be, hp, newv, JaxSP(*sp), 7 + r,
                                       attributes=attrs)
            ids, _ = TU.insert_tiered(tbe, thp, newv, sp, 7 + r,
                                      attributes=attrs, device="cpu")
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(tbe.attrs.tags, be.attrs.tags)
            got = check()
            assert np.isin(got.ids, ids).any()
            JU.delete_tiered(be, ids[:8])
            TU.delete_tiered(tbe, ids[:8])
            got = check()
            assert not np.isin(ids[:8], got.ids).any()
    finally:
        be.close()
        tbe.close()


# ---------------------------------------------------------------------------
# the engine: router, counters, coalescer, device mode
# ---------------------------------------------------------------------------

def _engine_cfg(mod, sp_cls, path, **kw):
    base = dict(degree=8, cache_slots=64, capacity=1024,
                disk_path=str(path), disk_capacity=1024, host_window=128,
                search=sp_cls(k=5, pool=64), attributes=(
                    SCHEMA if mod is TE else JSCHEMA),
                filter_fallback_selectivity=0.1, seed=1)
    base.update(kw)
    if mod is TE:
        base["device"] = "cpu"
    return mod.EngineConfig(**base)


def test_engine_router_and_counters_match_the_reference(tmp_path):
    """The same requests through both engines (integer data, coalescing
    and prefetch off): the same ids and distances, filtered and not, and
    the same filter counters, paths and selectivities in ``stats()``."""
    rng = np.random.default_rng(11)
    n = 400
    vecs = rng.integers(-6, 7, (n, 8)).astype(np.float32)
    kw = dict(coalesce=False, prefetch=False, spec_rank="flam",
              cache_dtype="fp32")
    je = JE.SVFusionEngine(vecs, _engine_cfg(JE, JaxSP, tmp_path / "j", **kw),
                           init_attrs=_mk_attrs(n))
    te = TE.SVFusionEngine(vecs, _engine_cfg(TE, SearchParams,
                                             tmp_path / "t", **kw),
                           init_attrs=_mk_attrs(n))
    try:
        q = vecs[:3]
        for spec in (dict(tags={"cat": {0, 1}}),
                     dict(ranges={"score": (0.0, 0.011)}), None,
                     dict(tags={"cat": {2}}, ranges={"score": (.5, 1)})):
            a = je.search(q, filter=spec and JF.FilterSpec(**spec))
            b = te.search(q, filter=spec and TF.FilterSpec(**spec))
            np.testing.assert_array_equal(b[0], a[0])
            np.testing.assert_array_equal(b[1], a[1])
            sj, st = je.stats(), te.stats()
            for k in ("filtered_searches", "filter_fallbacks",
                      "filter_last_selectivity", "filter_last_path",
                      "filter_fallback_selectivity", "attrs_written"):
                assert st[k] == sj[k], k
            assert st["bytes_per_tier"] == sj["bytes_per_tier"]
        assert st["filtered_searches"] == 3 and st["filter_fallbacks"] == 1
        new = rng.integers(-6, 7, (6, 8)).astype(np.float32)
        attrs = {"cat": np.full(6, 3), "score": np.full(6, 0.99)}
        np.testing.assert_array_equal(te.insert(new, attributes=attrs),
                                      je.insert(new, attributes=attrs))
        spec = dict(tags={"cat": {3}}, ranges={"score": (0.98, 1)})
        a = je.search(new, filter=JF.FilterSpec(**spec))
        b = te.search(new, filter=TF.FilterSpec(**spec))
        np.testing.assert_array_equal(b[0], a[0])
        assert te.stats()["filter_last_path"] == "fallback"
        a = te._backend.attrs
        ok = TF.host_pass(TF.compile_filter(TF.FilterSpec(**spec), SCHEMA),
                          a.tags, a.nums)
        assert ok[b[0][b[0] >= 0]].all() and (b[0][:, 0] >= n).all()
    finally:
        je.close()
        te.close()


def test_engine_rejects_bad_attribute_configs(tmp_path):
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(200, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="three-tier"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(
            degree=8, capacity=512, attributes=SCHEMA, device="cpu"))
    with pytest.raises(ValueError, match="init_attrs"):
        TE.SVFusionEngine(vecs, TE.EngineConfig(
            degree=8, capacity=512, device="cpu",
            disk_path=str(tmp_path / "t")), init_attrs=_mk_attrs(200))


def test_engine_device_mode_rejects_filter():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(200, 8)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, TE.EngineConfig(
        degree=8, capacity=512, coalesce=False, device="cpu"))
    try:
        with pytest.raises(ValueError, match="three-tier"):
            eng.search(vecs[:1], filter=TF.FilterSpec(tags={"cat": {0}}))
        with pytest.raises(ValueError, match="three-tier"):
            eng.insert(vecs[:1], attributes={"cat": [0]})
        assert eng.checkpoint() is None            # no log in device mode
    finally:
        eng.close()


def test_coalescer_demuxes_filter_specs(tmp_path):
    """Concurrent submissions with two specs and unfiltered traffic, from
    one caller and from threads: only key-equal specs share a dispatch,
    and every caller gets results that pass its own filter."""
    rng = np.random.default_rng(13)
    n, d = 400, 8
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, _engine_cfg(
        TE, SearchParams, tmp_path / "t", filter_fallback_selectivity=0.0,
        coalesce=True, coalesce_window=5e-3), init_attrs=_mk_attrs(n))
    try:
        specs = [TF.FilterSpec(tags={"cat": {0}}),
                 TF.FilterSpec(tags={"cat": {1}}), None,
                 TF.FilterSpec(tags={"cat": {0}}), None,
                 TF.FilterSpec(tags={"cat": {1, 2}})]
        allowed = [{0}, {1}, None, {0}, None, {1, 2}]
        q = rng.normal(size=(1, d)).astype(np.float32)
        futs = [eng.submit_search(q, filter=s) for s in specs]
        for f, ok in zip(futs, allowed):
            ids, _ = f.result()
            if ok is not None:
                assert np.isin(ids[ids >= 0] % 4, list(ok)).all()
        assert eng.stats()["coalesce_dispatches"] >= 3
        errs, results = [], []
        lock = threading.Lock()

        def worker(i):
            try:
                ids, _ = eng.submit_search(
                    rng.normal(size=(1, d)).astype(np.float32),
                    filter=specs[i % 6]).result(timeout=60)
                with lock:
                    results.append((i % 6, ids))
            except Exception as e:           # pragma: no cover
                with lock:
                    errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(18)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs and len(results) == 18
        for i, ids in results:
            if allowed[i] is not None:
                assert np.isin(ids[ids >= 0] % 4, list(allowed[i])).all()
    finally:
        eng.close()


def test_engine_rate_limit_through_the_tier(tmp_path):
    """A token bucket refilled at 1e-6 requests a second: the first
    request takes the only token, the second is rejected however long
    the first search took, other tenants pass."""
    from repro_torch.core.slo import RateLimitError
    rng = np.random.default_rng(19)
    vecs = rng.normal(size=(300, 8)).astype(np.float32)
    eng = TE.SVFusionEngine(vecs, _engine_cfg(
        TE, SearchParams, tmp_path / "t", attributes=None, coalesce=True,
        slo_tenant_rate_limits={"t0": (1e-6, 1.0)}))
    try:
        eng.search(vecs[:1], tenant="t0")
        with pytest.raises(RateLimitError):
            eng.search(vecs[:1], tenant="t0")
        eng.search(vecs[:1], tenant="other")
        st = eng.stats()["slo"]
        assert st["rate_limited"] == 1
        assert st["tenants"]["t0"]["rate_limited"] == 1
    finally:
        eng.close()
