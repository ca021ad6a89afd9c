"""The port's three-tier write path against the reference: the same op
sequence (inserts, deletes, a snapshot, inserts and deletes in the
window, the streaming consolidation and the MVCC merge) leaves the disk
tier's rows and vectors, the host window, alive, version, e_in and the
PQ codes identical, and a PQ-lane search afterwards returns the same
result; the three-tier engines of both packages agree op by op; the
reference's MVCC protocols (``tests/test_tiered.py``) hold for the port;
``MultiStreamRunner`` drains with every op applied. Integer-valued data
and an integer-rounded codebook keep every fp32 sum exact."""
import shutil

import numpy as np
import pytest

from repro.core import cache as JC
from repro.core import engine as JE
from repro.core import mvcc as JM
from repro.core import quant as JQ
from repro.core import update as JU
from repro.core.build import build_tiered_backend as jax_build_tiered
from repro.core.search import search_tiered as jax_search_tiered
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch import convert
from repro_torch.core import cache as TC
from repro_torch.core import engine as TE
from repro_torch.core import mvcc as TM
from repro_torch.core import update as TU
from repro_torch.core.search import search_tiered
from repro_torch.core.types import SearchParams

N, D, DEG, CAP = 400, 12, 8, 1024
SP = SearchParams(k=5, pool=16, max_iters=24, beam=2)


def ints(rng, n, d=D):
    return rng.integers(-6, 7, (n, d)).astype(np.float32)


def same_backend(tbe, be):
    """Disk tier, host window and the metadata directory, field by field."""
    assert tbe.n == be.n
    for f in ("alive", "e_in", "version"):
        np.testing.assert_array_equal(getattr(tbe, f), getattr(be, f),
                                      err_msg=f)
    ts, js = tbe.store, be.store
    np.testing.assert_array_equal(np.asarray(ts.disk.nbr),
                                  np.asarray(js.disk.nbr))
    np.testing.assert_array_equal(np.asarray(ts.disk.vec),
                                  np.asarray(js.disk.vec))
    for f in ("loc", "slot_id", "host_nbr", "host_vec"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)
    assert (ts.hits, ts.misses, ts.demotions) == \
        (js.hits, js.misses, js.demotions)
    if be.pq is not None:
        np.testing.assert_array_equal(tbe.pq.codes, be.pq.codes)
        assert tbe.pq.encoded == be.pq.encoded


def same_log(tlog, jlog):
    for g, w in zip(convert.rev_log_to_arrays(tlog), jlog):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture
def pair(tmp_path):
    """One integer-valued backend built by the reference, its directory
    copied and opened by the port; identical host placements and PQ lanes
    on the reference's codebook rounded to integers."""
    rng = np.random.default_rng(3)
    vecs = ints(rng, N)
    jpath, tpath = tmp_path / "j", tmp_path / "t"
    be = jax_build_tiered(vecs, DEG, str(jpath), disk_capacity=CAP,
                          host_window=120)
    be.store.disk.flush()
    shutil.copytree(jpath, tpath)
    tbe = convert.tiered_backend_from_arrays(
        str(tpath), capacity=CAP, dim=D, degree=DEG, n=be.n, alive=be.alive,
        e_in=be.e_in, version=be.version, host_window=120)
    hp = JC.HostPlacement(CAP, 48, D)
    thp = TC.HostPlacement(CAP, 48, D)
    hot = np.argsort(-be.e_in[:N], kind="stable")[:48]
    for p in (hp, thp):
        p.warm(hot, vecs[hot])
    cb = JQ.train_codebook(vecs, m=4, bits=6, iters=5, seed=1)
    cents = np.round(JQ.codebook_to_array(cb))
    codes = JQ.encode(JQ.codebook_from_array(cents), vecs)
    be.attach_pq(JQ.PQCodes(JQ.codebook_from_array(cents), CAP,
                            codes=codes))
    tbe.attach_pq(convert.pq_codes_from_arrays(cents, codes, CAP, "cpu"))
    yield dict(be=be, tbe=tbe, hp=hp, thp=thp, rng=rng)
    be.close()
    tbe.close()


def insert_both(p, vecs, seed):
    jsp = JaxSearchParams(*SP)
    ids, rev = JU.insert_tiered(p["be"], p["hp"], vecs, jsp, seed)
    tids, trev = TU.insert_tiered(p["tbe"], p["thp"], vecs, SP, seed,
                                  device="cpu")
    np.testing.assert_array_equal(tids, ids)
    same_log(trev, rev)
    same_backend(p["tbe"], p["be"])
    return (ids, rev), (tids, trev)


def delete_both(p, ids):
    got = TU.delete_tiered(p["tbe"], ids)
    np.testing.assert_array_equal(got, JU.delete_tiered(p["be"], ids))
    same_backend(p["tbe"], p["be"])


def test_tiered_write_path_matches_reference(pair):
    p, rng = pair, pair["rng"]
    be, tbe = p["be"], p["tbe"]
    insert_both(p, ints(rng, 40), 11)
    delete_both(p, np.array([-3, 0, 1, 2, 2, 57, N + 30, CAP + 9]))
    delete_both(p, np.arange(100, 160))
    snap, tsnap = JM.snapshot_tiered(be), TM.snapshot_tiered(tbe)
    assert tsnap.n == snap.n
    np.testing.assert_array_equal(tsnap.rows, snap.rows)
    np.testing.assert_array_equal(tsnap.alive, snap.alive)
    # the window: two insert batches (8 copies of one vector in the
    # second, so reverse edges collide), deletions of old and new ids
    (_, r1), (_, t1) = insert_both(p, ints(rng, 24), 12)
    dup = np.concatenate([np.repeat(ints(rng, 1), 8, 0), ints(rng, 16)])
    (i2, r2), (_, t2) = insert_both(p, dup, 13)
    delete_both(p, np.concatenate([np.arange(200, 230), i2[-5:]]))
    rows = JU.consolidate_tiered(be, snapshot=snap)
    trows = TU.consolidate_tiered(tbe, snapshot=tsnap)
    np.testing.assert_array_equal(trows, rows)
    JM.merge_consolidated_tiered(be, snap, rows, [r1, r2])
    TM.merge_consolidated_tiered(tbe, tsnap, trows, [t1, t2])
    same_backend(tbe, be)
    nb = np.asarray(tbe.store.disk.nbr[:tbe.n])
    assert not ((nb >= 0) & ~tbe.alive[np.clip(nb, 0, None)]).any()
    # serial consolidation (snapshot taken and merged in place)
    delete_both(p, np.arange(300, 320))
    np.testing.assert_array_equal(TU.consolidate_tiered(tbe),
                                  JU.consolidate_tiered(be))
    same_backend(tbe, be)
    assert tbe.deleted_fraction() == pytest.approx(
        float((~be.alive[:be.n]).mean()))
    # a PQ-lane search with a warm topology cache over the merged index
    q = ints(rng, 6)
    topo = JC.warm_topo_cache(be, 0)
    ttopo = TC.warm_topo_cache(tbe, 0, device="cpu")
    want = jax_search_tiered(be, p["hp"], q, 5, JaxSearchParams(*SP),
                             pq=be.pq, rerank_depth=SP.pool, topo=topo)
    got = search_tiered(tbe, p["thp"], q, 5, SP, pq=tbe.pq,
                        rerank_depth=SP.pool, topo=ttopo, device="cpu")
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_reverse_edge_rows_host_conflicts_keep_the_last_write():
    trow = np.array([[5, -1, -1, 7], [1, 2, 3, 4]], np.int32)
    tvec = np.zeros((2, 2), np.float32)
    nbr_vecs = np.ones((2, 4, 2), np.float32)
    inv = np.array([0, 0, 0, 1, 1])
    new_ids = np.array([40, 41, 42, 43, 44])
    d = np.array([9, 9, 9, 0.5, 3], np.float32)
    got = TU.reverse_edge_rows_host(trow, tvec, nbr_vecs, inv, new_ids, d)
    want = JU.reverse_edge_rows_host(trow, tvec, nbr_vecs, inv, new_ids, d)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[5, 42, -1, 7], [43, 2, 3, 4]])
    assert trow[0, 1] == -1                      # the input is not mutated


def test_insert_tiered_refuses_what_is_not_ported(pair):
    with pytest.raises(NotImplementedError, match="A.9"):
        TU.insert_tiered(pair["tbe"], pair["thp"], ints(pair["rng"], 2), SP,
                         0, attributes={"tag": [1, 2]}, device="cpu")
    with pytest.raises(ValueError, match="full"):
        TU.insert_tiered(pair["tbe"], pair["thp"], ints(pair["rng"], CAP),
                         SP, 0, device="cpu")


# ---------------------------------------------------------------------------
# engines of both packages, op by op
# ---------------------------------------------------------------------------

def _engine_kw(tmp, tag, **kw):
    return dict(degree=16, cache_slots=128, capacity=4096,
                disk_path=str(tmp / tag), disk_capacity=4096,
                host_window=375, seed=3, wal_enabled=False, coalesce=False,
                prefetch=False, spec_rank="flam", consolidate_threshold=2.0,
                **kw)


def test_three_tier_engine_write_path_matches_reference_engine(tmp_path):
    rng = np.random.default_rng(4)
    vecs = ints(rng, 1200, 16)
    sp = dict(k=10, pool=32, max_iters=48)
    je = JE.SVFusionEngine(vecs, JE.EngineConfig(
        search=JaxSearchParams(**sp), **_engine_kw(tmp_path, "j")))
    te = TE.SVFusionEngine(vecs, TE.EngineConfig(
        search=SearchParams(**sp), device="cpu", **_engine_kw(tmp_path, "t")))
    try:
        ops = [("insert", ints(rng, 300, 16)), ("delete", np.arange(0, 150)),
               ("search", ints(rng, 9, 16)), ("consolidate", None),
               ("insert", ints(rng, 40, 16)), ("delete", np.arange(1200, 1210)),
               ("search", ints(rng, 5, 16))]
        for op, arg in ops:
            if op == "insert":
                np.testing.assert_array_equal(te.insert(arg, chunk=128),
                                              je.insert(arg, chunk=128))
            elif op == "delete":
                te.delete(arg)
                je.delete(arg)
            elif op == "consolidate":
                te.consolidate_async(wait=True)
                je.consolidate_async(wait=True)
            else:
                a, b = je.search(arg), te.search(arg)
                np.testing.assert_array_equal(b[0], a[0])
                np.testing.assert_array_equal(b[1], a[1])
            same_backend(te._backend, je._backend)
        sj, st = je.stats(), te.stats()
        for k in ("n", "alive", "consolidations", "accesses", "hits",
                  "promotions", "host_hits", "disk_reads"):
            assert st[k] == sj[k], k
        assert st["consolidations"] == 1
        assert len(te.latencies["insert"]) == len(te.latencies["delete"]) == 2
    finally:
        je.close()
        te.close()


def test_three_tier_pq_engine_installs_inserted_rows(tmp_path):
    """PQ lane with the topology cache at full residency: inserted rows
    are installed at once, so the next search finds them resident."""
    rng = np.random.default_rng(5)
    eng = TE.SVFusionEngine(ints(rng, 500, 16), TE.EngineConfig(
        search=SearchParams(k=10, pool=32, max_iters=48), pq_enabled=True,
        pq_m=4, pq_bits=6, device="cpu", **_engine_kw(tmp_path, "t")))
    try:
        newv = ints(rng, 40, 16)
        ids = eng.insert(newv)
        topo = eng._backend.topo
        assert (topo.h2s[ids] >= 0).all()
        np.testing.assert_array_equal(topo.rows[topo.h2s[ids]],
                                      eng._backend.store.peek_rows(ids))
        found, _ = eng.search(newv)
        assert float((found[:, 0] == ids).mean()) > 0.9
        eng.delete(ids[:10])
        found, _ = eng.search(newv)
        assert not np.isin(ids[:10], found).any()
        assert eng.stats()["pq_encoded_incremental"] == 40
        with pytest.raises(NotImplementedError, match="A.8"):
            eng.checkpoint()
        with pytest.raises(NotImplementedError, match="A.9"):
            eng.insert(newv, attributes={"t": np.zeros(40)})
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the reference's MVCC protocols (tests/test_tiered.py) against the port
# ---------------------------------------------------------------------------

NP_, DP = 3000, 24


@pytest.fixture(scope="module")
def dataset():
    return np.random.default_rng(0).normal(size=(NP_, DP)).astype(np.float32)


def make_engine(path, dataset, **kw):
    return TE.SVFusionEngine(dataset, TE.EngineConfig(
        degree=16, cache_slots=256, capacity=8192, disk_path=str(path),
        disk_capacity=8192, host_window=700, wal_enabled=False,
        search=SearchParams(k=10, pool=64, max_iters=96), device="cpu", **kw))


def test_mvcc_protocol_no_lost_writes(tmp_path, dataset):
    """Inserts and deletes land in the window between snapshot and merge;
    after the merge every acknowledged write survives: new vertices keep
    their rows and reverse edges (both window batches replayed), window
    deletions are authoritative, and e_in matches the rows."""
    eng = make_engine(tmp_path / "tier", dataset, consolidate_threshold=2.0)
    try:
        rng = np.random.default_rng(7)
        be = eng._backend
        eng.delete(np.arange(0, 500))
        snap = TM.snapshot_tiered(be)
        newv = rng.normal(size=(40, DP)).astype(np.float32)
        ids, rev = TU.insert_tiered(be, eng._placement, newv,
                                    eng.cfg.search, seed=11, device="cpu")
        newv2 = rng.normal(size=(40, DP)).astype(np.float32)
        ids2, rev2 = TU.insert_tiered(be, eng._placement, newv2,
                                      eng.cfg.search, seed=12, device="cpu")
        eng.delete(np.arange(500, 560))
        win_dead = np.arange(500, 560)
        eng.delete(ids2[-8:])
        ids2, newv2 = ids2[:-8], newv2[:-8]
        new_rows = TU.consolidate_tiered(be, snapshot=snap)
        TM.merge_consolidated_tiered(be, snap, new_rows, [rev, rev2])
        assert be.alive[ids].all() and be.alive[ids2].all()
        _, rows = be.store.peek(np.arange(be.n))
        assert np.isin(ids, rows[:snap.n]).any()
        assert np.isin(ids2, rows[:snap.n]).any()
        found, _ = eng.search(newv)
        assert float((found[:, 0] == ids).mean()) > 0.9
        found2, _ = eng.search(newv2)
        assert float((found2[:, 0] == ids2).mean()) > 0.9
        assert not be.alive[win_dead].any()
        assert (rows[win_dead] == -1).all()
        assert not ((rows >= 0) & ~be.alive[np.clip(rows, 0, None)]).any()
        e_in = np.zeros((be.capacity,), np.int32)
        np.add.at(e_in, rows[rows >= 0], 1)
        np.testing.assert_array_equal(e_in, be.e_in)
    finally:
        eng.close()


def test_mvcc_concurrent_consolidation(tmp_path, dataset):
    """A consolidation overlapping live inserts, deletes and searches
    loses no acknowledged write, and recall matches a serial run."""
    rng = np.random.default_rng(9)
    queries = rng.normal(size=(32, DP)).astype(np.float32)
    inserts = [rng.normal(size=(32, DP)).astype(np.float32)
               for _ in range(4)]

    def run(tag, overlap):
        eng = make_engine(tmp_path / tag, dataset, consolidate_threshold=2.0)
        try:
            eng.delete(np.arange(0, 600))
            th = eng.consolidate_async(wait=not overlap)
            acked = []
            for part in inserts:
                acked.append(eng.insert(part))
                eng.search(queries)
                eng.delete(np.arange(600, 610))
            th.join()
            eng.wait_background()
            be = eng._backend
            for ids, part in zip(acked, inserts):
                assert be.alive[ids].all(), f"{tag}: lost inserted ids"
                found, _ = eng.search(part)
                assert float((found[:, 0] == ids).mean()) > 0.9, tag
            assert not be.alive[:610].any()
            assert eng.stats()["consolidations"] == 1
            found, _ = eng.search(queries)
            mirror = np.concatenate([np.arange(610, NP_)] + acked)
            mvecs = np.concatenate([dataset[610:]] + inserts)
            d = ((queries[:, None, :] - mvecs[None]) ** 2).sum(-1)
            truth = mirror[np.argsort(d, axis=1)[:, :10]]
            return float((found[:, :10, None] == truth[:, None, :])
                         .any(1).mean())
        finally:
            eng.close()

    rec_serial = run("serial", overlap=False)
    rec_conc = run("conc", overlap=True)
    assert rec_conc >= 0.8
    assert rec_conc >= rec_serial - 0.05, (rec_conc, rec_serial)


def test_multi_stream_runner_drains_with_every_op_applied(tmp_path, dataset):
    eng = make_engine(tmp_path / "tier", dataset[:1500],
                      consolidate_threshold=2.0)
    runner = TE.MultiStreamRunner(eng, n_search_streams=3)
    rng = np.random.default_rng(1)
    try:
        runner.start()
        batches = [rng.normal(size=(20, DP)).astype(np.float32)
                   for _ in range(3)]
        for i, b in enumerate(batches):
            runner.submit_insert(b)
            runner.submit_delete(np.arange(10 * i, 10 * i + 10))
            for t in range(4):
                runner.submit_search(rng.normal(size=(4, DP)).astype(
                    np.float32), tag=f"t{t % 2}")
        runner.drain_and_stop(timeout=120)
        be = eng._backend
        assert be.n == 1500 + 60 and be.alive[1500:1560].all()
        assert not be.alive[:30].any() and be.alive[30:1500].all()
        assert len(runner.results) == 12 and not runner.shed
        assert all(ids.shape == (4, 10) for _, ids, _ in runner.results)
        assert len(eng.latencies["insert"]) == len(eng.latencies["delete"]) \
            == 3
    finally:
        eng.close()
