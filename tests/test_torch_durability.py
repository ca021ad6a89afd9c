"""The port's durability layer (``repro_torch.core.wal``) against the
reference's (``repro.core.wal``): record framing byte for byte, torn
tails, CRC stops, group commit, a poisoned log, the manifest contract,
the read-only mode, checkpoint rotation, a manifest from before the
attribute store, directories published by either package recovered by
the other, and the crash matrix: a child process is killed with
``os._exit(137)`` at a named crash point, reopened, and its digest
compared with an uninterrupted run of the durable record prefix.

The crash child is this file run as a script (``__main__`` below): it
imports the port only. Tier-1 runs the reference's ``TIER1_COMBOS``; set
``SVF_DURABILITY_FULL=1`` for the rest of its matrix."""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import wal as TW                      # noqa: E402

N, D, N0 = 768, 16, 256
SEARCH_SEED = 4242
CRASH_EXIT = 137

# the reference's workloads (tests/faultinject.py), held equal below
WORKLOADS = {
    "insert_heavy": [
        ("insert", (256, 288)), ("insert", (288, 320)), ("insert", (320, 352)),
        ("checkpoint", None),
        ("insert", (352, 384)), ("insert", (384, 416)), ("insert", (416, 448)),
    ],
    "delete_heavy": [
        ("insert", (256, 320)), ("delete", (10, 40)), ("insert", (320, 384)),
        ("delete", (300, 330)),
        ("checkpoint", None),
        ("delete", (50, 80)), ("insert", (384, 448)),
    ],
    "consolidation": [
        ("insert", (256, 320)), ("delete", (0, 64)), ("delete", (100, 164)),
        ("consolidate", None), ("insert", (320, 384)),
    ],
}
WORKLOADS["insert_heavy_pq"] = WORKLOADS["insert_heavy"]
WORKLOADS["consolidation_pq"] = WORKLOADS["consolidation"]
WORKLOADS["insert_heavy_attrs"] = WORKLOADS["insert_heavy"]


# ---------------------------------------------------------------------------
# the crash child's half: the port alone
# ---------------------------------------------------------------------------

def dataset() -> np.ndarray:
    return np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)


def attrs_for(lo: int, hi: int) -> dict:
    ids = np.arange(lo, hi)
    return {"cat": ids % 4, "score": ((ids % 97) / 97).astype(np.float32)}


def make_config(disk_path, pq, attrs=False, **over):
    """``faultinject.make_config`` for the port, on the CPU, with
    ``wal_enabled`` at its default (on)."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.filters import AttributeSchema
    from repro_torch.core.types import SearchParams
    schema = AttributeSchema(tag_fields=("cat",), num_fields=("score",)) \
        if attrs else None
    kw = dict(
        attributes=schema, degree=8, cache_slots=64, capacity=2048,
        search=SearchParams(k=8, pool=32, max_iters=32),
        disk_path=str(disk_path), disk_capacity=2048, host_window=96,
        seed=0, prefetch=False, speculate=False, coalesce=False,
        cache_dtype="fp32", consolidate_threshold=2.0, wal_group_commit=4,
        snapshot_every_epochs=0, pq_enabled=pq, pq_m=4, pq_bits=6,
        pq_train_sample=512, rerank_depth=32, device="cpu")
    kw.update(over)
    return EngineConfig(**kw)


def arm(name: str, hits: int = 1) -> None:
    state = {"count": 0}

    def hook(point: str) -> None:
        if point == name:
            state["count"] += 1
            if state["count"] >= hits:
                os._exit(CRASH_EXIT)

    TW.set_crash_hook(hook)


def expected_records(ops, crash_point: str, crash_op: int) -> int:
    k = sum(1 for kind, _ in ops[:crash_op] if kind != "checkpoint")
    if crash_point in ("post_wal_append", "mid_memmap_write",
                       "mid_consolidation_merge"):
        k += 1
    return k


def run_ops(eng, data, ops, *, crash_op=None, crash_point=None,
            max_records=None) -> int:
    done = 0
    for i, (kind, arg) in enumerate(ops):
        if max_records is not None:
            if kind == "checkpoint":
                continue
            if done >= max_records:
                break
        if crash_op is not None and i == crash_op:
            arm(crash_point)
        if kind == "insert":
            attrs = (attrs_for(*arg) if eng._backend.attrs is not None
                     else None)
            eng.insert(data[arg[0]:arg[1]], attributes=attrs)
        elif kind == "delete":
            eng.delete(np.arange(arg[0], arg[1]))
        elif kind == "consolidate":
            eng._consolidate_tiered_async(wait=True)
        elif kind == "checkpoint":
            eng.checkpoint()
        if kind != "checkpoint":
            done += 1
    return done


def dump_digest(eng, out_path: str, last_seq: int) -> None:
    """Search results plus every host structure recovery rebuilds."""
    from repro_torch.core import quant
    from repro_torch.core.filters import FilterSpec
    from repro_torch.core.search import search_tiered
    from repro_torch.core.types import SearchParams
    b = eng._backend
    n = int(b.n)
    q = np.random.default_rng(SEARCH_SEED).normal(size=(8, D)) \
        .astype(np.float32)
    sp = SearchParams(k=8, pool=32, max_iters=32)
    res = search_tiered(b, eng._placement, q, SEARCH_SEED, sp,
                        speculate=False, device="cpu")
    ids = np.arange(n)
    arrays = dict(ids=res.ids, dists=res.dists, nbr=b.store.peek_rows(ids),
                  vec=b.store.peek(ids)[0], alive=b.alive[:n].copy(),
                  e_in=b.e_in.copy(), version=b.version.copy(),
                  n=np.asarray(n, np.int64),
                  last_seq=np.asarray(int(last_seq), np.int64))
    if b.pq is not None:
        arrays["pq_codes"] = b.pq.codes[:n].copy()
        arrays["pq_centroids"] = quant.codebook_to_array(b.pq.codebook)
    if b.attrs is not None:
        arrays["attr_tags"], arrays["attr_nums"] = b.attrs.snapshot(n)
        fres = search_tiered(b, eng._placement, q, SEARCH_SEED, sp,
                             speculate=False, device="cpu",
                             filter=FilterSpec(tags={"cat": {0, 2}}))
        arrays["filt_ids"], arrays["filt_dists"] = fres.ids, fres.dists
    np.savez(out_path, **arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="crash-matrix child process")
    ap.add_argument("workload", choices=sorted(WORKLOADS))
    ap.add_argument("mode", choices=["crash", "reopen", "clean"])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--out")
    ap.add_argument("--crash-point", choices=TW.CRASH_POINTS)
    ap.add_argument("--crash-op", type=int)
    ap.add_argument("--records", type=int)
    a = ap.parse_args(argv)

    from repro_torch.core.engine import SVFusionEngine
    data = dataset()
    ops = WORKLOADS[a.workload]
    with_attrs = a.workload.endswith("_attrs")
    cfg = make_config(a.dir, pq=a.workload.endswith("_pq"), attrs=with_attrs)
    init_attrs = attrs_for(0, N0) if with_attrs else None
    if a.mode == "crash":
        eng = SVFusionEngine(data[:N0], cfg, init_attrs=init_attrs)
        run_ops(eng, data, ops, crash_op=a.crash_op,
                crash_point=a.crash_point)
        return 3                        # the armed crash never fired
    if a.mode == "reopen":
        eng = SVFusionEngine(None, cfg)
        dump_digest(eng, a.out, int(eng.stats()["recovered_to_seq"]))
        eng.close()
        return 0
    eng = SVFusionEngine(data[:N0], cfg, init_attrs=init_attrs)
    done = run_ops(eng, data, ops, max_records=a.records)
    if done != a.records:
        print(f"clean run executed {done} record ops, wanted {a.records}",
              file=sys.stderr)
        return 4
    dump_digest(eng, a.out, a.records)
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

# ---------------------------------------------------------------------------
# the tests: the port against the reference
# ---------------------------------------------------------------------------

import pytest                                               # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
import faultinject                                          # noqa: E402
from repro.core import quant as JQ                          # noqa: E402
from repro.core import update as JU                         # noqa: E402
from repro.core import wal as JW                            # noqa: E402
from repro.core.build import build_tiered_backend as jax_build  # noqa: E402
from repro.core.cache import HostPlacement as JaxPlacement  # noqa: E402
from repro.core.filters import AttributeSchema as JaxSchema  # noqa: E402
from repro.core.filters import FilterSpec as JaxFilterSpec  # noqa: E402
from repro.core.search import search_tiered as jax_search   # noqa: E402
from repro.core.tiers import AttributeStore as JaxAttrs     # noqa: E402
from repro.core.types import SearchParams as JaxSP          # noqa: E402
from repro_torch.core import update as TU                   # noqa: E402
from repro_torch.core.build import build_tiered_backend     # noqa: E402
from repro_torch.core.cache import HostPlacement            # noqa: E402
from repro_torch.core.engine import (ReadOnlyEngineError,   # noqa: E402
                                     SVFusionEngine)
from repro_torch.core.filters import AttributeSchema, FilterSpec  # noqa: E402
from repro_torch.core.quant import PQCodes, codebook_from_array  # noqa: E402
from repro_torch.core.search import search_tiered           # noqa: E402
from repro_torch.core.tiers import AttributeStore           # noqa: E402
from repro_torch.core.types import SearchParams             # noqa: E402
from test_durability import FULL_COMBOS, TIER1_COMBOS       # noqa: E402


def test_workloads_are_the_reference_harness():
    assert WORKLOADS == faultinject.WORKLOADS
    assert (N, D, N0, SEARCH_SEED, CRASH_EXIT) == (
        faultinject.N, faultinject.D, faultinject.N0,
        faultinject.SEARCH_SEED, faultinject.CRASH_EXIT)
    np.testing.assert_array_equal(dataset(), faultinject.dataset())
    for k, v in attrs_for(3, 40).items():
        np.testing.assert_array_equal(v, faultinject.attrs_for(3, 40)[k])
    for point in TW.CRASH_POINTS:
        for i in range(len(WORKLOADS["delete_heavy"])):
            assert expected_records(WORKLOADS["delete_heavy"], point, i) \
                == faultinject.expected_records(
                    WORKLOADS["delete_heavy"], point, i)


def test_format_constants_are_the_reference():
    assert (TW.MAGIC, TW._HDR.format, TW.MANIFEST, TW.MANIFEST_FORMAT) == \
        (JW.MAGIC, JW._HDR.format, JW.MANIFEST, JW.MANIFEST_FORMAT)
    assert (TW.REC_INSERT, TW.REC_DELETE, TW.REC_CONSOLIDATE) == \
        (JW.REC_INSERT, JW.REC_DELETE, JW.REC_CONSOLIDATE)
    assert TW.CRASH_POINTS == JW.CRASH_POINTS


# ---------------------------------------------------------------------------
# framing and segment mechanics
# ---------------------------------------------------------------------------

def _insert_payload(rng):
    return {"ids": np.arange(40, 48, dtype=np.int64),
            "vecs": rng.normal(size=(8, 4)).astype(np.float32),
            "sel": rng.integers(-1, 40, (8, 3)).astype(np.int32),
            "rev_v": rng.integers(0, 40, 11).astype(np.int64),
            "rev_vn": rng.integers(40, 48, 11).astype(np.int64),
            "rev_d": rng.random(11).astype(np.float32),
            "tags": rng.integers(0, 4, (8, 1)).astype(np.int32),
            "nums": rng.random((8, 1)).astype(np.float32)}


@pytest.mark.parametrize("rtype,seq", [(1, 1), (2, 7), (3, 2 ** 40)])
def test_frame_is_byte_equal_to_the_reference(rtype, seq):
    rng = np.random.default_rng(rtype)
    payloads = [_insert_payload(rng), {"ids": np.arange(5)},
                {"ids": [np.arange(3), np.arange(2)],
                 "rows": [np.zeros((3, 4), np.int32),
                          np.ones((2, 4), np.int32)]}]
    for p in payloads:
        assert TW._frame(rtype, seq, p) == JW._frame(rtype, seq, p)


def test_segments_read_alike_and_torn_tails_truncate(tmp_path):
    """A port-written segment reads back identically through either
    package; a frame torn mid-body and raw garbage both stop the scan at
    the last whole record."""
    p = tmp_path / "w.log"
    w = TW.WriteAheadLog(str(p), group_commit=1)
    pay = _insert_payload(np.random.default_rng(0))
    assert w.append(TW.REC_INSERT, pay) == 1
    assert w.append(TW.REC_DELETE, {"ids": np.arange(5)}) == 2
    w.close()
    good = p.read_bytes()
    for reader in (TW.read_records, JW.read_records):
        recs, valid = reader(str(p))
        assert [(r[0], r[1]) for r in recs] == [(1, 1), (2, 2)]
        assert valid == len(good)
        for k, v in pay.items():
            np.testing.assert_array_equal(recs[0][2][k], v)
            assert recs[0][2][k].dtype == v.dtype
    torn = TW._frame(TW.REC_DELETE, 3, {"ids": np.arange(9)})[:-4]
    for tail in (torn, b"garbage!"):
        p.write_bytes(good + tail)
        recs, valid = TW.read_records(str(p))
        assert [r[1] for r in recs] == [1, 2] and valid == len(good)


def test_corrupt_record_stops_the_scan(tmp_path):
    p = tmp_path / "w.log"
    f1, f2, f3 = (TW._frame(TW.REC_DELETE, i, {"i": i}) for i in (1, 2, 3))
    bad = bytearray(f1 + f2 + f3)
    bad[len(f1) + TW._HDR.size] ^= 0x5A
    p.write_bytes(bytes(bad))
    recs, valid = TW.read_records(str(p))
    assert [r[1] for r in recs] == [1] and valid == len(f1)


def test_group_commit_counts(tmp_path):
    w = TW.WriteAheadLog(str(tmp_path / "w.log"), group_commit=3)
    for i in range(2):
        w.append(TW.REC_DELETE, {"i": i})
    assert (w.appended, w.synced, w.fsyncs) == (2, 0, 0)
    w.append(TW.REC_DELETE, {"i": 2})
    assert (w.synced, w.fsyncs) == (3, 1)
    w.append(TW.REC_DELETE, {"i": 3})
    assert w.synced == 3
    w.sync()
    assert (w.synced, w.fsyncs) == (4, 2)
    assert w.bytes == os.path.getsize(w.path)
    w.close()
    assert w.last_seq == 4 and w.closed


def test_log_is_poisoned_after_a_write_error(tmp_path):
    w = TW.WriteAheadLog(str(tmp_path / "w.log"), group_commit=1)
    w._f.close()                                   # the device fails
    with pytest.raises(TW.WALWriteError):
        w.append(TW.REC_DELETE, {"i": 0})
    assert w.failed
    with pytest.raises(TW.WALWriteError):
        w.append(TW.REC_DELETE, {"i": 1})
    with pytest.raises(TW.WALWriteError):
        w.sync()


# ---------------------------------------------------------------------------
# the engine's durability contract
# ---------------------------------------------------------------------------

def _engine(tmp_path, pq=False, attrs=False, **over):
    cfg = make_config(tmp_path / "store", pq=pq, attrs=attrs, **over)
    data = dataset()
    return SVFusionEngine(data[:N0], cfg,
                          init_attrs=attrs_for(0, N0) if attrs else None), \
        cfg, data


def test_default_config_logs_checkpoints_closes_and_recovers(tmp_path):
    """``wal_enabled`` at its default: epoch 0 at open, every update
    logged, a checkpoint, and a close that publishes, so the reopened
    engine replays nothing and searches alike."""
    eng, cfg, data = _engine(tmp_path, pq=True, attrs=True)
    assert eng.stats()["durable_epoch"] == 0
    eng.insert(data[256:320], attributes=attrs_for(256, 320))
    eng.delete(np.arange(10, 40))
    st = eng.stats()
    assert (st["wal_enabled"], st["wal_records"], st["wal_last_seq"]) == \
        (True, 2, 2)
    assert eng.checkpoint() == 1
    eng.insert(data[320:330], attributes=attrs_for(320, 330))
    q = data[:6]
    sp = SearchParams(k=8, pool=32, max_iters=32)
    kw = dict(speculate=False, device="cpu", pq=eng._backend.pq,
              topo=eng._backend.topo, rerank_depth=32)
    r1 = search_tiered(eng._backend, eng._placement, q, 99, sp, **kw)
    f1 = search_tiered(eng._backend, eng._placement, q, 99, sp,
                       filter=FilterSpec(tags={"cat": {1}}), **kw)
    nbr1 = eng._backend.store.peek_rows(np.arange(eng._backend.n))
    eng.close()
    man = TW.load_manifest(str(tmp_path / "store"))
    assert man["epoch"] == 2 and man["op_seq"] == 3 and man["attrs"]

    eng2 = SVFusionEngine(None, cfg)
    st = eng2.stats()
    assert (st["recovered_epoch"], st["recovered_replayed"],
            st["recovered_to_seq"], st["degraded"]) == (2, 0, 3, False)
    kw.update(pq=eng2._backend.pq, topo=eng2._backend.topo)
    r2 = search_tiered(eng2._backend, eng2._placement, q, 99, sp, **kw)
    f2 = search_tiered(eng2._backend, eng2._placement, q, 99, sp,
                       filter=FilterSpec(tags={"cat": {1}}), **kw)
    for a, b in ((r1, r2), (f1, f2)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
    assert f2.filter_path == "graph" and (f2.ids[f2.ids >= 0] % 4 == 1).all()
    np.testing.assert_array_equal(
        nbr1, eng2._backend.store.peek_rows(np.arange(eng2._backend.n)))
    eng2.close()


def test_reopen_without_close_replays_the_log(tmp_path):
    eng, cfg, data = _engine(tmp_path, wal_group_commit=1)
    eng.insert(data[256:320])
    eng.delete(np.arange(5, 25))
    n1 = int(eng._backend.n)
    alive1, e_in1 = eng._backend.alive[:n1].copy(), eng._backend.e_in.copy()
    eng2 = SVFusionEngine(None, cfg)             # no close: the process died
    assert eng2.stats()["recovered_replayed"] == 2
    assert int(eng2._backend.n) == n1
    np.testing.assert_array_equal(alive1, eng2._backend.alive[:n1])
    np.testing.assert_array_equal(e_in1, eng2._backend.e_in)
    eng2.close()


def test_manifest_contract_errors(tmp_path):
    eng, cfg, data = _engine(tmp_path, pq=True)
    eng.close()
    with pytest.raises(ValueError, match="recover"):
        SVFusionEngine(data[:N0], cfg)
    with pytest.raises(ValueError, match="wal"):
        SVFusionEngine(None, dataclasses.replace(cfg, wal_enabled=False))
    with pytest.raises(ValueError, match="pq_enabled"):
        SVFusionEngine(None, dataclasses.replace(cfg, pq_enabled=False))
    with pytest.raises(ValueError, match="init_attrs"):
        SVFusionEngine(None, make_config(tmp_path / "store", pq=True,
                                         attrs=True),
                       init_attrs=attrs_for(0, N0))
    with pytest.raises(ValueError, match="recover"):
        SVFusionEngine(None, dataclasses.replace(
            cfg, disk_path=str(tmp_path / "empty")))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.json").write_text('{"format": 9}')
    with pytest.raises(TW.WALCorruptionError, match="format"):
        SVFusionEngine(None, dataclasses.replace(
            cfg, disk_path=str(tmp_path / "bad")))


def test_degraded_engine_is_read_only_and_keeps_serving(tmp_path):
    eng, cfg, data = _engine(tmp_path)
    eng.insert(data[256:288])
    eng._wal._f.close()                            # the log device dies
    with pytest.raises(ReadOnlyEngineError):
        eng.insert(data[288:320])
    assert eng.stats()["degraded"]
    assert int(eng._backend.n) == 288              # the op was not applied
    ids, _ = eng.search(data[:4])
    assert ids.shape[0] == 4
    with pytest.raises(ReadOnlyEngineError):
        eng.delete(np.arange(4))
    assert eng.checkpoint() is None                # the log is gone
    eng.close()                                    # must not raise


def test_checkpoint_rotates_the_segment(tmp_path):
    eng, cfg, data = _engine(tmp_path)
    store = tmp_path / "store"
    eng.insert(data[256:288])
    assert eng.stats()["wal_records"] == 1
    assert eng.checkpoint() == 1
    man = TW.load_manifest(str(store))
    assert man["epoch"] == 1 and man["op_seq"] == 1
    eng.insert(data[288:320])
    assert eng.stats()["wal_last_seq"] == 2
    names = set(os.listdir(store))
    assert "wal-00000001.log" in names and "wal-00000000.log" not in names
    assert "snapshot-00000000.npz" not in names
    eng.close()


def test_snapshot_every_epochs_publishes_automatically(tmp_path):
    eng, cfg, data = _engine(tmp_path, snapshot_every_epochs=2)
    eng.insert(data[256:288])
    assert eng.stats()["durable_epoch"] == 0
    eng.delete(np.arange(3))
    assert eng.stats()["durable_epoch"] == 1
    eng.close()


def test_pre_attribute_manifest_recovers_with_an_empty_store(tmp_path):
    eng, cfg, data = _engine(tmp_path)
    eng.insert(data[256:288])
    eng.close()
    eng2 = SVFusionEngine(None, cfg)
    assert eng2._backend.attrs is None
    eng2.close()
    schema = AttributeSchema(tag_fields=("cat",), num_fields=("score",))
    eng3 = SVFusionEngine(None, dataclasses.replace(cfg, attributes=schema))
    a = eng3._backend.attrs
    assert a is not None and a.written == 0
    assert (a.tags[:eng3._backend.n] == 0).all()
    ids, _ = eng3.search(data[:2], filter=FilterSpec(tags={"cat": {0}}))
    assert (ids >= 0).any()
    ids, _ = eng3.search(data[:2], filter=FilterSpec(tags={"cat": {3}}))
    assert (ids == -1).all()
    nid = eng3.insert(data[288:292], attributes={"cat": np.full(4, 3),
                                                 "score": np.ones(4)})
    eng3.checkpoint()
    eng3.close()
    eng4 = SVFusionEngine(None, dataclasses.replace(cfg, attributes=schema))
    ids, _ = eng4.search(data[288:290], filter=FilterSpec(tags={"cat": {3}}))
    assert set(ids[ids >= 0].tolist()) <= set(nid.tolist())
    eng4.close()
    with pytest.raises(ValueError, match="schema mismatch"):
        SVFusionEngine(None, dataclasses.replace(
            cfg, attributes=AttributeSchema(tag_fields=("other",))))


# ---------------------------------------------------------------------------
# a directory published by either package, recovered by the other
# ---------------------------------------------------------------------------

RD, RN, RCAP, RDEG = 12, 300, 1024, 8


def _ints(rng, n):
    return rng.integers(-6, 7, (n, RD)).astype(np.float32)


def _publish_and_log(pkg, path, rng):
    """Build an integer-valued index with either package, attach a PQ
    lane on an integer codebook and an attribute store, publish epoch 0,
    then log and apply inserts with attributes, a delete, a snapshot,
    more inserts, a delete and a consolidation. The process is left
    without a close, so recovery replays the log. Returns the
    integer codebook."""
    vecs = _ints(rng, RN)
    cents = np.round(rng.normal(size=(4, 64, RD // 4)) * 4) \
        .astype(np.float32)
    tags = (np.arange(RN) % 4)[:, None].astype(np.int32)
    nums = (np.arange(RN) / RN)[:, None].astype(np.float32)
    batches = [(_ints(rng, 40), {"cat": np.arange(40) % 3,
                                 "score": np.linspace(0, 1, 40)})
               for _ in range(3)]
    dels = [rng.integers(0, RN + 40, 30), rng.integers(0, RN + 120, 25)]
    if pkg == "port":
        from repro_torch.core import mvcc as M
        from repro_torch.core import quant as Q
        be = build_tiered_backend(vecs, RDEG, str(path), disk_capacity=RCAP,
                                  host_window=100, device="cpu")
        cb = codebook_from_array(cents, "cpu")
        be.attach_pq(PQCodes(cb, RCAP, codes=Q.encode(cb, vecs)))
        schema = AttributeSchema(tag_fields=("cat",), num_fields=("score",))
        be.attach_attrs(AttributeStore(schema, RCAP, tags=tags, nums=nums,
                                       device="cpu"))
        hp = HostPlacement(RCAP, 32, RD)
        sp, W, U, kw = SearchParams(k=8, pool=16, max_iters=16), TW, TU, \
            dict(device="cpu")
    else:
        from repro.core import mvcc as M
        be = jax_build(vecs, RDEG, str(path), disk_capacity=RCAP,
                       host_window=100)
        cb = JQ.codebook_from_array(cents)
        be.attach_pq(JQ.PQCodes(cb, RCAP, codes=JQ.encode(cb, vecs)))
        schema = JaxSchema(tag_fields=("cat",), num_fields=("score",))
        be.attach_attrs(JaxAttrs(schema, RCAP, tags=tags, nums=nums))
        hp = JaxPlacement(RCAP, 32, RD)
        sp, W, U, kw = JaxSP(k=8, pool=16, max_iters=16), JW, JU, {}
    _, be.wal = W.publish_snapshot(str(path), be, None, group_commit=3)
    U.insert_tiered(be, hp, batches[0][0], sp, 1, attributes=batches[0][1],
                    **kw)
    U.delete_tiered(be, dels[0])
    snap = M.snapshot_tiered(be)
    ids2, rev2 = U.insert_tiered(be, hp, batches[1][0], sp, 2,
                                 attributes=batches[1][1], **kw)
    U.delete_tiered(be, dels[1])
    rows = U.consolidate_tiered(be, snapshot=snap)
    M.merge_consolidated_tiered(be, snap, rows, [rev2])
    _, be.wal = W.publish_snapshot(str(path), be, be.wal, group_commit=3)
    # epoch 1's log: one more insert and a delete, never published
    U.insert_tiered(be, hp, batches[2][0], sp, 3, attributes=batches[2][1],
                    **kw)
    U.delete_tiered(be, np.arange(5))
    be.wal._f.close()                 # dies: no sync, no publish
    be.store.stop()
    return cents


def _recover_both(path, tmp_path):
    """Recover copies of ``path`` with each package; returns (reference
    backend, port backend) and the reports."""
    jdir, tdir = tmp_path / "jrec", tmp_path / "trec"
    shutil.copytree(path, jdir)
    shutil.copytree(path, tdir)
    jbe, jwal, jrep = JW.recover(str(jdir), host_window=100)
    tbe, twal, trep = TW.recover(str(tdir), host_window=100, device="cpu")
    return jbe, tbe, jrep, trep


def _same_recovered(jbe, tbe):
    assert tbe.n == jbe.n
    n = tbe.n
    for f in ("alive", "e_in", "version"):
        np.testing.assert_array_equal(getattr(tbe, f), getattr(jbe, f),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(tbe.store.disk.nbr),
                                  np.asarray(jbe.store.disk.nbr))
    np.testing.assert_array_equal(np.asarray(tbe.store.disk.vec)[:n],
                                  np.asarray(jbe.store.disk.vec)[:n])
    np.testing.assert_array_equal(tbe.pq.codes, jbe.pq.codes)
    np.testing.assert_array_equal(
        tbe.pq.codebook.centroids.numpy(),
        JQ.codebook_to_array(jbe.pq.codebook))
    np.testing.assert_array_equal(tbe.attrs.tags, jbe.attrs.tags)
    np.testing.assert_array_equal(tbe.attrs.nums, jbe.attrs.nums)
    assert tbe.attrs.schema.to_meta() == jbe.attrs.schema.to_meta()
    tags_t, nums_t = tbe.attrs.synced()
    np.testing.assert_array_equal(tags_t.numpy(), tbe.attrs.tags)


def _searches_alike(jbe, tbe, rng):
    q = _ints(rng, 6)
    sp = SearchParams(k=8, pool=16, max_iters=16)
    ent = rng.integers(0, tbe.n, (6, 16))
    jhp, thp = JaxPlacement(RCAP, 32, RD), HostPlacement(RCAP, 32, RD)
    for filt in (None, ("cat", {0, 2})):
        for lane in ("exact", "pq"):
            for thresh in ((0.0, 1.1) if filt else (0.0,)):
                kw = dict(entry_ids=ent, filter_fallback_selectivity=thresh)
                want = jax_search(
                    jbe, jhp, q, 5, JaxSP(*sp),
                    pq=jbe.pq if lane == "pq" else None, rerank_depth=16,
                    filter=JaxFilterSpec(tags={filt[0]: filt[1]})
                    if filt else None, **kw)
                got = search_tiered(
                    tbe, thp, q, 5, sp, pq=tbe.pq if lane == "pq" else None,
                    rerank_depth=16, device="cpu",
                    filter=FilterSpec(tags={filt[0]: filt[1]})
                    if filt else None, **kw)
                for f in got._fields:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(got, f)),
                        np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("publisher", ["port", "reference"])
def test_cross_recovery(tmp_path, publisher):
    """A directory the port published is recovered by the reference, and
    one the reference published by the port: the same state, field by
    field, and the same ``search_tiered`` results in both lanes, with
    and without a filter, on each filter path."""
    rng = np.random.default_rng(11)
    path = tmp_path / "pub"
    _publish_and_log(publisher, path, rng)
    jbe, tbe, jrep, trep = _recover_both(path, tmp_path)
    try:
        assert jrep == trep and trep["replayed"] == 2 and trep["epoch"] == 1
        _same_recovered(jbe, tbe)
        _searches_alike(jbe, tbe, rng)
    finally:
        jbe.close()
        tbe.close()
        jbe.wal.close()
        tbe.wal.close()


def test_engines_recover_each_others_directories(tmp_path):
    """Engine level, integer data, attributes and the exact lane: the
    port's engine reopens a directory the reference's engine left
    without a close, and the other way round; each recovered engine
    equals the other package's recovery of the same directory."""
    from repro.core.engine import SVFusionEngine as JaxEngine
    rng = np.random.default_rng(2)
    data = rng.integers(-6, 7, (N, D)).astype(np.float32)
    jcfg = faultinject.make_config(str(tmp_path / "j"), pq=False,
                                   attrs=True)
    tcfg = make_config(tmp_path / "t", pq=False, attrs=True)
    for Eng, cfg in ((JaxEngine, jcfg), (SVFusionEngine, tcfg)):
        eng = Eng(data[:N0], cfg, init_attrs=attrs_for(0, N0))
        eng.insert(data[256:320], attributes=attrs_for(256, 320))
        eng.delete(np.arange(10, 40))
        eng.insert(data[320:352], attributes=attrs_for(320, 352))
        eng._backend.store.stop()         # abandoned: no close
    for src in ("j", "t"):
        for tag, Eng, cfg in (("J", JaxEngine, jcfg),
                              ("T", SVFusionEngine, tcfg)):
            shutil.copytree(tmp_path / src, tmp_path / (src + tag))
        je = JaxEngine(None, dataclasses.replace(
            jcfg, disk_path=str(tmp_path / (src + "J"))))
        te = SVFusionEngine(None, dataclasses.replace(
            tcfg, disk_path=str(tmp_path / (src + "T"))))
        try:
            assert te.stats()["recovered_replayed"] == 3
            for k in ("recovered_epoch", "recovered_replayed",
                      "recovered_to_seq", "n", "alive", "durable_epoch"):
                assert te.stats()[k] == je.stats()[k], k
            q = data[:5]
            sp = SearchParams(k=8, pool=32, max_iters=32)
            for spec in (None, ((0, 2), (0.0, 0.8))):
                f = j = None
                if spec:
                    f = FilterSpec(tags={"cat": spec[0]},
                                   ranges={"score": spec[1]})
                    j = JaxFilterSpec(tags={"cat": spec[0]},
                                      ranges={"score": spec[1]})
                got = search_tiered(te._backend, te._placement, q, 3, sp,
                                    speculate=False, filter=f,
                                    device="cpu")
                want = jax_search(je._backend, je._placement, q, 3,
                                  JaxSP(*sp), speculate=False, filter=j)
                np.testing.assert_array_equal(got.ids, want.ids)
                np.testing.assert_array_equal(got.dists, want.dists)
            np.testing.assert_array_equal(te._backend.attrs.tags,
                                          je._backend.attrs.tags)
        finally:
            je.close()
            te.close()


# ---------------------------------------------------------------------------
# the crash matrix: kill -9 -> reopen -> digest of the clean prefix
# ---------------------------------------------------------------------------

_CLEAN_DIGESTS: dict = {}


def _run_child(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__)] + [str(a) for a in args],
        env=env, capture_output=True, text=True, timeout=timeout)


def _clean_digest(tmp_path_factory, workload, records):
    key = (workload, records)
    if key not in _CLEAN_DIGESTS:
        d = tmp_path_factory.mktemp(f"clean-{workload}-{records}")
        out = d / "digest.npz"
        r = _run_child([workload, "clean", "--dir", d / "store", "--out", out,
                        "--records", records])
        assert r.returncode == 0, f"clean run failed:\n{r.stderr}"
        _CLEAN_DIGESTS[key] = str(out)
    return np.load(_CLEAN_DIGESTS[key])


def _crash_reopen_parity(tmp_path, tmp_path_factory, workload, point, op):
    ops = WORKLOADS[workload]
    store = tmp_path / "store"
    r = _run_child([workload, "crash", "--dir", store, "--crash-point",
                    point, "--crash-op", op])
    assert r.returncode == CRASH_EXIT, \
        f"expected a kill at {point}, got rc={r.returncode}:\n{r.stderr}"
    out = tmp_path / "reopen.npz"
    r = _run_child([workload, "reopen", "--dir", store, "--out", out])
    assert r.returncode == 0, f"recovery failed:\n{r.stderr}"
    dig = np.load(out)
    k = int(dig["last_seq"])
    assert k == expected_records(ops, point, op)
    clean = _clean_digest(tmp_path_factory, workload, k)
    assert set(dig.files) == set(clean.files)
    for key in clean.files:
        assert np.array_equal(dig[key], clean[key]), \
            f"{key} diverged after {point}@op{op} ({workload})"


@pytest.mark.parametrize("workload,point,op", TIER1_COMBOS)
def test_crash_recovery_parity(tmp_path, tmp_path_factory, workload, point,
                               op):
    _crash_reopen_parity(tmp_path, tmp_path_factory, workload, point, op)


@pytest.mark.skipif(not os.environ.get("SVF_DURABILITY_FULL"),
                    reason="full crash matrix: set SVF_DURABILITY_FULL=1")
@pytest.mark.parametrize("workload,point,op", FULL_COMBOS)
def test_crash_recovery_parity_full(tmp_path, tmp_path_factory, workload,
                                    point, op):
    _crash_reopen_parity(tmp_path, tmp_path_factory, workload, point, op)


def test_crash_child_imports_no_jax(tmp_path):
    """The child half of this file reaches the engine (a reopen of an
    empty directory fails inside it) without importing JAX or the
    reference package."""
    argv = ["x", "insert_heavy", "reopen", "--dir", str(tmp_path / "none"),
            "--out", str(tmp_path / "d.npz")]
    code = (f"import runpy, sys; sys.argv = {argv!r}\n"
            "try:\n"
            f"    runpy.run_path({os.path.abspath(__file__)!r}, "
            "run_name='__main__')\n"
            "except ValueError as e:\n"
            "    assert 'nothing to recover' in str(e), e\n"
            "assert 'repro_torch.core.engine' in sys.modules\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   capture_output=True)
