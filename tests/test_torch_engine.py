"""The port's device-mode engine on the CPU: search through the coalescer
and directly, recall, the entry draw, stats keys against the reference,
and the parts that are not ported yet."""
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core.types import SearchParams as JaxSearchParams
from repro_torch.core import engine as TE
from repro_torch.core.search import (brute_force_topk, frontier_search,
                                     recall_at_k)
from repro_torch.core.types import SearchParams

N, D, R = 3000, 24, 16
SP = SearchParams(k=10, pool=64, max_iters=96)


def cfg(**kw):
    return TE.EngineConfig(degree=R, cache_slots=384, capacity=8192,
                           search=SP, device="cpu", **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(64, D)).astype(np.float32))


@pytest.fixture(scope="module")
def engine(data):
    eng = TE.SVFusionEngine(data[0], cfg())
    yield eng
    eng.close()


def test_search_recall_through_the_coalescer(engine, data):
    _, q = data
    ids, dists = engine.search(q)
    assert ids.shape == dists.shape == (64, 10) and ids.dtype == np.int32
    truth, _ = brute_force_topk(engine.state.graph, torch.from_numpy(q), 10)
    assert float(recall_at_k(torch.from_numpy(ids), truth)) > 0.8
    assert (np.diff(dists, axis=1) >= 0).all()
    st = engine.stats()
    assert st["coalesce_requests"] >= 1
    assert st["hits"] + st["misses"] == st["accesses"] > 0


def test_direct_search_and_submit(engine, data):
    _, q = data
    before = engine.stats()["accesses"]
    ids, _ = engine.search(q[:5], update_cache=False)
    assert ids.shape == (5, 10)
    assert engine.stats()["accesses"] == before    # no placement pass
    fut = engine.submit_search(q[:7])
    ids2, d2 = fut.result(timeout=60)
    assert ids2.shape == d2.shape == (7, 10) and fut.latency > 0


def test_engine_result_is_frontier_search_on_drawn_entries(data):
    """A 48-query batch pads to 64 lanes; the engine draws the 64 x pool
    entries from a generator split off its own and runs the executor on
    the state it read. Replaying that draw gives the same answer."""
    vecs, q = data
    eng = TE.SVFusionEngine(vecs, cfg(coalesce=False, seed=5))
    try:
        st0 = eng.state
        key_state = eng._key.get_state()
        ids, dists = eng.search(q[:48])
        eng._key.set_state(key_state)
        entries = torch.randint(0, N, (64, SP.pool),
                                generator=eng._next_key(),
                                dtype=torch.int32)
        qp = torch.cat([torch.from_numpy(q[:48]), torch.zeros(16, D)])
        want = frontier_search(st0, qp, entries, SP)
        np.testing.assert_array_equal(ids, want.ids[:48].numpy())
        np.testing.assert_array_equal(dists, want.dists[:48].numpy())
        assert eng.host_syncs == want.host_syncs + 2   # n and the seed
        # the placement pass saw only the 48 real lanes
        assert eng.stats()["accesses"] == int(
            (want.acc_ids[:48] >= 0).sum())
    finally:
        eng.close()


def test_stats_keys_match_the_reference_device_mode(data, engine):
    vecs, _ = data
    ref = JE.SVFusionEngine(vecs[:400], JE.EngineConfig(
        degree=8, cache_slots=64, capacity=512,
        search=JaxSearchParams(k=10, pool=32, max_iters=32)))
    try:
        want = set(ref.stats()) - {"modeled_us_per_access"}
    finally:
        ref.close()
    assert set(engine.stats()) == want


def test_default_config_needs_a_gpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.EngineConfig()
    with pytest.raises(ValueError, match="device"):
        TE.EngineConfig(device="mps")


def test_config_keeps_every_reference_field():
    ref = set(JE.EngineConfig.__dataclass_fields__)
    port = set(TE.EngineConfig.__dataclass_fields__)
    assert port - ref == {"device"} and ref <= port


def test_unported_parts_raise(data, engine, tmp_path):
    vecs, _ = data
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.SVFusionEngine(vecs, cfg(disk_path=str(tmp_path),
                                    wal_enabled=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.SVFusionEngine(vecs, cfg(attributes=object()))
    for call in (lambda: engine.insert(vecs[:2]),
                 lambda: engine.delete([1]),
                 engine.consolidate_async, engine.checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_executor_errors_reach_the_caller(engine):
    """An exception on the coalescer's thread fails the request's future,
    as in the reference."""
    bad = np.zeros((3, D + 1), np.float32)
    with pytest.raises(RuntimeError):
        engine.search(bad)
    ids, _ = engine.search(np.zeros((2, D), np.float32))
    assert ids.shape == (2, 10)
