"""The port's tracer (``core/trace.py``): off it records nothing and the
engine's ``latencies`` fill as before; on, spans nest and carry the
native thread id, a lock records a wait only when it blocked, the ring
is bounded and counts what it could not keep, and the coalescer's
``coalesce.queue`` span runs from a request's submission to the start of
the dispatch that carries it."""
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import engine as TE
from repro_torch.core import trace
from repro_torch.core.types import SearchParams

D = 8


@pytest.fixture
def traced():
    """The process-wide tracer on for one test, off and empty after."""
    trace.enable()
    try:
        yield trace.TRACER
    finally:
        trace.disable()
        trace.drain()


def _engine(seed=0):
    rng = np.random.default_rng(seed)
    return TE.SVFusionEngine(rng.normal(size=(300, D)).astype(np.float32),
                             TE.EngineConfig(
                                 degree=8, cache_slots=64, capacity=1024,
                                 device="cpu", seed=seed,
                                 consolidate_threshold=0.2,
                                 search=SearchParams(k=5, pool=16,
                                                     max_iters=16)))


def _drive(eng, seed=1):
    """Searches from two threads, an insert and a delete past the
    consolidation threshold; returns after the background work."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(64, D)).astype(np.float32)

    def client(off):
        for j in range(3):
            eng.search(q[off + 8 * j: off + 8 * j + 8])
    ths = [threading.Thread(target=client, args=(o,)) for o in (0, 32)]
    for th in ths:
        th.start()
    eng.insert(rng.normal(size=(40, D)).astype(np.float32), chunk=16)
    eng.delete(np.arange(0, 80))
    for th in ths:
        th.join(timeout=60)
        assert not th.is_alive()
    eng.wait_background()


def test_off_records_nothing_and_latencies_fill_alike():
    trace.drain()
    assert not trace.TRACER.on
    eng = _engine()
    try:
        _drive(eng)
        off = {k: len(v) for k, v in eng.latencies.items()}
        assert trace.drain() == ([], 0)
        assert off["insert"] == off["delete"] == 1 and off["search"] >= 1
    finally:
        eng.close()
    eng = _engine()
    trace.enable()
    try:
        _drive(eng)
        eng.search(np.zeros((4, D), np.float32))     # one more dispatch
    finally:
        trace.disable()
        recs, dropped = trace.drain()
        eng.close()
    assert dropped == 0
    assert {k: len(v) for k, v in eng.latencies.items()} == dict(
        off, search=len(eng.latencies["search"]))
    for kind, lat in eng.latencies.items():
        got = [(t1 - t0) / 1e9 for n, t0, t1, _ in recs
               if n == f"engine.{kind}"]
        assert got == lat, kind        # the same clock reads, exactly
    names = {r[0] for r in recs}
    assert {"coalesce.queue", "engine.search", "engine.sync",
            "engine.insert", "engine.delete", "engine.consolidate",
            "update.e_in"} <= names


def test_engine_sync_spans_are_the_host_syncs_and_two_copies(traced):
    eng = _engine(3)
    try:
        h0 = eng.host_syncs
        eng.search(np.ones((8, D), np.float32))
        eng.search(np.ones((8, D), np.float32), update_cache=False)
    finally:
        eng.close()
    recs, _ = trace.drain()
    disp = {r[3] for r in recs if r[0] == "engine.search"}
    syncs = [r for r in recs if r[0] == "engine.sync" and r[3] in disp]
    assert len(syncs) == eng.host_syncs - h0 + 2 * 2
    # each read lies inside its dispatch's span but the dists copy, which
    # closes the dispatch after its latency is taken
    searches = sorted(r[1:3] for r in recs if r[0] == "engine.search")
    outside = [s for s in syncs
               if not any(a <= s[1] and s[2] <= b for a, b in searches)]
    assert len(outside) == 2


def test_spans_nest_and_carry_the_native_thread_id():
    tr = trace.Tracer()
    tr.enable()
    seen = {}

    def work():
        seen["tid"] = threading.get_native_id()
        with tr.span("outer"):
            with tr.span("inner"):
                time.sleep(0.01)
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    (inner, outer), dropped = tr.drain()
    assert dropped == 0 and inner[0] == "inner" and outer[0] == "outer"
    assert inner[3] == outer[3] == seen["tid"] != threading.get_native_id()
    assert outer[1] <= inner[1] < inner[2] <= outer[2]
    assert inner[2] - inner[1] >= 10_000_000


def test_span_into_times_on_and_off_and_skips_a_raise():
    tr = trace.Tracer()
    lat = []
    with tr.span("x", into=lat):
        pass
    with pytest.raises(ValueError):
        with tr.span("x", into=lat):
            raise ValueError
    assert len(lat) == 1 and lat[0] >= 0 and tr.drain() == ([], 0)
    with tr.span("x"):                          # off, no list: nothing
        pass
    assert tr.drain() == ([], 0)


def test_held_records_a_wait_only_when_it_blocked():
    tr = trace.Tracer()
    lock = threading.Lock()
    assert tr.held(lock, "l") is lock           # off: the lock itself
    tr.enable()
    with tr.held(lock, "l"):
        pass
    assert tr.drain() == ([], 0)                # not contended
    taken, hold = threading.Event(), 0.2

    def holder():
        with lock:
            taken.set()
            time.sleep(hold)
    th = threading.Thread(target=holder)
    th.start()
    assert taken.wait(10)
    with tr.held(lock, "l"):
        assert lock.locked()
    th.join(timeout=10)
    assert not lock.locked() and not th.is_alive()
    (rec,), dropped = tr.drain()
    assert rec[0] == "wait.l" and dropped == 0
    assert rec[3] == threading.get_native_id()
    assert hold * 0.75 <= (rec[2] - rec[1]) / 1e9 <= hold + 2.0


def test_ring_is_bounded_and_counts_dropped():
    tr = trace.Tracer(capacity=4)
    tr.enable()
    for i in range(10):
        tr.record("r", i, i + 1)
    recs, dropped = tr.drain()
    assert [r[1] for r in recs] == [0, 1, 2, 3] and dropped == 6
    assert tr.drain() == ([], 0)


def test_ring_counts_every_record_under_contention():
    tr = trace.Tracer(capacity=1000)
    tr.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def put():
            for i in range(500):
                tr.record("r", i, i)
        ths = [threading.Thread(target=put) for _ in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    recs, dropped = tr.drain()
    assert len(recs) == 1000 and dropped == 8 * 500 - 1000


def test_coalesce_queue_runs_from_submission_to_the_dispatch(traced):
    entered = []

    def search(q, **kw):
        entered.append(time.perf_counter_ns())
        time.sleep(0.02)                # the next requests queue meanwhile
        n = len(q)
        return np.zeros((n, 1), np.int64), np.zeros((n, 1), np.float32)
    sched = TE.CoalescingScheduler(search, max_batch=64)
    futs, tids = [], {}
    lock = threading.Lock()

    def client(c):
        for _ in range(3):
            f = sched.submit(np.zeros((2, D), np.float32))
            with lock:
                futs.append(f)
                tids[id(f)] = threading.get_native_id()
            f.result(timeout=30)
    ths = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sched.stop()
    recs = [r for r in trace.drain()[0] if r[0] == "coalesce.queue"]
    assert len(recs) == len(futs) == 12
    by_start = {r[1]: r for r in recs}
    starts = np.array(sorted(entered))
    for f in futs:
        _, t0, t1, tid = by_start[round(f.submitted * 1e9)]
        assert tid == tids[id(f)]
        # ends where the coalescer starts the dispatch, just before the
        # executor is entered
        i = np.searchsorted(starts, t1 - 1000)
        assert i < len(starts) and 0 <= starts[i] - t1 < 5_000_000
        assert t1 >= t0
