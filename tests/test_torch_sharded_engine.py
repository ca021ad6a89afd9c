"""One ``SVFusionEngine`` over four cards (``EngineConfig.cards``), on the
CPU at Deep1B's widths (D 96, degree 32, pool 64) and a few thousand
rows: held against four one-card engines built on ``vectors[c::4]`` with
the per-card seeds, against their answers merged by
``distributed.merge_shard_results``, against the plain exact top-k of
``svbench/reference/exact.py``, and read as ``svbench/system.py`` reads
it. The tests marked ``card`` run on the chip machine
(``PYTHONPATH=src python -m pytest tests/test_torch_sharded_engine.py -m
card``)."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import distributed
from repro_torch.core.engine import EngineConfig, SVFusionEngine
from repro_torch.core.types import SearchParams
from svbench import check, data, system
from svbench.reference.exact import sq_l2, topk_alive

CARDS, N, D, SEED = 4, 2400, 96, 2 ** 31 + 29
SP = SearchParams(k=10, pool=64, max_iters=64, beam=16)


def _draw(n, seed, dev="cpu"):
    """``n`` rows of the benchmark's synthetic descriptors (float32)."""
    gen = data.generator(SEED, dev)
    draw = data.synthetic_descriptors(gen, N, D, dev, clusters=64,
                                      intrinsic=16)
    return draw(n, data.generator(seed, dev)).cpu().numpy()


def _cfg(**kw):
    base = dict(degree=32, cache_slots=256, capacity=1024, search=SP,
                seed=SEED, device="cpu")
    base.update(kw)
    return EngineConfig(**base)


def _one_card(vectors, cfg, c):
    """The one-card engine card ``c`` of ``cfg`` should equal, on that
    card."""
    dev = f"cuda:{c}" if torch.device(cfg.device).type == "cuda" \
        else cfg.device
    return SVFusionEngine(vectors[c::cfg.cards], dataclasses.replace(
        cfg, cards=1, device=dev, seed=distributed.shard_seed(cfg.seed, c),
        coalesce=False))


def _merged(engines, queries, cards):
    """The one-card engines' answers as global ids, merged."""
    ids, dists = [], []
    for c, e in enumerate(engines):
        i, d = e.search(queries)
        ids.append(np.where(i >= 0, i.astype(np.int64) * cards + c, -1))
        dists.append(d)
    i, d = distributed.merge_shard_results(
        torch.from_numpy(np.stack(ids)), torch.from_numpy(np.stack(dists)),
        SP.k)
    return i.numpy(), d.numpy()


def _same_index(a, b):
    """Two one-card engines' published graphs and caches, field for
    field."""
    sa, sb = a.state, b.state
    for part in ("graph", "cache"):
        for name, x in getattr(sa, part)._asdict().items():
            assert torch.equal(x, getattr(getattr(sb, part), name)), \
                f"{part}.{name}"


@pytest.fixture(autouse=True)
def _one_thread():
    """On the CPU the four card workers each run torch's operators; one
    intra-op thread apiece keeps them from contending for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def built():
    vectors = _draw(N, 1)
    cfg = _cfg(cards=CARDS)
    eng = SVFusionEngine(vectors, cfg)
    ones = [_one_card(vectors, cfg, c) for c in range(CARDS)]
    yield vectors, cfg, eng, ones
    eng.close()
    for e in ones:
        e.close()


@pytest.mark.parametrize("searches", [0, 2])
def test_each_card_is_a_one_card_engine_and_answers_merge(built, searches):
    """(a) each card's graph and cache equal a one-card engine's built on
    ``vectors[c::4]`` with the card's seed; (b) after ``searches``
    dispatches the answers, mapped to global ids and merged, are
    bit-equal, and the cards' caches moved alike."""
    vectors, cfg, eng, ones = built
    for c in range(CARDS):
        assert int(eng._shards[c].state.graph.n) == len(vectors[c::CARDS])
        _same_index(eng._shards[c], ones[c])
    for s in range(searches):
        q = _draw(64 + 17 * s, 100 + s)
        ids, dists = eng.search(q)
        want_i, want_d = _merged(ones, q, CARDS)
        assert ids.dtype == np.int64 and np.array_equal(ids, want_i)
        assert np.array_equal(dists, want_d)
    for c in range(CARDS):
        _same_index(eng._shards[c], ones[c])


def test_a_stream_of_writes_routes_to_the_cards():
    """(c) odd-sized inserts and deletes, repair and consolidation on:
    ids are dense from n and never reused; an acknowledged insert finds
    itself, within the cells' ``fresh_self_miss`` limit (0.5), as the
    one-card engines' merged answers do, bit for bit; a deleted id never
    comes back; and each card equals a one-card engine fed that card's
    share of the writes and searches."""
    vectors = _draw(N, 2)
    cfg = _cfg(cards=CARDS, repair_every=3, consolidate_threshold=0.1)
    eng = SVFusionEngine(vectors, cfg)
    ones = [_one_card(vectors, cfg, c) for c in range(CARDS)]
    n, dead, seen, misses = N, np.zeros(0, np.int64), [], []
    rng = np.random.default_rng(5)
    try:
        for step, m in enumerate([37, 101, 5, 64, 1]):
            rows = _draw(m, 200 + step)
            ids = eng.insert(rows)
            assert np.array_equal(ids, np.arange(n, n + m))
            for c, e in enumerate(ones):
                if (ids % CARDS == c).any():
                    e.insert(rows[ids % CARDS == c])
            n += m
            seen.append(ids)
            found, _ = eng.search(rows)
            assert np.array_equal(found, _merged(ones, rows, CARDS)[0])
            misses.append(1.0 - (found == ids[:, None]).any(1).mean())
            gone = np.concatenate([
                rng.choice(n, 40 + 13 * step, replace=False),
                dead[:3], [-1, n, n + 7]])
            eng.delete(gone)
            ok = gone[(gone >= 0) & (gone < n)]
            for c, e in enumerate(ones):
                if (ok % CARDS == c).any():
                    e.delete(ok[ok % CARDS == c] // CARDS)
            dead = np.union1d(dead, ok)
            for e in [eng, *ones]:
                e.wait_background()
            q = np.concatenate([_draw(32, 300 + step), vectors[dead[:32]]])
            got, _ = eng.search(q)
            assert np.array_equal(got, _merged(ones, q, CARDS)[0])
            assert not np.isin(got, dead).any()
        assert max(misses) <= 0.5, misses
        all_ids = np.concatenate(seen)
        assert len(np.unique(all_ids)) == len(all_ids)
        assert sum(s._consolidations for s in eng._shards) > 0
        for c in range(CARDS):
            _same_index(eng._shards[c], ones[c])
    finally:
        eng.close()
        for e in ones:
            e.close()


def test_answers_match_the_plain_exact_top_k():
    """(d) recall@10 against ``exact.topk_alive`` at or above the
    configuration's 0.5 floor; returned distances within ``dist_gap``'s
    2e-5 of the plain float32 distance."""
    vectors = _draw(N, 3)
    eng = SVFusionEngine(vectors, _cfg(cards=CARDS))
    try:
        q = _draw(256, 400)
        ids, dists = eng.search(q)
    finally:
        eng.close()
    qt, vt = torch.from_numpy(q), torch.from_numpy(vectors)
    truth = topk_alive(qt, vt, torch.ones(len(q), N, dtype=torch.bool),
                       SP.k).numpy()
    recall = np.mean([len(np.intersect1d(a, b)) / SP.k
                      for a, b in zip(ids, truth)])
    assert recall >= 0.5, recall
    ans = check.Answers(q, np.arange(len(q)), np.zeros(len(q)),
                        np.zeros(len(q)), ids, dists, np.arange(len(q)))
    assert check.dist_gap(ans, vt, "cpu") <= 2e-5
    assert np.allclose(dists, sq_l2(qt[:, None, :], vt[ids]).numpy(),
                       rtol=2e-5, atol=0)


def test_the_harness_reads_the_cards_as_one_index():
    """(e) ``state.graph`` read through ``system.IndexView``: ``n``, the
    rows and flags by global id; ``system.counters`` and ``stats()`` add
    the cards' counters up."""
    vectors = _draw(N, 4)
    eng = SVFusionEngine(vectors, _cfg(cards=CARDS))
    try:
        rows = _draw(70, 500)
        ids = eng.insert(rows)
        eng.delete(ids[:9])
        eng.delete(np.arange(0, 1800, 3))
        eng.search(_draw(33, 501))
        eng.wait_background()
        view = system.IndexView.of_graph(eng.state.graph)
        assert view.n == N + 70
        assert np.array_equal(view.vectors(ids), rows)
        assert np.array_equal(view.vectors(np.arange(N)), vectors)
        alive = view.alive(np.arange(N + 70))
        assert not alive[ids[:9]].any() and alive[ids[9:]].all()
        assert not alive[:1800:3].any() and alive[1:1800:3].all()
        assert check.lost_writes(view, [(ids, rows)],
                                 [ids[:9], np.arange(0, 1800, 3)]) == 0
        got = system.counters(eng)
        shards = eng._shards
        assert got["consolidations"] == sum(s._consolidations
                                            for s in shards) > 0
        assert got["host_syncs"] == sum(s.host_syncs for s in shards) > 0
        assert got["spec_hits"] == got["spec_misses"] == 0
        assert got["search_latencies"] == len(eng.latencies["search"]) == 1
        assert got["coalesce_dispatches"] == 1 and got["coalesce_queries"] \
            == 33
        assert eng._backend is eng._placement is eng._wal is None
        st = eng.stats()
        assert [s["dispatches"] for s in st["shards"]] == [1] * CARDS
        assert st["alive"] == sum(s["alive"] for s in st["shards"]) \
            == int(alive.sum())
        assert st["n"] == N + 70 and st["consolidations"] == \
            got["consolidations"]
        assert st["accesses"] == sum(int(s.state.stats.accesses)
                                     for s in shards) > 0
    finally:
        eng.close()


@pytest.mark.parametrize("kw", [dict(cards=4, disk_path="index"),
                                dict(cards=0)])
def test_cards_outside_device_mode_raise(kw, tmp_path):
    """(f) the three-tier mode holds one index, so ``cards > 1`` there
    raises, naming the field; so does no card at all."""
    if "disk_path" in kw:
        kw["disk_path"] = str(tmp_path / kw["disk_path"])
    with pytest.raises(ValueError, match="cards"):
        _cfg(**kw)


def test_cards_consolidate_one_at_a_time(monkeypatch):
    """Every card past the threshold takes its snapshot at once, and the
    cards' consolidations then run one after another: each card
    consolidates once and no two overlap."""
    from repro_torch.core import update
    vectors = _draw(N, 8)
    eng = SVFusionEngine(vectors, _cfg(cards=CARDS,
                                       consolidate_threshold=0.99))
    running, most, done = [0], [0], []
    lock = threading.Lock()
    plain = update.consolidate

    def consolidate(state, **kw):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.05)
        try:
            return plain(state, **kw)
        finally:
            with lock:
                running[0] -= 1
                done.append(state.graph.nbrs.shape)
    monkeypatch.setattr(update, "consolidate", consolidate)
    try:
        eng.delete(np.arange(0, N, 3))
        threads = eng.consolidate_async()
        assert len(threads) == CARDS and all(threads)
        assert all(s._snapshot_n is not None for s in eng._shards)
        eng.wait_background()
    finally:
        eng.close()
    assert most[0] == 1 and len(done) == CARDS
    assert [s._consolidations for s in eng._shards] == [1] * CARDS


def test_spans_of_the_fan_out_and_the_routing():
    """``shard.search`` once a card a dispatch, ``wait.shard`` and
    ``shard.merge`` once a dispatch, ``shard.route`` once a card an
    insert or delete, the card's share on the card's workers."""
    vectors = _draw(N, 6)
    eng = SVFusionEngine(vectors, _cfg(cards=CARDS))
    tracer = eng.tracer
    try:
        eng.search(_draw(8, 600))
        tracer.enable()
        eng.search(_draw(16, 601))
        eng.search(_draw(16, 602))
        eng.insert(_draw(6, 603))
        eng.delete(np.arange(8))
        records, dropped = tracer.drain()
    finally:
        tracer.disable()
        eng.close()
    assert dropped == 0
    names = [r[0] for r in records]
    assert names.count("engine.search") == 2
    assert names.count("shard.search") == 2 * CARDS
    assert names.count("shard.merge") == names.count("wait.shard") == 2
    assert names.count("shard.route") == 2 * CARDS
    me = threading.get_native_id()
    card_tids = {r[3] for r in records if r[0] == "shard.search"}
    assert len(card_tids) == CARDS and me not in card_tids
    # the merge on the thread that dispatched; a card's share of a search
    # and of a write on that card's workers
    dispatcher = {r[3] for r in records if r[0] == "engine.search"}
    assert {r[3] for r in records if r[0] in ("shard.merge", "wait.shard")} \
        == dispatcher
    routes = {r[3] for r in records if r[0] == "shard.route"}
    assert me not in routes and len(routes) >= CARDS


def test_concurrent_searches_and_writes():
    """More searching threads than cores and a writer, the interpreter
    switching threads often: no request fails, ids stay dense and
    unique, and no answer holds an id deleted before it was asked."""
    vectors = _draw(N, 7)
    eng = SVFusionEngine(vectors, _cfg(cards=CARDS, repair_every=2,
                                       consolidate_threshold=0.1))
    stop = threading.Event()
    errors, answers, deletes, written = [], [], [], []
    pool = _draw(512, 700)

    def searcher(i):
        j = 0
        while not stop.is_set():
            ts = time.perf_counter()
            try:
                ids, _ = eng.search(pool[(i * 64 + j) % 448:][:64])
            except Exception as e:   # counted, the test fails on it
                errors.append(e)
                return
            answers.append((ts, ids))
            j += 7

    def writer():
        oldest = 0
        for step in range(6):
            try:
                written.append(eng.insert(_draw(48, 800 + step)))
                gone = np.arange(oldest, oldest + 48)
                eng.delete(gone)
                deletes.append((time.perf_counter(), gone))
                oldest += 48
            except Exception as e:   # counted, the test fails on it
                errors.append(e)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=searcher, args=(i,))
               for i in range(8)]
    w = threading.Thread(target=writer)
    try:
        for th in threads + [w]:
            th.start()
        w.join(timeout=120)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        eng.wait_background()
    finally:
        stop.set()
        sys.setswitchinterval(old)
        eng.close()
    assert not w.is_alive() and not any(th.is_alive() for th in threads)
    assert not errors, errors
    ids = np.concatenate(written)
    assert np.array_equal(ids, np.arange(N, N + len(ids)))
    assert answers
    for ts, got in answers:
        dead = [g for t, g in deletes if t < ts]
        if dead:
            assert not np.isin(got, np.concatenate(dead)).any()


# -- on the card --------------------------------------------------------

def _kernel_cases(dev):
    """One small launch of each of the five kernels on ``dev``, with the
    plain version to hold it to: (name, kernel call, plain call)."""
    from repro_torch.kernels.e_in_count.kernel import e_in_count
    from repro_torch.kernels.l2_gather.kernel import l2_gather
    from repro_torch.kernels.pq_adc.kernel import pq_adc
    from repro_torch.kernels.row_gather.kernel import row_gather
    from repro_torch.kernels.topk_merge.kernel import topk_merge
    from repro_torch.kernels import ops
    g = torch.Generator(device="cpu").manual_seed(3)

    def on(*ts):
        return [t.to(dev) for t in ts]
    table = torch.randn(512, D, generator=g)
    ids = torch.randint(-1, 512, (8, 64), generator=g, dtype=torch.int32)
    q = torch.randn(8, D, generator=g)
    codes = torch.randint(0, 256, (512, 16), generator=g).to(torch.uint8)
    lut = torch.rand(8, 16, 256, generator=g)
    rows = torch.randint(-1, 512, (128, 32), generator=g, dtype=torch.int32)
    h2s = torch.randint(-1, 128, (512,), generator=g, dtype=torch.int32)
    pool_d = torch.sort(torch.rand(8, 64, generator=g), 1)[0]
    pool_i = torch.randint(0, 512, (8, 64), generator=g, dtype=torch.int32)
    pool_v = torch.rand(8, 64, generator=g) < 0.5
    new_d = torch.rand(8, 32, generator=g)
    new_i = torch.randint(0, 512, (8, 32), generator=g, dtype=torch.int32)
    return [
        ("l2_gather", lambda: l2_gather(*on(table, ids, q)),
         lambda: ops.l2_gather_ref(table, ids, q)),
        ("pq_adc", lambda: pq_adc(*on(codes, lut, ids)),
         lambda: ops.pq_adc_ref(codes, lut, ids)),
        ("row_gather", lambda: row_gather(*on(rows, h2s, ids)),
         lambda: ops.row_gather_ref(rows, h2s, ids)),
        ("topk_merge", lambda: topk_merge(*on(pool_d, pool_i, pool_v,
                                              new_d, new_i)),
         lambda: ops.topk_merge_ref(pool_d, pool_i, pool_v, new_d, new_i)),
        ("e_in_count", lambda: e_in_count(*on(rows), 512),
         lambda: ops.e_in_count_ref(rows, 512)),
    ]


@pytest.mark.card(chips=4)
def test_launchers_leave_the_current_card(card):
    """A launch of each kernel on card 1 from a thread whose current card
    is 0 leaves card 0 current, and matches the plain version."""
    out = {}

    def run():
        torch.cuda.set_device(0)
        for name, kernel, plain in _kernel_cases(torch.device("cuda", 1)):
            got = kernel()
            torch.cuda.synchronize(1)
            out[name] = (torch.cuda.current_device(), got, plain())
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=600)
    assert not th.is_alive() and len(out) == 5, sorted(out)
    for name, (current, got, want) in out.items():
        assert current == 0, name
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g_, w_ in zip(got, want):
            assert g_.device == torch.device("cuda", 1), name
            torch.testing.assert_close(g_.cpu(), w_, rtol=1e-5, atol=1e-5,
                                       msg=name)


@pytest.mark.card(chips=4)
def test_cards_match_four_one_card_engines_on_the_card(card):
    """At the cell's widths and engine settings
    (``svbench/configs/deep1b_sharded4.json``), 65,536 rows a card: each
    card's graph equals a one-card engine's, and one 1,024-query batch,
    with each card's entries drawn from its seed on both sides, answers
    bit for bit as the merge of the four one-card engines."""
    import json
    from pathlib import Path
    spec = json.loads((Path(__file__).resolve().parents[1] / "svbench" /
                       "configs" / "deep1b_sharded4.json").read_text())
    cards = spec["engine"]["cards"]
    n = 65536 * cards
    home = torch.device("cuda", 0)
    gen = data.generator(SEED, home)
    draw = data.synthetic_descriptors(gen, n, spec["dim"], home,
                                      clusters=spec["clusters"],
                                      intrinsic=spec["intrinsic"])
    vectors = draw(n)
    queries = draw(1024, data.generator(SEED + 1, home)).cpu().numpy()
    cfg = system.engine_config(spec, SEED, "cuda")
    ones = [_one_card(vectors, cfg, c) for c in range(cards)]
    eng = SVFusionEngine(vectors, cfg)
    try:
        for c in range(cards):
            _same_index(eng._shards[c], ones[c])
        ids, dists = eng.search(queries)
        want_i, want_d = _merged(ones, queries, cards)
        assert torch.cuda.current_device() == 0
    finally:
        eng.close()
        for e in ones:
            e.close()
    assert np.array_equal(ids, want_i)
    assert np.array_equal(dists, want_d)
