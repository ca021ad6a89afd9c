"""The program's spans on the profiler's clock (``svbench/spans.py``), on
the CPU: a span holds the aten op it was wrapped around after the
mapping; a thread born and ended inside a slice and a span left open
across its stop both run to their end and export; the threads, the
device time and the idle gaps on synthetic traces."""
import json
import threading

import pytest
import torch

from repro_torch.core.trace import Tracer
from svbench import spans
from svbench import trace as tr_mod


def _events(s, path):
    s.prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_a_span_holds_its_aten_op_after_the_mapping(tmp_path):
    tracer = Tracer()
    tracer.enable()
    s = tr_mod.Slice("cpu", str(tmp_path / "t.json"))
    anchors = []
    s.start()
    tid = spans.anchor(anchors)
    a = torch.randn(400, 400)

    def work():
        for _ in range(5):
            with tracer.span("probe"):
                torch.mm(a, a)
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    spans.anchor(anchors)
    s.stop()
    recs, dropped = tracer.drain()
    _, _, host, _, clock = spans.parse(_events(s, tmp_path / "e.json"))
    m = spans.map_program(recs, anchors, clock, tid, host)
    assert dropped == 0 and m["counts"] == {"probe": 5}
    assert m["threads"] == "identity" and abs(m["skew_us"]) < 100
    ((name, ttid), ivs), = m["spans"].items()
    ops = sorted(h[:2] for h in host if h[2] == "aten::mm" and h[3] == ttid)
    assert len(ops) == 5
    for (ps, pe), (hs, he) in zip(sorted(ivs), ops):
        assert ps <= hs + 50 and he - 50 <= pe          # microseconds


def test_a_short_thread_and_a_span_open_across_the_stop(tmp_path):
    """What a write cell's slice holds: a consolidation thread that starts,
    records and ends inside it, and an insert whose span closes after the
    profiler stopped. Both run to their end; the trace exports with the
    ended thread's ops, and the spans map."""
    tracer = Tracer()
    tracer.enable()
    s = tr_mod.Slice("cpu", str(tmp_path / "t.json"))
    a = torch.randn(200, 200)
    opened, release = threading.Event(), threading.Event()

    def short():
        with tracer.span("engine.consolidate"):
            for _ in range(3):
                with tracer.span("update.e_in"):
                    torch.zeros(64, dtype=torch.int32).index_add_(
                        0, torch.arange(64) % 8,
                        torch.ones(64, dtype=torch.int32))
                torch.mm(a, a)

    def long():
        with tracer.span("engine.insert"):
            torch.mm(a, a)
            opened.set()
            release.wait(30)
            torch.mm(a, a)
    anchors = []
    lt = threading.Thread(target=long)
    s.start()
    tid = spans.anchor(anchors)
    lt.start()
    assert opened.wait(30)
    st = threading.Thread(target=short)
    st.start()
    st.join(timeout=60)
    assert not st.is_alive()
    spans.anchor(anchors)
    s.stop()
    release.set()
    lt.join(timeout=60)
    assert not lt.is_alive()
    recs, dropped = tracer.drain()
    assert dropped == 0 and len(recs) == 5
    events = _events(s, tmp_path / "e.json")
    _, _, host, _, _ = spans.parse(events)
    short_tid = {r[3] for r in recs if r[0] == "engine.consolidate"}.pop()
    assert any(h[3] == short_tid and h[2] == "aten::index_add_"
               for h in host)                   # the ended thread's ops
    out = spans.summarize(events, anchors, tid, recs)
    assert out["threads"] == "identity"
    assert out["counts"] == {"engine.consolidate": 1, "update.e_in": 3,
                             "engine.insert": 1}
    assert out["device_s"] == {} and out["idle_gaps_by_span"] == []


def test_threads_matched_where_the_trace_names_them_otherwise():
    """Program tids 101 (a dispatcher: spans over [0, 1] and [2, 3] ms)
    and 202 (a consolidation over [0, 3] ms); the trace's threads 7 and 8
    run ops inside 101's and only 202's spans. The clock ranges' thread is
    not the anchoring thread's id, so the threads are matched."""
    anchors = [(0, 2), (10_000_000, 10_000_002)]
    clock = [(0.0, 0.002, 99), (10_000.0, 10_000.002, 99)]
    recs = [("engine.search", 0, 1_000_000, 101),
            ("engine.search", 2_000_000, 3_000_000, 101),
            ("engine.sync", 100_000, 900_000, 101),
            ("engine.consolidate", 0, 3_000_000, 202)]
    host = [(t, t + 1, "aten::add", 7) for t in (100.0, 500.0, 2_500.0)] \
        + [(t, t + 1, "aten::mul", 8) for t in (1_200.0, 1_500.0, 1_800.0)]
    m = spans.map_program(recs, anchors, clock, 12345, host)
    assert m["threads"] == "matched"
    assert abs(m["skew_us"]) < 1e-6
    assert set(m["spans"]) == {("engine.search", 7), ("engine.sync", 7),
                               ("engine.consolidate", 8)}
    (s, t), = m["spans"][("engine.sync", 7)]
    assert s == pytest.approx(100.0) and t == pytest.approx(900.0)
    same = spans.map_program(recs, anchors, [c[:2] + (12345,)
                                             for c in clock], 12345, host)
    assert same["threads"] == "identity"
    assert {k[1] for k in same["spans"]} == {101, 202}


def test_idle_gaps_named_by_the_innermost_open_span():
    sp = {("engine.search", 7): [(0.0, 100.0), (300.0, 400.0)],
          ("engine.sync", 7): [(10.0, 50.0), (320.0, 330.0)],
          ("update.e_in", 8): [(0.0, 1000.0)]}
    gaps = [(20.0, 40.0), (60.0, 80.0), (120.0, 140.0), (500.0, 700.0),
            (340.0, 350.0)]
    ends_at = {40.0: 7, 80.0: 7, 140.0: 7, 700.0: 9, 350.0: 7}
    got = spans.gaps_by_span(sp, gaps, ends_at)
    assert got == pytest.approx({"engine.sync": 20e-6,
                                 "engine.search": 30e-6,
                                 "none": 220e-6})


def _x(name, cat, ts, dur, tid, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_time_and_gaps_of_a_synthetic_trace():
    """Thread 5 runs an ``update.e_in`` span over [100, 200] us inside an
    ``engine.insert`` over [50, 400]; it launches kernels at 110 (inside
    both), at 250 (inside the insert only) and at 150 inside the
    benchmark's accounting range, which is left out."""
    us = 1000                                    # ns per trace microsecond
    anchors = [(0, 2), (1000 * us, 1000 * us + 2)]
    events = [_x(spans.CLOCK, "user_annotation", 0.0, 0.002, 5),
              _x(spans.CLOCK, "user_annotation", 1000.0, 0.002, 5),
              _x("cudaLaunchKernel", "cuda_runtime", 110.0, 2, 5, 1),
              _x("cudaLaunchKernel", "cuda_runtime", 250.0, 2, 5, 2),
              _x("cudaLaunchKernel", "cuda_runtime", 150.0, 2, 5, 3),
              _x(tr_mod.ACCOUNTING, "user_annotation", 140.0, 20, 5),
              _x("k1", "kernel", 120.0, 30, "stream 7", 1),
              _x("k2", "kernel", 260.0, 40, "stream 7", 2),
              _x("k3", "kernel", 155.0, 5, "stream 7", 3)]
    recs = [("update.e_in", 100 * us, 200 * us, 5),
            ("engine.insert", 50 * us, 400 * us, 5)]
    out = spans.summarize(events, anchors, 5, recs)
    assert out["threads"] == "identity" and out["counts"] == {
        "update.e_in": 1, "engine.insert": 1}
    assert out["device_s"] == pytest.approx({"update.e_in": 30e-6,
                                             "engine.insert": 70e-6})
    # the gap [150, 260] ends with k2, launched at 250 in the insert
    assert out["idle_gaps_by_span"] == [("engine.insert",
                                         pytest.approx(110e-6))]


def test_nothing_to_map():
    for recs in (None, []):
        out = spans.summarize([], [], 1, recs)
        assert out["device_s"] == {} and out["idle_gaps_by_span"] == []
        assert out["threads"] is None and out["skew_us"] is None
