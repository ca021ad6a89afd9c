"""The traced slice on the CPU: its read part bounded by the ``begin``
and ``cut`` marks, and a profiler that starts and stops only while no
request, write or background consolidation runs."""
import threading
import types

import pytest

from svbench import harness, system
from svbench import trace as tr_mod
from svbench.tests.test_svbench_cards import _one_card, _two_cards, _x
from svbench.tests.tiny import run_tiny, tiny_cell


def _marked(events, begin, cut):
    return events + [_x(tr_mod.BEGIN, "user_annotation", begin, 0.0, 3),
                     _x(tr_mod.CUT, "user_annotation", cut, 0.0, 3)]


def test_marks_bound_the_read_part():
    # card 0: [0, 10] and [60, 70] fall outside [22, 55], [20, 30] is cut
    # to [22, 30], [25, 40] stays: busy [22, 40]; card 1: [5, 15] falls
    # outside, [50, 60] is cut to [50, 55]
    out = tr_mod.reduce_events(_marked(_two_cards(), 22.0, 55.0), 33e-6,
                               cards=(0, 1))
    assert out["busy_s_per_card"] == pytest.approx([18e-6, 5e-6])
    assert out["busy_s"] == pytest.approx(11.5e-6)
    assert out["device_events"] == 3
    assert dict(out["device_ops"]) == pytest.approx({"k": 28e-6})
    assert out["host_events"] == 2            # the marks are no host op


def test_the_last_marks_count():
    events = _marked(_marked(_two_cards(), 0.0, 5.0), 22.0, 55.0)
    out = tr_mod.reduce_events(events, 33e-6, cards=(0, 1))
    assert out["busy_s_per_card"] == pytest.approx([18e-6, 5e-6])


@pytest.mark.parametrize("begin,cut", [(-1.0, 1e9), (0.0, 1e6)])
def test_marks_around_the_whole_trace_change_nothing(begin, cut):
    plain = tr_mod.reduce_events(_one_card(), 1e-3)
    marked = tr_mod.reduce_events(_marked(_one_card(), begin, cut), 1e-3)
    for key, want in plain.items():
        assert marked[key] == want, key


class _Counted:
    """The engine behind a count of the calls that run in it."""

    def __init__(self, eng):
        self._eng = eng
        self._lock = threading.Lock()
        self.inside = 0

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _call(self, fn, *a):
        with self._lock:
            self.inside += 1
        try:
            return fn(*a)
        finally:
            with self._lock:
                self.inside -= 1

    def search(self, queries):
        return self._call(self._eng.search, queries)

    def insert(self, rows):
        return self._call(self._eng.insert, rows)

    def delete(self, ids):
        return self._call(self._eng.delete, ids)


def test_profiler_starts_and_stops_with_the_program_quiet(monkeypatch):
    made, seen = [], []
    under_test = types.SimpleNamespace(
        build=lambda *a: made.append(_Counted(system.build(*a))) or made[-1],
        settle=lambda t: system.settle(t._eng),
        read_back=lambda cfg, t, *a: system.read_back(cfg, t._eng, *a))

    def quiet(what, fn):
        def at(self):
            t = made[-1]
            seen.append((what, t.inside,
                         sum(th.is_alive() for th in t._eng._bg_threads)))
            return fn(self)
        return at

    monkeypatch.setattr(tr_mod.Slice, "start",
                        quiet("start", tr_mod.Slice.start))
    monkeypatch.setattr(tr_mod.Slice, "stop",
                        quiet("stop", tr_mod.Slice.stop))
    cell = tiny_cell("deep1b_device.slide_write")
    r = run_tiny(cell, trace=True, under_test=under_test)
    assert r["correct"] and r["failed"] == 0
    # the warm-up's profiler and the slice's, each started and stopped
    assert [w for w, _, _ in seen] == ["start", "stop"] * 2
    assert all(inside == 0 and bg == 0 for _, inside, bg in seen), seen
    # the read part is the slice's span, not its ramp
    span = min(cell.traffic.get("trace_slice_s", harness.TRACE_SLICE_S),
               1.0)
    assert span <= r["device"]["window_s"] < span + 0.5
