"""A cell on several cards, on the CPU: the slice's reduction kept per
card on synthetic Chrome traces, the scored op's least time kept per
device, and the four-replica stand-in (``replicas.py``) driven through a
whole run."""
import json

import numpy as np
import pytest

from svbench import bounds
from svbench import trace as tr_mod
from svbench.tests import replicas
from svbench.tests.tiny import run_tiny, tiny_cell


def _x(name, cat, ts, dur, tid, corr=None, device=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if device is not None:
        args["device"] = device
    if args:
        e["args"] = args
    return e


def _two_cards():
    """Card 0 runs [0, 10], [20, 30], [25, 40], [60, 70] us (busy 40, gaps
    (10, 20) and (40, 60)); card 1 [5, 15], [50, 60] (busy 20, gap
    (15, 50)), interleaved with card 0's. ``aten::a`` spans the middle of
    card 0's first gap, ``aten::w`` the other two."""
    k = [(0, 0, 10), (1, 5, 10), (0, 20, 10), (0, 25, 15), (1, 50, 10),
         (0, 60, 10)]
    return [_x("k", "kernel", float(ts), float(d), "stream 7", device=c)
            for c, ts, d in k] + [
        _x("aten::a", "cpu_op", 8.0, 14.0, 1),
        _x("aten::w", "cpu_op", 0.0, 100.0, 2)]


def test_two_cards_are_reduced_each_on_its_own():
    out = tr_mod.reduce_events(_two_cards(), 1e-4, cards=(0, 1))
    assert out["busy_s_per_card"] == pytest.approx([40e-6, 20e-6])
    assert out["busy_s"] == pytest.approx(30e-6)
    # each card's gaps named, then summed over the cards
    assert dict(out["idle_gaps"]) == pytest.approx({"aten::a": 10e-6,
                                                    "aten::w": 55e-6})
    assert dict(out["device_ops"]) == pytest.approx({"k": 65e-6})
    assert out["device_events"] == 6


def test_a_card_that_ran_nothing_counts_nought():
    out = tr_mod.reduce_events(_two_cards(), 1e-4, cards=(0, 1, 2))
    assert out["busy_s_per_card"] == pytest.approx([40e-6, 20e-6, 0.0])
    assert out["busy_s"] == pytest.approx(20e-6)


def _one_card():
    """Kernels in and out of the scored op's range, one launched inside
    the accounting range (left out), one with no ``device`` argument, a
    memcpy and an unlinked memset."""
    return [
        _x("svbench.l2_score", "user_annotation", 100.0, 100.0, 1),
        _x(tr_mod.ACCOUNTING, "user_annotation", 210.0, 20.0, 1),
        _x("aten::mm", "cpu_op", 95.0, 110.0, 1),
        _x("aten::sort", "cpu_op", 205.0, 55.0, 1),
        _x("aten::copy_", "cpu_op", 300.0, 120.0, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 110.0, 3.0, 1, 1),
        _x("cudaLaunchKernel", "cuda_runtime", 150.0, 3.0, 1, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 215.0, 3.0, 1, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 240.0, 3.0, 1, 4),
        _x("cudaMemcpyAsync", "cuda_runtime", 310.0, 3.0, 2, 5),
        _x("l2", "kernel", 120.0, 40.0, "stream 7", 1, 0),
        _x("l2", "kernel", 165.0, 20.0, "stream 7", 2, 0),
        _x("acct", "kernel", 220.0, 8.0, "stream 7", 3, 0),
        _x("sort", "kernel", 250.0, 40.0, "stream 7", 4),
        _x("Memcpy DtoH", "gpu_memcpy", 330.0, 10.0, "stream 7", 5, 0),
        _x("Memset", "gpu_memset", 400.0, 2.0, "stream 7", None, 0),
        {"ph": "i", "name": "marker", "ts": 5.0}]


# what the reduction gave on this trace while it merged every device event
# into one busy time
ONE_CARD = {
    "window_s": 0.001, "busy_s": 0.000112, "device_events": 5,
    "device_events_unlinked": 1, "host_events": 5, "all_threads": True,
    "range_device_s": {"l2_score": 6.000000000000001e-05},
    "device_ops": [("l2", 6.000000000000001e-05), ("sort", 4e-05),
                   ("Memcpy DtoH", 1e-05), ("Memset", 2e-06)],
    "idle_gaps": [("aten::copy_", 0.0001), ("aten::sort", 6.5e-05),
                  ("svbench.l2_score", 5e-06)]}


def test_one_card_reads_as_before_bit_for_bit():
    out = tr_mod.reduce_events(_one_card(), 1e-3)
    for key, want in ONE_CARD.items():
        assert out[key] == want, key
    assert out["busy_s_per_card"] == [ONE_CARD["busy_s"]]


class _OnDevice:
    """A scalar on a named device that, as torch does, refuses an add
    with a scalar on another device."""

    def __init__(self, value, device):
        self.value, self.device = value, device

    def __iadd__(self, other):
        if other.device != self.device:
            raise RuntimeError("operands on two devices")
        self.value += other.value
        return self

    def __float__(self):
        return float(self.value)


def test_least_time_is_kept_per_device(monkeypatch):
    """Calls on two devices: each device's sum is its calls' sum, and the
    host's sum over the devices (as the harness reads it) is all of
    them."""
    calls = [(1.5, "cuda:0"), (2.0, "cuda:1"), (0.25, "cuda:0"),
             (4.0, "cuda:1"), (0.5, "cuda:1")]
    monkeypatch.setattr(bounds, "least_seconds",
                        lambda v, dev: _OnDevice(v, dev))
    w = tr_mod.Wraps()
    op = w._scored("l2_score", lambda v, dev: None, lambda v, dev: (v, dev))
    w.counting = True
    for v, dev in calls:
        op(v, dev)
    per = w.least_s["l2_score"]
    assert {d: float(s) for d, s in per.items()} == {"cuda:0": 1.75,
                                                     "cuda:1": 6.5}
    assert sum(float(s) for s in per.values()) == sum(v for v, _ in calls)


@pytest.mark.parametrize("trace", [False, True])
def test_the_replicas_through_a_whole_run(trace):
    """The four-replica stand-in in a run on the CPU: every write on every
    replica, read back from replica 0; the counters added up."""
    cell = tiny_cell("deep1b_device.search_uniform")
    r = json.loads(json.dumps(run_tiny(cell, trace=trace,
                                       under_test=replicas)))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["index_lost"]["value"] == 0
    if trace:
        assert r["metrics"]["coalesce_batch_mean"]["value"] > 0
        assert r["metrics"]["dispatch_ms_p50.search"]["value"] > 0
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_the_replicas_hand_out_one_set_of_ids():
    cell = tiny_cell("deep1b_device.search_uniform")
    cfg = cell.config
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((cfg["n"], cfg["dim"])).astype(np.float32)
    target = replicas.build(cfg, vectors, 7, "cpu")
    try:
        ids = target.insert(vectors[:32] + 1.0)
        assert list(ids) == list(range(cfg["n"], cfg["n"] + 32))
        target.delete(ids[:8])
        target.wait_background()
        for e in target.engines:
            alive = e.state.graph.alive[ids].cpu().numpy()
            assert not alive[:8].any() and alive[8:].all()
    finally:
        target.close()
