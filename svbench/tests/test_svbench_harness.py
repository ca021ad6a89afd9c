"""A tiny cell of each configuration through the harness on the CPU."""
import json

import pytest

from svbench.tests.tiny import run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["deep1b_device.search_uniform",
                                  "deep1b_tiered_pq.search_zipf"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_result_line(name, trace):
    cell = tiny_cell(name)
    r = json.loads(json.dumps(run_tiny(cell, trace=trace)))
    want = KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(r) == want                     # checks come last
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        names = {m["name"] for m in cell.per_layer}
        assert set(r["metrics"]) <= names
        # the counters read on the CPU too; the trace's device metrics
        # have nothing to read there and are left out, never 0
        assert "device_idle_pct.search" not in r["metrics"]
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(r["metrics"]) == names
        assert all(m["value"] > 0 for m in r["metrics"].values())
    for c in r["checks"].values():
        assert set(c) == {"value", "limit", "must"}
    assert r["checks"]["wrong_ids"]["value"] == 0
    assert r["checks"]["unanswered"]["value"] == 0
