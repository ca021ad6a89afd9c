"""The four-card cell ``deep1b_sharded4.search``: its files found by name,
its five readers on a synthetic layer context, and a tiny copy of it run
through the harness on the CPU, the engine spread over four shards."""
import json

import pytest
import torch

from svbench import spec
from svbench.tests.tiny import run_tiny, tiny_cell

CELL = "deep1b_sharded4.search"


def test_the_cell_finds_its_files():
    cell = spec.load_cell(CELL)
    assert cell.chips == 4
    assert cell.config["name"] == "deep1b_sharded4"
    assert cell.config["engine"]["cards"] == 4
    assert cell.config["mode"] == "device"
    assert cell.traffic["request_queries"] == 1024
    assert cell.limits["dist_gap"] == 2e-5
    assert cell.limits["fresh_self_miss"] == 0.5
    assert {m["name"] for m in cell.end_to_end} == {"recall_at_10",
                                                     "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READS)


CTX = {"window": {"search_qps": 12345.0, "search_p95_ms": 81.5},
       "dispatch_s": [0.3, 0.1, 0.2],
       "trace": {"window_s": 2.0, "busy_s": 0.5,
                 "busy_s_per_card": [0.4, 0.6, 0.5, 0.5]}}
READS = {"search_qps.sharded4": 12345.0, "search_p95_ms.sharded4": 81.5,
         "dispatch_ms_p50.sharded4": 200.0,
         "device_idle_pct.sharded4": 75.0,
         "card_busy_balance.sharded4": 100.0 * 0.4 / 0.6}
MISSING = [{"window": {}, "dispatch_s": [], "trace": None},
           {"window": {}, "dispatch_s": None,
            "trace": {"window_s": 2.0, "busy_s": 0.0,
                      "busy_s_per_card": [0.0, 0.0, 0.0, 0.0]}}]


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_a_number_or_nothing(name):
    read = spec.reader(name)
    assert read(CTX) == pytest.approx(READS[name])
    for ctx in MISSING:
        assert read(ctx) is None


def test_a_tiny_copy_through_the_harness():
    """Four shards on the CPU, 1,024-query requests cut to 64 (the
    dispatches then stay a few hundred queries), a second of window:
    correct, every write read back."""
    cell = tiny_cell(CELL)
    cell.traffic["request_queries"] = 64
    old = torch.get_num_threads()
    torch.set_num_threads(1)      # four card workers share the cores
    try:
        r = json.loads(json.dumps(run_tiny(cell, trace=True)))
    finally:
        torch.set_num_threads(old)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["index_lost"]["value"] == 0
    assert r["metrics"]["dispatch_ms_p50.sharded4"]["value"] > 0
    assert r["metrics"]["search_qps.sharded4"]["value"] > 0
    # the trace's device metrics have nothing to read on the CPU
    assert "card_busy_balance.sharded4" not in r["metrics"]
