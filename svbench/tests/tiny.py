"""A tiny copy of a benchmark cell for the CPU tests: the cell's own
traffic shape and engine settings at a few thousand rows of width 16;
and a cell cut in rows alone, on four cards, for a test on the card."""
from __future__ import annotations

import copy
import time

from svbench import harness, spec

# The three-tier configuration has no cell in BENCHMARK.json yet (PERF.md,
# Open questions); its files stay, and keep the three-tier paths of the
# harness under test, as this cell.
UNLISTED = {"deep1b_tiered_pq.search_zipf": ("deep1b_tiered_pq",
                                             "search_zipf")}
UNLISTED_E2E = ("search_qps", "search_p95_ms", "recall_at_10", "setup_s")


def _cell(name: str) -> spec.Cell:
    if name not in UNLISTED:
        return spec.load_cell(name)
    config, traffic = UNLISTED[name]
    bench = spec._load(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(
        name, 1, spec._load(spec.HERE / "configs" / f"{config}.json"),
        spec._load(spec.HERE / "traffic" / f"{traffic}.json"),
        spec._load(spec.HERE / "limits" / f"{name}.json"),
        [m for m in bench["end_to_end"] if m["name"] in UNLISTED_E2E], [])


def tiny_cell(name: str, clients: int = 3) -> spec.Cell:
    cell = _cell(name)
    c = copy.deepcopy(cell.config)
    c.update(n=3000, dim=16)
    if c["mode"] == "device":
        c["capacity"] = 1 << 15
    else:
        c.update(capacity=1 << 14, disk_capacity=1 << 14, host_window=1024)
        # a deterministic predictor and no prefetch thread: the probe and
        # the prefetcher time the host, which a test should not depend on
        c["engine"].update(pq_m=4, pq_train_iters=4, pq_train_sample=1024,
                           spec_rank="flam", prefetch=False)
    c["engine"].update(cache_slots=256, degree=8)
    c["search"] = {"k": 10, "pool": 48, "max_iters": 32, "beam": 8}
    t = copy.deepcopy(cell.traffic)
    t.update(query_pool=4096, recall_sample_queries=256,
             clients=min(t["clients"], clients))
    w = t["writer"]
    w.update(insert_rows=min(w["insert_rows"], 64),
             delete_rows=min(w["delete_rows"], 64))
    if w["kind"] == "paced":
        w["period_s"] = 0.25
    return spec.Cell(cell.name, 1, c, t, dict(cell.limits), cell.end_to_end,
                     cell.per_layer)


def run_tiny(cell: spec.Cell, seed=12345678901, seconds=1.0, trace=False,
             control=False, under_test=None) -> dict:
    """A run on the CPU against ``under_test``: by default the program,
    or with ``control`` the control."""
    from svbench import control as control_, system
    if under_test is None:
        under_test = control_ if control else system
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), under_test=under_test)


def four_card_cell(name: str = "deep1b_device.search_uniform",
                   n: int = 65536) -> spec.Cell:
    """``name`` on four cards for the replicas' run on the card
    (``replicas.py``): the configuration's widths and engine settings and
    the cell's traffic, cut to ``n`` rows, the capacity, the cache (half
    the rows, as in the cell) and the query pool with them."""
    cell = spec.load_cell(name)
    c = copy.deepcopy(cell.config)
    c.update(n=n, capacity=1 << 20)
    c["engine"]["cache_slots"] = n // 2
    t = dict(cell.traffic, query_pool=1 << 18)
    return spec.Cell(cell.name, 4, c, t, dict(cell.limits), cell.end_to_end,
                     cell.per_layer)
