"""One run of one cell: data from the seed, the system built and warmed,
the traffic for the window, then the metrics and the comparison.

``run_cell`` takes the device as an argument so that the tests can drive
a tiny cell on the CPU; ``svbench/run.py`` is the entry that insists on
a card. On the card a cell uses cards ``0 .. chips - 1``, all of one
kind: the run synchronises, counts and traces each of them.
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time

import numpy as np
import torch

from svbench import check, data, load, spec, system
from svbench.reference.exact import Mirror

TRACE_SLICE_S = 2.0       # the read part of a --trace 1 run's slice
TRACE_RAMP_S = 1.0        # the slice's load before its read part
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (whole) is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def make_inputs(cell: spec.Cell, seed: int, dev):
    """The initial rows, the query pool (numpy) and the writer's draw,
    all from ``seed``."""
    cfg, tr = cell.config, cell.traffic
    seeds = data.stream_seeds(seed)
    gen = data.generator(seeds["data"], dev)
    draw = data.synthetic_descriptors(gen, cfg["n"], cfg["dim"], dev,
                                      clusters=cfg["clusters"],
                                      intrinsic=cfg["intrinsic"])
    vectors = draw(cfg["n"]).cpu().numpy()
    qgen = data.generator(seeds["queries"], dev)
    clusters = data.query_clusters(tr["query_pool"], cfg["clusters"],
                                   tr["query_clusters"], seeds, dev)
    pool = draw(tr["query_pool"], qgen, clusters).cpu().numpy()
    wgen = data.generator(seeds["writer"], dev)

    def draw_rows(m):
        return draw(m, wgen).cpu().numpy()
    return seeds, vectors, pool, draw_rows


def _answers(reqs, pool, k, base=0):
    """check.Answers of answered requests (``qoff`` into ``pool``)."""
    ok = [r for r in reqs if r.error is None and r.ids is not None]
    if not ok:
        z = np.zeros(0)
        return check.Answers(pool, z.astype(np.int64), z, z,
                             np.zeros((0, k), np.int64),
                             np.zeros((0, k), np.float32), z.astype(int))
    cols = []
    for i, r in enumerate(ok):
        b = len(r.ids)
        cols.append((r.qoff + np.arange(b), np.full(b, r.ts),
                     np.full(b, r.te), np.asarray(r.ids, np.int64),
                     np.asarray(r.dists, np.float32), np.full(b, base + i)))
    return check.Answers(pool, *(np.concatenate(c) for c in zip(*cols)))


def _p(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(win: load.Window, setup_s: float, recall: float) -> dict:
    """The window's end-to-end numbers: all its requests and writes, over
    the time from its start to the last answer or acknowledgement of the
    work started in it."""
    reqs = [r for r in win.requests if r.error is None]
    out = {"setup_s": setup_s, "recall_at_10": recall}
    if reqs:
        last = max(r.te for r in reqs)
        out["search_qps"] = sum(len(r.ids) for r in reqs) / (last - win.t0)
        out["search_p95_ms"] = _p([(r.te - r.ts) * 1e3 for r in reqs], 95)
    writes = [w for w in win.writes if w.ts >= win.t0]
    if writes:
        last = max(w.te for w in writes)
        out["update_rows_per_s"] = sum(len(w.ids) for w in writes) / (
            last - win.t0)
    return out


def layer_context(win, before, after, lat, wraps, trace_summary,
                  e2e=None):
    ins = [w for w in win.writes if w.kind == "insert" and w.ts >= win.t0]
    return {
        # the window's numbers as end_to_end gives them
        "window": e2e or {},
        "before": before, "after": after,
        "dispatch_s": lat,
        "insert_s": [w.te - w.ts for w in ins],
        "rows_written": sum(len(w.ids) for w in win.writes
                            if w.ts >= win.t0),
        "trace": trace_summary,
        # each op's least time, added over the devices its calls ran on
        "least_s": ({op: sum(float(v) for v in per.values())
                     for op, per in wraps.least_s.items()}
                    if wraps is not None else {}),
    }


def warm_write_steps(cfg: dict, traffic: dict) -> int:
    """Writer steps made in set-up: one; or, where the traffic file asks
    for ``warm_to_consolidation``, as many as take the deleted share to
    the configuration's consolidation threshold. The set-up then waits for
    that first consolidation, so that the window measures one regime from
    its start: deleted rows are never reused, so once the share is reached
    consolidation runs back to back."""
    w = traffic.get("writer")
    if not w:
        return 0
    if not w.get("warm_to_consolidation"):
        return 1
    thr = cfg["engine"]["consolidate_threshold"]
    s = 1
    while s * w["delete_rows"] < thr * (cfg["n"] + s * w["insert_rows"]):
        s += 1
    return s


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             dev: str, t_start: float, under_test=system,
             log=None) -> dict:
    """One run against ``under_test`` (``svbench/system.py``, the program,
    or ``svbench/control.py``, untraced); returns the result line as a
    dict (``checks`` last)."""
    from svbench import trace as tr_mod
    log = log or (lambda *a: None)
    cfg, tr = cell.config, cell.traffic
    cuda = torch.device(dev).type == "cuda"
    cards = tuple(range(cell.chips)) if cuda else (0,)
    kind = card_kind(cards) if cuda else "cpu"
    # the harness's own tensors on the first card, named by its index: a
    # kernel launch of the program may move a thread's current card
    home = torch.device("cuda", cards[0]) if cuda else torch.device(dev)
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
    seeds, vectors, pool, draw_rows = make_inputs(cell, seed, home)
    mirror = Mirror(vectors)
    wraps = tr_mod.Wraps().install() if trace else None
    tmp = tempfile.TemporaryDirectory(prefix="svbench-")
    disk = os.path.join(tmp.name, "index") if cfg["mode"] == "tiered" \
        else None
    try:
        target = under_test.build(cfg, vectors, seed, dev, disk)
        traffic = dict(tr, max_dispatch_queries=cfg["engine"].get(
            "coalesce_max_batch", 256))
        load_ = load.Traffic(target, traffic, pool, draw_rows, cfg["n"])
        writes = load_.warm(warm_write_steps(cfg, tr))
        under_test.settle(target)
        slice_ = None
        if trace:
            slice_ = tr_mod.Slice(torch.device(dev).type,
                                  os.path.join(tmp.name, "trace.json"),
                                  cards)
            warm_profiler(dev, tmp.name, cards)
        if cuda:
            for c in cards:
                torch.cuda.synchronize(c)
                torch.cuda.reset_peak_memory_stats(c)
        gc.collect()
        before = system.counters(target) if trace else None
        setup_s = time.perf_counter() - t_start
        log(f"setup {setup_s:.1f} s ({len(writes)} writes); "
            f"window {seconds} s")
        span = min(tr.get("trace_slice_s", TRACE_SLICE_S), seconds)

        win = load_.run(seconds)
        peaks = [torch.cuda.max_memory_allocated(c) if cuda else 0
                 for c in cards]
        log(f"{len(cards)} x {kind}: memory peaks {peaks}")
        after = lat = None
        extra = load.Window(t0=0.0, seconds=0.0)
        if trace:
            after = system.counters(target)
            lat = target.latencies["search"][before["search_latencies"]:
                                             after["search_latencies"]]
            extra = traced_slice(under_test, target, load_, slice_, wraps,
                                 span)
        writes += win.writes + extra.writes
        for w in writes:
            _mirror_write(mirror, w)
        summary = slice_.reduce() if slice_ is not None else None
        if wraps is not None:
            wraps.remove()
        # the acknowledged writes read back from the index, then the
        # program's state freed before the reference runs
        lost = under_test.read_back(
            cfg, target, disk, dev,
            [(w.ids, w.vecs) for w in writes if w.kind == "insert"],
            [w.ids for w in writes if w.kind == "delete"])
        probes = load_.probes
        del target, load_
        gc.collect()
        if cuda:
            for c in cards:
                with torch.cuda.device(c):
                    torch.cuda.empty_cache()
        k = cfg["search"]["k"]
        window_ans = _answers(win.requests, pool, k)
        unanswered = failures(win) + failures(extra)
        t_ref = time.perf_counter()
        checks = check.compare(
            mirror, window_ans, unanswered, cell.limits, cfg["stated"], k,
            tr["recall_sample_queries"], seeds["sample"], home, lost=lost,
            probes=probes)
        log(f"reference {time.perf_counter() - t_ref:.1f} s")
    finally:
        tmp.cleanup()
    e2e = end_to_end(win, setup_s, checks["recall_at_10"]["value"])
    result = {
        "correct": check.judge(checks),
        "attempted": len(win.requests) + len(
            [w for w in win.writes if w.ts >= win.t0]),
        "failed": failures(win) + failures(extra),
    }
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ctx = layer_context(win, before, after, lat, wraps, summary, e2e)
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info(cuda, kind, len(cards), max(peaks),
                                   summary)
    if summary is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
        log("counters: " + ", ".join(
            f"{k_} {after[k_] - before[k_]}" for k_ in before
            if isinstance(before[k_], (int, float))))
        log("trace: " + ", ".join(f"{k_} {summary[k_]}" for k_ in (
            "busy_s_per_card", "device_events", "device_events_unlinked",
            "host_events", "all_threads", "range_device_s")))
    result["checks"] = checks
    return result


def traced_slice(under_test, target, load_, slice_, wraps, span):
    """The traced slice of a ``--trace 1`` run, after its window: the
    cell's load again under the profiler, read over ``span`` seconds that
    start ``TRACE_RAMP_S`` into it and end as long before its end. The
    profiler starts and stops while the program is quiet: no request,
    write or background consolidation runs (``Slice``). Returns the
    slice's load."""
    under_test.settle(target)
    slice_.start()

    def during(t0, t_end):
        time.sleep(max(0.0, t0 + TRACE_RAMP_S - time.perf_counter()))
        wraps.counting = True
        slice_.begin()
        time.sleep(span)
        slice_.cut()
        wraps.counting = False

    out = load_.run(span + 2 * TRACE_RAMP_S, during)
    under_test.settle(target)
    slice_.stop()
    return out


def failures(win: load.Window) -> int:
    """Requests that failed, writer failures and threads left running."""
    return (sum(r.error is not None for r in win.requests)
            + len(win.errors) + win.stuck)


def _mirror_write(mirror: Mirror, w: load.Write):
    if w.kind == "insert":
        mirror.insert(w.ids, w.vecs, w.ts, w.te)
    else:
        mirror.delete(w.ids, w.ts, w.te)


def warm_profiler(dev, tmp, cards):
    """Start and stop the profiler once, with work on each card, so that
    its first start (CUPTI's set-up) falls in set-up and not in the
    window."""
    from svbench import trace as tr_mod
    cuda = torch.device(dev).type == "cuda"
    s = tr_mod.Slice(torch.device(dev).type, os.path.join(tmp, "warm.json"),
                     cards)
    s.start()
    for c in cards:
        torch.zeros(1, device=torch.device("cuda", c) if cuda
                    else dev).add_(1)
    s.stop()


def card_kind(cards) -> str:
    """The name of the cell's cards, which have to be all of one kind."""
    kinds = [torch.cuda.get_device_name(c) for c in cards]
    if len(set(kinds)) != 1:
        raise ValueError(f"the cell's cards are not of one kind: {kinds}")
    return kinds[0]


def device_info(cuda, kind, count, peak, summary) -> dict:
    """``memory_peak_bytes`` is the fullest card's peak."""
    out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": count, "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["window_s"]
    return out
