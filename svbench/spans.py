"""The program's own spans (``repro_torch/core/trace.py``: a name, the
native thread id, start and end on ``perf_counter_ns``) on the
profiler's clock, for a traced slice (``svbench/trace.py`` ``Slice``).

* ``anchor`` records ``svbench.clock`` ranges on the calling thread, each
  between two ``perf_counter_ns`` reads; made at a slice's start and at
  its stop, the tightest pair at each end fixes a line from the
  program's clock to the trace's (``skew_us``: how far the second
  anchor's offset lies from the first's).
* A program thread is the trace's thread of the same id when the clock
  ranges' trace thread is the anchoring thread's own native id
  (``threads`` "identity"), else the trace thread whose host ops its
  spans (those it does not wait in) cover the largest share of
  (``threads`` "matched").
* ``summarize`` then gives the device time of the kernels launched inside
  each span (matched by launch thread and CUDA correlation id, as the
  slice matches its ``svbench.*`` ranges) and names each idle gap of the
  device by the innermost span open at its middle on the thread that
  launched the activity ending it, else "none".
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np
import torch

from svbench.trace import (ACCOUNTING, Slice, _containment,
                           _union_and_gaps)

CLOCK = "svbench.clock"
ANCHOR_TRIES = 4       # clock ranges at each end of a slice
# spans a thread waits in: its host ops run elsewhere meanwhile
WAITING = ("wait.", "coalesce.queue", "engine.sync")


def anchor(into: list) -> int:
    """``ANCHOR_TRIES`` clock ranges back to back, their (before, after)
    ``perf_counter_ns`` pairs appended to ``into`` (a thread's first range
    can take a millisecond of the profiler's set-up, so the mapping takes
    the tightest). Returns the calling thread's native id."""
    for _ in range(ANCHOR_TRIES):
        a = time.perf_counter_ns()
        with torch.profiler.record_function(CLOCK):
            pass
        into.append((a, time.perf_counter_ns()))
    return threading.get_native_id()


def parse(events):
    """A Chrome trace's complete events, in its microseconds: device
    activities (start, end, name, correlation), launches {correlation:
    (tid, ts)}, host events (start, end, name, tid) but the clock ranges,
    the benchmark's ranges {(name, tid): [(start, end)]}, and the clock
    ranges (start, end, tid)."""
    dev, launch, host, notes, clock = [], {}, [], defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in Slice.DEVICE_CATS:
            dev.append((s, t, e["name"], e.get("args", {}).get("correlation")))
        elif cat in Slice.LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], s)
        elif cat in ("user_annotation", "cpu_op", "python_function"):
            if e["name"] == CLOCK:
                clock.append((s, t, e["tid"]))
                continue
            host.append((s, t, e["name"], e["tid"]))
            if e["name"].startswith("svbench."):
                notes[(e["name"], e["tid"])].append((s, t))
    return dev, launch, host, notes, clock


def map_program(records, anchors, clock, anchor_tid, host) -> dict:
    """The span ``records`` (name, t0_ns, t1_ns, native tid) on the
    trace's clock and threads, for the spans that overlap the slice.
    ``anchors``: the (before, after) pairs of ``anchor`` at the slice's
    start and stop, in order; ``clock``: the trace's clock ranges;
    ``anchor_tid``: the anchoring thread's native id; ``host``: the
    trace's host events. Returns {"spans": {(name, trace tid): [(start,
    end)]}, "counts": {name: spans}, "skew_us", "threads"}."""
    out = {"spans": {}, "counts": {}, "skew_us": None, "threads": None}
    if not records or not anchors or len(anchors) != len(clock) \
            or len(anchors) % 2:
        return out
    clock = sorted(clock)
    half = len(anchors) // 2
    pick = [min(range(lo, lo + half),
                key=lambda i: anchors[i][1] - anchors[i][0])
            for lo in (0, half)]
    p = [sum(anchors[i]) / 2 for i in pick]                  # ns
    q = [(clock[i][0] + clock[i][1]) / 2 for i in pick]      # us
    slope = (q[1] - q[0]) / (p[1] - p[0])
    out["skew_us"] = (q[1] - q[0]) - (p[1] - p[0]) / 1e3
    lo, hi = clock[0][0], clock[-1][1]
    by_thread = defaultdict(list)
    for name, t0, t1, tid in records:
        s, t = q[0] + (t0 - p[0]) * slope, q[0] + (t1 - p[0]) * slope
        if t > lo and s < hi:
            by_thread[tid].append((name, s, t))
    if _same_id(clock[0][2], anchor_tid):
        tids = {tid: type(clock[0][2])(tid) for tid in by_thread}
        out["threads"] = "identity"
    else:
        tids = _match_threads(by_thread, host)
        out["threads"] = "matched"
    spans, counts = defaultdict(list), defaultdict(int)
    for tid, recs in by_thread.items():
        if tid not in tids:
            continue
        for name, s, t in recs:
            spans[(name, tids[tid])].append((s, t))
            counts[name] += 1
    out["spans"], out["counts"] = dict(spans), dict(counts)
    return out


def _same_id(trace_tid, native_tid) -> bool:
    try:
        return int(trace_tid) == int(native_tid)
    except (TypeError, ValueError):
        return False


def _match_threads(by_thread, host) -> dict:
    """{program tid: trace tid}: each pair scored by the share of the
    trace thread's host ops that start inside the program thread's spans
    it does not wait in, taken greedily from the highest share, and from
    the least covered time among equal shares (a short-lived thread's
    spans hold its own ops and few others'); a share below half is left
    out."""
    ops = defaultdict(list)
    for s, _, name, tid in host:
        if not name.startswith("svbench."):
            ops[tid].append(s)
    ops = {tid: np.array(v) for tid, v in ops.items()}
    scores = []
    for ptid, recs in by_thread.items():
        merged = []
        for s, t in sorted((s, t) for name, s, t in recs
                           if not name.startswith(WAITING)):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        if not merged:
            continue
        starts = np.array([s for s, _ in merged])
        ends = np.array([t for _, t in merged])
        covered = float((ends - starts).sum())
        for ttid, ts in ops.items():
            i = np.searchsorted(starts, ts, side="right") - 1
            hit = (i >= 0) & (ends[np.maximum(i, 0)] > ts)
            scores.append((-hit.mean(), covered, ptid, ttid))
    out, taken = {}, set()
    for neg, _, ptid, ttid in sorted(scores, key=lambda x: x[:2]):
        if -neg < 0.5:
            break
        if ptid not in out and ttid not in taken:
            out[ptid] = ttid
            taken.add(ttid)
    return out


def summarize(events, anchors, anchor_tid, records) -> dict:
    """The program's spans in a slice's trace ``events``: {"device_s":
    {span name: device seconds launched inside it}, "idle_gaps_by_span":
    [(span name or "none", idle seconds)], longest first, "counts",
    "skew_us", "threads"}. Activities launched inside the benchmark's
    accounting range are left out, as the slice leaves them out."""
    dev, launch, host, notes, clock = parse(events)
    mapped = map_program(records, anchors, clock, anchor_tid, host)
    inside = _containment({**notes, **mapped["spans"]})
    device_s, kept, ends_at = defaultdict(float), [], {}
    for s, t, name, corr in dev:
        where = launch.get(corr)
        names = inside(*where) if where is not None else ()
        if ACCOUNTING in names:
            continue
        kept.append((s, t, name))
        if where is not None:
            ends_at[s] = where[0]
        for n in names:
            if not n.startswith("svbench."):
                device_s[n] += (t - s) / 1e6
    _, gaps = _union_and_gaps(kept)
    by_span = gaps_by_span(mapped["spans"], gaps, ends_at)
    return {"device_s": dict(device_s),
            "idle_gaps_by_span": sorted(by_span.items(),
                                        key=lambda x: -x[1]),
            "counts": mapped["counts"], "skew_us": mapped["skew_us"],
            "threads": mapped["threads"]}


def gaps_by_span(spans, gaps, ends_at) -> dict:
    """Seconds of every idle gap (start, end), summed by the innermost
    span of ``spans`` ({(name, tid): [(start, end)]}) open at the gap's
    middle on the thread that launched the device activity ending it
    (``ends_at``: activity start -> launch thread), else "none"."""
    threads = defaultdict(list)
    for (name, tid), ivs in spans.items():
        threads[tid].extend((s, t, name) for s, t in ivs)
    index = {tid: _nesting(ivs) for tid, ivs in threads.items()}
    out = defaultdict(float)
    for a, b in gaps:
        name = None
        tid = ends_at.get(b)
        if tid in index:
            name = _innermost(index[tid], (a + b) / 2)
        out[name or "none"] += (b - a) / 1e6
    return out


def _nesting(ivs):
    """Spans of one thread sorted by start (the longer first on a tie),
    with each one's parent: the innermost earlier span that holds its
    start."""
    ivs = sorted(ivs, key=lambda x: (x[0], -x[1]))
    parent, stack = [], []
    for i, (s, t, _) in enumerate(ivs):
        while stack and ivs[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return np.array([s for s, _, _ in ivs]), ivs, parent


def _innermost(index, x):
    """The name of the innermost span open at ``x``: the last to start at
    or before ``x`` if it has not ended, else its nearest ancestor that
    has not (spans of one thread nest)."""
    starts, ivs, parent = index
    i = int(np.searchsorted(starts, x, side="right")) - 1
    while i >= 0 and ivs[i][1] <= x:
        i = parent[i]
    return ivs[i][2] if i >= 0 else None
