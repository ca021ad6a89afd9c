"""The traced run's instruments, all in the benchmark's own files.

* ``Wraps`` puts a ``record_function`` range around the scored kernel
  op, ``gather_l2`` as ``core/search.py`` imports it (a module attribute,
  so the program's code is not touched), and adds up, on the device, the
  bytes of each call by the frozen arithmetic of ``svbench/bounds.py``,
  inside an ``svbench.accounting`` range whose kernels the reading leaves
  out.
* ``Slice`` runs ``torch.profiler`` on every thread and reduces the part
  of the trace between its ``begin`` and ``cut`` marks: for each of the
  cell's cards the seconds in which it ran anything, and their mean; the
  device time of the kernels launched inside each range; the device
  operations that took the most time, summed over the cards; and each
  card's longest idle gaps, named by the innermost host op the profiler
  recorded across them and summed over the cards.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np
import torch

from svbench import bounds

ACCOUNTING = "svbench.accounting"
# the marks of a slice's read part, on the thread that drives the slice
BEGIN, CUT = "svbench.slice.begin", "svbench.slice.cut"
# op -> (module, attribute, cost): the scored kernel ops, wrapped where
# ``core/search.py`` imports them by name
OPS = {"l2_score": ("repro_torch.core.search", "gather_l2", bounds.l2_call)}


class Wraps:
    """Ranges around the scored ops while installed; ``least_s[op]`` maps
    each device to the summed least time of the op's calls on it made
    while ``counting`` is set, a scalar on that device: a call never
    waits for the card, and calls on two cards never meet in one add."""

    def __init__(self):
        self._undo = []
        self._lock = threading.Lock()
        self.counting = False
        self.least_s = {}

    def install(self):
        """Wrap every scored op; a name the program no longer has is an
        error, never a silent loss of the metric."""
        import importlib
        for op, (mod, attr, cost) in OPS.items():
            owner = importlib.import_module(mod)
            self._wrap(owner, attr, self._scored(op, getattr(owner, attr),
                                                 cost))
        return self

    def _wrap(self, owner, attr, fn):
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, fn)

    def remove(self):
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo = []

    def _scored(self, op, fn, cost):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(f"svbench.{op}"):
                out = fn(*a, **kw)
            if self.counting:
                with torch.profiler.record_function(ACCOUNTING):
                    least = bounds.least_seconds(*cost(*a, **kw))
                    with self._lock:
                        acc = self.least_s.setdefault(op, {})
                        if least.device in acc:
                            acc[least.device] += least
                        else:
                            acc[least.device] = least
            return out
        return wrapped


def _experimental():
    """Profile every thread (the coalescer's dispatcher, the writer and
    the background consolidation run the work); torch releases that lack
    the option record the starting thread alone."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except TypeError:
        return None


class Slice:
    """``torch.profiler`` over [start, stop) on ``cards`` (the cell's card
    indices), read over [``begin``, ``cut``) (by default the whole of it);
    the trace is read from its Chrome-trace export, which keeps the CUDA
    correlation between each device activity and the host call that
    launched it, and the card it ran on.

    ``start`` and ``stop`` belong where no other thread launches work on
    a card: on an H100 a profiler started while other threads launched
    kernels ended the process with a segmentation fault, at its stop,
    about once in thirty starts; ``begin`` and ``cut`` only mark the
    trace and may come under load."""

    DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
    LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

    def __init__(self, device_type: str, path: str, cards=(0,)):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        cfg = _experimental()
        self.all_threads = cfg is not None
        self.prof = profile(activities=acts, experimental_config=cfg)
        self.path = path
        self.cards = tuple(cards)
        self.t0 = self.t1 = None

    def start(self):
        self._sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def begin(self):
        """The read part starts here."""
        self.t0 = time.perf_counter()
        with torch.profiler.record_function(BEGIN):
            pass

    def cut(self):
        """The read part ends here, once every card has finished what was
        launched on it."""
        self._sync()
        with torch.profiler.record_function(CUT):
            pass
        self.t1 = time.perf_counter()

    def stop(self):
        if self.t1 is None:
            self._sync()
            self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def _sync(self):
        if torch.cuda.is_available():
            for c in self.cards:
                torch.cuda.synchronize(c)

    def reduce(self, top=10) -> dict:
        """Read the trace and reduce it (``reduce_events``)."""
        import json
        import os
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        return reduce_events(events, self.t1 - self.t0, self.cards,
                             self.all_threads, top)


def reduce_events(events, window_s, cards=(0,), all_threads=True,
                  top=10) -> dict:
    """A slice's Chrome-trace events reduced; see the module's docstring.
    A device activity belongs to a range when the call that launched it
    ran inside the range, on the range's thread, and to the card the
    profiler names in its ``device`` argument (the first card where it
    names none). ``busy_s`` is the mean of ``busy_s_per_card`` over
    ``cards``: a card that ran nothing counts 0. Device activities count
    only as far as they lie between the last ``BEGIN`` mark and the last
    ``CUT`` mark, where the trace has them."""
    lo, hi = _marks(events)
    dev, launch, notes, host = [], {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if e.get("name") in (BEGIN, CUT):
            continue
        if cat in Slice.DEVICE_CATS:
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if t <= lo or s >= hi:
                continue
            args = e.get("args", {})
            dev.append((max(s, lo), min(t, hi),
                        e["name"], args.get("correlation"),
                        args.get("device", cards[0])))
        elif cat in Slice.LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], float(e["ts"]))
        elif cat in ("user_annotation", "cpu_op", "python_function"):
            iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"])
            host.append(iv)
            if e["name"].startswith("svbench."):
                notes[(e["name"], e["tid"])].append(iv[:2])
    inside = _containment(notes)
    by_range = defaultdict(float)
    spans, unlinked = [], 0
    on_card = defaultdict(list)
    for s, t, name, corr, card in dev:
        where = launch.get(corr)
        if where is None:
            unlinked += 1
            names = ()
        else:
            names = inside(*where)
        if ACCOUNTING in names:
            continue
        spans.append((s, t, name))
        on_card[card].append((s, t, name))
        for n in names:
            by_range[n[len("svbench."):]] += (t - s) / 1e6
    ops = defaultdict(float)
    for s, t, name in spans:
        ops[name] += (t - s) / 1e6
    named, busy = defaultdict(float), []
    ranges = [h for h in host if h[2] != ACCOUNTING]
    for c in cards:
        b, gaps = _union_and_gaps(on_card[c])
        busy.append(b / 1e6)
        for n, v in _name_gaps(ranges, gaps).items():
            named[n] += v
    return {
        "window_s": window_s,
        "busy_s": sum(busy) / len(busy),
        "busy_s_per_card": busy,
        "device_events": len(spans),
        "device_events_unlinked": unlinked,
        "host_events": len(host),
        "all_threads": all_threads,
        "range_device_s": dict(by_range),
        "device_ops": sorted(ops.items(), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(named.items(), key=lambda x: -x[1])[:top],
    }


def _marks(events):
    """The last ``BEGIN`` and the last ``CUT`` mark's time in the trace,
    or the open ends where it has none."""
    at = {BEGIN: [], CUT: []}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in at:
            at[e["name"]].append(float(e["ts"]))
    return (max(at[BEGIN], default=float("-inf")),
            max(at[CUT], default=float("inf")))


def _containment(notes):
    """``inside(tid, ts)``: names of the svbench ranges on thread ``tid``
    that span time ``ts`` (ranges of one name do not nest on a thread)."""
    index = defaultdict(list)
    for (name, tid), ivs in notes.items():
        ivs.sort()
        index[tid].append((name, np.array([a for a, _ in ivs]),
                           np.array([b for _, b in ivs])))

    def inside(tid, ts):
        out = []
        for name, starts, ends in index.get(tid, ()):
            i = np.searchsorted(starts, ts, side="right") - 1
            if i >= 0 and ends[i] > ts:
                out.append(name)
        return out
    return inside


def _union_and_gaps(spans):
    """Total length of the union of [start, end) spans, and the gaps
    between them, in the spans' unit."""
    busy, gaps, end = 0.0, [], None
    for s, t, _ in sorted(spans):
        if end is None:
            busy, end = t - s, t
        elif s > end:
            gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def _name_gaps(host, gaps, longest=1000) -> dict:
    """Seconds of the ``longest`` idle gaps, summed by the name of the
    shortest host event (on any thread) that spans each gap's middle;
    ``host`` holds (start, end, name)."""
    named = defaultdict(float)
    if not host:
        return named
    start = np.array([h[0] for h in host])
    end = np.array([h[1] for h in host])
    names = [h[2] for h in host]
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        t = (a + b) / 2
        inside = np.nonzero((start <= t) & (end > t))[0]
        name = "host: no recorded op" if not len(inside) else \
            names[inside[np.argmin(end[inside] - start[inside])]]
        named[name] += (b - a) / 1e6
    return named
