"""The program's own spans: a name, the native thread id, and start and
end on ``time.perf_counter_ns()``.

One tracer serves the process (``TRACER``), as a profiler does, so the
executor loop and the index build record without new arguments. It is
off by default; off, ``span`` and ``held`` record nothing and cost one
flag check. On, records go into a bounded ring; a record that finds the
ring full is not kept and counts in ``dropped``, so a reader can tell a
complete window from a cut one.

    with trace.span("update.e_in"): ...
    with trace.span("engine.insert", into=latencies): ...   # always timed
    with trace.held(lock, "update_lock"): ...   # wait.update_lock if blocked

The spans (the benchmark's readers are ``svbench/metrics/``):

* ``coalesce.queue``: a request, from ``submitted`` to the start of the
  dispatch that carries it, on the submitting thread;
* ``engine.search``, ``engine.insert``, ``engine.delete``: the engine's
  calls, whose seconds also fill ``engine.latencies``;
* ``engine.sync``: a device-to-host read of the device executor;
* ``wait.<lock>``: an acquisition of an engine lock that blocked;
* ``engine.consolidate``: a background consolidation, merge included;
* ``update.e_in``: ``build.compute_e_in``.

Nothing here calls a profiler: a benchmark maps the records onto its
profiler's clock itself.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

CAPACITY = 1 << 18     # records kept between two drains

_now = time.perf_counter_ns
_tid = threading.get_native_id


class Tracer:
    """A bounded ring of (name, t0_ns, t1_ns, tid) records."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self.dropped = 0
        self._ring = collections.deque()
        self._lock = threading.Lock()

    def enable(self):
        """Start recording into an empty ring."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0
        self.on = True

    def disable(self):
        self.on = False

    def drain(self):
        """(records, dropped) since the last drain or ``enable``; both
        start again from empty."""
        with self._lock:
            out, dropped = list(self._ring), self.dropped
            self._ring.clear()
            self.dropped = 0
        return out, dropped

    def record(self, name: str, t0_ns: int, t1_ns: int, tid: int = None):
        """Keep one span (``tid`` defaults to the calling thread's)."""
        r = (name, int(t0_ns), int(t1_ns), _tid() if tid is None else tid)
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(r)
            else:
                self.dropped += 1

    def span(self, name: str, into: list = None):
        """A span around a ``with`` block. With ``into`` the block is
        timed on and off, and its seconds are appended to ``into`` when it
        ends without an exception."""
        if into is None and not self.on:
            return _NULL
        return _Span(self, name, into)

    def held(self, lock, name: str):
        """``lock`` acquired for a ``with`` block; on, a blocked acquire
        records ``wait.<name>`` from the first try to the acquisition."""
        if not self.on:
            return lock
        return _Held(self, lock, "wait." + name)


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "into", "t0")

    def __init__(self, tracer, name, into):
        self.tracer, self.name, self.into = tracer, name, into

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        if self.into is not None and exc_type is None:
            self.into.append((t1 - self.t0) / 1e9)
        if self.tracer.on:
            self.tracer.record(self.name, self.t0, t1)
        return False


class _Held:
    __slots__ = ("tracer", "lock", "name")

    def __init__(self, tracer, lock, name):
        self.tracer, self.lock, self.name = tracer, lock, name

    def __enter__(self):
        if not self.lock.acquire(blocking=False):
            t0 = _now()
            self.lock.acquire()
            self.tracer.record(self.name, t0, _now())
        return self

    def __exit__(self, exc_type, exc, tb):
        self.lock.release()
        return False


TRACER = Tracer()
span = TRACER.span
held = TRACER.held
record = TRACER.record
enable = TRACER.enable
disable = TRACER.disable
drain = TRACER.drain
