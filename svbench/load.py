"""The one general traffic generator: closed-loop search clients and one
writer, driven by a traffic file's parameters.

* ``clients`` threads each send ``request_queries`` queries through the
  system's ``search`` and wait for the answer before sending the next;
  client ``c``'s ``j``-th request takes a fixed block of the seed's query
  pool, so every seed sends the same sizes in the same order.
* The writer inserts ``insert_rows`` new rows and then deletes the
  ``delete_rows`` oldest live ones: every ``period_s`` seconds of the
  window (``paced``) or back to back (``closed``). Right after each
  insert is acknowledged it searches ``probe_rows`` of the new rows'
  own vectors (the read-after-write probe: each row should find itself).

Every request and write is kept with its host-clock times, for the
metrics and for the reference.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field

import numpy as np

JOIN_S = 60.0     # how long past the window's end an answer may come


@dataclass
class Request:
    client: int
    qoff: int
    ts: float
    te: float = None
    ids: np.ndarray = None
    dists: np.ndarray = None
    error: str = None


@dataclass
class Write:
    kind: str               # insert | delete
    ts: float
    te: float
    ids: np.ndarray
    vecs: np.ndarray = None


@dataclass
class Probe:
    """The search of freshly acknowledged rows' own vectors."""
    ids: np.ndarray         # [m] the rows searched for
    found: np.ndarray       # [m, k] their answers


@dataclass
class Window:
    t0: float
    seconds: float
    requests: list = field(default_factory=list)
    writes: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    stuck: int = 0          # threads still running JOIN_S after the end


class Oldest:
    """Live ids in the order they were written."""

    def __init__(self, n: int):
        self._q = collections.deque([np.arange(n, dtype=np.int64)])

    def push(self, ids):
        self._q.append(np.asarray(ids, np.int64))

    def pop(self, m: int) -> np.ndarray:
        out, need = [], m
        while need and self._q:
            head = self._q[0]
            out.append(head[:need])
            if len(head) <= need:
                self._q.popleft()
            else:
                self._q[0] = head[need:]
            need -= len(out[-1])
        return np.concatenate(out) if out else np.zeros(0, np.int64)


class Traffic:
    """A traffic file's load against ``target`` (the engine, or the
    control), with the query ``pool`` and ``draw_rows(m)`` for new rows
    (numpy [m, D], the writer's stream), over ``n`` initial rows."""

    def __init__(self, target, traffic: dict, pool: np.ndarray, draw_rows,
                 n: int):
        self.target = target
        self.t = traffic
        self.pool = pool
        self.draw_rows = draw_rows
        self.oldest = Oldest(n)
        self.probes = []

    # -- pieces --------------------------------------------------------
    def qoff(self, client: int, j: int) -> int:
        rq = self.t["request_queries"]
        slots = len(self.pool) // rq
        per = slots // self.t["clients"]
        return ((client * per + j) % slots) * rq

    def write_step(self, into: list):
        w = self.t["writer"]
        rows = self.draw_rows(w["insert_rows"])
        ts = time.perf_counter()
        ids = np.asarray(self.target.insert(rows), np.int64)
        into.append(Write("insert", ts, time.perf_counter(), ids, rows))
        self.oldest.push(ids)
        m = w.get("probe_rows", 0)
        if m:
            found, _ = self.target.search(rows[:m])
            self.probes.append(Probe(ids[:m], np.asarray(found, np.int64)))
        old = self.oldest.pop(w["delete_rows"])
        ts = time.perf_counter()
        self.target.delete(old)
        into.append(Write("delete", ts, time.perf_counter(), old))

    def warm(self, write_steps=1, passes=2) -> list:
        """Every dispatch size the window can make (one request to all
        the clients' requests and the writer's probe, at most
        ``max_dispatch_queries``, in steps of a request), then
        ``write_steps`` writer steps back to back; returns their writes."""
        rq = self.t["request_queries"]
        probe = (self.t.get("writer") or {}).get("probe_rows", 0)
        top = min(rq * self.t["clients"] + probe,
                  max(rq, self.t.get("max_dispatch_queries", rq)))
        for _ in range(passes):
            for b in range(rq, top + 1, rq):
                self.target.search(self.pool[:b])
        writes = []
        if self.t.get("writer"):
            for _ in range(write_steps):
                self.write_step(writes)
        return writes

    # -- the window ----------------------------------------------------
    def run(self, seconds: float, during=None) -> Window:
        """Run the load for ``seconds``; ``during(t0, t_end)`` runs on this
        thread meanwhile (the traced slice)."""
        start = threading.Event()
        win = Window(t0=0.0, seconds=seconds)
        lock = threading.Lock()
        t_end = [None]

        def client(c):
            start.wait()
            rq = self.t["request_queries"]
            j = 0
            while time.perf_counter() < t_end[0]:
                off = self.qoff(c, j)
                r = Request(c, off, time.perf_counter())
                try:
                    r.ids, r.dists = self.target.search(
                        self.pool[off:off + rq])
                except Exception as e:     # counted, judged unanswered
                    r.error = repr(e)
                r.te = time.perf_counter()
                with lock:
                    win.requests.append(r)
                j += 1

        def writer():
            start.wait()
            w = self.t["writer"]
            k = 0
            while True:
                if w["kind"] == "paced":
                    due = win.t0 + k * w["period_s"]
                    if due >= t_end[0]:
                        return
                    time.sleep(max(0.0, due - time.perf_counter()))
                elif time.perf_counter() >= t_end[0]:
                    return
                try:
                    self.write_step(win.writes)
                except Exception as e:     # the writer stops at a failure
                    win.errors.append(repr(e))
                    return
                k += 1

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(self.t["clients"])]
        if self.t.get("writer"):
            threads.append(threading.Thread(target=writer, daemon=True))
        for th in threads:
            th.start()
        win.t0 = time.perf_counter()
        t_end[0] = win.t0 + seconds
        start.set()
        if during is not None:
            during(win.t0, t_end[0])
        deadline = t_end[0] + JOIN_S
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        win.stuck = sum(th.is_alive() for th in threads)
        return win
