"""A four-card stand-in for the system under test, for the harness's own
tests: one ``SVFusionEngine`` a card, each holding every row. Never a
cell: it shows that a run drives, counts and traces every card a cell
asks for, before a program that spreads its rows over cards has a cell.

* A search goes to the replicas in turn.
* A write is applied to every replica before it is acknowledged; the
  replicas hand out the same ids, since each sees the same writes in the
  same order.
* After the window the acknowledged writes are read back from replica 0.

It is a module the run takes as its system under test (``build``,
``settle``, ``read_back``, as ``svbench/system.py``), and the engine it
returns has the attributes ``system.counters`` reads, added up over the
replicas. Device mode only.
"""
from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from svbench import system

REPLICAS = 4
# the engine's counters that system.counters reads, added over replicas
SUMMED = ("_consolidations", "host_syncs", "_spec_hits", "_spec_misses")


class _Summed:
    """The replicas' coalescers' counters, added up."""

    def __init__(self, parts):
        self._parts = parts

    def __getattr__(self, name):
        return sum(getattr(p, name) for p in self._parts)


class Replicas:
    _backend = _placement = _wal = None

    def __init__(self, engines):
        self.engines = engines
        self._turn = itertools.count()
        self._lock = threading.Lock()
        # one list of dispatch times for all replicas, so that a window's
        # entries are the slice between two counts, as on one engine
        self.latencies = {"search": [], "insert": [], "delete": []}
        for e in engines:
            e.latencies = self.latencies
        self._coalescer = (_Summed([e._coalescer for e in engines])
                           if engines[0]._coalescer is not None else None)

    def __getattr__(self, name):
        if name in SUMMED:
            return sum(getattr(e, name) for e in self.engines)
        raise AttributeError(name)

    def search(self, queries):
        with self._lock:
            i = next(self._turn) % len(self.engines)
        return self.engines[i].search(queries)

    def insert(self, vectors):
        ids = [np.asarray(e.insert(vectors), np.int64) for e in self.engines]
        for other in ids[1:]:
            if not np.array_equal(ids[0], other):
                raise RuntimeError("the replicas handed out different ids")
        return ids[0]

    def delete(self, ids):
        for e in self.engines:
            e.delete(ids)

    def wait_background(self):
        for e in self.engines:
            e.wait_background()

    def close(self):
        for e in self.engines:
            e.close()


def build(cfg: dict, vectors, seed, device, disk_path=None):
    if cfg["mode"] != "device":
        raise ValueError("the replicas hold device-mode engines only")
    if torch.device(device).type == "cuda":
        devices = [f"cuda:{i}" for i in range(REPLICAS)]
    else:
        devices = [device] * REPLICAS
    return Replicas([system.build(cfg, vectors, seed, d) for d in devices])


def settle(target) -> None:
    target.wait_background()


def read_back(cfg, target, disk_path, device, inserted, deleted):
    """Close every replica; the acknowledged writes read back from
    replica 0 (``system.read_back``)."""
    for e in target.engines[1:]:
        e.close()
    return system.read_back(cfg, target.engines[0], disk_path, device,
                            inserted, deleted)
