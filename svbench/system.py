"""The system under test: the port's ``SVFusionEngine``, built from a
configuration file, and the counters the per-layer metrics read.

A run drives whatever module it is given through ``build``, ``settle``
and ``read_back``; this one is the program, ``svbench/control.py`` the
control.

``engine_config`` maps a configuration's keys onto ``EngineConfig``. The
three-tier defaults are frozen from ``chip_smoke.py``'s ``tiered_config``
(PR 24 tree, ``chip_smoke.py:1789``): a configuration file states every
one of them, and this module adds only what the file leaves out (the
device, the seed and the disk directory, which a run chooses).
"""
from __future__ import annotations

import numpy as np

SCALE_KEYS = ("capacity", "disk_capacity", "host_window")


def engine_config(cfg: dict, seed: int, device: str, disk_path=None):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.types import SearchParams
    kw = dict(cfg["engine"])
    kw.update({k: cfg[k] for k in SCALE_KEYS if k in cfg})
    kw["search"] = SearchParams(**cfg["search"])
    if cfg["mode"] == "tiered":
        if disk_path is None:
            raise ValueError("a three-tier configuration needs a disk path")
        kw["disk_path"] = disk_path
    return EngineConfig(seed=abs(int(seed)) % (2 ** 31), device=device,
                        **kw)


def build(cfg: dict, vectors: np.ndarray, seed: int, device: str,
          disk_path=None):
    from repro_torch.core.engine import SVFusionEngine
    ecfg = engine_config(cfg, seed, device, disk_path)
    if cfg["mode"] == "device":
        import torch
        return SVFusionEngine(torch.as_tensor(vectors, device=device), ecfg)
    return SVFusionEngine(vectors, ecfg)


def settle(eng) -> None:
    """Wait for the engine's background work (a consolidation the set-up
    started)."""
    eng.wait_background()


def read_back(cfg: dict, eng, disk_path, device, inserted, deleted):
    """Close the engine and count the acknowledged writes its index does
    not hold (``check.lost_writes``): in device mode from the engine's
    published graph, in three-tier mode from the disk directory reopened
    through the program's recovery after a stop without a snapshot.
    Returns (name, count)."""
    from svbench import check
    if cfg["mode"] == "tiered":
        stop_without_publish(eng)
        backend, wal = recover(cfg, disk_path, device)
        lost = check.lost_writes(IndexView.of_backend(backend), inserted,
                                 deleted)
        backend.close()
        wal.close()
        return "wal_lost", lost
    eng.close()
    return "index_lost", check.lost_writes(
        IndexView.of_graph(eng.state.graph), inserted, deleted)


def counters(eng) -> dict:
    """The program's own counters, read without ``stats()`` (which
    measures the cost model at its first call and narrows the placement
    counters to int32)."""
    out = {"consolidations": eng._consolidations,
           "host_syncs": eng.host_syncs,
           "spec_hits": eng._spec_hits, "spec_misses": eng._spec_misses,
           "search_latencies": len(eng.latencies["search"])}
    c = eng._coalescer
    if c is not None:
        out.update(coalesce_requests=c.requests, coalesce_queries=c.queries,
                   coalesce_dispatches=c.dispatches)
    if eng._backend is not None:
        st = eng._backend.store
        out.update(store_hits=st.hits, store_misses=st.misses,
                   topo_hits=eng._topo_hits, topo_misses=eng._topo_misses)
    if eng._placement is not None:
        out.update(cache_hits=eng._placement.counters["hits"],
                   cache_accesses=eng._placement.counters["accesses"])
    wal = eng._wal
    if wal is not None:
        out.update(wal_fsyncs=wal.fsyncs, wal_records=wal.appended,
                   wal_bytes=wal.bytes)
    return out


class IndexView:
    """The rows an index holds after the window, for the check of the
    acknowledged writes: ``n``, ``vectors(ids)``, ``alive(ids)``."""

    def __init__(self, n, vectors, alive):
        self.n, self.vectors, self.alive = n, vectors, alive

    @staticmethod
    def of_graph(graph):
        return IndexView(
            int(graph.n),
            lambda ids: graph.vectors[_t(ids, graph.vectors)].cpu().numpy(),
            lambda ids: graph.alive[_t(ids, graph.alive)].cpu().numpy())

    @staticmethod
    def of_backend(backend):
        return IndexView(int(backend.n),
                         lambda ids: backend.store.peek(ids)[0],
                         lambda ids: backend.alive[ids])


def _t(ids, like):
    import torch
    return torch.as_tensor(np.asarray(ids, np.int64), device=like.device)


def stop_without_publish(eng) -> None:
    """End the engine as a process that stops after its last
    acknowledgement would: the log is synced and closed, no snapshot is
    published, so a reopen rolls every acknowledged write forward from
    the log (three-tier mode; device mode has no durable state)."""
    eng.wait_background()
    if eng._wal is not None:
        eng._wal.close()
    eng.close()


def recover(cfg: dict, disk_path: str, device: str):
    """Reopen the disk directory through the program's recovery; returns
    its backend (the store, the alive bits, the high-water mark)."""
    from repro_torch.core import wal
    backend, log, _ = wal.recover(
        disk_path, host_window=cfg.get("host_window", 0)
        or max(64, cfg["disk_capacity"] // 4), device=device)
    return backend, log
