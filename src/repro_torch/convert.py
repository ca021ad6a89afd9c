"""Carry index state across frameworks as plain numpy arrays.

``index_state_from_arrays`` builds the port's ``IndexState`` from three
dicts of arrays keyed by field name, for example the reference's state
as ``{f: np.asarray(x) for f, x in st.graph._asdict().items()}`` for each
of graph, cache and stats; ``index_state_to_arrays`` goes back.

The tiered state crosses the same way: ``pq_codes_from_arrays`` (the
reference's ``codebook_to_array`` output and codes),
``tiered_backend_from_arrays`` (a disk-tier directory and the metadata
directory), ``host_placement_from_arrays`` and
``topo_cache_from_arrays``, so that both packages search one index.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import HostPlacement, TopoCache
from repro_torch.core.quant import PQCodes, codebook_from_array
from repro_torch.core.tiers import DiskTier, TieredBackend, TieredStore
from repro_torch.core.types import CacheState, GraphState, IndexState, Stats


def _tensors(cls, arrays, device):
    return cls(**{f: torch.as_tensor(np.array(arrays[f]), device=device)
                  for f in cls._fields})


def index_state_from_arrays(graph: dict, cache: dict, stats: dict,
                            device="cuda") -> IndexState:
    return IndexState(_tensors(GraphState, graph, device),
                      _tensors(CacheState, cache, device),
                      _tensors(Stats, stats, device))


def index_state_to_arrays(state: IndexState) -> tuple[dict, dict, dict]:
    return tuple({f: x.cpu().numpy() for f, x in part._asdict().items()}
                 for part in (state.graph, state.cache, state.stats))


def pq_codes_from_arrays(centroids, codes, capacity: int,
                         device="cuda") -> PQCodes:
    """The PQ lane from centroids [m, K, dsub] and codes [n, m] uint8."""
    return PQCodes(codebook_from_array(centroids, device), capacity,
                   codes=np.asarray(codes, np.uint8))


def tiered_backend_from_arrays(disk_path: str, *, capacity: int, dim: int,
                               degree: int, n: int, alive, e_in, version,
                               host_window: int = 0) -> TieredBackend:
    """A backend over the existing disk-tier directory ``disk_path``
    (``vectors.npy``, ``nbrs.npy``), with an empty host window of
    ``host_window`` slots (0 -> capacity // 4, at least 64) and the given
    alive / e_in / version directory."""
    disk = DiskTier(disk_path, capacity, dim, degree, create=False)
    be = TieredBackend(TieredStore(disk, host_window
                                   or max(64, capacity // 4)), n)
    be.alive[:] = np.asarray(alive, bool)
    be.e_in[:] = np.asarray(e_in, np.int32)
    be.version[:] = np.asarray(version, np.int32)
    return be


def host_placement_from_arrays(arrays: dict,
                               dtype=torch.float32) -> HostPlacement:
    """A HostPlacement from its fields: ``vectors`` (fp32 values, held in
    ``dtype``), ``slot_hid``, ``h2d``, ``ref``, ``slot_ver``,
    ``f_recent``, ``theta``, ``alpha``, ``beta`` and the ``counters``
    dict."""
    vectors = np.asarray(arrays["vectors"], np.float32)
    hp = HostPlacement(len(arrays["h2d"]), vectors.shape[0],
                       vectors.shape[1], theta=arrays["theta"],
                       alpha=arrays["alpha"], beta=arrays["beta"],
                       dtype=dtype)
    hp.vectors = torch.from_numpy(vectors.copy()).to(dtype)
    for f in ("slot_hid", "h2d", "ref", "slot_ver", "f_recent"):
        setattr(hp, f, np.array(arrays[f], dtype=getattr(hp, f).dtype))
    hp.counters.update(arrays["counters"])
    hp.view = hp.view._replace(h2d=hp.h2d, vectors=hp.vectors)
    return hp


def topo_cache_from_arrays(rows, slot_hid, h2s, *, slots: int, epoch=None,
                           device="cuda") -> TopoCache:
    """A TopoCache holding ``rows`` [max(slots, 1), R] with its slot->id
    and id->slot maps, fenced at the store write ``epoch``."""
    rows = np.asarray(rows, np.int32)
    topo = TopoCache(len(h2s), slots, rows.shape[1], device=device)
    topo.rows[:] = rows
    topo.slot_hid[:] = np.asarray(slot_hid, np.int64)
    topo.h2s[:] = np.asarray(h2s, np.int32)
    topo.epoch = epoch
    topo._cursor = int((topo.slot_hid >= 0).sum())
    return topo
