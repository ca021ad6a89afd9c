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
``rev_log_from_arrays`` / ``rev_log_to_arrays`` carry a reverse-edge log
(``update.RevLog``) for the MVCC merges, and
``attribute_store_from_arrays`` the attribute columns of filtered search
(the reference's ``schema.to_meta()``, ``tags`` and ``nums``).
``shard_rows`` cuts one shard's rows out of the sharded index's global
arrays (``core/distributed.py``). ``model_params_from_arrays`` carries an
LM's params (the reference's pytree as nested dicts of numpy arrays,
``jax.tree.map(np.asarray, params)``) into the port, so that both
packages compute with the same weights; ``model_params_to_arrays`` goes
back. ``adam_state_from_arrays`` / ``adam_state_to_arrays`` carry an
optimizer state (``train.optimizer.AdamState``: step, mu, nu) the same
way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import HostPlacement, TopoCache
from repro_torch.core.filters import AttributeSchema
from repro_torch.core.quant import PQCodes, codebook_from_array
from repro_torch.core.tiers import (AttributeStore, DiskTier, TieredBackend,
                                    TieredStore)
from repro_torch.core.types import CacheState, GraphState, IndexState, Stats
from repro_torch.core.update import RevLog
from repro_torch.train.optimizer import AdamState


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


def shard_rows(arrays: dict, shard: int, n_shards: int,
               device="cuda") -> dict:
    """One shard of the sharded index's global arrays (the fields of
    ``distributed.shard_index_arrays``) as tensors on ``device``: block
    ``shard`` of ``n_shards`` equal blocks along each array's first
    dimension, which is what the reference's ``index_shardings`` gives
    the device at that shard."""
    out = {}
    for f, a in arrays.items():
        if a.shape[0] % n_shards:
            raise ValueError(f"{f}: {a.shape[0]} rows do not split into "
                             f"{n_shards} shards")
        m = a.shape[0] // n_shards
        out[f] = torch.as_tensor(np.asarray(a[shard * m:(shard + 1) * m]),
                                 device=device)
    return out


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


def rev_log_from_arrays(v, v_new, d, device="cuda") -> RevLog:
    """A device-mode RevLog (int32 ids, fp32 distances) on ``device``."""
    return RevLog(torch.tensor(np.asarray(v, np.int32), device=device),
                  torch.tensor(np.asarray(v_new, np.int32), device=device),
                  torch.tensor(np.asarray(d, np.float32), device=device))


def rev_log_to_arrays(log) -> tuple:
    """(v, v_new, d) numpy arrays of a RevLog of either form."""
    return tuple(x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                 for x in log)


def attribute_store_from_arrays(schema_meta: dict, tags, nums, capacity: int,
                                device="cuda") -> AttributeStore:
    """An AttributeStore of ``capacity`` ids from a schema's meta dict
    (``AttributeSchema.to_meta``) and its columns ``tags`` [n, n_tags]
    and ``nums`` [n, n_nums], with its mirror on ``device``."""
    return AttributeStore(AttributeSchema.from_meta(schema_meta), capacity,
                          tags=np.asarray(tags, np.int32),
                          nums=np.asarray(nums, np.float32), device=device)


def model_params_from_arrays(tree, device, dtype=None):
    """An LM param tree (nested dicts of arrays) as fp32 tensors on
    ``device`` (a bf16 source is exact in fp32), cast to ``dtype`` when
    given."""
    if isinstance(tree, dict):
        return {k: model_params_from_arrays(v, device, dtype)
                for k, v in tree.items()}
    t = torch.as_tensor(np.array(tree, np.float32), device=device)
    return t if dtype is None else t.to(dtype)


def model_params_to_arrays(params):
    """The port's LM params as nested dicts of fp32 numpy arrays."""
    if isinstance(params, dict):
        return {k: model_params_to_arrays(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()


def adam_state_from_arrays(state, device) -> AdamState:
    """An AdamState from (step, mu, nu) as numpy (the reference's state
    through ``jax.tree.map(np.asarray, state)``): an int32 0-d step and
    fp32 moments on ``device``."""
    step, mu, nu = state
    return AdamState(torch.as_tensor(np.array(step, np.int32), device=device),
                     model_params_from_arrays(mu, device),
                     model_params_from_arrays(nu, device))


def adam_state_to_arrays(state: AdamState) -> tuple:
    """(step, mu, nu) as numpy: an int32 0-d step and fp32 moments (the
    reference's ``AdamState(*arrays)`` takes them)."""
    return (state.step.detach().cpu().numpy().astype(np.int32),
            model_params_to_arrays(state.mu), model_params_to_arrays(state.nu))
