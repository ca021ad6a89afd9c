"""Carry index state across frameworks as plain numpy arrays.

``index_state_from_arrays`` builds the port's ``IndexState`` from three
dicts of arrays keyed by field name, for example the reference's state
as ``{f: np.asarray(x) for f, x in st.graph._asdict().items()}`` for each
of graph, cache and stats; ``index_state_to_arrays`` goes back.
"""
from __future__ import annotations

import numpy as np
import torch

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
