"""Faults planted under the timed path: the tests see ``correct`` come
out false for each, and a fault's numbers are read on the card at a
cell's own size with

    python3 svbench/faults.py --fault <name> --workload <cell> \\
        --seed <n> --seconds <s> --trace 0

Each fault takes ``patch(owner, name, value)`` (pytest's
``monkeypatch.setattr`` in the tests, ``setattr`` here) and the
configuration's mode, and replaces a function of the program that the
engine calls by its module attribute.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def alter_answers(patch, mode):
    """The best answer of every query replaced where it is produced."""
    from repro_torch.core import engine
    name = "search_batch" if mode == "device" else "search_tiered"
    real = getattr(engine, name)

    def altered(*a, **kw):
        res = real(*a, **kw)
        ids = res.ids.clone() if hasattr(res.ids, "clone") else \
            res.ids.copy()
        ids[:, 0] = ids[:, 1]
        return res._replace(ids=ids)
    patch(engine, name, altered)


def lose_inserts(patch, mode):
    """An insert acknowledged with fresh ids, the index left unchanged."""
    import torch
    from repro_torch.core import update
    if mode == "device":
        def lost(state, new_vecs, entries, sp):
            ids = state.graph.n + torch.arange(len(new_vecs),
                                               dtype=torch.int32)
            return state, ids, None
        patch(update, "insert_batch", lost)
    else:
        def lost(backend, cache_mirror, new_vecs, sp, seed, **kw):
            z = np.zeros(0, np.int64)
            return backend.n + np.arange(len(new_vecs)), update.RevLog(
                z, z, np.zeros(0, np.float32))
        patch(update, "insert_tiered", lost)


def ignore_deletes(patch, mode):
    """A delete acknowledged and not applied."""
    from repro_torch.core import update
    if mode == "device":
        patch(update, "delete_batch", lambda st, ids: st)
    else:
        patch(update, "delete_tiered",
              lambda backend, ids: np.zeros(0, np.int64))


def publish_late(patch, mode):
    """An insert acknowledged before its rows are visible: they stay
    marked dead until the next delete, which publishes them first. Every
    acknowledged write is in the index once the window closes; only a
    search right after an acknowledgement can tell."""
    from repro_torch.core import update
    hidden = []
    if mode == "device":
        insert, delete = update.insert_batch, update.delete_batch

        def late_insert(state, new_vecs, entries, sp):
            st, ids, rev = insert(state, new_vecs, entries, sp)
            hidden.append(ids.long())
            alive = st.graph.alive.clone()
            alive[ids.long()] = False
            return st._replace(graph=st.graph._replace(alive=alive)), ids, rev

        def publish_then_delete(state, ids):
            alive = state.graph.alive.clone()
            for h in hidden:
                alive[h] = True
            hidden.clear()
            return delete(state._replace(
                graph=state.graph._replace(alive=alive)), ids)
        patch(update, "insert_batch", late_insert)
        patch(update, "delete_batch", publish_then_delete)
    else:
        insert, delete = update.insert_tiered, update.delete_tiered

        def late_insert(backend, *a, **kw):
            ids, rev = insert(backend, *a, **kw)
            hidden.append(np.asarray(ids, np.int64))
            backend.alive[hidden[-1]] = False
            return ids, rev

        def publish_then_delete(backend, ids):
            for h in hidden:
                backend.alive[h] = True
            hidden.clear()
            return delete(backend, ids)
        patch(update, "insert_tiered", late_insert)
        patch(update, "delete_tiered", publish_then_delete)


FAULTS = {f.__name__: f for f in (alter_answers, lose_inserts,
                                  ignore_deletes, publish_late)}


if __name__ == "__main__":
    import argparse
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from svbench import run, spec
    p = argparse.ArgumentParser(description="a run with a fault planted")
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    known, rest = p.parse_known_args()
    mode = spec.load_cell(run._args(rest).workload).config["mode"]
    FAULTS[known.fault](setattr, mode)
    sys.exit(run.main(rest))
