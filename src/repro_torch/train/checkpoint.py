"""Fault-tolerant checkpointing (twin of ``repro.train.checkpoint``, in
its on-disk format, so that each package restores the other's
checkpoints).

* one ``.npy`` a leaf (the tensor brought to the host), and a
  ``manifest.json`` with each leaf's path, file, shape, dtype and CRC32;
  leaves in JAX's pytree order (dict keys sorted, ``NamedTuple`` fields
  in field order, tuple and list items by index) and paths spelled as
  JAX's key paths are (``0/tok/embed``, ``1/.step``, ``1/.mu/...``).
* atomic: writes go to ``step_XXXXXXXX.tmp`` then ``os.replace``, so a
  crash mid-save never corrupts the latest checkpoint.
* integrity: restore checks every CRC and falls back to the newest
  *valid* checkpoint.
* async: ``save_async`` copies the leaves to host memory at once and
  writes them in a background thread (training continues).
* keep-last-k garbage collection.

numpy has no bfloat16: a tree saved here holds fp32 or integer leaves
(the train loop's fp32 params and moments and its int32 step).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.sharding import NamedSharding


def _items(tree):
    """(key, child) pairs of an inner node in JAX's order, else None."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten_with_paths(tree, prefix=()):
    """(paths, leaves); ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return [], []
    items = _items(tree)
    if items is None:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for k, child in items:
        p, l = _flatten_with_paths(child, prefix + (k,))
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(like, leaves, device):
    """``like``'s structure over the next leaves of the iterator
    ``leaves``: a tensor leaf of ``like`` becomes a tensor on ``device``
    (default: that leaf's device), any other leaf stays a numpy array."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, device) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(x, leaves, device) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves, device) for x in like)
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.as_tensor(arr, device=device or like.device)
    return arr


def _place(tree, shardings):
    """Each leaf of ``tree`` placed by the ``NamedSharding`` at its place
    in ``shardings`` (a None there leaves the subtree as it is)."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return shardings.place(torch.as_tensor(tree))
    if isinstance(tree, dict):
        return {k: _place(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place(x, sh) for x, sh in zip(tree, shardings)))
    return type(tree)(_place(x, sh) for x, sh in zip(tree, shardings))


def _host(x):
    """A host copy of a leaf, which later writes to ``x`` do not reach."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _host_tree(tree):
    paths, leaves = _flatten_with_paths(tree)
    return paths, [_host(x) for x in leaves]


class CheckpointManager:
    def __init__(self, directory, keep=3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._threads: list = []

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self._write(step, *_host_tree(tree), extra or {})

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        paths, leaves = _host_tree(tree)                 # snapshot
        th = threading.Thread(target=self._write,
                              args=(step, paths, leaves, extra or {}),
                              daemon=True)
        th.start()
        self._threads.append(th)
        return th

    def wait(self):
        for th in self._threads:
            th.join()
        self._threads = []

    def _write(self, step, paths, leaves, extra):
        with self._lock:
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            manifest = {"step": step, "extra": extra, "leaves": []}
            for i, (p, leaf) in enumerate(zip(paths, leaves)):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, leaf)
                manifest["leaves"].append({
                    "path": p, "file": fname, "shape": list(leaf.shape),
                    "dtype": str(leaf.dtype),
                    "crc": zlib.crc32(np.ascontiguousarray(leaf).tobytes()),
                })
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _validate(self, step) -> Optional[dict]:
        """The manifest of a checkpoint whose every leaf loads and matches
        its CRC, else None."""
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            for leaf in manifest["leaves"]:
                arr = np.load(d / leaf["file"])
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                        != leaf["crc"]:
                    return None
            return manifest
        except (OSError, EOFError, ValueError, KeyError):
            return None

    def restore(self, like: Any, step: Optional[int] = None, device=None,
                shardings: Any = None):
        """Restore into the structure of ``like``, each tensor leaf on
        ``device`` (default: the device of ``like``'s leaf); with
        ``shardings`` (``like``'s structure, ``NamedSharding`` leaves) each
        leaf is placed as a DTensor. Falls back through older checkpoints
        if the newest is corrupt. Returns (step, tree) or (None, None) if
        nothing restorable."""
        candidates = [step] if step is not None \
            else list(reversed(self.all_steps()))
        n_like = len(_flatten_with_paths(like)[1])
        for s in candidates:
            manifest = self._validate(s)
            if manifest is None or len(manifest["leaves"]) != n_like:
                continue
            d = self.dir / f"step_{s:08d}"
            leaves = iter([np.load(d / l["file"])
                           for l in manifest["leaves"]])
            tree = _unflatten(like, leaves, device)
            return s, (tree if shardings is None
                       else _place(tree, shardings))
        return None, None
