"""Shared utilities: tree helpers, sharding helpers, timing (twin of
``repro.utils``).

Trees are the port's: nested dicts (and tuples, NamedTuples) of tensors.
``shape_struct`` is a tensor on the ``meta`` device (a shape and a dtype,
no storage) and ``spec`` the port's partition spec, a tuple with one
entry a tensor dimension (``models.sharding.ax``). ``block_tree`` waits
for the card. The reference's ``compat`` (JAX version shims) has no
counterpart.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Iterable

import torch

from repro_torch.models.layers import tree_leaves  # noqa: F401  (one copy)


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in tree_leaves(tree))


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_tree(v, dtype) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shape_struct(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` and ``dtype`` with no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class Timer:
    """Wall-clock timer accumulating named spans (host-side benchmarking)."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, float]:
        return dict(self.spans)


def block_tree(tree):
    """Wait for the card to finish the work that wrote ``tree``'s leaves
    (one ``torch.cuda.synchronize`` a CUDA device among them)."""
    devices = {x.device for x in tree_leaves(tree)
               if torch.is_tensor(x) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def percentile(xs: Iterable[float], p: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    idx = min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))
    return xs[idx]


def spec(*names) -> tuple:
    """Shorthand partition spec: one entry a tensor dimension."""
    return tuple(names)


def current_mesh_axis_sizes() -> dict[str, int]:
    from repro_torch.models.sharding import current_mesh
    mesh = current_mesh()
    return {} if mesh is None else mesh.sizes
