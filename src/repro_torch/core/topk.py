"""Top-k and argsort with the reference's tie order.

``jax.lax.top_k`` returns values best first and, among equal values, the
lower index first; ``jnp.argsort`` is stable. ``torch.topk`` resolves
ties in no fixed order, so every top-k and argsort of the port goes
through here. Small inputs take one stable sort, as do the MoE
router's narrow rows at any count (``largest_k_by_sort``: no
data-dependent shape, so it runs on meta tensors). Large rows (the
build's [2048, N] distance blocks) take ``torch.topk`` for the k-th
value ``t``, keep every lane strictly better than ``t``, and fill the
remaining places with the lowest-index lanes equal to ``t``; only rows
whose ties at ``t`` are ambiguous pay for the index scan.
"""
from __future__ import annotations

import torch

_SORT_NUMEL = 1 << 24    # at or below this many elements: one stable sort


def argsort(x):
    """Stable argsort along the last axis (``jnp.argsort`` order)."""
    return torch.sort(x, dim=-1, stable=True).indices


def _smallest_k_select(x, k):
    """Threshold selection for large rows (see the module docstring)."""
    idx = torch.topk(x, k, dim=-1, largest=False, sorted=True).indices
    t = x.gather(-1, idx[..., k - 1:])
    n_lt = (x < t).sum(-1)
    n_eq = (x == t).sum(-1)
    amb = (n_lt + n_eq > k).nonzero().squeeze(-1)
    if amb.numel():
        xa, ta = x[amb], t[amb]
        eq = xa == ta
        need = k - n_lt[amb, None]
        take = (xa < ta) | (eq & (eq.cumsum(-1) <= need))
        lane = torch.arange(x.shape[-1], device=x.device).expand_as(xa)
        # exactly k lanes are taken: their indices are the k smallest keys
        key = torch.where(take, lane, x.shape[-1])
        idx[amb] = torch.topk(key, k, dim=-1, largest=False).values
    # order the selected set by (value, index), as lax.top_k returns it
    idx = idx.sort(-1).values
    vals, order = torch.sort(x.gather(-1, idx), dim=-1, stable=True)
    return vals, idx.gather(-1, order)


def smallest_k(x, k):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties lower index first: ``lax.top_k(-x, k)`` negated."""
    if x.dim() == 1:
        v, i = smallest_k(x[None], k)
        return v[0], i[0]
    if x.numel() <= _SORT_NUMEL or k == x.shape[-1]:
        vals, idx = torch.sort(x, dim=-1, stable=True)
        return vals[..., :k], idx[..., :k]
    lead = x.shape[:-1]
    vals, idx = _smallest_k_select(x.reshape(-1, x.shape[-1]), k)
    return vals.reshape(*lead, k), idx.reshape(*lead, k)


def largest_k(x, k):
    """(values, indices) of the k largest entries, descending, ties lower
    index first: ``lax.top_k(x, k)``."""
    vals, idx = smallest_k(-x, k)
    return -vals, idx


def largest_k_by_sort(x, k):
    """``largest_k`` by one stable sort of every row, whatever the row
    count: for narrow rows (the router's experts)."""
    vals, idx = torch.sort(-x, dim=-1, stable=True)
    return -vals[..., :k], idx[..., :k]
