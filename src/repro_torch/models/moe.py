"""Mixture-of-Experts FFN (twin of ``repro.models.moe``).

Two dispatch implementations:

* ``capacity`` — GShard/Switch-style grouped capacity dispatch. Tokens
  over an expert's capacity are dropped (the residual passes them
  through). The reference builds one-hot dispatch and combine tensors
  and contracts them; the port computes each (token, expert) claim's
  place in the expert's buffer and moves the token there by index,
  which fills the same ``[G, E, C, D]`` buffers. A dropped claim goes to
  a spare place C that is sliced off, so that every shape is fixed by
  the config (no host sync, and the step runs on fake tensors).
* ``dense`` — computes every expert for every token and combines with
  the router weights. Exact (no dropping); the correctness oracle.

Top-k routing goes through ``core.topk.largest_k_by_sort``: ties take
the lower expert index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.topk import largest_k_by_sort
from repro_torch.models.layers import TSpec
from repro_torch.models.sharding import (blocks, constrain, from_blocks,
                                         is_dtensor, local_rows,
                                         replicated_like, weight_gather,
                                         whole_dim)


def moe_template(cfg, stacked=None):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    return {
        "router": TSpec(L + (D, E), LN + (None, None), 0.02),
        "w_gate": TSpec(L + (E, D, Fd), LN + ("expert", "fsdp", "tensor"),
                        0.02),
        "w_up": TSpec(L + (E, D, Fd), LN + ("expert", "fsdp", "tensor"),
                      0.02),
        "w_down": TSpec(L + (E, Fd, D), LN + ("expert", "tensor", "fsdp"),
                        0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _router_probs(p, x):
    logits = x.float() @ p["router"].float()
    return torch.softmax(logits, dim=-1)              # [..., E] fp32


def _expert_ffn(p, xe, dt, cfg):
    """xe [..., E, C, D] per-expert token blocks -> same shape."""
    wg = weight_gather(cfg, p["w_gate"].to(dt), ("expert", "fsdp", "tensor"))
    wu = weight_gather(cfg, p["w_up"].to(dt), ("expert", "fsdp", "tensor"))
    wd = weight_gather(cfg, p["w_down"].to(dt), ("expert", "tensor", "fsdp"))
    h = constrain(F.silu(xe @ wg) * (xe @ wu), "batch", None, None, "tensor")
    return h @ wd


def moe_apply_dense(p, x, cfg):
    """Exact dense-compute MoE (oracle)."""
    dt = x.dtype
    probs = _router_probs(p, x)                       # [B,S,E]
    gates = local_rows(lambda pr: _dense_gates(pr, cfg.top_k), probs)
    w = [p[k].to(dt) for k in ("w_gate", "w_up", "w_down")]
    experts = _dense_blocks if is_dtensor(x) else _dense_experts
    return experts(x, gates.to(dt), *w)


def _dense_gates(probs, K):
    """The top-K router probabilities of each token, renormalised, as
    [..., E] gates (zero off the top K)."""
    topv, topi = largest_k_by_sort(probs, K)
    gates = torch.zeros_like(probs).scatter(-1, topi, topv)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def _dense_experts(x, gates, wg, wu, wd):
    """Every expert on every token x [B,S,D], combined by gates [B,S,E]."""
    h = torch.einsum("bsd,edf->bsef", x, wg)
    u = torch.einsum("bsd,edf->bsef", x, wu)
    y = torch.einsum("bsef,efd->bsed", F.silu(h) * u, wd)
    return torch.einsum("bsed,bse->bsd", y, gates)


def _dense_blocks(x, gates, wg, wu, wd):
    """``_dense_experts`` of DTensors, tensor-parallel. Each rank takes its
    tokens (x's batch split) and its block of the experts' hidden dim F
    (the weights' tensor split), D whole (the weights gathered over their
    fsdp split, as ``weight_gather`` does); its part of the down-
    projection is summed across the F split (a Partial placement). The
    einsums over DTensors would flatten a sharded F into a product's
    dim, which torch 2.11 refuses."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    rows = [p.is_shard(0) for p in x.placements]
    f_split = [p.is_shard(2) and not r for p, r in zip(wg.placements, rows)]

    def pl(split, dim):
        return [Shard(dim) if s else Replicate() for s in split]
    y = _dense_experts(*blocks(
        [x, replicated_like(gates, x), wg, wu, wd],
        [pl(rows, 0), pl(rows, 0), pl(f_split, 2), pl(f_split, 2),
         pl(f_split, 1)]))
    return from_blocks(y, mesh, [Shard(0) if r else Partial() if f
                                 else Replicate()
                                 for r, f in zip(rows, f_split)], x.shape)


def capacity_slots(topi, E, C):
    """Each routing slot's place in its expert's buffer. topi [G, g, K]
    expert ids; returns (pos, keep), both [G, g, K]: ``pos`` counts the
    earlier claims on the same expert in slot-major order (slot 0 of every
    token before slot 1, GShard's priority), and a claim is kept while
    ``pos < C``."""
    G, g, K = topi.shape
    sel = F.one_hot(topi.transpose(1, 2).reshape(G, K * g), E)  # [G,K*g,E]
    before = (sel.cumsum(1) - sel).gather(
        -1, topi.transpose(1, 2).reshape(G, K * g, 1))[..., 0]
    pos = before.reshape(G, K, g).transpose(1, 2)
    return pos, pos < C


def moe_apply_capacity(p, x, cfg):
    """GShard grouped capacity dispatch.

    x [B,S,D] -> tokens in [G, g, D] (g the largest divisor of B*S not
    above ``moe_group``); per group each expert takes at most C =
    min(ceil(g * top_k / E * capacity_factor), g) tokens.
    """
    dt = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    g = min(cfg.moe_group, T)
    while T % g:          # largest divisor of T not exceeding moe_group
        g -= 1
    G = T // g
    C = min(int(math.ceil(g * K / E * cfg.capacity_factor)), g)

    # each rank's groups whole on it (a redistribution of the tokens where
    # the groups do not split evenly over the batch's shards)
    xt = whole_dim(x, 0, G).reshape(G, g, D)
    probs = _router_probs(p, xt)                      # [G,g,E] fp32
    xe, topv, topi, place, keep = local_rows(
        lambda xt, probs: _dispatch(xt, probs, K, C), xt, probs)
    xe = constrain(xe, "batch", None, None, None)
    ye = _expert_ffn(p, xe, dt, cfg)                  # [G,E,C,D]
    y = local_rows(lambda *a: _combine(*a, dt), topv, topi, place, keep, ye)
    return constrain(y.reshape(B, S, D), "batch", None, None)


def _rows(topi, place, E, C):
    """Each claim's row in the groups' [G, E, C+1] places."""
    grp = torch.arange(topi.shape[0], device=topi.device)[:, None, None]
    return ((grp * E + topi) * (C + 1) + place).reshape(-1)


def _dispatch(xt, probs, K, C):
    """Routing and dispatch of token groups xt [G, g, D] by their router
    probabilities [G, g, E]: (xe [G, E, C, D], the normalised top-k
    weights, the experts, each claim's place and whether it is kept,
    each [G, g, K]). Every group is its own."""
    G, g, D = xt.shape
    E = probs.shape[-1]
    topv, topi = largest_k_by_sort(probs, K)          # [G,g,K]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    pos, keep = capacity_slots(topi, E, C)
    # each claim's row in the [G, E, C+1] places: a token routes to each
    # expert at most once, so every kept place is written once; dropped
    # claims all land in their expert's spare place C
    place = torch.where(keep, pos, C)
    row = _rows(topi, place, E, C)
    src = xt[:, :, None, :].expand(G, g, K, D).reshape(-1, D)
    xe = xt.new_zeros(G * E * (C + 1), D).index_put((row,), src)
    return xe.view(G, E, C + 1, D)[:, :, :C], topv, topi, place, keep


def _combine(topv, topi, place, keep, ye, dt):
    """The experts' outputs ye [G, E, C, D] back at their tokens, weighted
    and summed over the top-k claims: [G, g, D] in ``dt``."""
    G, g, K = topi.shape
    E, C, D = ye.shape[1:]
    # combine in fp32 (a product of two dt values is exact there), one
    # rounding to dt at the end; the spare places read zeros
    w = topv.to(dt).float() * keep
    ye = torch.cat([ye.float(), ye.new_zeros(G, E, 1, D, dtype=torch.float32)],
                   dim=2)
    yk = ye.reshape(-1, D)[_rows(topi, place, E, C)].view(G, g, K, D)
    return (w[..., None] * yk).sum(2).to(dt)


def moe_apply(p, x, cfg):
    if cfg.moe_impl == "dense":
        return moe_apply_dense(p, x, cfg)
    return moe_apply_capacity(p, x, cfg)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style load-balance auxiliary loss: E times the sum over
    experts of (share of tokens whose top-1 expert it is) x (mean router
    probability). ``argmax`` takes the first maximum, as ``jnp.argmax``."""
    E = cfg.n_experts
    probs = _router_probs(p, x).reshape(-1, E)
    frac = F.one_hot(probs.argmax(-1), E).float().mean(0)
    return E * (frac * probs.mean(0)).sum()
