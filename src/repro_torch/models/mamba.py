"""Mamba-1 selective SSM: chunked scan and single-token step (twin of
``repro.models.mamba``).

The sequence is split into chunks of ``cfg.ssm_chunk``, and the state
is carried across them. Inside a chunk the linear recurrence
``h_t = a_t * h_{t-1} + bx_t`` runs step by step, the product order of
``mamba_step``: the scan's order does not depend on how the sequence
was chunked, and a prefill followed by a decode step scans as one
forward over the longer sequence does. The reference's
``lax.associative_scan`` combines the same pairs in a tree, so the two
agree to fp32 rounding. The state ``h`` is fp32; the conv state is in the
compute dtype and holds the last ``d_conv - 1`` pre-conv inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.models.layers import TSpec, res_constrain
from repro_torch.models.sharding import (blocks, constrain, from_blocks,
                                         is_dtensor, replicated_like,
                                         weight_gather)


def ssm_template(cfg, stacked=None, d_model=None):
    D = d_model or cfg.d_model
    Din = cfg.expand * D
    R = cfg.dt_rank or -(-D // 16)
    N, K = cfg.d_state, cfg.d_conv
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    return {
        "in_proj": TSpec(L + (D, 2 * Din), LN + ("fsdp", "tensor"), 0.02),
        "conv_w": TSpec(L + (K, Din), LN + (None, "tensor"), 0.02),
        "conv_b": TSpec(L + (Din,), LN + ("tensor",), 0.0),
        "x_proj": TSpec(L + (Din, R + 2 * N), LN + ("tensor", None), 0.02),
        "dt_proj": TSpec(L + (R, Din), LN + (None, "tensor"), 0.02),
        "dt_bias": TSpec(L + (Din,), LN + ("tensor",), 0.0),
        "A_log": TSpec(L + (Din, N), LN + ("tensor", None), 0.02),
        "D": TSpec(L + (Din,), LN + ("tensor",), -1.0),
        "out_proj": TSpec(L + (Din, D), LN + ("tensor", "fsdp"),
                          0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv. x [B,S,Din], w [K,Din]. init_state
    [B,K-1,Din]. Returns (out, the last K-1 inputs as the new state)."""
    K = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros(x.shape[0], K - 1, x.shape[-1])
    xp = torch.cat([init_state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    # a copy, so that a kept state does not hold the whole input alive
    new_state = xp[:, -(K - 1):].clone() if K > 1 else init_state
    return out + b.to(x.dtype), new_state


def _ssm_coeffs(p, xc, cfg):
    """xc [B,S,Din] post-conv. Returns (a, bx, Cc): a [B,S,Din,N] decay,
    bx [B,S,Din,N] input, Cc [B,S,N], all fp32."""
    R = p["dt_proj"].shape[0]
    N = cfg.d_state
    # whole on Din's split (an all-reduce of the sharded contraction): the
    # dt projection and the input and output maps read every column
    proj = constrain(xc @ p["x_proj"].to(xc.dtype), "batch", None, None)
    dt, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = F.softplus(dt.float() @ p["dt_proj"].float()
                    + p["dt_bias"].float())           # [B,S,Din]
    A = -torch.exp(p["A_log"].float())                # [Din,N]
    a = torch.exp(dt[..., None] * A)
    bx = (dt * xc.float())[..., None] * Bc.float()[..., None, :]
    return a, bx, Cc.float()


class _Scan(torch.autograd.Function):
    """hs[t] = a[t] * hs[t-1] + bx[t] (hs[-1] = h0), one step at a time.
    The backward runs the recurrence in reverse: with G[t] the gradient
    reaching hs[t] through every later step, G[t] = g_hs[t] + a[t+1] *
    G[t+1]; then g_bx = G, g_a[t] = G[t] * hs[t-1] and g_h0 = a[0] * G[0].
    It keeps a, hs and h0 (not one autograd node a step)."""

    @staticmethod
    def forward(ctx, a, bx, h0):
        hs = torch.empty_like(bx)
        h = h0
        for t in range(a.shape[1]):
            h = torch.mul(a[:, t], h, out=hs[:, t])
            h += bx[:, t]
        ctx.save_for_backward(a, hs, h0)
        return hs

    @staticmethod
    @once_differentiable
    def backward(ctx, g_hs):
        a, hs, h0 = ctx.saved_tensors
        G = torch.empty_like(g_hs)
        g = G[:, -1]
        g.copy_(g_hs[:, -1])
        for t in range(a.shape[1] - 2, -1, -1):
            g = torch.addcmul(g_hs[:, t], a[:, t + 1], g, out=G[:, t])
        h_prev = torch.cat([h0[:, None], hs[:, :-1]], 1)
        return G * h_prev, G, a[:, 0] * G[:, 0]


def _chunk_scan(a, bx, h0):
    """Within-chunk scan. a, bx [B,C,Din,N]; h0 [B,Din,N] -> (states
    [B,C,Din,N], a copy of the last state), one step at a time
    (differentiable through ``_Scan``)."""
    hs = _scan_blocks(a, bx, h0) if is_dtensor(a) else _Scan.apply(a, bx,
                                                                   h0)
    return hs, hs[:, -1].clone()


def _scan_blocks(a, bx, h0):
    """``_Scan`` of DTensors on each rank's own block. The recurrence is
    elementwise over (B, Din, N), so with the time dim whole (gathered
    where it is split) every rank scans its lanes exactly as one process
    does, and the states keep ``a``'s placements."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if p.is_shard() and p.dim != 1 else Replicate()
          for p in a.placements]
    # h0 has no time dim: a's dim d > 1 is its dim d - 1
    h_pl = [Shard(p.dim - (p.dim > 1)) if p.is_shard() else p for p in pl]
    hs = _Scan.apply(*blocks([a, bx, replicated_like(h0, a)],
                             [pl, pl, h_pl]))
    return from_blocks(hs, a.device_mesh, pl, a.shape)


def mamba_mixer(p, x, cfg, state=None):
    """Full-sequence mixer. x [B,S,D]. Returns (y [B,S,D], (h, conv))."""
    dt = x.dtype
    B, S, _ = x.shape
    Din = p["in_proj"].shape[-1] // 2
    N = cfg.d_state
    w_in = weight_gather(cfg, p["in_proj"].to(dt), ("fsdp", "tensor"))
    xr, z = torch.chunk(x @ w_in, 2, dim=-1)
    xr = constrain(xr, "batch", None, "tensor")
    if state is None:
        h, conv0 = x.new_zeros(B, Din, N, dtype=torch.float32), None
    else:
        h, conv0 = state
    xc, conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv0)
    xc = F.silu(xc)

    chunk = min(cfg.ssm_chunk, S) or S
    if S % chunk != 0:
        chunk = S
    ys = []
    for s in range(0, S, chunk):
        a, bx, Cc = _ssm_coeffs(p, xc[:, s:s + chunk], cfg)
        hs, h = _chunk_scan(a, bx, h)
        del a, bx
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cc))      # fp32
        del hs
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]

    y = y + p["D"].float() * xc.float()
    y = constrain(y.to(dt) * F.silu(z), "batch", None, "tensor")
    w_out = weight_gather(cfg, p["out_proj"].to(dt), ("tensor", "fsdp"))
    return res_constrain(cfg, y @ w_out), (h, conv_state)


def mamba_step(p, x, cfg, state):
    """Single-token decode. x [B,1,D]; state (h [B,Din,N], conv
    [B,K-1,Din]). Returns (y [B,1,D], (h, conv))."""
    dt = x.dtype
    h, conv0 = state
    xr, z = torch.chunk(x @ p["in_proj"].to(dt), 2, dim=-1)
    xc, conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv0)
    xc = F.silu(xc)                                   # [B,1,Din]
    a, bx, Cc = _ssm_coeffs(p, xc, cfg)
    h = a[:, 0] * h + bx[:, 0]                        # [B,Din,N]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
    y = y + p["D"].float() * xc.float()
    y = y.to(dt) * F.silu(z)
    return y @ p["out_proj"].to(dt), (h, conv_state)


def init_mamba_state(cfg, batch, d_model=None, dtype=torch.bfloat16,
                     device="cuda"):
    Din = cfg.expand * (d_model or cfg.d_model)
    h = torch.zeros(batch, Din, cfg.d_state, dtype=torch.float32,
                    device=device)
    conv = torch.zeros(batch, cfg.d_conv - 1, Din, dtype=dtype,
                       device=device)
    return h, conv
