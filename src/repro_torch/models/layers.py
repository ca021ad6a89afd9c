"""Core model building blocks: templates, norms, RoPE, attention, SwiGLU
(twin of ``repro.models.layers``), the training loss and the remat
policies.

Parameters are nested dicts of tensors. Every family builds a *template*
— a nested dict of ``TSpec(shape, axes, scale)`` — from which the
initialised params are drawn. ``axes`` keeps the reference's logical
sharding names; on one card they are not read.

The arithmetic follows the reference step for step, because serving
compares token ids: the RMS-norm's sum of squares accumulates in fp32
and its ``rsqrt`` is cast to the activation dtype before the multiply;
RoPE rotates split halves in fp32; attention scores and softmax are
fp32 with a -1e30 additive mask (not -inf), and the probabilities are
cast to the query dtype before the PV product. Attention is written out
rather than sent to ``scaled_dot_product_attention``, whose fused
backends sum in another order.

The reference's sharding constraints (``constrain``, ``weight_gather``,
``res_constrain``, ``sp_gather``) stand at the same points: identities on
a plain tensor, a redistribution of a DTensor (``models.sharding``).
Tensors built beside the activations (the RoPE tables, the mask) are
lifted onto a DTensor's mesh, replicated.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.sharding import (ax, blocks, constrain, context,
                                         from_blocks, is_dtensor,
                                         replicated_like, use_context,
                                         weight_gather, whole_dim)

NEG = -1e30          # the reference's additive mask value


class TSpec(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis names (None = replicated)
    scale: float = 0.02    # normal init stddev; 0 -> zeros; -1 -> ones


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a nested dict (keys in sorted order, as a
    JAX pytree flattens them), with the same leaf of each of ``rest``
    (dicts of the same structure) as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts (keys in sorted order), tuples and
    lists; a template's ``TSpec`` is a leaf and ``None`` is none."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, TSpec):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def init_from_template(gen: torch.Generator, template,
                       dtype=torch.float32):
    """Params drawn from ``gen`` on its device, leaf by leaf in sorted key
    order: scale 0 gives zeros, -1 ones, anything else a standard normal
    draw (fp32) times the scale, cast to ``dtype``. The reference draws
    with ``jax.random`` and cannot be reproduced; parity tests carry its
    params over with ``convert.model_params_from_arrays``."""
    dev = gen.device

    def draw(t: TSpec):
        if t.scale == 0.0:
            return torch.zeros(t.shape, dtype=dtype, device=dev)
        if t.scale == -1.0:
            return torch.ones(t.shape, dtype=dtype, device=dev)
        return (torch.randn(t.shape, generator=gen, device=dev)
                * t.scale).to(dtype)
    return tree_map(draw, template)


def specs_from_template(template):
    return tree_map(lambda t: ax(*t.axes), template)


def abstract_from_template(template, dtype=torch.float32):
    """The template's tensors on the ``meta`` device (no storage)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=dtype,
                                          device="meta"), template)


def res_constrain(cfg, x):
    """Residual-stream sharding constraint (ModelConfig.residual_shard)."""
    if cfg.residual_shard == "seq":
        return constrain(x, "batch", "tensor", None)
    if cfg.residual_shard == "dmodel":
        return constrain(x, "batch", None, "tensor")
    return constrain(x, "batch", None, None)


def sp_gather(cfg, h):
    """Block-boundary gather: the seq- or dmodel-sharded activation
    collected once, so that the projections that read it share one
    all-gather."""
    if cfg.residual_shard in ("seq", "dmodel"):
        return constrain(h, "batch", None, None)
    return h


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps=1e-5):
    # fp32 sum of squares over the activation dtype's operands (a bf16
    # product is exact in fp32), then the multiply in x.dtype
    sq = x.float().square().sum(-1)
    var = (sq / x.shape[-1])[..., None]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * weight.to(x.dtype)


def rope_freqs(positions, head_dim, theta):
    """positions [...], returns (cos, sin) of shape [..., head_dim//2]."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.float()[..., None] * replicated_like(inv, positions)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B,S,H,D]; cos/sin [B,S,half] or [S,half]."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.ndim == 2:       # [S, half] -> [1, S, 1, half]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.ndim == 3:     # [B, S, half] -> [B, S, 1, half]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _mask_bias(qpos, kpos, *, causal, window, kv_len=None):
    """Additive mask bias [*, S, T] (fp32) from absolute positions."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    cond = replicated_like(torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                                      dtype=torch.bool, device=kpos.device),
                           k)
    if causal:
        cond = cond & (k <= q)
    if window:
        cond = cond & (k > q - window)
    if kv_len is not None:
        cond = cond & (k < kv_len)
    return torch.where(cond, 0.0, NEG).float()


def _attn_core(q, k, v, bias):
    """q [B,S,H,D]; k,v [B,T,H,D]; bias broadcastable to [B,1,S,T] (fp32)."""
    if is_dtensor(q) or is_dtensor(k):
        return _attn_blocks(q, k, v, bias)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _attn_blocks(q, k, v, bias):
    """``_attn_core`` of DTensors, each rank on its own block. Attention is
    independent per batch row, query and head, so q keeps its split of
    those dims and k, v and the bias follow it (DTensor's einsum would
    flatten a sharded head dim into the batched product's batch, which
    torch 2.11 refuses). A key dim split over mesh dims (a seq-sharded
    decode cache) stays split: the softmax's max and sum and the partial
    PV products are all-reduced over those mesh dims (flash-decoding's
    combine; no backward) instead of gathering the cache."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    ref = q if is_dtensor(q) else k
    mesh = ref.device_mesh
    t_dims = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
    # per mesh dim: the q dim it splits (0 batch, 1 query, 2 head), or 3
    # where it splits the keys
    split = [3 if i in t_dims else p.dim if p.is_shard() and p.dim < 3
             else None for i, p in enumerate(q.placements)]

    def pl(t, dims):    # dims: t's dim for (batch, query, head, key)
        out = []
        for axis in split:
            dim = None if axis is None else dims[axis]
            out.append(Shard(dim) if dim is not None and t.shape[dim] > 1
                       else Replicate())
        return out
    q, k, v, bias = (replicated_like(t, ref) for t in (q, k, v, bias))
    q_pl = pl(q, (0, 1, 2, None))
    ql, kl, vl, bl = blocks([q, k, v, bias], [
        q_pl, pl(k, (0, None, 2, 1)), pl(v, (0, None, 2, 1)),
        pl(bias, (0, 2, 1, 3))])
    scale = 1.0 / math.sqrt(ql.shape[-1])
    scores = torch.einsum("bshd,bthd->bhst", ql.float(), kl.float()) * scale
    scores = scores + bl
    if not t_dims:
        probs = torch.softmax(scores, dim=-1).to(ql.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, vl)
    else:
        def reduce(t, op):
            for i in t_dims:
                t = funcol.all_reduce(t, op, (mesh, i))
            return t
        m = reduce(scores.amax(-1, keepdim=True), "max")
        e = torch.exp(scores - m)
        probs = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(ql.dtype)
        out = reduce(torch.einsum("bhst,bthd->bshd", probs, vl), "sum")
    return from_blocks(out, mesh, q_pl, q.shape)


def repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def attention(q, k, v, *, causal=True, q_offset=0, window=0, kv_len=None,
              chunk=0):
    """Multi-head attention with GQA repeat, optional sliding window and
    query chunking (memory control for long prefill).

    q [B,S,Hq,D]; k,v [B,T,Hkv,D]. q_offset: absolute position of q[0]
    (scalar or [B]). kv_len: valid KV length (scalar or [B]) for decode.
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dev = q.device
    k = repeat_kv(k, Hq // Hkv)
    v = repeat_kv(v, Hq // Hkv)
    # positions given as DTensors (a sharded decode's cache length) put
    # the mask's other positions on their mesh, replicated
    on_mesh = next((t for t in (q_offset, kv_len) if is_dtensor(t)), None)

    def positions(t):
        return replicated_like(torch.as_tensor(t, device=dev), on_mesh)
    q_offset = positions(q_offset)
    kv_len_arr = None if kv_len is None else positions(kv_len)
    kpos = positions(torch.arange(T, device=dev))

    def block(qc, off):
        Sc = qc.shape[1]
        ar = positions(torch.arange(Sc, device=dev))
        if off.ndim == 0:
            bias = _mask_bias(off + ar, kpos, causal=causal, window=window,
                              kv_len=kv_len_arr
                              if (kv_len_arr is None or kv_len_arr.ndim == 0)
                              else None)[None, None]
        else:  # per-batch offsets
            bias = _mask_bias(off[:, None] + ar, kpos, causal=causal,
                              window=window)[:, None]
        if kv_len_arr is not None and kv_len_arr.ndim == 1:
            bias = bias + torch.where(kpos[None, None, None, :]
                                      < kv_len_arr[:, None, None, None],
                                      0.0, NEG)
        return _attn_core(qc, k, v, bias)

    if chunk and S > chunk and S % chunk == 0:
        return torch.cat([block(q[:, i:i + chunk], q_offset + i)
                          for i in range(0, S, chunk)], dim=1)
    return block(q, q_offset)


def cross_attention(q, k, v):
    """Bidirectional cross-attention (whisper decoder -> encoder memory)."""
    return attention(q, k, v, causal=False)


def decode_attention(q, k_cache, v_cache, kv_len, *, window=0):
    """Single-token decode attention. q [B,1,Hq,D]; caches [B,T,Hkv,D]."""
    return attention(q, k_cache, v_cache, causal=False, window=window,
                     q_offset=torch.as_tensor(kv_len) - 1 if window else 0,
                     kv_len=kv_len)


# ---------------------------------------------------------------------------
# Attention block (projections + RoPE + attention)
# ---------------------------------------------------------------------------

def attn_template(cfg, stacked: Optional[int] = None):
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    s = 0.02
    t = {
        "wq": TSpec(L + (D, Hq * Dh), LN + ("fsdp", "tensor"), s),
        "wk": TSpec(L + (D, Hkv * Dh), LN + ("fsdp", "tensor"), s),
        "wv": TSpec(L + (D, Hkv * Dh), LN + ("fsdp", "tensor"), s),
        "wo": TSpec(L + (Hq * Dh, D), LN + ("tensor", "fsdp"),
                    s / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        t["q_norm"] = TSpec(L + (Dh,), LN + (None,), -1.0)
        t["k_norm"] = TSpec(L + (Dh,), LN + (None,), -1.0)
    return t


def attn_qkv(p, x, cfg, positions):
    """Project + RoPE. Returns q [B,S,Hq,D], k,v [B,S,Hkv,D]."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    wq = weight_gather(cfg, p["wq"].to(dt), ("fsdp", "tensor"))
    wk = weight_gather(cfg, p["wk"].to(dt), ("fsdp", "tensor"))
    wv = weight_gather(cfg, p["wv"].to(dt), ("fsdp", "tensor"))
    q = whole_dim(x @ wq, 2, Hq).reshape(B, S, Hq, Dh)
    k = whole_dim(x @ wk, 2, Hkv).reshape(B, S, Hkv, Dh)
    v = whole_dim(x @ wv, 2, Hkv).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = (replicated_like(t, x)
                for t in rope_freqs(positions, Dh, cfg.rope_theta))
    q = constrain(apply_rope(q, cos, sin), "batch", None, "tensor", None)
    return q, apply_rope(k, cos, sin), v


def attn_out(p, o, cfg):
    B, S = o.shape[:2]
    wo = weight_gather(cfg, p["wo"].to(o.dtype), ("tensor", "fsdp"))
    o = whole_dim(o, 2, cfg.n_heads)
    y = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ wo
    return res_constrain(cfg, y)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_template(cfg, stacked: Optional[int] = None, d_ff=None):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    return {
        "w_gate": TSpec(L + (D, Fd), LN + ("fsdp", "tensor"), 0.02),
        "w_up": TSpec(L + (D, Fd), LN + ("fsdp", "tensor"), 0.02),
        "w_down": TSpec(L + (Fd, D), LN + ("tensor", "fsdp"),
                        0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def mlp_apply(p, x, cfg):
    dt = x.dtype
    wg = weight_gather(cfg, p["w_gate"].to(dt), ("fsdp", "tensor"))
    wu = weight_gather(cfg, p["w_up"].to(dt), ("fsdp", "tensor"))
    wd = weight_gather(cfg, p["w_down"].to(dt), ("tensor", "fsdp"))
    h = constrain(F.silu(x @ wg) * (x @ wu), "batch", None, "tensor")
    return res_constrain(cfg, h @ wd)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_template(cfg):
    V, D = cfg.padded_vocab, cfg.d_model
    t = {
        "embed": TSpec((V, D), ("tensor", "fsdp"), 0.02),
        "final_norm": TSpec((D,), (None,), -1.0),
    }
    if not cfg.tie_embeddings:
        t["head"] = TSpec((D, V), ("fsdp", "tensor"), 0.02)
    return t


def embed_tokens(p, tokens, dtype):
    """Rows of the table for ``tokens``, cast to ``dtype`` (gather, then
    cast: the same values as casting the table first). A DTensor table is
    gathered whole first: DTensor's vocab-parallel embedding mishandles
    batch-sharded ids."""
    table = constrain(p["embed"], None, None)
    emb = F.embedding(replicated_like(tokens, table).long(), table)
    emb = emb.to(dtype)
    return constrain(emb, "batch", None, None)


def lm_logits(p, x, cfg):
    """Logits over the padded vocabulary (``cfg.padded_vocab`` wide)."""
    w = p["head"] if not cfg.tie_embeddings else p["embed"].T
    return constrain(x @ w.to(x.dtype), "batch", None, "tensor")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """logits [B,S,V], labels [B,S] -> the mean token cross-entropy (fp32).
    The logsumexp runs over all V columns, the padding columns of
    ``lm_logits`` included, as the reference's does; with ``mask`` [B,S]
    the mean is over the masked-in tokens (at least one). DTensor logits
    are gathered whole on the vocabulary first (DTensor's gather from a
    vocab-sharded tensor mishandles batch-sharded labels)."""
    logits = constrain(logits.float(), "batch", None, None)
    labels = replicated_like(torch.as_tensor(labels, device=logits.device),
                             logits).long()
    loss = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    if mask is not None:
        mask = replicated_like(torch.as_tensor(mask, device=logits.device),
                               logits).float()
        return (loss * mask).sum() / mask.sum().clamp_min(1)
    return loss.mean()


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

# "dots" keeps the outputs of the products without batch dimensions (a
# [B,S,D] x [D,F] ``@`` folds to ``mm``), as the reference's
# ``dots_with_no_batch_dims_saveable``; the attention and expert
# products run as ``bmm`` and are recomputed, as in JAX
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _dots_context():
    return create_selective_checkpoint_contexts(_DOTS)


def _differentiated(args) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for a in args for t in tree_leaves(a)
        if torch.is_tensor(t))


def maybe_remat(fn, policy: str):
    """``fn`` under the remat ``policy``: "none" saves every activation,
    "dots" saves ``fn``'s inputs and its batch-free matmul outputs and
    recomputes the rest in the backward, anything else ("full") saves
    only the inputs. A call that no gradient will pass through (grad
    mode off, or no argument requiring grad: serving, prefill) runs
    ``fn`` as it is, as ``jax.checkpoint`` does outside
    differentiation. The values computed do not depend on the policy.
    The recompute runs under the forward's mesh and rules, on whatever
    thread the backward takes."""
    if policy == "none":
        return fn
    kw = {"context_fn": _dots_context} if policy == "dots" else {}

    def remat(*args):
        if not _differentiated(args):
            return fn(*args)
        ctx = context()

        def in_context(*a):      # the recompute keeps the forward's rules
            with use_context(ctx):
                return fn(*a)
        return checkpoint(in_context, *args, use_reentrant=False, **kw)
    return remat
