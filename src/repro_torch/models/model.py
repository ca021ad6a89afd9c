"""Model assembly, dense family (twin of ``repro.models.model``).

The layer stack is a Python loop over the stacked layer params (the
reference scans them). ``prefill`` returns a KV cache; ``decode_step``
consumes it and writes the new token's keys and values into it IN PLACE
(one write per lane; the reference returns a new cache, the port saves
the copy of the whole cache per token), returning the cache dict with
the new length.

Only the dense family is ported (SmolLM, Qwen3, Phi-4-mini, DeepSeek);
MoE, SSM, hybrid, enc-dec and VLM raise ``ValueError`` (ROADMAP A.12).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models.layers import (TSpec, attention, attn_out, attn_qkv,
                                       attn_template, decode_attention,
                                       embed_template, embed_tokens,
                                       lm_logits, mlp_apply, mlp_template,
                                       rms_norm)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dense_only(cfg):
    if cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port "
            "serves the dense family only (ROADMAP A.12)")


def dtype_of(name) -> torch.dtype:
    return DTYPES[name] if isinstance(name, str) else name


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _norm_t(cfg, stacked=None):
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    return TSpec(L + (cfg.d_model,), LN + (None,), -1.0)


def _dense_layer_template(cfg, n):
    return {"attn": attn_template(cfg, stacked=n),
            "ln1": _norm_t(cfg, n),
            "ln2": _norm_t(cfg, n),
            "mlp": mlp_template(cfg, stacked=n)}


def build_templates(cfg):
    _dense_only(cfg)
    return {"tok": embed_template(cfg),
            "layers": _dense_layer_template(cfg, cfg.n_layers)}


def init_params(cfg, gen: torch.Generator, dtype=None):
    """Params from ``gen``, on its device, in ``dtype`` (default
    ``cfg.param_dtype``)."""
    return Lyr.init_from_template(gen, build_templates(cfg),
                                  dtype_of(dtype or cfg.param_dtype))


def cast_params(cfg, params, device=None):
    """The params on ``device`` with every fp32 leaf cast to ``cfg.dtype``,
    once (the serving engines call it when they are built; the reference
    casts its layer stack on every call). Every use of a param casts it
    to the activation dtype, so the numbers are those of the fp32
    params; a leaf already in place is not copied."""
    dt = dtype_of(cfg.dtype)
    return Lyr.tree_map(
        lambda a: a.to(device=device or a.device,
                       dtype=dt if a.dtype == torch.float32 else a.dtype),
        params)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _n_layers(layers) -> int:
    return layers["ln1"].shape[0]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def dense_layer_fwd(cfg, p, x, positions, *, collect=False):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = x + attn_out(p["attn"], o, cfg)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h)
    return (x, (k, v)) if collect else (x, None)


def _lm_trunk(cfg, params, emb, positions, collect=False):
    """Run the layer stack on embeddings. Returns (hidden, (k, v)) with k,
    v stacked [L, B, S, Hkv, Dh] when ``collect``, else (hidden, None)."""
    _dense_only(cfg)
    layers = params["layers"]
    x, ks, vs = emb, [], []
    for i in range(_n_layers(layers)):
        x, kv = dense_layer_fwd(cfg, _layer(layers, i), x, positions,
                                collect=collect)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
    return x, ((torch.stack(ks), torch.stack(vs)) if collect else None)


def forward_lm(cfg, params, tokens):
    """Full-sequence forward. tokens [B,S] -> logits [B,S,padded_vocab]."""
    _dense_only(cfg)
    dt = dtype_of(cfg.dtype)
    dev = params["tok"]["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    emb = embed_tokens(params["tok"], tokens, dt)
    positions = torch.arange(emb.shape[1], device=dev)
    x, _ = _lm_trunk(cfg, params, emb, positions)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x, cfg)


# ---------------------------------------------------------------------------
# KV cache, prefill, decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, device="cuda"):
    """Zero decode cache: k, v [L, B, max_len, Hkv, Dh] and len (int32
    scalar, or [B] per lane)."""
    _dense_only(cfg)
    dt = dtype_of(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg, params, batch_inputs, max_len):
    """Full-sequence forward that fills a decode cache. Returns (logits of
    the last position [B,1,V], cache)."""
    _dense_only(cfg)
    dt = dtype_of(cfg.dtype)
    dev = params["tok"]["embed"].device
    tokens = torch.as_tensor(batch_inputs["tokens"], device=dev)
    cache = init_cache(cfg, tokens.shape[0], max_len, device=dev)
    emb = embed_tokens(params["tok"], tokens, dt)
    S = emb.shape[1]
    x, (k, v) = _lm_trunk(cfg, params, emb, torch.arange(S, device=dev),
                          collect=True)
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    cache["len"] = torch.tensor(S, dtype=torch.int32, device=dev)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x[:, -1:], cfg), cache


def _cache_write(cache, val, pos):
    """Write one token into ``cache`` [B, T, ...] in place at position
    ``pos`` (scalar, or [B] for per-lane continuous batching), clamped to
    [0, T-1] as the reference's dynamic update is. One write per lane:
    no index repeats."""
    pos = pos.long().clamp(0, cache.shape[1] - 1)
    if pos.ndim == 0:
        cache.index_copy_(1, pos.view(1), val[:, None])
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = val
    return cache


def _decode_attn_layer(cfg, p, x, k_cache, v_cache, pos, kv_len):
    """One decode attention sublayer (full attention; the sliding-window
    branch belongs to the hybrid family). ``pos`` is a scalar or a
    per-lane [B] vector. Returns (attn_out, k_cache, v_cache)."""
    positions = pos[None, None] if pos.ndim == 0 else pos[:, None]
    q, k, v = attn_qkv(p["attn"], x, cfg, positions)
    k_cache = _cache_write(k_cache, k[:, 0], pos)
    v_cache = _cache_write(v_cache, v[:, 0], pos)
    return decode_attention(q, k_cache, v_cache, kv_len), k_cache, v_cache


def decode_step(cfg, params, cache, token):
    """One-token decode. token [B,1] int. Returns (logits [B,1,V], cache)
    with the caches written in place and ``len`` advanced by one."""
    _dense_only(cfg)
    dt = dtype_of(cfg.dtype)
    dev = params["tok"]["embed"].device
    pos = torch.as_tensor(cache["len"], device=dev)
    kv_len = pos + 1
    x = embed_tokens(params["tok"], torch.as_tensor(token, device=dev), dt)
    layers = params["layers"]
    kall, vall = cache["k"], cache["v"]
    for i in range(_n_layers(layers)):
        p = _layer(layers, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        o, _, _ = _decode_attn_layer(cfg, p, h, kall[i], vall[i], pos,
                                     kv_len)
        x = x + attn_out(p["attn"], o, cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h)
    cache = dict(cache, len=kv_len)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x, cfg), cache
