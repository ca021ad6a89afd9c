"""Model assembly for every architecture family (twin of
``repro.models.model``).

Families: dense | moe | ssm | hybrid | encdec | vlm.

Each layer stack is a Python loop over the stacked layer params (the
reference scans them), each layer of a full-sequence forward under the
config's remat policy (``layers.maybe_remat``); the hybrid family runs
its 3 global-attention layers and its sliding-window layers in layer
order. ``loss_fn`` is the training loss over that forward. ``prefill``
returns a KV/SSM cache; ``decode_step`` consumes it and writes the new
token's keys, values and states into it IN PLACE (one write per lane;
the reference returns a new cache, the port saves the copy of the whole
cache per token), returning the cache dict with the new length.

As the reference does, the layer params are cast to the compute dtype
once per call (``cfg.cast_params_once``), so that the fp32 reads of the
router and the SSM's dt/A/D weights see the values the reference sees.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as Lyr
from repro_torch.models import mamba as M
from repro_torch.models import moe as Moe
from repro_torch.models.layers import (NEG, TSpec, attention, attn_out,
                                       attn_qkv, attn_template,
                                       decode_attention, embed_template,
                                       embed_tokens, lm_logits, maybe_remat,
                                       mlp_apply, mlp_template, res_constrain,
                                       rms_norm, softmax_xent, sp_gather)
from repro_torch.models.sharding import (ax, constrain, index_copy_,
                                         is_dtensor, placements,
                                         replicated_like)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name) -> torch.dtype:
    return DTYPES[name] if isinstance(name, str) else name


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _norm_t(cfg, stacked=None):
    L = (stacked,) if stacked else ()
    LN = (None,) if stacked else ()
    return TSpec(L + (cfg.d_model,), LN + (None,), -1.0)


def _dense_layer_template(cfg, n, with_moe=False):
    return {"attn": attn_template(cfg, stacked=n),
            "ln1": _norm_t(cfg, n),
            "ln2": _norm_t(cfg, n),
            "mlp": Moe.moe_template(cfg, stacked=n) if with_moe
            else mlp_template(cfg, stacked=n)}


def _hybrid_layer_template(cfg, n):
    return {"attn": attn_template(cfg, stacked=n),
            "ssm": M.ssm_template(cfg, stacked=n),
            "ln1": _norm_t(cfg, n),
            "ln2": _norm_t(cfg, n),
            "ln_attn": _norm_t(cfg, n),
            "ln_ssm": _norm_t(cfg, n),
            "mlp": mlp_template(cfg, stacked=n)}


def _encdec_layer_templates(cfg):
    ne, nd = cfg.n_enc_layers, cfg.n_dec_layers
    enc = {"attn": attn_template(cfg, stacked=ne),
           "ln1": _norm_t(cfg, ne),
           "ln2": _norm_t(cfg, ne),
           "mlp": mlp_template(cfg, stacked=ne)}
    dec = {"attn": attn_template(cfg, stacked=nd),
           "xattn": attn_template(cfg, stacked=nd),
           "ln1": _norm_t(cfg, nd),
           "lnx": _norm_t(cfg, nd),
           "ln2": _norm_t(cfg, nd),
           "mlp": mlp_template(cfg, stacked=nd)}
    return enc, dec


def hybrid_split(cfg):
    """(global_layer_ids, swa span sizes). Globals: first / middle / last."""
    L = cfg.n_layers
    g = sorted({0, L // 2, L - 1})
    spans = []
    prev = -1
    for gi in g + [L]:
        spans.append(gi - prev - 1)
        prev = gi
    return g, spans  # len(spans) == len(g)+1 (span before each global + tail)


def _hybrid_order(cfg):
    """The hybrid's layers in order, as ("global", i) or ("swa", j): the
    reference's spans and globals, interleaved."""
    g_ids, _ = hybrid_split(cfg)
    order, j = [], 0
    for layer in range(cfg.n_layers):
        if layer in g_ids:
            order.append(("global", g_ids.index(layer)))
        else:
            order.append(("swa", j))
            j += 1
    return order


def build_templates(cfg):
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {"tok": embed_template(cfg),
                "layers": _dense_layer_template(cfg, cfg.n_layers)}
    if fam == "moe":
        return {"tok": embed_template(cfg),
                "layers": _dense_layer_template(cfg, cfg.n_layers,
                                                with_moe=True)}
    if fam == "ssm":
        return {"tok": embed_template(cfg),
                "layers": {"ssm": M.ssm_template(cfg, stacked=cfg.n_layers),
                           "ln1": _norm_t(cfg, cfg.n_layers)}}
    if fam == "hybrid":
        g, _ = hybrid_split(cfg)
        return {"tok": embed_template(cfg),
                "global": _hybrid_layer_template(cfg, len(g)),
                "swa": _hybrid_layer_template(cfg, cfg.n_layers - len(g))}
    if fam == "encdec":
        enc, dec = _encdec_layer_templates(cfg)
        return {"tok": embed_template(cfg), "enc": enc, "dec": dec,
                "enc_final_norm": _norm_t(cfg)}
    raise ValueError(fam)


def init_params(cfg, gen: torch.Generator, dtype=None):
    """Params from ``gen``, on its device, in ``dtype`` (default
    ``cfg.param_dtype``)."""
    return Lyr.init_from_template(gen, build_templates(cfg),
                                  dtype_of(dtype or cfg.param_dtype))


def param_specs(cfg):
    return Lyr.specs_from_template(build_templates(cfg))


def abstract_params(cfg, dtype=None):
    """The params' shapes and dtype as ``meta`` tensors."""
    return Lyr.abstract_from_template(build_templates(cfg),
                                      dtype_of(dtype or cfg.param_dtype))


def cast_params(cfg, params, device=None):
    """The params on ``device`` with every fp32 leaf cast to ``cfg.dtype``,
    once (the serving engines call it when they are built). Every use of
    a param casts it to the activation dtype, and the fp32 reads (router,
    dt/A/D) see the cast values, as the reference's do; a leaf already in
    place is not copied."""
    dt = dtype_of(cfg.dtype)
    return Lyr.tree_map(
        lambda a: a.to(device=device or a.device,
                       dtype=dt if a.dtype == torch.float32 else a.dtype),
        params)


def _cast_once(cfg, tree):
    return cast_params(cfg, tree) if cfg.cast_params_once else tree


def _unstack(tree) -> list:
    """Stacked layer params -> one param dict a layer. ``unbind`` splits
    every leaf once, so the backward stacks the layers' gradients in one
    write (indexing layer by layer would add a full-size zero gradient a
    layer)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v) for k, v in tree.items()}
        return [dict(zip(cols, row)) for row in zip(*cols.values())]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# Layer bodies (full-sequence forward; optionally emit KV/state for prefill)
# ---------------------------------------------------------------------------

def dense_layer_fwd(cfg, p, x, positions, *, window=0, collect=False):
    x = res_constrain(cfg, x)
    h = sp_gather(cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    o = attention(q, k, v, causal=True, window=window, chunk=cfg.attn_chunk)
    x = x + attn_out(p["attn"], o, cfg)
    h = sp_gather(cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    if cfg.family == "moe" or "router" in p["mlp"]:
        x = x + Moe.moe_apply(p["mlp"], h, cfg)
    else:
        x = x + mlp_apply(p["mlp"], h, cfg)
    if collect:   # the prefill KV sharded like the decode cache
        k = constrain(k, "batch", "kv_seq", None, None)
        v = constrain(v, "batch", "kv_seq", None, None)
        return x, (k, v)
    return x, None


def ssm_layer_fwd(cfg, p, x, *, collect=False):
    x = res_constrain(cfg, x)
    h = sp_gather(cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
    y, state = M.mamba_mixer(p["ssm"], h, cfg)
    return (x + y, state) if collect else (x + y, None)


def hybrid_layer_fwd(cfg, p, x, positions, *, window, collect=False):
    x = res_constrain(cfg, x)
    h = sp_gather(cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    o = attention(q, k, v, causal=True, window=window, chunk=cfg.attn_chunk)
    ao = attn_out(p["attn"], o, cfg)
    so, state = M.mamba_mixer(p["ssm"], h, cfg)
    fused = 0.5 * (rms_norm(ao, p["ln_attn"], cfg.norm_eps)
                   + rms_norm(so, p["ln_ssm"], cfg.norm_eps))
    x = x + fused
    h2 = sp_gather(cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    x = x + mlp_apply(p["mlp"], h2, cfg)
    if collect:
        k = constrain(k, "batch", "kv_seq", None, None)
        v = constrain(v, "batch", "kv_seq", None, None)
        return x, ((k, v), state)
    return x, None


def enc_layer_fwd(cfg, p, x, positions):
    x = res_constrain(cfg, x)
    h = sp_gather(cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    o = attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    x = x + attn_out(p["attn"], o, cfg)
    h = sp_gather(cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + mlp_apply(p["mlp"], h, cfg)


def dec_layer_fwd(cfg, p, x, memory, positions, mem_positions, *,
                  collect=False):
    x = res_constrain(cfg, x)
    h = sp_gather(cfg, rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = attn_qkv(p["attn"], h, cfg, positions)
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    x = x + attn_out(p["attn"], o, cfg)
    h = sp_gather(cfg, rms_norm(x, p["lnx"], cfg.norm_eps))
    qx, _, _ = attn_qkv(p["xattn"], h, cfg, positions)
    # cross KV come from the encoder memory, RoPE'd at its own positions
    _, mk, mv = attn_qkv(p["xattn"], memory, cfg, mem_positions)
    ox = attention(qx, mk, mv, causal=False, chunk=cfg.attn_chunk)
    x = x + attn_out(p["xattn"], ox, cfg)
    h = sp_gather(cfg, rms_norm(x, p["ln2"], cfg.norm_eps))
    x = x + mlp_apply(p["mlp"], h, cfg)
    if collect:
        k = constrain(k, "batch", None, None, None)
        mk = constrain(mk, "batch", "kv_seq", None, None)
        mv = constrain(mv, "batch", "kv_seq", None, None)
        return x, (k, v, mk, mv)
    return x, None


def _stack(parts):
    """A list of per-layer tuples of tensors -> a tuple of stacked
    tensors (layer dim 0)."""
    return tuple(torch.stack(t) for t in zip(*parts))


def _lm_trunk(cfg, params, emb, positions, collect=False):
    """Run the layer stack on embeddings, each layer under the config's
    remat policy. Returns (hidden, cache parts): with ``collect``, (k, v)
    stacked [L, B, S, Hkv, Dh] for dense, moe and vlm; (h, conv) stacked
    for ssm; for hybrid, per-layer lists of ((k, v), (h, conv)) for the
    global and the window layers."""
    fam = cfg.family
    rp = cfg.remat_policy
    if fam in ("dense", "moe", "vlm", "ssm"):
        if fam == "ssm":
            lyr = maybe_remat(lambda x, p: ssm_layer_fwd(
                cfg, p, x, collect=collect), rp)
        else:
            lyr = maybe_remat(lambda x, p: dense_layer_fwd(
                cfg, p, x, positions, collect=collect), rp)
        x, parts = emb, []
        for p in _unstack(_cast_once(cfg, params["layers"])):
            x, part = lyr(x, p)
            parts.append(part)
        return x, (_stack(parts) if collect else None)

    if fam == "hybrid":
        def layer(window):
            return maybe_remat(lambda x, p: hybrid_layer_fwd(
                cfg, p, x, positions, window=window, collect=collect), rp)
        lyr = {"global": layer(0), "swa": layer(cfg.swa_window)}
        stacks = {k: _unstack(_cast_once(cfg, params[k])) for k in lyr}
        x, caches = emb, {"global": [], "swa": []}
        for kind, i in _hybrid_order(cfg):
            x, c = lyr[kind](x, stacks[kind][i])
            caches[kind].append(c)
        return x, ((caches["global"], caches["swa"]) if collect else None)

    raise ValueError(fam)


def forward_lm(cfg, params, tokens, patches=None):
    """Full-sequence forward for the decoder-only families. tokens [B,S]
    (and, for vlm, patch embeddings [B,P,D] placed before them) -> logits
    [B,P+S,padded_vocab]."""
    dt = dtype_of(cfg.dtype)
    dev = params["tok"]["embed"].device
    emb = embed_tokens(params["tok"], torch.as_tensor(tokens, device=dev),
                       dt)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError(f"{cfg.name}: the vlm forward needs patches")
        emb = torch.cat([torch.as_tensor(patches, device=dev).to(dt), emb],
                        dim=1)
    positions = torch.arange(emb.shape[1], device=dev)
    x, _ = _lm_trunk(cfg, params, emb, positions)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x, cfg)


def _encode(cfg, params, frames):
    """The encoder over frame embeddings [B,T,D]. Returns (memory,
    memory positions)."""
    dt = dtype_of(cfg.dtype)
    dev = params["tok"]["embed"].device
    mem = torch.as_tensor(frames, device=dev).to(dt)
    mem_pos = torch.arange(mem.shape[1], device=dev)
    lyr = maybe_remat(lambda x, p: enc_layer_fwd(cfg, p, x, mem_pos),
                      cfg.remat_policy)
    for p in _unstack(_cast_once(cfg, params["enc"])):
        mem = lyr(mem, p)
    return rms_norm(mem, params["enc_final_norm"], cfg.norm_eps), mem_pos


def _decode_trunk(cfg, params, mem, mem_pos, tokens, collect=False):
    """The decoder over the encoder memory. Returns (hidden, stacked
    (k, v, mk, mv) with ``collect``)."""
    dev = params["tok"]["embed"].device
    x = embed_tokens(params["tok"], torch.as_tensor(tokens, device=dev),
                     dtype_of(cfg.dtype))
    pos = torch.arange(x.shape[1], device=dev)
    lyr = maybe_remat(lambda x, p: dec_layer_fwd(
        cfg, p, x, mem, pos, mem_pos, collect=collect), cfg.remat_policy)
    parts = []
    for p in _unstack(_cast_once(cfg, params["dec"])):
        x, kv = lyr(x, p)
        parts.append(kv)
    return x, (_stack(parts) if collect else None)


def forward_encdec(cfg, params, frames, tokens):
    """Encoder over frames [B,T,D], decoder over tokens [B,S] -> logits
    [B,S,padded_vocab]."""
    mem, mem_pos = _encode(cfg, params, frames)
    x, _ = _decode_trunk(cfg, params, mem, mem_pos, tokens)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x, cfg)


def loss_fn(cfg, params, batch):
    """The training loss: ``batch`` holds the family's inputs (tokens;
    patches for vlm, frames for encdec), labels [B,S] and an optional
    mask [B,S]. The vlm's patch positions carry no label and are dropped
    before the loss."""
    if cfg.family == "encdec":
        logits = forward_encdec(cfg, params, batch["frames"], batch["tokens"])
    else:
        logits = forward_lm(cfg, params, batch["tokens"], batch.get("patches"))
        if cfg.family == "vlm":
            logits = logits[:, batch["patches"].shape[1]:]
    return softmax_xent(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, device="cuda", mesh=None):
    """Zero decode cache (the reference's fields and shapes); ``len`` is
    an int32 scalar, or [B] per lane. With ``mesh`` (a named
    ``DeviceMesh``) every field is a DTensor laid out by ``cache_specs``
    under the current rules, each rank allocating its own block."""
    dt = dtype_of(dtype or cfg.dtype)
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    f32, i32 = torch.float32, torch.int32
    fam = cfg.family

    def kv(n, T):
        return ((n, batch, T, Hkv, Dh), dt), ((n, batch, T, Hkv, Dh), dt)

    def ssm(n):
        return (((n, batch, cfg.d_inner, cfg.d_state), f32),
                ((n, batch, cfg.d_conv - 1, cfg.d_inner), dt))

    length = ((), i32)
    if fam in ("dense", "moe", "vlm"):
        k, v = kv(cfg.n_layers, max_len)
        fields = {"k": k, "v": v, "len": length}
    elif fam == "ssm":
        h, conv = ssm(cfg.n_layers)
        fields = {"h": h, "conv": conv, "len": length}
    elif fam == "hybrid":
        g_ids, _ = hybrid_split(cfg)
        nG, nW = len(g_ids), cfg.n_layers - len(g_ids)
        W = min(cfg.swa_window, max_len)
        (kg, vg), (kw, vw) = kv(nG, max_len), kv(nW, W)
        (hg, convg), (hw, convw) = ssm(nG), ssm(nW)
        fields = {"kg": kg, "vg": vg, "kw": kw, "vw": vw,
                  "wpos": ((nW, batch, W), i32),
                  "hg": hg, "convg": convg, "hw": hw, "convw": convw,
                  "len": length}
    elif fam == "encdec":
        k, v = kv(cfg.n_dec_layers, min(max_len, 4096))
        ck, cv = kv(cfg.n_dec_layers, max_len)
        fields = {"k": k, "v": v, "ck": ck, "cv": cv, "enc_len": length,
                  "len": length}
    else:
        raise ValueError(fam)
    specs = cache_specs(cfg) if mesh is not None else {}

    def new(name, shape, dtype):
        fill = -1 if name == "wpos" else 0    # the ring's empty slots
        if mesh is None:
            return torch.full(shape, fill, dtype=dtype, device=device)
        from torch.distributed.tensor import full
        return full(shape, fill, dtype=dtype, device_mesh=mesh,
                    placements=placements(specs[name], mesh))
    return {name: new(name, *f) for name, f in fields.items()}


def cache_specs(cfg, long_context=False):
    """Specs of ``init_cache``'s tree. The KV sequence dim is sharded
    (logical kv_seq, or kv_seq_long for the long-context cell); the
    hybrid's window ring on kv_seq."""
    seq_ax = "kv_seq_long" if long_context else "kv_seq"
    kvs = ax(None, "batch", seq_ax, None, None)
    h = ax(None, "batch", "tensor", None)
    conv = ax(None, "batch", None, "tensor")
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {"k": kvs, "v": kvs, "len": ax()}
    if fam == "ssm":
        return {"h": h, "conv": conv, "len": ax()}
    if fam == "hybrid":
        win = ax(None, "batch", "kv_seq", None, None)
        return {"kg": kvs, "vg": kvs, "kw": win, "vw": win,
                "wpos": ax(None, "batch", "kv_seq"), "hg": h, "convg": conv,
                "hw": h, "convw": conv, "len": ax()}
    if fam == "encdec":
        dec = ax(None, "batch", None, None, None)
        return {"k": dec, "v": dec, "ck": kvs, "cv": kvs,
                "enc_len": ax(), "len": ax()}
    raise ValueError(fam)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(cfg, params, batch_inputs, max_len):
    """Full-sequence forward that fills a decode cache. ``batch_inputs``
    holds ``tokens`` (and ``patches`` for vlm, ``frames`` for encdec).
    Returns (logits of the last position [B,1,V], cache)."""
    fam = cfg.family
    embed = params["tok"]["embed"]
    dev = embed.device
    tokens = torch.as_tensor(batch_inputs["tokens"], device=dev)
    cache = init_cache(cfg, tokens.shape[0], max_len, device=dev,
                       mesh=embed.device_mesh if is_dtensor(embed) else None)

    def upto(n):
        return torch.arange(n, device=dev)

    def scalar(n, like):
        return replicated_like(torch.tensor(n, dtype=torch.int32, device=dev),
                               like)

    if fam == "encdec":
        mem, mem_pos = _encode(cfg, params, batch_inputs["frames"])
        x, (k, v, ck, cv) = _decode_trunk(cfg, params, mem, mem_pos, tokens,
                                          collect=True)
        S, T = tokens.shape[1], ck.shape[2]
        index_copy_(cache["k"], 2, upto(S), k)
        index_copy_(cache["v"], 2, upto(S), v)
        index_copy_(cache["ck"], 2, upto(T), ck)
        index_copy_(cache["cv"], 2, upto(T), cv)
        cache["enc_len"] = scalar(T, x)
        cache["len"] = scalar(S, x)
        x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
        return lm_logits(params["tok"], x[:, -1:], cfg), cache

    dt = dtype_of(cfg.dtype)
    emb = embed_tokens(params["tok"], tokens, dt)
    if fam == "vlm" and batch_inputs.get("patches") is not None:
        emb = torch.cat([torch.as_tensor(batch_inputs["patches"],
                                         device=dev).to(dt), emb], dim=1)
    S = emb.shape[1]
    x, collected = _lm_trunk(cfg, params, emb, upto(S), collect=True)

    if fam in ("dense", "moe", "vlm"):
        k, v = collected
        index_copy_(cache["k"], 2, upto(S), k)
        index_copy_(cache["v"], 2, upto(S), v)
    elif fam == "ssm":
        cache["h"], cache["conv"] = collected
    elif fam == "hybrid":
        caches_g, caches_w = collected
        for i, ((k, v), (h, conv)) in enumerate(caches_g):
            index_copy_(cache["kg"][i], 1, upto(S), k)
            index_copy_(cache["vg"][i], 1, upto(S), v)
            cache["hg"][i] = h
            cache["convg"][i] = conv
        # the ring keeps the last W positions, each at slot pos % W
        W = cache["kw"].shape[2]
        pos = torch.arange(max(0, S - W), S, device=dev)
        slots = pos % W
        for j, ((k, v), (h, conv)) in enumerate(caches_w):
            index_copy_(cache["kw"][j], 1, slots,
                        k.index_select(1, replicated_like(pos, k)))
            index_copy_(cache["vw"][j], 1, slots,
                        v.index_select(1, replicated_like(pos, v)))
            index_copy_(cache["wpos"][j], 1, slots,
                        pos.to(torch.int32).expand(tokens.shape[0], -1))
            cache["hw"][j] = h
            cache["convw"][j] = conv
    cache["len"] = scalar(S, x)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x[:, -1:], cfg), cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _cache_write(cache, val, pos):
    """Write one token into ``cache`` [B, T, ...] in place at position
    ``pos`` (scalar, or [B] for per-lane continuous batching), clamped to
    [0, T-1] as the reference's dynamic update is. One write per lane:
    no index repeats."""
    pos = pos.long().clamp(0, cache.shape[1] - 1)
    if pos.ndim == 0:
        index_copy_(cache, 1, pos.view(1), val[:, None])
    else:
        cache[torch.arange(cache.shape[0], device=cache.device), pos] = val
    return cache


def _decode_attn_layer(cfg, p, x, k_cache, v_cache, pos, kv_len, *,
                       window=0, wpos=None):
    """One decode attention sublayer. ``pos`` is a scalar or a per-lane
    [B] vector. With ``window`` and ``wpos`` the caches are a ring of W
    slots: the token goes to slot pos % W, ``wpos`` records its position,
    and every slot that holds a position (wpos >= 0) is attended. Returns
    the attention output; the caches and ``wpos`` are written in place."""
    positions = pos[None, None] if pos.ndim == 0 else pos[:, None]
    q, k, v = attn_qkv(p["attn"], x, cfg, positions)
    if window and wpos is not None:
        slot = pos % k_cache.shape[1]
        _cache_write(k_cache, k[:, 0], slot)
        _cache_write(v_cache, v[:, 0], slot)
        _cache_write(wpos, pos.to(torch.int32).expand(wpos.shape[0]), slot)
        bias = torch.where(wpos >= 0, 0.0, NEG)[:, None, None, :].float()
        n_rep = cfg.n_heads // cfg.n_kv_heads
        return Lyr._attn_core(q, Lyr.repeat_kv(k_cache, n_rep),
                              Lyr.repeat_kv(v_cache, n_rep), bias)
    _cache_write(k_cache, k[:, 0], pos)
    _cache_write(v_cache, v[:, 0], pos)
    return decode_attention(q, k_cache, v_cache, kv_len)


def decode_step(cfg, params, cache, token, patches=None):
    """One-token decode. token [B,1] int. Returns (logits [B,1,V], cache)
    with the caches written in place and ``len`` advanced by one.
    ``patches`` is not read (the reference's signature: a vlm's patches
    went in with the prefill)."""
    dt = dtype_of(cfg.dtype)
    fam = cfg.family
    dev = params["tok"]["embed"].device
    pos = torch.as_tensor(cache["len"], device=dev)
    kv_len = pos + 1
    x = embed_tokens(params["tok"], torch.as_tensor(token, device=dev), dt)

    if fam in ("dense", "moe", "vlm"):
        for i, p in enumerate(_unstack(_cast_once(cfg, params["layers"]))):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            o = _decode_attn_layer(cfg, p, h, cache["k"][i], cache["v"][i],
                                   pos, kv_len)
            x = x + attn_out(p["attn"], o, cfg)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            if "router" in p["mlp"]:
                x = x + Moe.moe_apply(p["mlp"], h, cfg.replace(moe_group=1))
            else:
                x = x + mlp_apply(p["mlp"], h, cfg)

    elif fam == "ssm":
        for i, p in enumerate(_unstack(_cast_once(cfg, params["layers"]))):
            y, (h1, c1) = M.mamba_step(
                p["ssm"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                (cache["h"][i], cache["conv"][i]))
            x = x + y
            cache["h"][i] = h1
            cache["conv"][i] = c1

    elif fam == "hybrid":
        stacks = {k: _unstack(_cast_once(cfg, params[k]))
                  for k in ("global", "swa")}
        for kind, i in _hybrid_order(cfg):
            p = stacks[kind][i]
            sfx = "g" if kind == "global" else "w"
            hh = rms_norm(x, p["ln1"], cfg.norm_eps)
            o = _decode_attn_layer(
                cfg, p, hh, cache["k" + sfx][i], cache["v" + sfx][i], pos,
                kv_len, window=cfg.swa_window if kind == "swa" else 0,
                wpos=cache["wpos"][i] if kind == "swa" else None)
            ao = attn_out(p["attn"], o, cfg)
            so, (h1, c1) = M.mamba_step(
                p["ssm"], hh, cfg, (cache["h" + sfx][i],
                                    cache["conv" + sfx][i]))
            cache["h" + sfx][i] = h1
            cache["conv" + sfx][i] = c1
            fused = 0.5 * (rms_norm(ao, p["ln_attn"], cfg.norm_eps)
                           + rms_norm(so, p["ln_ssm"], cfg.norm_eps))
            x = x + fused
            x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                              cfg)

    elif fam == "encdec":
        positions = pos[None, None] if pos.ndim == 0 else pos[:, None]
        for i, p in enumerate(_unstack(_cast_once(cfg, params["dec"]))):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            o = _decode_attn_layer(cfg, p, h, cache["k"][i], cache["v"][i],
                                   pos, kv_len)
            x = x + attn_out(p["attn"], o, cfg)
            h = rms_norm(x, p["lnx"], cfg.norm_eps)
            qx, _, _ = attn_qkv(p["xattn"], h, cfg, positions)
            ox = decode_attention(qx, cache["ck"][i], cache["cv"][i],
                                  cache["enc_len"])
            x = x + attn_out(p["xattn"], ox, cfg)
            x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                              cfg)
    else:
        raise ValueError(fam)

    cache = dict(cache, len=kv_len)
    x = rms_norm(x, params["tok"]["final_norm"], cfg.norm_eps)
    return lm_logits(params["tok"], x, cfg), cache
