"""Step builders for the dry run and the roofline: per (arch x shape) a
train, prefill, decode or search step with abstract inputs, their specs,
and cost units (twin of ``repro.launch.steps``).

A bundle's ``fn`` takes real tensors; its ``abstract_args`` are the same
inputs as ``meta`` tensors (shapes and dtypes, no storage), its
``in_shardings`` their specs under the current mesh and rules.
``materialize`` makes real inputs for a bundle on a device;
``run_sharded`` runs a bundle resolved on a ``DeviceMesh`` there, as
the reference's ``jit(fn, in_shardings=, out_shardings=)`` does.

Cost units: each is one layer body of a kind (a train unit is one
layer's forward, recompute and backward through autograd) with the
number of further layers of that kind. The step run at ``cut_depth``
(one layer a kind; the hybrid's three globals and one window layer)
plus every unit times its multiplier counts as the whole step does; the
dry run uses that where a whole step would replay too many SSM scan
steps.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      load_config)
from repro_torch.core.types import SearchParams
from repro_torch.models import layers as Lyr
from repro_torch.models import mamba as M
from repro_torch.models import model as Mdl
from repro_torch.models import moe as Moe
from repro_torch.models.sharding import (NamedSharding, ax, axis_size,
                                         current_mesh, is_dtensor,
                                         placements, rules_override,
                                         use_mesh)
from repro_torch.train import optimizer as Opt
from repro_torch.train.train_loop import make_step

I32, F32, BF16 = torch.int32, torch.float32, torch.bfloat16


def meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclass
class CostUnit:
    name: str
    multiplier: int
    fn: Callable
    abstract_args: tuple
    in_shardings: Any


@dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    abstract_args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple
    cost_units: list
    model_flops: float
    notes: str = ""
    cfg: Optional[ModelConfig] = None     # the tuned config (LM cells)
    reads: Any = None                     # the index fields a search reads
    n_shards: int = 1                     # a search's index shards
    rules: Optional[dict] = None          # plan_rules its specs took on a mesh


@dataclass(frozen=True)
class SvfShape:
    """A SVFusion search cell: N vectors of ``dim`` in a graph of out-degree
    ``degree``, ``batch`` queries, ``cache_per_chip`` hot-cache slots a
    shard."""
    name: str
    n: int
    dim: int
    degree: int
    batch: int
    cache_per_chip: int


SVF_SHAPES = {
    "search_10k": SvfShape("search_10k", n=1_000_000_000, dim=96, degree=32,
                           batch=10240, cache_per_chip=131072),   # Deep1B
    "search_1k": SvfShape("search_1k", n=200_000_000, dim=100, degree=32,
                          batch=1024, cache_per_chip=131072),     # MSTuring
}
SVF_ARCH = {"search_10k": "svfusion_deep1b", "search_1k": "svfusion_msturing"}
SVF_PARAMS = SearchParams(k=10, pool=64, max_iters=64)


def shape_config(shape):
    """A shape name (``SHAPES`` or ``SVF_SHAPES``) or a config, as a
    config."""
    if isinstance(shape, str):
        return SHAPES[shape] if shape in SHAPES else SVF_SHAPES[shape]
    return shape


# ---------------------------------------------------------------------------
# Per-cell policy
# ---------------------------------------------------------------------------

def plan_rules(arch: str, shape, cfg: Optional[ModelConfig] = None) -> dict:
    """Pick the parallelism scheme per cell (call under ``use_mesh``).

    Pure DP+FSDP (batch over data x model, no tensor axis) for a training
    step whose batch divides the mesh and whose per-layer gathered weight
    slab stays small; the SP/TP scheme (DEFAULT_RULES) otherwise; batch
    replicated where it does not divide the batch axes. ``cfg`` (default
    the published config) is the model the cell runs: a smoke config for
    the tests' small cells."""
    shape = shape_config(shape)
    if not isinstance(shape, ShapeConfig) or arch.startswith("svfusion"):
        return {}
    rules: dict = {}
    if shape.global_batch % max(axis_size("batch"), 1) != 0:
        rules["batch"] = ()          # e.g. long_500k batch=1
        return rules
    cfg = cfg or load_config(arch)
    sizes = current_mesh().sizes
    data_model = sizes.get("data", 1) * sizes.get("model", 1)
    layer_slab_gb = count_params(cfg) / max(cfg.n_layers, 1) * 2 / 1e9
    dims_ok = (cfg.d_model % data_model == 0
               and (cfg.d_ff == 0 or cfg.d_ff % data_model == 0))
    if (shape.kind == "train" and shape.global_batch % data_model == 0
            and layer_slab_gb < 2.0 and "pod" not in sizes and dims_ok):
        rules["batch"] = ("data", "model")
        rules["fsdp"] = ("data", "model")
        rules["tensor"] = ()
    return rules


def tune_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    kw: dict = {}
    if shape.kind in ("train", "prefill"):
        kw["gather_weights"] = True
        if shape.seq_len >= 8192 or (shape.kind == "train"
                                     and cfg.d_model >= 4096):
            kw["attn_chunk"] = 2048
        est = (shape.global_batch / 32) * shape.seq_len * cfg.d_model * 2 \
            * max(cfg.n_layers, 1)
        if shape.kind == "train" and est > 3e9:
            kw["residual_shard"] = "dmodel" if cfg.family in ("ssm", "hybrid") \
                else "seq"
        if shape.kind == "prefill":
            kw["remat_policy"] = "none"       # inference: no backward
            if cfg.family in ("ssm", "hybrid"):
                kw["residual_shard"] = "dmodel"
            elif shape.seq_len * cfg.d_model * 2 > 5e7:
                kw["residual_shard"] = "seq"
    if shape.kind == "decode":
        kw["remat_policy"] = "none"
        kw["moe_group"] = 1
    return cfg.replace(**kw) if kw else cfg


def cost_variant(cfg: ModelConfig, seq_len: int) -> ModelConfig:
    return cfg.replace(attn_chunk=0, ssm_chunk=max(seq_len, 1))


def cut_depth(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with one layer of each kind (the hybrid keeps its three
    global layers and one window layer)."""
    if cfg.family == "encdec":
        return cfg.replace(n_enc_layers=1, n_dec_layers=1)
    if cfg.family == "hybrid":
        return cfg.replace(n_layers=min(cfg.n_layers, 4))
    return cfg.replace(n_layers=1)


def moe_flops_factor(cfg) -> float:
    """Active fraction of MLP params per token (MoE top-k vs dense)."""
    if cfg.n_experts:
        return cfg.top_k
    return 1.0


def count_params(cfg: ModelConfig) -> float:
    """Analytical parameter count (excluding embeddings for 6ND)."""
    D, F, Dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh \
        + cfg.n_heads * Dh * D
    ssm = 0
    if cfg.family in ("ssm", "hybrid"):
        Din = cfg.d_inner
        R = cfg.dt_rank_eff
        ssm = D * 2 * Din + cfg.d_conv * Din + Din * (R + 2 * cfg.d_state) \
            + R * Din + Din * cfg.d_state + Din * D
    if cfg.family == "encdec":
        enc = (attn + 3 * D * F) * cfg.n_enc_layers
        dec = (2 * attn + 3 * D * F) * cfg.n_dec_layers
        return enc + dec
    if cfg.family == "ssm":
        per_layer = ssm
    elif cfg.family == "hybrid":
        per_layer = attn + ssm + 3 * D * F
    else:
        per_layer = attn + 3 * D * F * (cfg.n_experts or 1)
    return per_layer * cfg.n_layers


def active_params(cfg: ModelConfig) -> float:
    """N_active for MODEL_FLOPS = 6·N_active·D (MoE counts top_k experts)."""
    D, F = cfg.d_model, cfg.d_ff
    total = count_params(cfg)
    if cfg.n_experts:
        total -= 3 * D * F * cfg.n_experts * cfg.n_layers
        total += 3 * D * F * cfg.top_k * cfg.n_layers
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for forward-only
    (plus the attention's quadratic term)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_act = active_params(cfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    if cfg.family == "encdec" and shape.kind != "train":
        # encoder sees seq_len frames; decoder only its own token budget
        D, F, Dh = cfg.d_model, cfg.d_ff, cfg.head_dim
        attn_p = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * Dh \
            + cfg.n_heads * Dh * D
        enc_p = (attn_p + 3 * D * F) * cfg.n_enc_layers
        dec_p = (2 * attn_p + 3 * D * F) * cfg.n_dec_layers
        tok_enc = shape.global_batch * shape.seq_len
        tok_dec = shape.global_batch * (min(shape.seq_len, 4096)
                                        if shape.kind == "prefill" else 1)
        flops = mult * (enc_p * tok_enc + dec_p * tok_dec)
        if shape.kind == "prefill":
            tokens = tok_enc  # attention term below keyed to encoder side
    else:
        flops = mult * n_act * tokens
    if cfg.n_heads:
        Dh, Hq = cfg.head_dim, cfg.n_heads
        if shape.kind == "decode":
            kv = shape.seq_len
            att = 4.0 * shape.global_batch * Hq * Dh * kv
            if cfg.family == "hybrid":
                att *= 3.0 / cfg.n_layers  # only global layers see full kv
                att += 4.0 * shape.global_batch * Hq * Dh \
                    * min(cfg.swa_window, kv) * (cfg.n_layers - 3) / cfg.n_layers
            att *= cfg.n_layers if cfg.family != "encdec" else cfg.n_dec_layers * 2
        else:
            att = (mult / 6 * 12.0 if shape.kind == "train" else 4.0) \
                * tokens * shape.seq_len * Hq * Dh / 2
            att *= cfg.n_layers if cfg.family != "encdec" \
                else (cfg.n_enc_layers + 2 * cfg.n_dec_layers)
            if cfg.family == "hybrid":
                w = min(cfg.swa_window, shape.seq_len)
                full = tokens * shape.seq_len / 2
                swa = tokens * w
                att = att / cfg.n_layers * (3 * 1.0 + (cfg.n_layers - 3)
                                            * (swa / full))
        flops += att
    return flops


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def batch_inputs(cfg: ModelConfig, shape: ShapeConfig, with_labels=True):
    B, S = shape.global_batch, shape.seq_len
    bspec = ax("batch", None)
    if cfg.family == "vlm":
        S_tok = S - cfg.n_patches
        abs_in = {"tokens": meta((B, S_tok), I32),
                  "patches": meta((B, cfg.n_patches, cfg.d_model), BF16)}
        specs = {"tokens": bspec, "patches": ax("batch", None, None)}
    elif cfg.family == "encdec":
        abs_in = {"frames": meta((B, S, cfg.d_model), BF16),
                  "tokens": meta((B, S if shape.kind == "train" else
                                  min(S, 4096)), I32)}
        specs = {"frames": ax("batch", None, None), "tokens": bspec}
    else:
        abs_in = {"tokens": meta((B, S), I32)}
        specs = {"tokens": bspec}
    if with_labels:
        abs_in["labels"] = meta(abs_in["tokens"].shape, I32)
        specs["labels"] = bspec
    return abs_in, specs


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    cache = Mdl.init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
    specs = Mdl.cache_specs(cfg, long_context=(shape.name == "long_500k"))
    return cache, specs


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

# ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
# the training loop's own step, under the reference's name.
make_train_step = make_step


def _train_unit(cfg_cost, layer_fwd):
    """One remat'd layer body ``layer_fwd(p_layer, x, *rest)``: forward,
    recompute and backward (autograd with a gradient of ones) to the
    params and to every input, as inside the whole step (the decoder's
    gradient reaches the encoder's memory)."""
    def unit(p_layer, *xs):
        p_layer = Lyr.tree_map(lambda a: a.detach().requires_grad_(),
                               p_layer)
        xs = [x.detach().requires_grad_() for x in xs]
        with torch.enable_grad():
            y = Lyr.maybe_remat(layer_fwd, cfg_cost.remat_policy)(p_layer,
                                                                  *xs)
            return torch.autograd.grad(y, Lyr.tree_leaves(p_layer) + xs,
                                       torch.ones_like(y), allow_unused=True)
    return unit


def _layer_template_and_specs(cfg, fam_key, dtype):
    """One layer's params of ``fam_key`` (the stacked dim stripped), as
    meta tensors in ``dtype``, and their specs."""
    sub = Lyr.tree_map(lambda t: Lyr.TSpec(t.shape[1:], t.axes[1:], t.scale),
                       Mdl.build_templates(cfg)[fam_key])
    return (Lyr.abstract_from_template(sub, dtype),
            Lyr.specs_from_template(sub))


def make_cost_units(cfg: ModelConfig, shape: ShapeConfig,
                    param_dtype=None) -> list:
    """Per-layer bodies of each kind and the number of further layers of
    that kind beyond ``cut_depth``'s, in the cost variant (unchunked
    attention, one SSM chunk)."""
    cfgc = cost_variant(cfg, shape.seq_len)
    pdt = Mdl.dtype_of(param_dtype or cfg.param_dtype)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    x_abs = meta((B, S if kind != "decode" else 1, cfg.d_model), BF16)
    x_spec = ax("batch", None, None)
    units = []

    def pos(n, x):
        return torch.arange(n, device=x.device)

    def last(x):
        return torch.tensor(S - 1, dtype=I32, device=x.device)

    def add(name, mult, fn, args, shardings):
        if mult > 0:
            units.append(CostUnit(name, mult, fn, args, shardings))

    def layer_unit(fwd, name, mult, p_abs, p_spec):
        fn = _train_unit(cfgc, fwd) if kind == "train" else fwd
        add(name, mult, fn, (p_abs, x_abs), (p_spec, x_spec))

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        p_abs, p_spec = _layer_template_and_specs(cfg, "layers", pdt)
        if kind != "decode":
            layer_unit(lambda pp, xx: Mdl.dense_layer_fwd(
                cfgc, pp, xx, pos(S, xx))[0], "layer", cfg.n_layers - 1,
                p_abs, p_spec)
        else:
            cache, cspecs = abstract_cache(cfg, shape)
            kc, vc = (meta(cache[k].shape[1:], cache[k].dtype)
                      for k in ("k", "v"))
            kspec = cspecs["k"][1:]

            def dec_fn(pp, xx, kc, vc):
                posn = last(xx)
                h = Lyr.rms_norm(xx, pp["ln1"], cfgc.norm_eps)
                o = Mdl._decode_attn_layer(cfgc, pp, h, kc, vc, posn,
                                           posn + 1)
                xx = xx + Lyr.attn_out(pp["attn"], o, cfgc)
                h = Lyr.rms_norm(xx, pp["ln2"], cfgc.norm_eps)
                if "router" in pp["mlp"]:
                    xx = xx + Moe.moe_apply(pp["mlp"], h,
                                            cfgc.replace(moe_group=1))
                else:
                    xx = xx + Lyr.mlp_apply(pp["mlp"], h, cfgc)
                return xx, kc, vc
            add("layer", cfg.n_layers - 1, dec_fn, (p_abs, x_abs, kc, vc),
                (p_spec, x_spec, kspec, kspec))

    elif fam == "ssm":
        p_abs, p_spec = _layer_template_and_specs(cfg, "layers", pdt)
        if kind != "decode":
            layer_unit(lambda pp, xx: Mdl.ssm_layer_fwd(cfgc, pp, xx)[0],
                       "layer", cfg.n_layers - 1, p_abs, p_spec)
        else:
            cache, cspecs = abstract_cache(cfg, shape)
            h = meta(cache["h"].shape[1:], cache["h"].dtype)
            cv = meta(cache["conv"].shape[1:], cache["conv"].dtype)

            def dec_fn(pp, xx, h0, c0):
                hh = Lyr.rms_norm(xx, pp["ln1"], cfgc.norm_eps)
                y, st = M.mamba_step(pp["ssm"], hh, cfgc, (h0, c0))
                return xx + y, st
            add("layer", cfg.n_layers - 1, dec_fn, (p_abs, x_abs, h, cv),
                (p_spec, x_spec, cspecs["h"][1:], cspecs["conv"][1:]))

    elif fam == "hybrid":
        g_ids, _ = Mdl.hybrid_split(cfg)
        nW = cfg.n_layers - len(g_ids)
        p_abs, p_spec = _layer_template_and_specs(cfg, "swa", pdt)
        if kind != "decode":
            layer_unit(lambda pp, xx: Mdl.hybrid_layer_fwd(
                cfgc, pp, xx, pos(S, xx), window=cfg.swa_window)[0],
                "swa_layer", nW - 1, p_abs, p_spec)
        else:
            cache, cspecs = abstract_cache(cfg, shape)
            keys = ("kw", "vw", "wpos", "hw", "convw")
            args = tuple(meta(cache[k].shape[1:], cache[k].dtype)
                         for k in keys)
            sh = tuple(cspecs[k][1:] for k in keys)

            def dec_fn(pp, xx, kc, vc, wp, h0, c0):
                posn = last(xx)
                hh = Lyr.rms_norm(xx, pp["ln1"], cfgc.norm_eps)
                o = Mdl._decode_attn_layer(cfgc, pp, hh, kc, vc, posn,
                                           posn + 1, window=cfg.swa_window,
                                           wpos=wp)
                ao = Lyr.attn_out(pp["attn"], o, cfgc)
                so, st = M.mamba_step(pp["ssm"], hh, cfgc, (h0, c0))
                fused = 0.5 * (Lyr.rms_norm(ao, pp["ln_attn"], cfgc.norm_eps)
                               + Lyr.rms_norm(so, pp["ln_ssm"], cfgc.norm_eps))
                xx = xx + fused
                h2 = Lyr.rms_norm(xx, pp["ln2"], cfgc.norm_eps)
                xx = xx + Lyr.mlp_apply(pp["mlp"], h2, cfgc)
                return xx, kc, vc, wp, st
            add("swa_layer", nW - 1, dec_fn, (p_abs, x_abs) + args,
                (p_spec, x_spec) + sh)

    elif fam == "encdec":
        e_abs, e_spec = _layer_template_and_specs(cfg, "enc", pdt)
        d_abs, d_spec = _layer_template_and_specs(cfg, "dec", pdt)
        mem_abs = meta((B, S, cfg.d_model), BF16)
        if kind in ("train", "prefill"):
            Sd = S if kind == "train" else min(S, 4096)
            xd_abs = meta((B, Sd, cfg.d_model), BF16)

            def enc_fn(pp, xx):
                return Mdl.enc_layer_fwd(cfgc, pp, xx, pos(S, xx))

            def dec_fn(pp, xx, mm):
                return Mdl.dec_layer_fwd(cfgc, pp, xx, mm, pos(Sd, xx),
                                         pos(S, xx))[0]
            layer_unit(enc_fn, "enc_layer", cfg.n_enc_layers - 1, e_abs,
                       e_spec)
            add("dec_layer", cfg.n_dec_layers - 1,
                _train_unit(cfgc, dec_fn) if kind == "train" else dec_fn,
                (d_abs, xd_abs, mem_abs), (d_spec, x_spec, x_spec))
        else:
            cache, cspecs = abstract_cache(cfg, shape)
            keys = ("k", "v", "ck", "cv")
            args = tuple(meta(cache[k].shape[1:], cache[k].dtype)
                         for k in keys)
            sh = tuple(cspecs[k][1:] for k in keys)

            def dec_fn(pp, xx, kc, vc, ck, cv):
                posn = torch.tensor(min(S, 4096) - 1, dtype=I32,
                                    device=xx.device)
                h = Lyr.rms_norm(xx, pp["ln1"], cfgc.norm_eps)
                o = Mdl._decode_attn_layer(cfgc, pp, h, kc, vc, posn,
                                           posn + 1)
                xx = xx + Lyr.attn_out(pp["attn"], o, cfgc)
                h = Lyr.rms_norm(xx, pp["lnx"], cfgc.norm_eps)
                qx, _, _ = Lyr.attn_qkv(pp["xattn"], h, cfgc,
                                        posn[None, None])
                ox = Lyr.decode_attention(qx, ck, cv, S)
                xx = xx + Lyr.attn_out(pp["xattn"], ox, cfgc)
                h = Lyr.rms_norm(xx, pp["ln2"], cfgc.norm_eps)
                xx = xx + Lyr.mlp_apply(pp["mlp"], h, cfgc)
                return xx, kc, vc
            add("dec_layer", cfg.n_dec_layers - 1, dec_fn,
                (d_abs, x_abs) + args, (d_spec, x_spec) + sh)
    return units


def adam_config(cfg: ModelConfig) -> Opt.AdamConfig:
    return Opt.AdamConfig(
        moment_dtype="bfloat16" if count_params(cfg) > 5e10 else "float32")


def build_bundle(arch: str, shape) -> StepBundle:
    """The step of ``arch`` at ``shape`` (a ``SHAPES`` name or a
    ``ShapeConfig``), with the config tuned for it."""
    shape = shape_config(shape)
    return step_bundle(arch, shape, tune_config(load_config(arch), shape))


def step_bundle(arch: str, shape: ShapeConfig, cfg: ModelConfig,
                mesh=None):
    """``build_bundle``'s step for the config ``cfg`` (a published or a
    smoke config, tuned or not) at ``shape`` (any ``ShapeConfig``). Its
    specs resolve under the current mesh and rules; with ``mesh`` (a
    named ``DeviceMesh`` or a ``MeshDesc``), under ``use_mesh(mesh)`` and
    the cell's ``plan_rules``, which the bundle keeps for
    ``run_sharded``."""
    if mesh is not None:
        with use_mesh(mesh):
            rules = plan_rules(arch, shape, cfg)
            with rules_override(**rules):
                return dataclasses.replace(step_bundle(arch, shape, cfg),
                                           rules=rules)
    notes = (f"residual_shard={cfg.residual_shard} attn_chunk={cfg.attn_chunk}"
             f" remat={cfg.remat_policy}")

    def bundle(kind, fn, args, in_sh, out_sh, donate, units):
        return StepBundle(arch, shape.name, kind, fn, args, in_sh, out_sh,
                          donate, units, model_flops(cfg, shape), notes, cfg)

    if shape.kind == "train":
        adam = adam_config(cfg)
        p_abs = Mdl.abstract_params(cfg)
        p_spec = Mdl.param_specs(cfg)
        mdt = Mdl.dtype_of(adam.moment_dtype)
        opt_abs = Opt.AdamState(
            meta((), I32), *(Lyr.tree_map(lambda a: meta(a.shape, mdt), p_abs)
                             for _ in range(2)))
        opt_spec = Opt.adam_specs(p_spec)
        b_abs, b_spec = batch_inputs(cfg, shape, with_labels=True)
        # nothing is donated: the port's AdamW returns new tensors
        return bundle("train", make_train_step(cfg, adam),
                      (p_abs, opt_abs, b_abs), (p_spec, opt_spec, b_spec),
                      (p_spec, opt_spec, ()), (),
                      make_cost_units(cfg, shape))

    # serving: params in bf16
    p_abs = Mdl.abstract_params(cfg, dtype="bfloat16")
    p_spec = Mdl.param_specs(cfg)
    units = make_cost_units(cfg, shape, param_dtype="bfloat16")
    cache_abs, cache_spec = abstract_cache(cfg, shape)
    if shape.kind == "prefill":
        b_abs, b_spec = batch_inputs(cfg, shape, with_labels=False)

        def prefill_fn(params, batch):
            return Mdl.prefill(cfg, params, batch, shape.seq_len)
        return bundle("prefill", prefill_fn, (p_abs, b_abs),
                      (p_spec, b_spec), ((), cache_spec), (), units)

    def decode_fn(params, cache, token):   # writes the cache in place
        return Mdl.decode_step(cfg, params, cache, token)
    return bundle("decode", decode_fn,
                  (p_abs, cache_abs, meta((shape.global_batch, 1), I32)),
                  (p_spec, cache_spec, ax("batch", None)),
                  ((), cache_spec), (1,), units)


# ---------------------------------------------------------------------------
# Sharded execution
# ---------------------------------------------------------------------------

def _spec_map(fn, tree, specs):
    """``fn(tensor, spec)`` on every tensor of ``tree`` (dicts, tuples,
    NamedTuples, lists), its spec the leaf at the same place of
    ``specs``; any other leaf is kept."""
    if torch.is_tensor(tree):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_spec_map(fn, t, s) for t, s in zip(tree, specs, strict=True)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def run_sharded(bundle: StepBundle, args, mesh):
    """``bundle.fn(*args)`` run sharded on ``mesh`` (a named
    ``DeviceMesh``: gloo ranks on CPUs, NCCL ranks on cards), the port's
    ``jit(fn, in_shardings=, out_shardings=)``. Each argument, the same
    whole tensor on every rank (or a DTensor on ``mesh``), is laid out by
    ``in_shardings``; ``fn`` runs under ``use_mesh(mesh)`` and the rules
    the bundle's specs were resolved under; every output is laid out by
    ``out_shardings`` (a spec of ``()``: replicated). A decode bundle
    writes the placed cache in place and returns it. The bundle comes
    from ``step_bundle(..., mesh=mesh)``."""
    if bundle.rules is None:
        raise ValueError(f"{bundle.arch} {bundle.shape}: the bundle's specs "
                         "were not resolved on a mesh; build it with "
                         "step_bundle(..., mesh=mesh)")

    def lay_out(x, spec):
        if is_dtensor(x):
            return x.redistribute(mesh, placements(spec, mesh))
        return NamedSharding(mesh, spec).place(x)

    with use_mesh(mesh), rules_override(**bundle.rules):
        placed = _spec_map(lay_out, tuple(args), bundle.in_shardings)
        out = bundle.fn(*placed)
        return _spec_map(lay_out, out, bundle.out_shardings)


# ---------------------------------------------------------------------------
# SVFusion (the paper's own architecture) cells
# ---------------------------------------------------------------------------

# the index arrays the search step reads; the reference's compiled step
# drops the others (e_in, slot_hid, f_recent) from its arguments
SEARCH_READS = ("vectors", "nbrs", "alive", "cache_vectors", "h2d")


def build_svfusion_bundle(shape, mesh) -> StepBundle:
    """The sharded search of ``shape`` (a ``SVF_SHAPES`` name or a
    ``SvfShape``) with the capacity tier split over every axis of
    ``mesh`` and the queries replicated. ``mesh`` is a ``MeshDesc`` (the
    dry run: ``fn`` cannot run) or a ``RankMesh`` over the initialised
    process group, on which ``fn(idx, queries, seed)`` runs
    ``make_distributed_search`` over this rank's shard. ``seed`` (a 0-d
    int64, the counterpart of the reference's PRNG key) seeds each
    shard's entry draw."""
    from repro_torch.core.distributed import (RankMesh,
                                              analytical_search_flops,
                                              make_distributed_search,
                                              shard_index_arrays)
    p = shape_config(shape)
    sp = SVF_PARAMS
    data_axes = tuple(mesh.axis_names)
    ranks = isinstance(mesh, RankMesh)
    n_shards = math.prod(mesh.shape if ranks else mesh.axis_sizes)
    idx = shard_index_arrays(p.n, p.dim, p.degree, n_shards,
                             p.cache_per_chip)
    dspec = (data_axes,)
    in_sh = ({k: dspec + ((),) * (v.ndim - 1) for k, v in idx.items()},
             ((), ()), ())
    step = make_distributed_search(mesh, sp, data_axes=data_axes,
                                   query_axis=None) if ranks else None

    def search_fn(idx, queries, seed):
        if step is None:
            raise RuntimeError("a dry-run bundle: build it on a RankMesh "
                               "to run its step")
        return step(idx, queries, seed=int(seed))
    return StepBundle(
        SVF_ARCH.get(p.name, "svfusion"), p.name, "search", search_fn,
        (idx, meta((p.batch, p.dim), F32), meta((), torch.int64)), in_sh,
        None, (), [],
        # replicated-query scheme: every shard beam-searches its partition
        # for the whole batch, so useful work scales with n_shards
        analytical_search_flops(sp, p.batch, p.dim, p.degree) * n_shards,
        f"distributed beam search, {n_shards} shards, queries replicated",
        reads=SEARCH_READS, n_shards=n_shards)


# ---------------------------------------------------------------------------
# Real inputs
# ---------------------------------------------------------------------------

def materialize(bundle: StepBundle, gen: torch.Generator, device="cuda",
                shard=None):
    """Real inputs for ``bundle.fn`` on ``device``, drawn from ``gen``
    (a generator on ``device``): the params from the templates in the
    cell's dtype, a zero optimizer state and a zero cache, tokens and
    labels uniform over the vocabulary, frames and patches normal in
    bf16. A search cell gets the whole index of its abstract arguments
    (``convert.shard_rows`` cuts a rank's shard; on a mesh of one device
    it is the shard): vectors normal, each shard's neighbour lists
    uniform over its own rows (local ids), every row alive, an empty hot
    cache, queries normal and the seed 0. With ``shard`` (a search cell
    only) it gets that shard's rows alone, drawn from a generator seeded
    from (``gen``'s seed, ``shard``), and the queries from ``gen``: the
    same on every rank whose ``gen`` has the same seed."""
    dev = torch.device(device)
    args = bundle.abstract_args
    if bundle.kind == "search":
        return _materialize_search(args, bundle.n_shards, gen, dev, shard)
    if shard is not None:
        raise ValueError(f"{bundle.kind} bundle: only a search cell's "
                         "inputs are drawn a shard at a time")
    cfg = bundle.cfg

    def zeros(a):
        return torch.zeros(a.shape, dtype=a.dtype, device=dev)

    def batch(b_abs):
        out = {}
        for k, a in b_abs.items():
            if a.dtype == I32:
                out[k] = torch.randint(0, cfg.vocab, a.shape, generator=gen,
                                       device=dev, dtype=I32)
            else:
                out[k] = torch.randn(a.shape, generator=gen,
                                     device=dev).to(a.dtype)
        return out

    p_dtype = Lyr.tree_leaves(args[0])[0].dtype
    params = Mdl.init_params(cfg, gen, dtype=p_dtype)
    params = Lyr.tree_map(lambda a: a.to(dev), params)
    if bundle.kind == "train":
        opt = Opt.AdamState(zeros(args[1].step),
                            *(Lyr.tree_map(zeros, t) for t in args[1][1:]))
        return params, opt, batch(args[2])
    if bundle.kind == "prefill":
        return params, batch(args[1])
    cache = Mdl.init_cache(cfg, args[2].shape[0],
                           _cache_len(cfg, args[1]), device=dev)
    return params, cache, batch({"token": args[2]})["token"]


def _cache_len(cfg, cache_abs):
    """The ``max_len`` an abstract cache was made with."""
    if cfg.family == "ssm":
        return 1
    key = {"hybrid": "kg", "encdec": "ck"}.get(cfg.family, "k")
    return cache_abs[key].shape[2]


def _materialize_search(args, n_shards, gen, dev, shard=None):
    idx_abs, q_abs, _ = args
    n, dim = idx_abs["vectors"].shape
    cache_slots = idx_abs["cache_vectors"].shape[0]
    degree = idx_abs["nbrs"].shape[1]
    local = n // n_shards                 # a shard's rows
    i32 = torch.int32
    q = None
    if shard is not None:
        from repro_torch.core.distributed import shard_generator
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} of {n_shards}")
        n, cache_slots = local, cache_slots // n_shards
        q = torch.randn(q_abs.shape, generator=gen, device=dev)
        gen = shard_generator(gen.initial_seed(), shard, dev)
    idx = {
        "vectors": torch.randn(n, dim, generator=gen, device=dev),
        "nbrs": torch.randint(0, local, (n, degree), generator=gen,
                              device=dev, dtype=i32),
        "alive": torch.ones(n, dtype=torch.bool, device=dev),
        "e_in": torch.zeros(n, dtype=i32, device=dev),
        "cache_vectors": torch.zeros(cache_slots, dim, device=dev),
        "slot_hid": torch.full((cache_slots,), -1, dtype=i32, device=dev),
        "h2d": torch.full((n,), -1, dtype=i32, device=dev),
        "f_recent": torch.zeros(n, device=dev),
    }
    if q is None:
        q = torch.randn(q_abs.shape, generator=gen, device=dev)
    return idx, q, torch.zeros((), dtype=torch.int64, device=dev)
