"""The port's LM configs, layers and dense model against the reference on
the CPU: the same numpy inputs through both packages, the reference's
params carried over with ``convert.model_params_from_arrays``.

Tolerances: fp32 layers rtol = atol = 1e-5 and whole models 1e-4 (the
same operations in another summation order); bf16 2e-2 (one or two
bf16 roundings land elsewhere in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCfg
from repro.configs import svfusion_deep1b as JDeep
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import base as TCfg
from repro_torch.configs import svfusion_deep1b as TDeep
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

DENSE = ["smollm_135m", "qwen3_0p6b", "phi4_mini_3p8b", "deepseek_7b"]
OTHER = [a for a in JCfg.ARCH_IDS if a not in DENSE]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def j2n(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def t2n(x):
    return x.float().numpy()


def close(got, want, tol):
    np.testing.assert_allclose(t2n(got), j2n(want), rtol=tol, atol=tol)


def both(a, dt):
    """One numpy array as a JAX and a torch array of dtype ``dt``."""
    return (jnp.asarray(a).astype(JDT[dt]),
            torch.as_tensor(np.asarray(a)).to(TDT[dt]))


def j_params(cfg, seed=0):
    return JM.init_params(cfg, jax.random.PRNGKey(seed))


def t_params(jp):
    return convert.model_params_from_arrays(jax.tree.map(np.asarray, jp),
                                            "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JCfg.ARCH_IDS)
def test_config_equals_the_reference(arch):
    for load in ("load_config", "load_smoke_config"):
        got, want = getattr(TCfg, load)(arch), getattr(JCfg, load)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.head_dim, got.padded_vocab, got.d_inner,
                got.dt_rank_eff) == (want.head_dim, want.padded_vocab,
                                     want.d_inner, want.dt_rank_eff)


def test_shapes_and_svfusion_configs_equal_the_reference():
    assert TCfg.ARCH_IDS == JCfg.ARCH_IDS
    assert TCfg.SUBQUADRATIC == JCfg.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in TCfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCfg.SHAPES.items()}
    assert all(TCfg.shape_cells(a) == JCfg.shape_cells(a)
               for a in JCfg.ARCH_IDS)
    for name in ("DEEP1B", "MSTURING"):
        got, want = getattr(TDeep, name), getattr(JDeep, name)
        assert {k: v for k, v in got.items() if k != "search"} == \
            {k: v for k, v in want.items() if k != "search"}
        assert tuple(got["search"]) == tuple(want["search"])
    assert tuple(TDeep.smoke_config()["search"]) == \
        tuple(JDeep.smoke_config()["search"])


@pytest.mark.parametrize("arch", JCfg.ARCH_IDS)
def test_full_width_templates_match_the_reference_shapes(arch):
    """Template shapes of the published configs, without allocating."""
    got = TL.tree_leaves(TM.build_templates(TCfg.load_config(arch)))
    want = jax.tree.leaves(JM.abstract_params(JCfg.load_config(arch)))
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    jt = jax.tree.leaves(JM.build_templates(JCfg.load_config(arch)),
                         is_leaf=lambda x: isinstance(x, JL.TSpec))
    assert [(t.axes, t.scale) for t in got] == [(t.axes, t.scale)
                                                for t in jt]


def test_unknown_family_raises():
    """An unknown family raises ``ValueError(family)`` as the reference
    does; so does ``forward_lm`` on the enc-dec family, which has its own
    forward."""
    cfg = TCfg.load_smoke_config("smollm_135m").replace(family="bogus")
    params = {"tok": {"embed": torch.zeros(cfg.padded_vocab, cfg.d_model),
                      "final_norm": torch.ones(cfg.d_model)}}
    tok = torch.zeros(1, 2, dtype=torch.int32)
    for call in (lambda: TM.build_templates(cfg),
                 lambda: TM.init_cache(cfg, 2, 8, device="cpu"),
                 lambda: TM.forward_lm(cfg, params, tok),
                 lambda: TM.prefill(cfg, params, {"tokens": tok}, 8),
                 lambda: TM.decode_step(cfg, params, {"len": torch.tensor(
                     0)}, tok[:, :1])):
        with pytest.raises(ValueError, match="^bogus$"):
            call()
    with pytest.raises(ValueError, match="^encdec$"):
        TM.forward_lm(cfg.replace(family="encdec"), params, tok)


def test_init_from_template_scale_rules():
    tpl = {"z": TL.TSpec((3, 4), (None, None), 0.0),
           "o": TL.TSpec((5,), (None,), -1.0),
           "n": TL.TSpec((200, 100), (None, None), 0.5)}
    gen = torch.Generator().manual_seed(0)
    p = TL.init_from_template(gen, tpl, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in TL.tree_leaves(p))
    assert torch.equal(p["z"], torch.zeros(3, 4, dtype=torch.bfloat16))
    assert torch.equal(p["o"], torch.ones(5, dtype=torch.bfloat16))
    assert abs(p["n"].float().std().item() - 0.5) < 0.02
    again = TL.init_from_template(torch.Generator().manual_seed(0), tpl,
                                  torch.bfloat16)
    assert torch.equal(again["n"], p["n"])


def test_params_cross_both_ways():
    cfg = JCfg.load_smoke_config("qwen3_0p6b")
    arrays = jax.tree.map(np.asarray, j_params(cfg))
    back = convert.model_params_to_arrays(
        convert.model_params_from_arrays(arrays, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for a, b in zip(jax.tree.leaves(arrays), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    half = convert.model_params_from_arrays(arrays, "cpu", torch.bfloat16)
    assert half["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_cast_params_casts_float32_leaves_once():
    cfg = TCfg.load_smoke_config("smollm_135m")
    p = TM.init_params(cfg, torch.Generator().manual_seed(1))
    cast = TM.cast_params(cfg, p)
    assert all(t.dtype == torch.bfloat16 for t in TL.tree_leaves(cast))
    again = TM.cast_params(cfg, cast)
    assert all(a is b for a, b in zip(TL.tree_leaves(cast),
                                      TL.tree_leaves(again)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm(dt):
    rng = np.random.default_rng(1)
    jx, tx = both(rng.normal(size=(2, 5, 48)), dt)
    jw, tw = both(rng.normal(size=48).astype(np.float32), "float32")
    out = TL.rms_norm(tx, tw, 1e-5)
    assert out.dtype == TDT[dt]
    close(out, JL.rms_norm(jx, jw, 1e-5), TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", ["range", "scalar", "lanes"])
def test_apply_rope(dt, pos):
    rng = np.random.default_rng(2)
    B, S, H, Dh = 3, 4, 2, 16
    if pos == "range":
        p = np.arange(S)
    elif pos == "scalar":
        p = np.array(37)[None, None]
    else:
        p = np.array([0, 5, 91])[:, None]
    x = rng.normal(size=(B, S if pos == "range" else 1, H, Dh))
    jx, tx = both(x, dt)
    for theta in (1e4, 1e6):
        jc, js = JL.rope_freqs(jnp.asarray(p), Dh, theta)
        tc, ts = TL.rope_freqs(torch.as_tensor(p), Dh, theta)
        close(tc, jc, 1e-5)
        close(ts, js, 1e-5)
        close(TL.apply_rope(tx, tc, ts), JL.apply_rope(jx, jc, js),
              TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "chunked", "lane_kv_len",
                                  "scalar_kv_len", "window", "lane_offset"])
def test_attention(dt, case):
    rng = np.random.default_rng(3)
    B, S, T, Hq, Hkv, Dh = 2, 8, 8, 4, 2, 16
    if case in ("lane_kv_len", "scalar_kv_len"):
        S, T = 1, 12
    q = rng.normal(size=(B, S, Hq, Dh))
    k = rng.normal(size=(B, T, Hkv, Dh))
    v = rng.normal(size=(B, T, Hkv, Dh))
    (jq, tq), (jk, tk), (jv, tv) = both(q, dt), both(k, dt), both(v, dt)
    kw = {"causal": dict(),
          "chunked": dict(chunk=4),
          "lane_kv_len": dict(causal=False, kv_len=np.array([3, 12])),
          "scalar_kv_len": dict(causal=False, kv_len=np.array(7)),
          "window": dict(window=3),
          "lane_offset": dict(q_offset=np.array([0, 2]), causal=True)}[case]
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    out = TL.attention(tq, tk, tv, **tkw)
    assert out.dtype == TDT[dt]
    close(out, JL.attention(jq, jk, jv, **jkw), TOL[dt])
    if case == "lane_kv_len":
        close(TL.decode_attention(tq, tk, tv, tkw["kv_len"]),
              JL.decode_attention(jq, jk, jv, jkw["kv_len"]), TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm_135m", "phi4_mini_3p8b"])
def test_mlp_embed_and_logits(dt, arch):
    """``smollm_135m`` ties its embeddings; ``phi4_mini_3p8b`` has a head."""
    cfg = JCfg.load_smoke_config(arch)
    jp = j_params(cfg, 4)
    tp = t_params(jp)
    p0 = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    rng = np.random.default_rng(4)
    jx, tx = both(rng.normal(size=(2, 3, cfg.d_model)), dt)
    close(TL.mlp_apply({k: v[0] for k, v in tp["layers"]["mlp"].items()},
                       tx, TCfg.load_smoke_config(arch)),
          JL.mlp_apply(p0, jx), TOL[dt])
    tok = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    emb = TL.embed_tokens(tp["tok"], torch.as_tensor(tok), TDT[dt])
    assert emb.dtype == TDT[dt]
    close(emb, JL.embed_tokens(jp["tok"], jnp.asarray(tok), cfg, JDT[dt]),
          0.0)
    lg = TL.lm_logits(tp["tok"], tx, cfg)
    assert lg.shape[-1] == cfg.padded_vocab
    close(lg, JL.lm_logits(jp["tok"], jx, cfg), TOL[dt])


# ---------------------------------------------------------------------------
# the dense model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    cfg = JCfg.load_smoke_config(request.param).replace(dtype="float32")
    jp = j_params(cfg)
    return (cfg, TCfg.load_smoke_config(request.param).replace(
        dtype="float32"), jp, t_params(jp))


def test_forward_prefill_and_lane_decode_match_the_reference(dense):
    jc, tc, jp, tp = dense
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jc.vocab, (3, 17)).astype(np.int32)
    tol = 1e-4
    full = TM.forward_lm(tc, tp, torch.as_tensor(tok))
    np.testing.assert_allclose(
        t2n(full), j2n(JM.forward_lm(jc, jp, jnp.asarray(tok))),
        rtol=tol, atol=tol)
    jl, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(tok[:, :16])}, 24)
    tl, tcache = TM.prefill(tc, tp, {"tokens": torch.as_tensor(tok[:, :16])},
                            24)
    np.testing.assert_allclose(t2n(tl), j2n(jl), rtol=tol, atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(t2n(tcache[name]), j2n(jcache[name]),
                                   rtol=tol, atol=tol)
    assert int(tcache["len"]) == int(jcache["len"]) == 16
    # per-lane positions, one of them past the cache's end (clamped)
    lens = np.array([16, 9, 30], np.int32)
    jcache = dict(jcache, len=jnp.asarray(lens))
    tcache = dict(tcache, len=torch.as_tensor(lens))
    for step in range(2):
        nxt = tok[:, 16:17] if step == 0 else rng.integers(
            0, jc.vocab, (3, 1)).astype(np.int32)
        jl, jcache = JM.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(nxt))
        np.testing.assert_allclose(t2n(tl), j2n(jl), rtol=tol, atol=tol)
        for name in ("k", "v"):
            np.testing.assert_allclose(t2n(tcache[name]), j2n(jcache[name]),
                                       rtol=tol, atol=tol)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))


def test_scalar_decode_and_chunked_forward_match_the_reference(dense):
    jc, tc, jp, tp = dense
    rng = np.random.default_rng(6)
    tok = rng.integers(0, jc.vocab, (2, 16)).astype(np.int32)
    jcc, tcc = jc.replace(attn_chunk=4), tc.replace(attn_chunk=4)
    np.testing.assert_allclose(
        t2n(TM.forward_lm(tcc, tp, torch.as_tensor(tok))),
        j2n(JM.forward_lm(jcc, jp, jnp.asarray(tok))), rtol=1e-4, atol=1e-4)
    _, jcache = JM.prefill(jc, jp, {"tokens": jnp.asarray(tok[:, :8])}, 16)
    _, tcache = TM.prefill(tc, tp, {"tokens": torch.as_tensor(tok[:, :8])},
                           16)
    jl, _ = JM.decode_step(jc, jp, jcache, jnp.asarray(tok[:, 8:9]))
    tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(tok[:, 8:9]))
    np.testing.assert_allclose(t2n(tl), j2n(jl), rtol=1e-4, atol=1e-4)
    assert tcache["len"].ndim == 0 and int(tcache["len"]) == 9


@pytest.mark.parametrize("arch", JCfg.ARCH_IDS)
def test_prefill_decode_parity(arch):
    """The reference's own check (``tests/test_models.py``), on the port
    alone, at the configs' bf16 compute; MoE with the dense oracle, as
    the reference's test does."""
    cfg = TCfg.load_smoke_config(arch)
    if cfg.family == "moe":
        cfg = cfg.replace(moe_impl="dense")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 32
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1)).astype(
        np.int32))
    extra = {k: torch.as_tensor(v) for k, v in family_inputs(
        cfg, rng, B)[1].items()}
    if cfg.family == "encdec":
        full = TM.forward_encdec(cfg, params, extra["frames"], tokens)
    else:
        full = TM.forward_lm(cfg, params, tokens, extra.get("patches"))
    lg_pre, cache = TM.prefill(cfg, params, {"tokens": tokens[:, :S],
                                             **extra}, max_len=64)
    lg_dec, cache2 = TM.decode_step(cfg, params, cache, tokens[:, S:S + 1])
    off = cfg.n_patches if cfg.family == "vlm" else 0
    np.testing.assert_allclose(t2n(full[:, off + S - 1]), t2n(lg_pre[:, 0]),
                               rtol=2e-2, atol=1e-2)
    np.testing.assert_allclose(t2n(full[:, off + S]), t2n(lg_dec[:, 0]),
                               rtol=2e-2, atol=1e-2)
    assert int(cache2["len"]) == S + 1 + off


# ---------------------------------------------------------------------------
# the other families: moe, ssm, hybrid, vlm, encdec
# ---------------------------------------------------------------------------

MAX_LEN = 32
LANES = np.array([24, 5, 40], np.int32)   # one lane past max_len (clamped)
EXACT = ("wpos", "len", "enc_len")


def family_inputs(cfg, rng, B=3):
    """24 positions of prefill (vlm: 8 patches + 16 tokens; encdec: 16
    frames of memory and 24 tokens), then 2 decode tokens. The hybrid's
    smoke window is 16, so its prefill and decode run past it."""
    S = 24 - cfg.n_patches if cfg.family == "vlm" else 24
    tok = rng.integers(0, cfg.vocab, (B, S + 2)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(size=(B, 16, cfg.d_model)).astype(
            np.float32)
    return tok, extra


@pytest.fixture(scope="module", params=OTHER)
def family(request):
    """The reference's forward, prefill and decodes (jitted), and the
    port's, on one smoke config in fp32 with the reference's params.
    Decodes run from one prefill's cache, scalar and per lane (``LANES``),
    two steps each."""
    arch = request.param
    jc = JCfg.load_smoke_config(arch).replace(dtype="float32")
    tc = TCfg.load_smoke_config(arch).replace(dtype="float32")
    jp = j_params(jc, 7)
    tp = t_params(jp)
    tok, extra = family_inputs(jc, np.random.default_rng(8))
    S = tok.shape[1] - 2
    jex = {k: jnp.asarray(v) for k, v in extra.items()}
    tex = {k: torch.as_tensor(v) for k, v in extra.items()}
    if jc.family == "encdec":
        jfwd = jax.jit(lambda p, f, t: JM.forward_encdec(jc, p, f, t))(
            jp, jex["frames"], jnp.asarray(tok))
        tfwd = TM.forward_encdec(tc, tp, tex["frames"], torch.as_tensor(tok))
    else:
        jfwd = jax.jit(lambda p, t, x: JM.forward_lm(jc, p, t, x))(
            jp, jnp.asarray(tok), jex.get("patches"))
        tfwd = TM.forward_lm(tc, tp, torch.as_tensor(tok), tex.get("patches"))
    jpre = jax.jit(lambda p, b: JM.prefill(jc, p, b, MAX_LEN))(
        jp, {"tokens": jnp.asarray(tok[:, :S]), **jex})
    tpre = TM.prefill(tc, tp, {"tokens": torch.as_tensor(tok[:, :S]), **tex},
                      MAX_LEN)
    jdec = jax.jit(lambda p, c, t: JM.decode_step(jc, p, c, t))
    out = {"fwd": (tfwd, jfwd), "prefill": (tpre, jpre)}
    for mode in ("scalar", "lanes"):
        jcache = jpre[1]
        tcache = {k: v.clone() for k, v in tpre[1].items()}
        if mode == "lanes":
            jcache = dict(jcache, len=jnp.asarray(LANES))
            tcache = dict(tcache, len=torch.as_tensor(LANES))
        steps = []
        for s in (S, S + 1):
            jl, jcache = jdec(jp, jcache, jnp.asarray(tok[:, s:s + 1]))
            tl, tcache = TM.decode_step(tc, tp, tcache,
                                        torch.as_tensor(tok[:, s:s + 1]))
            # the port writes its cache in place: keep this step's copy
            steps.append(((tl, {k: v.clone() for k, v in tcache.items()}),
                          (jl, jcache)))
        out[mode] = steps
    return jc, out


def same_cache(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        if name in EXACT:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]), name)
        else:
            np.testing.assert_allclose(t2n(got[name]), j2n(want[name]),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


def test_family_forward_matches_the_reference(family):
    cfg, out = family
    got, want = out["fwd"]
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(t2n(got), j2n(want), rtol=1e-4, atol=1e-4)


def test_family_prefill_cache_matches_the_reference(family):
    """Logits and every cache field; ``wpos``, ``len`` and ``enc_len``
    exactly (the hybrid's ring holds the last 16 of 24 positions)."""
    cfg, out = family
    (tl, tcache), (jl, jcache) = out["prefill"]
    np.testing.assert_allclose(t2n(tl), j2n(jl), rtol=1e-4, atol=1e-4)
    same_cache(tcache, jcache)
    assert int(tcache["len"]) == 24
    if cfg.family == "hybrid":
        assert sorted(tcache["wpos"][0, 0].tolist()) == list(range(8, 24))
    if cfg.family == "encdec":
        assert int(tcache["enc_len"]) == 16


@pytest.mark.parametrize("mode", ["scalar", "lanes"])
def test_family_decode_matches_the_reference(family, mode):
    for (tl, tcache), (jl, jcache) in family[1][mode]:
        np.testing.assert_allclose(t2n(tl), j2n(jl), rtol=1e-4, atol=1e-4)
        same_cache(tcache, jcache)


@pytest.mark.parametrize("arch", OTHER)
def test_family_bf16_forward_matches_the_reference(arch):
    cfg = JCfg.load_smoke_config(arch)
    jp = j_params(cfg, 9)
    tok, extra = family_inputs(cfg, np.random.default_rng(9), B=2)
    if cfg.family == "encdec":
        want = jax.jit(lambda p, f, t: JM.forward_encdec(cfg, p, f, t))(
            jp, jnp.asarray(extra["frames"]), jnp.asarray(tok))
        got = TM.forward_encdec(TCfg.load_smoke_config(arch), t_params(jp),
                                torch.as_tensor(extra["frames"]),
                                torch.as_tensor(tok))
    else:
        p = extra.get("patches")
        want = jax.jit(lambda p, t, x: JM.forward_lm(cfg, p, t, x))(
            jp, jnp.asarray(tok), None if p is None else jnp.asarray(p))
        got = TM.forward_lm(TCfg.load_smoke_config(arch), t_params(jp),
                            torch.as_tensor(tok),
                            None if p is None else torch.as_tensor(p))
    assert got.dtype == torch.bfloat16
    close(got, want, TOL["bfloat16"])
