"""The port's Mamba-1 mixer against the reference on the CPU, on the same
numpy inputs and the reference's params (``convert.model_params_from_
arrays``).

The reference scans a chunk with ``lax.associative_scan``; the port step
by step, which combines the same pairs in another order. The mixer
is held at several chunks (``ssm_chunk=8``, S = 32) and at one chunk,
with and without a carried state. Tolerances: fp32 1e-5, bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_smoke_config as j_smoke
from repro.models import mamba as JMa
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs.base import load_smoke_config as t_smoke
from repro_torch.models import mamba as TMa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ssm0():
    """Layer 0's SSM params of falcon-mamba's smoke config (d_inner 128,
    d_state 4, conv 4), with a nonzero conv bias and dt bias."""
    cfg = j_smoke("falcon_mamba_7b")
    jp = jax.tree.map(lambda a: np.asarray(a[0]), JM.init_params(
        cfg, jax.random.PRNGKey(5))["layers"]["ssm"])
    rng = np.random.default_rng(5)
    jp["conv_b"] = rng.normal(size=jp["conv_b"].shape).astype(np.float32)
    jp["dt_bias"] = rng.normal(size=jp["dt_bias"].shape).astype(np.float32)
    return (jax.tree.map(jnp.asarray, jp),
            convert.model_params_from_arrays(jp, "cpu"))


def both(a, dt):
    return (jnp.asarray(a).astype(JDT[dt]),
            torch.as_tensor(np.asarray(a)).to(TDT[dt]))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def states(cfg, dt, B, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, cfg.d_inner, cfg.d_state)).astype(np.float32)
    conv = rng.normal(size=(B, cfg.d_conv - 1, cfg.d_inner))
    return both(h, "float32"), both(conv, dt)


@pytest.mark.parametrize("C", [1, 5, 8, 13])
def test_chunk_scan(C):
    rng = np.random.default_rng(C)
    a = rng.uniform(0.5, 1.0, size=(2, C, 6, 4)).astype(np.float32)
    bx = rng.normal(size=(2, C, 6, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 6, 4)).astype(np.float32)
    got = TMa._chunk_scan(*(torch.as_tensor(t) for t in (a, bx, h0)))
    want = JMa._chunk_scan(*(jnp.asarray(t) for t in (a, bx, h0)))
    for g, w in zip(got, want):
        close(g, w, TOL["float32"])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
def test_causal_conv(dt, state):
    cfg = t_smoke("falcon_mamba_7b")
    rng = np.random.default_rng(1)
    jx, tx = both(rng.normal(size=(2, 6, cfg.d_inner)), dt)
    jw, tw = both(rng.normal(size=(cfg.d_conv, cfg.d_inner)), "float32")
    jb, tb = both(rng.normal(size=cfg.d_inner), "float32")
    _, (jc, tc) = states(cfg, dt, 2, 2)
    got = TMa._causal_conv(tx, tw, tb, tc if state else None)
    want = JMa._causal_conv(jx, jw, jb, jc if state else None)
    assert got[0].dtype == got[1].dtype == TDT[dt]
    close(got[0], want[0], TOL[dt])
    close(got[1], want[1], 0.0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk,state", [(8, False), (8, True),
                                         (256, False), (256, True),
                                         (12, False)])
def test_mamba_mixer(ssm0, dt, chunk, state):
    """S = 32: four chunks of 8; one chunk (256 > S); 12 does not divide
    32, so the reference falls back to one chunk."""
    jp, tp = ssm0
    cfg = t_smoke("falcon_mamba_7b").replace(dtype=dt, ssm_chunk=chunk)
    jx, tx = both(np.random.default_rng(3).normal(size=(2, 32, cfg.d_model)),
                  dt)
    (jh, th), (jc, tc) = states(cfg, dt, 2, 4)
    y, (h, conv) = TMa.mamba_mixer(tp, tx, cfg,
                                   (th, tc) if state else None)
    wy, (wh, wconv) = JMa.mamba_mixer(jp, jx, cfg,
                                      (jh, jc) if state else None)
    assert y.dtype == conv.dtype == TDT[dt] and h.dtype == torch.float32
    close(y, wy, TOL[dt])
    close(h, wh, TOL[dt])
    close(conv, wconv, TOL[dt])         # the in_proj GEMM's last rows


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mamba_step_and_state(ssm0, dt):
    """Three steps from a random state; the last state of a mixer over the
    same tokens equals the state the steps carry."""
    jp, tp = ssm0
    cfg = t_smoke("falcon_mamba_7b").replace(dtype=dt)
    (jh, th), (jc, tc) = states(cfg, dt, 3, 6)
    jx, tx = both(np.random.default_rng(7).normal(size=(3, 3, cfg.d_model)),
                  dt)
    jst, tst = (jh, jc), (th, tc)
    for t in range(3):
        y, tst = TMa.mamba_step(tp, tx[:, t:t + 1], cfg, tst)
        wy, jst = JMa.mamba_step(jp, jx[:, t:t + 1], cfg, jst)
        close(y, wy, TOL[dt])
        close(tst[0], jst[0], TOL[dt])
        close(tst[1], jst[1], TOL[dt])
    _, (h, conv) = TMa.mamba_mixer(tp, tx, cfg, (th, tc))
    close(h, jst[0], TOL[dt])
    close(conv, jst[1], TOL[dt])        # one GEMM of 3 rows against 3 of 1
    h0, c0 = TMa.init_mamba_state(cfg, 3, device="cpu")
    wh0, wc0 = JMa.init_mamba_state(cfg, 3)
    assert h0.shape == wh0.shape and c0.shape == wc0.shape
    assert (h0.dtype, c0.dtype) == (torch.float32, torch.bfloat16)
