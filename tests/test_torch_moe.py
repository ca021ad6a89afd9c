"""The port's MoE FFN against the reference on the CPU: the router, the
exact dense oracle and the capacity dispatch, on the same numpy inputs and
the reference's params (``convert.model_params_from_arrays``).

The capacity dispatch must drop exactly the (token, expert) pairs the
reference drops and put each kept token at the same place of its
expert's buffer: both packages' expert FFN is patched to record the
dispatched ``[G, E, C, D]`` buffer, which is pure data movement, and the
two buffers must be equal. Tolerances: fp32 1e-5, bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import load_smoke_config as j_smoke
from repro.models import model as JM
from repro.models import moe as JMoe
from repro_torch import convert
from repro_torch.configs.base import load_smoke_config as t_smoke
from repro_torch.core.topk import largest_k, largest_k_by_sort
from repro_torch.models import moe as TMoe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer0(arch):
    """Layer 0's MoE params of a smoke config, in both packages."""
    cfg = j_smoke(arch)
    jp = jax.tree.map(lambda a: a[0], JM.init_params(
        cfg, jax.random.PRNGKey(3))["layers"]["mlp"])
    return jp, convert.model_params_from_arrays(
        jax.tree.map(np.asarray, jp), "cpu")


def inputs(cfg, dt, B=2, S=16, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return (jnp.asarray(x).astype(JDT[dt]),
            torch.as_tensor(x).to(TDT[dt]))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def recording(monkeypatch):
    """Patch both packages' expert FFN to record its input buffer."""
    seen = {}
    j_ffn, t_ffn = JMoe._expert_ffn, TMoe._expert_ffn

    def j_rec(p, xe, dt, cfg=None):
        seen["ref"] = np.asarray(xe.astype(jnp.float32))
        return j_ffn(p, xe, dt, cfg)

    def t_rec(p, xe, dt, cfg):
        seen["port"] = xe.float().numpy()
        return t_ffn(p, xe, dt, cfg)
    monkeypatch.setattr(JMoe, "_expert_ffn", j_rec)
    monkeypatch.setattr(TMoe, "_expert_ffn", t_rec)
    return seen


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_moe_1b", "grok1_314b"])
def test_router_and_dense_match_the_reference(arch, dt):
    cfg = t_smoke(arch).replace(dtype=dt)
    jp, tp = layer0(arch)
    jx, tx = inputs(cfg, dt)
    close(TMoe._router_probs(tp, tx), JMoe._router_probs(jp, jx, cfg),
          1e-6)
    out = TMoe.moe_apply_dense(tp, tx, cfg)
    assert out.dtype == TDT[dt]
    close(out, JMoe.moe_apply_dense(jp, jx, cfg), TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["drops", "odd_group", "no_drops",
                                  "group_of_one"])
def test_capacity_dispatch_keeps_the_reference_pairs(monkeypatch, case,
                                                     dt):
    """``drops``: capacity factor 0.5 over 4 groups of 8 tokens (C = 2 of
    the 4 claims an expert would get on average); ``odd_group``: 3 x 7
    tokens, so the group is 7, the largest divisor of 21 under 16;
    ``no_drops``: capacity factor 4, so C = g; ``group_of_one``: decode's
    ``moe_group=1``, where C = 1 keeps every pair."""
    kw, B, S = {"drops": (dict(capacity_factor=0.5, moe_group=8), 2, 16),
                "odd_group": (dict(capacity_factor=0.75, moe_group=16),
                              3, 7),
                "no_drops": (dict(capacity_factor=4.0), 2, 16),
                "group_of_one": (dict(moe_group=1), 4, 1)}[case]
    cfg = t_smoke("granite_moe_1b").replace(dtype=dt, **kw)
    jp, tp = layer0("granite_moe_1b")
    jx, tx = inputs(cfg, dt, B, S)
    seen = recording(monkeypatch)
    want = JMoe.moe_apply_capacity(jp, jx, cfg)
    got = TMoe.moe_apply_capacity(tp, tx, cfg)
    np.testing.assert_array_equal(seen["port"], seen["ref"])
    close(got, want, TOL[dt])
    kept = int((np.abs(seen["port"]).sum(-1) > 0).sum())
    pairs = B * S * cfg.top_k
    assert (kept < pairs) == (case in ("drops", "odd_group")), kept


def test_capacity_slots_priority_is_slot_major():
    """Expert 0 has capacity 2: token 2's slot 0 beats token 0's slot 1."""
    topi = torch.tensor([[[1, 0], [0, 2], [0, 1]]])        # [G=1, g=3, K=2]
    pos, keep = TMoe.capacity_slots(topi, 3, 2)
    assert pos.tolist() == [[[0, 2], [0, 0], [1, 1]]]
    assert keep.tolist() == [[[True, False], [True, True], [True, True]]]


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_tied_router_takes_the_lower_expert(monkeypatch, impl):
    """A router whose columns come in equal pairs gives every token tied
    probabilities: both packages pick the lower expert of a tie, as
    ``lax.top_k`` does (``torch.topk`` does not promise it)."""
    cfg = t_smoke("granite_moe_1b").replace(dtype="float32",
                                            capacity_factor=1.0,
                                            moe_group=8, moe_impl=impl)
    jp, tp = layer0("granite_moe_1b")
    r = np.asarray(jp["router"])
    r = np.repeat(r[:, ::2], 2, axis=1)                    # e, e+1 equal
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.as_tensor(r))
    jx, tx = inputs(cfg, "float32")
    probs = TMoe._router_probs(tp, tx)
    assert torch.equal(probs[..., ::2], probs[..., 1::2])
    top = largest_k_by_sort(probs, cfg.top_k)[1]           # top_k = 2
    assert (top[..., 0] % 2 == 0).all() and (top[..., 1] == top[..., 0] + 1
                                             ).all()
    seen = recording(monkeypatch)
    close(TMoe.moe_apply(tp, tx, cfg), JMoe.moe_apply(jp, jx, cfg),
          TOL["float32"])
    if impl == "capacity":
        np.testing.assert_array_equal(seen["port"], seen["ref"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_top_k_by_sort_matches_lax_top_k(seed):
    """The router's top-k (one stable sort) picks what ``lax.top_k`` and
    ``largest_k`` pick on narrow rows full of ties, and needs no data to
    know its shape: it runs on meta tensors past any size threshold."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, (3, 50, 8)).astype(np.float32)
    for k in (1, 2, 8):
        v, i = largest_k_by_sort(torch.from_numpy(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        lv, li = largest_k(torch.from_numpy(x), k)
        assert torch.equal(li, i) and torch.equal(lv, v)
    m = torch.empty((4, 1 << 21, 8), device="meta")      # 2^26 elements
    v, i = largest_k_by_sort(m, 2)
    assert v.shape == i.shape == (4, 1 << 21, 2) and i.dtype == torch.int64
