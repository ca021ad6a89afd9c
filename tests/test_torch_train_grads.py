"""The port's training loss and its gradients against the reference's
``jax.value_and_grad(loss_fn)`` on the CPU, on the smoke config of every
architecture (both MoE dispatches; the hybrid past its window; the VLM
with patches; the enc-dec with frames), the reference's params carried
over with ``convert.model_params_from_arrays``.

Tolerance, fp32 (``cfg.replace(dtype="float32")``): the loss within 1e-5
and each gradient leaf within ``1e-4 * max|g_ref| + 1e-7`` (the same
operations summed in another order; the SSM scan is sequential in the
port and a tree in the reference).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCfg
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import base as TCfg
from repro_torch.models import model as TM
from repro_torch.models.layers import tree_leaves

CASES = [(a, impl) for a in JCfg.ARCH_IDS
         for impl in (("capacity", "dense")
                      if JCfg.load_smoke_config(a).family == "moe"
                      else (None,))]


def configs(arch, impl=None, **kw):
    """The reference's and the port's fp32 smoke config of ``arch``."""
    kw = dict(kw, dtype="float32", **({"moe_impl": impl} if impl else {}))
    return (JCfg.load_smoke_config(arch).replace(**kw),
            TCfg.load_smoke_config(arch).replace(**kw))


def train_batch(cfg, rng, B=2, S=24):
    """Tokens, next-token labels and a mask with ~20% of positions out;
    the vlm's patches, the enc-dec's 16 frames."""
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, 1),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.family == "vlm":
        b["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, 16, cfg.d_model)).astype(
            np.float32)
    return b


def port_loss_and_grads(cfg, params, batch):
    """(loss, gradient leaves in sorted-key order) of the port's
    ``loss_fn`` by ``.backward()``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = TM.loss_fn(cfg, params, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    loss.backward()
    return loss.detach(), [p.grad for p in leaves]


def worst_grad_ratio(got, want):
    """max over leaves of max|g - g_ref| / (1e-4 max|g_ref| + 1e-7): at
    most 1 within the tolerance."""
    return max(float(np.abs(g.numpy() - w).max()
                     / (1e-4 * np.abs(w).max() + 1e-7))
               for g, w in zip(got, want))


@pytest.mark.parametrize("arch,impl", CASES,
                         ids=[f"{a}-{i}" if i else a for a, i in CASES])
def test_loss_and_gradients_match_the_reference(arch, impl):
    jc, tc = configs(arch, impl)
    # the hybrid's smoke window is 16: 40 positions run past it
    b = train_batch(jc, np.random.default_rng(1),
                    S=40 if jc.family == "hybrid" else 24)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jc, p, b)))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    tp = convert.model_params_from_arrays(jax.tree.map(np.asarray, jp),
                                          "cpu")
    tl, tg = port_loss_and_grads(tc, tp, b)
    assert abs(float(tl) - float(jl)) <= 1e-5, (float(tl), float(jl))
    want = [np.asarray(g) for g in jax.tree.leaves(jg)]
    assert [tuple(g.shape) for g in tg] == [w.shape for w in want]
    worst = worst_grad_ratio(tg, want)
    assert worst <= 1.0, f"worst gradient leaf at {worst:.3g}x the tolerance"
