"""The port's training path against the reference on the CPU: the loss
pieces, the SSM scan's backward, the remat policies, AdamW, the data
pipelines, checkpoints in both directions, gradient compression and the
train loop. Each reference oracle of ``tests/test_models.py`` and
``tests/test_substrate.py`` on training runs on the port here too.

Tolerances (fp32): the loss pieces 1e-6; ``adam_update`` 1e-6 of each
leaf's largest value; the loop's losses 1e-4. Remat, the data and the
checkpoints are held exactly.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:   # no network route: replay fixed seeded examples
    from _hypothesis_shim import given, settings, st

from repro.configs import base as JCfg
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoe
from repro.train import checkpoint as JCk
from repro.train import compression as JCo
from repro.train import data as JData
from repro.train import optimizer as JOpt
from repro.train import train_loop as JLoop
from repro_torch import convert
from repro_torch.configs import base as TCfg
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TMa
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import checkpoint as TCk
from repro_torch.train import compression as TCo
from repro_torch.train import data as TData
from repro_torch.train import optimizer as TOpt
from repro_torch.train import train_loop as TLoop

from test_torch_train_grads import configs, port_loss_and_grads, train_batch

SRC = str(Path(__file__).resolve().parents[1] / "src")


def t_params(jp):
    return convert.model_params_from_arrays(jax.tree.map(np.asarray, jp),
                                            "cpu")


def close(got, want, rel):
    """Every leaf within ``rel`` of the reference leaf's largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the loss pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_the_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = TL.softmax_xent(torch.as_tensor(logits).to(torch.bfloat16)
                          .float(), torch.as_tensor(labels),
                          None if mask is None else torch.as_tensor(mask))
    want_bf = JL.softmax_xent(jnp.asarray(logits).astype(jnp.bfloat16),
                              jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask))
    assert abs(float(got) - float(want_bf)) <= 1e-6 * abs(float(want_bf))
    got = TL.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                          None if mask is None else torch.as_tensor(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_softmax_xent_of_an_empty_mask_is_zero():
    logits = torch.randn(2, 3, 8)
    got = TL.softmax_xent(logits, torch.zeros(2, 3, dtype=torch.int32),
                          torch.zeros(2, 3))
    assert float(got) == float(JL.softmax_xent(
        jnp.asarray(logits.numpy()), jnp.zeros((2, 3), jnp.int32),
        jnp.zeros((2, 3)))) == 0.0


@pytest.mark.parametrize("case", ["random", "tied"])
def test_aux_load_balance_loss_matches_the_reference(case):
    """Random routers, and a zero router whose every token ties across
    all experts: both packages take the first maximum (expert 0)."""
    jc, tc = configs("granite_moe_1b")
    jp = jax.tree.map(lambda a: np.asarray(a[0]), JM.init_params(
        jc, jax.random.PRNGKey(2))["layers"]["mlp"])
    if case == "tied":
        jp["router"] = np.zeros_like(jp["router"])
    x = np.random.default_rng(2).normal(size=(2, 16, jc.d_model)).astype(
        np.float32)
    want = JMoe.aux_load_balance_loss(jax.tree.map(jnp.asarray, jp),
                                      jnp.asarray(x), jc)
    got = TMoe.aux_load_balance_loss(convert.model_params_from_arrays(
        jp, "cpu"), torch.as_tensor(x), tc)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    if case == "tied":
        assert float(got) == 1.0


# ---------------------------------------------------------------------------
# the SSM scan's backward
# ---------------------------------------------------------------------------

def plain_scan(a, bx, h0):
    """The recurrence out of place, for autograd to differentiate."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


@pytest.mark.parametrize("C", [1, 2, 9])
def test_scan_backward_equals_autograd_through_a_plain_loop(C):
    rng = np.random.default_rng(C)
    ins = [rng.uniform(0.5, 1.0, (2, C, 6, 4)), rng.normal(size=(2, C, 6, 4)),
           rng.normal(size=(2, 6, 4))]
    w_hs, w_end = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                   for s in ((2, C, 6, 4), (2, 6, 4)))
    grads = []
    for scan in (TMa._chunk_scan, plain_scan):
        xs = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
              for x in ins]
        hs, h_end = scan(*xs)
        ((hs * w_hs).sum() + (h_end * w_end).sum()).backward()
        grads.append([x.grad for x in xs])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_scan_gradcheck_in_float64():
    rng = np.random.default_rng(0)
    a, bx, h0 = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
                 for x in (rng.uniform(0.5, 1.0, (2, 5, 3, 2)),
                           rng.normal(size=(2, 5, 3, 2)),
                           rng.normal(size=(2, 3, 2))))
    assert torch.autograd.gradcheck(TMa._chunk_scan, (a, bx, h0))


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT = [("smollm_135m", None), ("granite_moe_1b", "capacity"),
         ("falcon_mamba_7b", None), ("hymba_1p5b", None),
         ("whisper_medium", None)]


@pytest.mark.parametrize("arch,impl", REMAT, ids=[a for a, _ in REMAT])
def test_remat_policies_give_bit_equal_gradients(arch, impl):
    """"none", "full" and "dots" recompute the same operations on the
    same inputs: on the CPU the loss and every gradient are bit-equal."""
    jc, _ = configs(arch, impl)
    jp = JM.init_params(jc, jax.random.PRNGKey(4))
    b = train_batch(jc, np.random.default_rng(4),
                    S=40 if jc.family == "hybrid" else 24)
    out = {}
    for policy in ("none", "full", "dots"):
        tc = configs(arch, impl, remat_policy=policy)[1]
        out[policy] = port_loss_and_grads(tc, t_params(jp), b)
    for policy in ("full", "dots"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for g, w in zip(out[policy][1], out["none"][1]):
            assert torch.equal(g, w), policy


def test_remat_policies_leave_the_forward_unchanged():
    """Without a gradient to take (serving, prefill) the layers run as
    they are; with one, through the checkpoint: the logits are the same
    bits under every policy."""
    jc, _ = configs("hymba_1p5b")
    jp = JM.init_params(jc, jax.random.PRNGKey(5))
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, jc.vocab, (2, 40), dtype=np.int32))
    out = {}
    for policy in ("none", "full", "dots"):
        tc = configs("hymba_1p5b", remat_policy=policy)[1]
        params = t_params(jp)
        plain = TM.forward_lm(tc, params, tok)
        for p in TL.tree_leaves(params):
            p.requires_grad_()
        out[policy] = (plain, TM.forward_lm(tc, params, tok).detach())
    for policy in ("full", "dots"):
        for got, want in zip(out[policy], out["none"]):
            assert torch.equal(got, want), policy


class CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args, kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_the_matmuls_that_full_recomputes():
    """The backward of "full" reruns each layer's forward products; the
    backward of "dots" reruns none (they are saved), as "none" does."""
    jc, _ = configs("smollm_135m")
    jp = JM.init_params(jc, jax.random.PRNGKey(4))
    b = train_batch(jc, np.random.default_rng(4))
    counts = {}
    for policy in ("none", "full", "dots"):
        tc = configs("smollm_135m", remat_policy=policy)[1]
        params = t_params(jp)
        leaves = TL.tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        loss = TM.loss_fn(tc, params, {k: torch.as_tensor(v)
                                       for k, v in b.items()})
        with CountMM() as mode:
            loss.backward()
        counts[policy] = mode.mm
    # q, k, v, o, gate and up a layer at least (the recompute may stop
    # before down, whose output no backward reads)
    assert counts["full"] >= counts["none"] + 6 * tc.n_layers
    assert counts["dots"] == counts["none"]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_schedule_and_global_norm_match_the_reference():
    cfg = dict(lr=1e-3, warmup=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 250):
        got = TOpt.schedule(torch.tensor(s, dtype=torch.int32),
                            TOpt.AdamConfig(**cfg))
        want = JOpt.schedule(jnp.asarray(s, jnp.int32), JOpt.AdamConfig(**cfg))
        assert got.dtype == torch.float32
        close(got, want, 1e-6)
    rng = np.random.default_rng(1)
    tree = {"b": rng.normal(size=(3, 4)).astype(np.float32),
            "a": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    close(TOpt.global_norm(convert.model_params_from_arrays(tree, "cpu")),
          JOpt.global_norm(jax.tree.map(jnp.asarray, tree)), 1e-6)


def test_adam_update_matches_the_reference_over_three_steps():
    """Three steps from the reference's smoke params; the second step's
    gradients are scaled up so that the global-norm clip acts."""
    jc, _ = configs("qwen3_0p6b")
    jp = JM.init_params(jc, jax.random.PRNGKey(6))
    adam = dict(lr=1e-2, warmup=2, total_steps=10)
    jcfg, tcfg = JOpt.AdamConfig(**adam), TOpt.AdamConfig(**adam)
    js = JOpt.init_adam(jp, jcfg)
    tp, ts = t_params(jp), TOpt.init_adam(t_params(jp), tcfg)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    rng = np.random.default_rng(6)
    clipped = []
    for k in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3
                                    * (1e4 if k == 1 else 1)
                                    ).astype(np.float32), jp)
        jp, js, jm = JOpt.adam_update(jp, jax.tree.map(jnp.asarray, g), js,
                                      jcfg)
        tp, ts, tm = TOpt.adam_update(
            tp, convert.model_params_from_arrays(g, "cpu"), ts, tcfg)
        clipped.append(float(jm["grad_norm"]) > jcfg.grad_clip)
        close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        close(tm["lr"], jm["lr"], 1e-6)
        assert int(ts.step) == int(js.step) == k + 1
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(TL.tree_leaves(got), jax.tree.leaves(want)):
                close(a, b, 1e-6)
    assert clipped == [False, True, False]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def read_batches(mod, n, pause):
    pipe = mod.TokenPipeline(512, 2, 16, seed=3)
    try:
        out = []
        for _ in range(n):
            out.append(next(pipe))
            time.sleep(pause)
        return out
    finally:
        pipe.close()


@pytest.mark.parametrize("pause", [0.0, 0.25])
def test_token_pipeline_batches_equal_the_reference(pause):
    """The reference read at once; the port at once and with a pause
    longer than the queue's 0.1 s put timeout after each batch (the
    reference drops batches then; the port does not)."""
    for got, want in zip(read_batches(TData, 4, pause),
                         read_batches(JData, 4, 0.0)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


WORKLOAD_KW = {"msturing_ih": dict(n_start=256, n_final=1024, dim=8,
                                   n_ops=30),
               "sliding_window": dict(n=1000, dim=8, t_max=20),
               "expiration_time": dict(n=1000, dim=8, t_max=20),
               "clustered": dict(n=1000, dim=8, rounds=2)}


@pytest.mark.parametrize("wname", sorted(JData.WORKLOADS))
def test_workload_ops_equal_the_reference(wname):
    assert sorted(TData.WORKLOADS) == sorted(JData.WORKLOADS)
    ops = [list(m.WORKLOADS[wname](**WORKLOAD_KW[wname], seed=5))
           for m in (TData, JData)]
    assert len(ops[0]) == len(ops[1]) > 0
    for got, want in zip(*ops):
        assert got.kind == want.kind
        for f in ("vectors", "ids", "queries"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if w is not None:
                assert g.dtype == w.dtype and g.shape == w.shape
                assert g.tobytes() == w.tobytes(), f


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def train_state(seed=0):
    """The reference's (params, AdamState) after one update on the
    smollm smoke config, and the port's copy of it."""
    jc, _ = configs("smollm_135m")
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    adam = JOpt.AdamConfig()
    g = jax.tree.map(lambda a: jnp.full(a.shape, 1e-3, a.dtype), jp)
    jp, js, _ = JOpt.adam_update(jp, g, JOpt.init_adam(jp, adam), adam)
    tp = t_params(jp)
    ts = convert.adam_state_from_arrays(jax.tree.map(np.asarray, js), "cpu")
    return (jp, js), (tp, ts)


def manifest(path, step):
    return json.loads((Path(path) / f"step_{step:08d}" /
                       "manifest.json").read_text())


def same_state(got, want):
    gp, gs = got
    wp, ws = want
    assert isinstance(gs, TOpt.AdamState)
    assert gs.step.dtype == torch.int32 and int(gs.step) == int(ws.step)
    for g, w in zip(TL.tree_leaves(gp) + TL.tree_leaves(gs.mu)
                    + TL.tree_leaves(gs.nu),
                    jax.tree.leaves((wp, ws.mu, ws.nu))):
        assert torch.is_tensor(g)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_adam_state_crosses_both_ways():
    (jp, js), (tp, ts) = train_state(3)
    back = JOpt.AdamState(*convert.adam_state_to_arrays(ts))
    assert back.step.dtype == np.int32 and back.step.shape == ()
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    same_state((tp, ts), (jp, js))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    (jp, js), (tp, ts) = train_state()
    JCk.CheckpointManager(tmp_path / "ref").save(7, (jp, js))
    like = (TL.tree_map(torch.zeros_like, tp),
            TOpt.init_adam(tp, TOpt.AdamConfig()))
    s, tree = TCk.CheckpointManager(tmp_path / "ref").restore(like)
    assert s == 7
    same_state(tree, (jp, js))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (jp, js), (tp, ts) = train_state(1)
    TCk.CheckpointManager(tmp_path / "port").save(3, (tp, ts),
                                                   extra={"k": 1})
    like = (jax.tree.map(jnp.zeros_like, jp),
            JOpt.init_adam(jp, JOpt.AdamConfig()))
    s, (rp, rs) = JCk.CheckpointManager(tmp_path / "port").restore(like)
    assert s == 3 and int(rs.step) == 1
    for g, w in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_manifests_are_equal(tmp_path):
    """The same state saved by each package: the same paths (``0/...``,
    ``1/.step``, ``1/.mu/...``), files, shapes, dtypes and CRCs."""
    (jp, js), (tp, ts) = train_state(2)
    JCk.CheckpointManager(tmp_path / "ref").save(5, (jp, js), {"e": 2})
    TCk.CheckpointManager(tmp_path / "port").save(5, (tp, ts), {"e": 2})
    got, want = manifest(tmp_path / "port", 5), manifest(tmp_path / "ref", 5)
    assert got == want
    paths = [leaf["path"] for leaf in got["leaves"]]
    assert paths[0] == "0/layers/attn/wk" and "0/tok/embed" in paths
    assert "1/.step" in paths and "1/.mu/tok/embed" in paths
    assert paths[-1] == "1/.nu/tok/final_norm"


def ck_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "d": torch.zeros(())}


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    """tests/test_substrate.py's check, on the port."""
    mgr = TCk.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, TL.tree_map(lambda x: x + s, ck_tree()))
    assert mgr.all_steps() == [2, 3]
    s, tree = mgr.restore(ck_tree())
    assert s == 3
    np.testing.assert_allclose(tree["a"].numpy(), ck_tree()["a"].numpy() + 3)
    assert tree["b"]["c"].dtype == torch.int32


def test_checkpoint_corruption_falls_back(tmp_path):
    """tests/test_substrate.py's check, on the port: a corrupt leaf of the
    newest checkpoint, then an empty one."""
    mgr = TCk.CheckpointManager(tmp_path, keep=3)
    mgr.save(1, ck_tree())
    mgr.save(2, TL.tree_map(lambda x: x * 2, ck_tree()))
    mgr.save(3, TL.tree_map(lambda x: x * 3, ck_tree()))
    next((tmp_path / "step_00000003").glob("leaf_*.npy")).write_bytes(
        b"garbage garbage garbage")
    next((tmp_path / "step_00000002").glob("leaf_*.npy")).write_bytes(b"")
    s, tree = mgr.restore(ck_tree())
    assert s == 1
    assert torch.equal(tree["a"], ck_tree()["a"])
    assert mgr.restore({"only": torch.zeros(1)}) == (None, None)


def test_save_async_snapshots_before_the_caller_writes(tmp_path):
    mgr = TCk.CheckpointManager(tmp_path)
    t = ck_tree()
    mgr.save_async(4, t)
    t["a"].add_(100)
    mgr.wait()
    s, tree = mgr.restore(ck_tree(), device="cpu")
    assert s == 4 and torch.equal(tree["a"], ck_tree()["a"])


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_and_ef_compress_match_the_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 64)) * 3).astype(np.float32)
    err = (rng.normal(size=(16, 64)) * 0.01).astype(np.float32)
    (qj, sj), (qt, s_t) = (JCo.quantize_int8(jnp.asarray(x)),
                           TCo.quantize_int8(torch.as_tensor(x)))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(TCo.dequantize_int8(qt, s_t).numpy(),
                                  np.asarray(JCo.dequantize_int8(qj, sj)))
    got = TCo.ef_compress(torch.as_tensor(x), torch.as_tensor(err))
    want = JCo.ef_compress(jnp.asarray(x), jnp.asarray(err))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_int8_quantization_bounds():
    """tests/test_substrate.py's check, on the port."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 64))
                        * 3.0, dtype=torch.float32)
    q, s = TCo.quantize_int8(x)
    err = (TCo.dequantize_int8(q, s) - x).abs().numpy()
    amax = x.abs().numpy().max(-1, keepdims=True)
    assert (err <= amax / 127.0 * 0.501 + 1e-6).all()


def test_error_feedback_accumulates_small_signal():
    """tests/test_substrate.py's check, on the port: error feedback
    transmits a signal far below one quantization step."""
    x = torch.full((1, 8), 1e-4)
    big = torch.zeros(1, 8)
    big[0, 0] = 1.0
    err = torch.zeros_like(x)
    total = np.zeros((1, 8), np.float32)
    for _ in range(300):
        deq, err = TCo.ef_compress(x + big - big, err)
        total += deq.numpy()
    np.testing.assert_allclose(total / 300.0, x.numpy(), rtol=0.2, atol=2e-5)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_ef_residual_bounded(seed):
    """tests/test_substrate.py's check, on the port."""
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(4, 32)),
                        dtype=torch.float32)
    err = torch.zeros_like(x)
    for _ in range(5):
        _, err = TCo.ef_compress(x, err)
        amax = (x + err).abs().amax(-1, keepdim=True)
        assert (err.abs() <= amax / 127.0 + 1e-5).all()


PSUM_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
src, rdzv, out, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path.insert(0, src)
from repro_torch.train.compression import ef_int8_psum, make_crosspod_grad_sync
dist.init_process_group("gloo", init_method="file://" + rdzv, world_size=2,
                        rank=rank)
try:
    z = np.load(out)
    g, e = (torch.from_numpy(z[f"{k}{rank}"]) for k in ("g", "e"))
    mean, err = ef_int8_psum(g, e)
    tm, te = make_crosspod_grad_sync()({"w": {"v": g}, "b": g[:1]},
                                       {"w": {"v": e}, "b": e[:1]})
    np.savez(out + f".rank{rank}.npz", mean=mean.numpy(), err=err.numpy(),
             tree_w=tm["w"]["v"].numpy(), tree_b=tm["b"].numpy(),
             err_w=te["w"]["v"].numpy())
finally:
    dist.destroy_process_group()
"""


def test_ef_int8_psum_over_two_gloo_processes(tmp_path):
    """Each rank's result is the mean of both ranks' ``ef_compress``, and
    its error is its own ``ef_compress`` residual; the tree form equals
    the leaf form."""
    rng = np.random.default_rng(3)
    arrays = {f"{k}{r}": rng.normal(size=(6, 32)).astype(np.float32)
              * (1.0 if k == "g" else 0.01) for k in "ge" for r in (0, 1)}
    out = str(tmp_path / "in.npz")
    np.savez(out, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", PSUM_RANK, SRC,
                               str(tmp_path / "rdzv"), out, str(r)],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    comp = [TCo.ef_compress(torch.as_tensor(arrays[f"g{r}"]),
                            torch.as_tensor(arrays[f"e{r}"])) for r in (0, 1)]
    mean = ((comp[0][0] + comp[1][0]) / 2).numpy()
    for r in (0, 1):
        got = np.load(out + f".rank{r}.npz")
        np.testing.assert_allclose(got["mean"], mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got["err"], comp[r][1].numpy())
        np.testing.assert_array_equal(got["tree_w"], got["mean"])
        np.testing.assert_array_equal(got["err_w"], got["err"])
        assert got["tree_b"].shape == (1, 32)


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def test_train_loop_losses_match_the_reference(monkeypatch):
    """6 steps of ``run`` on smollm's smoke config in fp32 from the
    reference's params, over the same TokenPipeline batches (the port's
    pipeline in both: the reference's skips batches while its first,
    compiling step runs, data.py)."""
    monkeypatch.setattr(JLoop, "TokenPipeline", TData.TokenPipeline)
    jc, tc = configs("smollm_135m")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    want = JLoop.run(jc, steps=6, batch=2, seq=32, params=jp)
    got = TLoop.run(tc, steps=6, batch=2, seq=32, params=t_params(jp),
                    device="cpu")
    assert (got.steps, got.restored_from) == (6, -1)
    assert len(got.losses) == len(got.step_seconds) == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    assert got.losses[-1] < got.losses[0]


def test_train_resume_continues(tmp_path):
    """tests/test_substrate.py's check, on the port."""
    cfg = TCfg.load_smoke_config("smollm_135m")
    kw = dict(batch=2, seq=32, ckpt_dir=tmp_path, ckpt_every=3,
              device="cpu")
    TLoop.run(cfg, steps=6, **kw)
    r2 = TLoop.run(cfg, steps=6, **kw)
    assert r2.restored_from == 6 and len(r2.losses) == 0
    r3 = TLoop.run(cfg, steps=8, **kw)
    assert r3.restored_from == 6 and len(r3.losses) == 2


def test_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TLoop.run(TCfg.load_smoke_config("smollm_135m"), steps=1)


def smoke_batch(cfg, rng, B=2, S=33):
    """tests/test_models.py's batch (labels = tokens, mask of ones), from
    numpy."""
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32))
    b = {"tokens": tok, "labels": tok, "mask": torch.ones(B, S)}
    if cfg.family == "vlm":
        b["patches"] = torch.randn(B, cfg.n_patches, cfg.d_model)
    if cfg.family == "encdec":
        b["frames"] = torch.randn(B, 16, cfg.d_model)
    return b


@pytest.mark.parametrize("arch", JCfg.ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """tests/test_models.py's check, on the port: finite loss and
    gradients, and one SGD step lowers the loss."""
    cfg = TCfg.load_smoke_config(arch)
    torch.manual_seed(0)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = smoke_batch(cfg, np.random.default_rng(0))
    loss, grads = port_loss_and_grads(cfg, params, batch)
    gnorm = sum(float((g.float() ** 2).sum()) for g in grads)
    assert np.isfinite(float(loss)) and np.isfinite(gnorm) and gnorm > 0
    with torch.no_grad():
        params2 = TL.tree_map(lambda p: p - 0.05 * p.grad, params)
        assert float(TM.loss_fn(cfg, params2, batch)) < float(loss)


def test_multi_step_training_decreases_loss():
    """tests/test_models.py's check, on the port: 8 SGD steps."""
    cfg = TCfg.load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = smoke_batch(cfg, np.random.default_rng(1), B=4, S=64)
    losses = []
    for _ in range(8):
        loss, grads = port_loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            params = TL.tree_map(lambda p: p - 0.03 * p.grad, params)
        losses.append(float(loss))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.03
    assert losses[-1] < losses[0]


def test_bf16_products_accumulate_in_fp32_where_the_lm_runs():
    """``ServeEngine`` and ``make_step`` turn off cuBLAS's reduced-
    precision bf16 reduction (the reference's dots accumulate in fp32)."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    cfg = TCfg.load_smoke_config("smollm_135m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        ServeEngine(cfg, params, slots=2, max_len=8, device="cpu")
        assert flags.allow_bf16_reduced_precision_reduction is False
        flags.allow_bf16_reduced_precision_reduction = True
        TLoop.make_step(cfg, TOpt.AdamConfig())
        assert flags.allow_bf16_reduced_precision_reduction is False
    finally:
        flags.allow_bf16_reduced_precision_reduction = before
