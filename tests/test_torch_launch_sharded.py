"""Every LM family's train, prefill and decode step bundle run sharded by
``launch.steps.run_sharded`` on a (2, 2) ("data", "model") mesh of gloo
processes, held against the same bundle in one process and the training
loss against the reference's ``jit(loss_fn, in_shardings=...)`` on 4
fake CPU devices (as ``tests/test_distributed.py:74-99`` runs it).

Each family runs at its smoke config in fp32 (remat "full" for training,
so ``torch.utils.checkpoint`` runs on DTensors), with the reference's
params carried over by ``convert.model_params_from_arrays``; granite-moe
runs both MoE dispatches. The cells are B = 4 sequences of S = 36
positions (no smoke width is 36, so a gather of a KV cache shows by its
length); the decode steps go on from a one-process prefill of the first
28 positions (the hybrid's ring of 16 has wrapped), two steps.

Tolerances: the loss within 1e-4 relative of one process and of the
reference; every gradient leaf, and every param and moment after one
AdamW step, within ``1e-4 max|x| + 1e-7`` (``test_torch_train_grads``'s
bound); prefill and decode logits within 1e-4, decode token ids equal.
Outputs keep ``out_shardings``' placements with local blocks of
``sharding.shard_shape``. A decode step gathers no KV cache: no
all-gather it issues (``Collectives`` records their shapes) has a dim
of the cache's length S.

One JAX process computes the reference's losses while one world of 4
gloo processes (``RANK``) runs every case; each writes a record and the
tests read them.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
WORLD = 4
B, S, PROMPT = 4, 36, 28
CASES = [("smollm_135m", None), ("qwen3_0p6b", None), ("phi4_mini_3p8b", None),
         ("deepseek_7b", None), ("granite_moe_1b", None),
         ("granite_moe_1b", "dense"), ("grok1_314b", None),
         ("falcon_mamba_7b", None), ("hymba_1p5b", None),
         ("internvl2_2b", None), ("whisper_medium", None)]
NAMES = [a + ("-" + i if i else "") for a, i in CASES]

REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, numpy as np
from repro import compat
from repro.configs import base as JCfg
from repro.launch import steps as JS
from repro.launch.mesh import make_test_mesh
from repro.models import model as JM, sharding as JSh

out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))


def flat(tree, pre=""):
    if isinstance(tree, dict):
        return {{k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, pre + k + "/").items()}}
    return {{pre[:-1]: np.asarray(tree)}}


def config(c):
    cfg = JCfg.load_smoke_config(c["arch"]).replace(**c["cfg"])
    return JS.tune_config(cfg, JCfg.ShapeConfig("smoke_train", {S}, {B},
                                                "train"))


params = {{}}
for c in cases:      # the params first: the port's ranks start from them
    params[c["name"]] = JM.init_params(config(c), jax.random.PRNGKey(0))
    np.savez(f"{{out}}/params_{{c['name']}}.npz", **flat(params[c["name"]]))
open(out + "/params.done", "w").close()

mesh = make_test_mesh((2, 2), ("data", "model"))
res = {{}}
for c in cases:
    cfg, p = config(c), params[c["name"]]
    batch = dict(np.load(f"{{out}}/train_{{c['name']}}.npz"))
    with compat.use_mesh(mesh), JSh.rules_override(**c["rules"]):
        b_spec = {{k: JSh.ax("batch", *[None] * (v.ndim - 1))
                  for k, v in batch.items()}}
        f = jax.jit(lambda p, b: JM.loss_fn(cfg, p, b),
                    in_shardings=compat.resolve_shardings(
                        (JM.param_specs(cfg), b_spec)))
        res[c["name"]] = {{"sharded": float(f(p, batch)),
                          "single": float(JM.loss_fn(cfg, p, batch))}}
json.dump(res, open(out + "/reference.json", "w"))
"""

RANK = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
rank, out = int(sys.argv[1]), sys.argv[2]
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

dist.init_process_group("gloo", init_method=f"file://{{out}}/rdzv",
                        world_size={world}, rank=rank)
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig, load_smoke_config
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M, moe as Moe, sharding as Sh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train import optimizer as Opt
from repro_torch.train.train_loop import loss_and_grads


class Collectives(TorchDispatchMode):
    # the collectives DTensor issues, with their outputs' shapes
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor lower to collectives
        out = func(*args, **(kwargs or {{}}))
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional" and name in (
                "all_gather_into_tensor", "all_reduce",
                "reduce_scatter_tensor", "all_to_all_single"):
            self.ops.append([name, list(out.shape)])
        return out


def unflat(npz):
    tree = {{}}
    for key, v in npz.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {{}})
        node[leaf] = v
    return tree


def pairs(tree, specs):
    # (tensor, spec) for every tensor of an output tree
    if torch.is_tensor(tree):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [x for k in tree for x in pairs(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs) for x in pairs(t, s)]


def whole(x):
    return x.full_tensor() if Sh.is_dtensor(x) else x


def ratio(got, want):
    # max over leaves of max|x - x_1| / (1e-4 max|x_1| + 1e-7)
    return max(float((whole(g).float() - w.float()).abs().max()
                     / (1e-4 * w.float().abs().max() + 1e-7))
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def max_err(got, want):
    return max(float((whole(g).float() - w.float()).abs().max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def laid_out(tree, specs):
    # every output leaf a DTensor with its spec's placements and blocks
    return all(Sh.is_dtensor(x)
               and list(x.placements) == Sh.placements(s, mesh)
               and tuple(x.to_local().shape) == Sh.shard_shape(x.shape, s,
                                                               mesh)
               for x, s in pairs(tree, specs))


def torch_batch(npz):
    return {{k: torch.as_tensor(v) for k, v in npz.items()}}


def clone(tree):
    return tree_map(lambda a: a.clone(), tree)


mesh = make_test_mesh((2, 2), ("data", "model"))
res = {{}}
for c in json.load(open(out + "/cases.json")):
    name, arch = c["name"], c["arch"]
    base = load_smoke_config(arch).replace(**c["cfg"])
    shapes = {{k: ShapeConfig("smoke_" + k, {S}, {B}, k)
              for k in ("train", "prefill", "decode")}}
    cfgs = {{k: S.tune_config(base, s) for k, s in shapes.items()}}
    one = {{k: S.step_bundle(arch, s, cfgs[k]) for k, s in shapes.items()}}
    sb = {{k: S.step_bundle(arch, s, cfgs[k], mesh=mesh)
          for k, s in shapes.items()}}
    params = convert.model_params_from_arrays(
        unflat(np.load(f"{{out}}/params_{{name}}.npz")), "cpu")
    r = res[name] = {{}}

    # train: the step, then its gradients alone
    cfg, batch = cfgs["train"], torch_batch(np.load(
        f"{{out}}/train_{{name}}.npz"))
    opt = Opt.init_adam(params, S.adam_config(cfg))
    want = one["train"].fn(params, opt, batch)
    rec = Collectives()
    with rec:
        got = S.run_sharded(sb["train"], (params, opt, batch), mesh)
    grad_bundle = dataclasses.replace(
        sb["train"], fn=lambda p, o, b: loss_and_grads(cfg, p, b),
        out_shardings=((), sb["train"].in_shardings[0]))
    g_loss, grads = S.run_sharded(grad_bundle, (params, opt, batch), mesh)
    w_loss, w_grads = loss_and_grads(cfg, params, batch)
    r["train"] = dict(
        loss_single=float(want[2]), loss_sharded=float(whole(got[2])),
        grad_loss=float(whole(g_loss)), grad_ratio=ratio(grads, w_grads),
        param_ratio=ratio(got[0], want[0]), moment_ratio=max(
            ratio(got[1].mu, want[1].mu), ratio(got[1].nu, want[1].nu)),
        step=int(whole(got[1].step)),
        laid_out=laid_out(got[:2], sb["train"].out_shardings[:2]),
        grads_laid_out=laid_out(grads, sb["train"].in_shardings[0]),
        collectives=len(rec.ops))

    # prefill
    pbatch = torch_batch(np.load(f"{{out}}/prefill_{{name}}.npz"))
    want = one["prefill"].fn(params, pbatch)
    got = S.run_sharded(sb["prefill"], (params, pbatch), mesh)
    r["prefill"] = dict(logits_err=max_err(got[0], want[0]),
                        cache_err=max_err(got[1], want[1]),
                        laid_out=laid_out(got[1],
                                          sb["prefill"].out_shardings[1]))

    # decode: two steps on from a one-process prefill of PROMPT positions
    dcfg = cfgs["decode"]
    prompt = torch_batch(np.load(f"{{out}}/prompt_{{name}}.npz"))
    _, cache = M.prefill(dcfg, params, prompt, {S})
    tok = torch.as_tensor(np.load(f"{{out}}/token_{{name}}.npy"))
    w_cache, d_cache, errs, same = clone(cache), cache, [], True
    rec = Collectives()
    for _ in range(2):
        w_logits, w_cache = one["decode"].fn(params, w_cache, tok)
        with rec:
            logits, d_cache = S.run_sharded(sb["decode"],
                                            (params, d_cache, tok), mesh)
        errs.append(max_err(logits, w_logits))
        ids = whole(logits).argmax(-1)
        same &= bool(torch.equal(ids, w_logits.argmax(-1)))
        tok = w_logits.argmax(-1).to(torch.int32)
    gathers = [shape for op, shape in rec.ops
               if op == "all_gather_into_tensor"]
    r["decode"] = dict(
        logits_err=max(errs), ids_equal=same,
        cache_err=max_err(d_cache, w_cache),
        len=int(whole(d_cache["len"])),
        laid_out=laid_out(d_cache, sb["decode"].out_shardings[1]),
        cache_gathers=[g for g in gathers if {S} in g],
        collectives=len(rec.ops))

    if dcfg.family == "moe":     # the auxiliary loss on DTensors
        layer = tree_map(lambda a: a[0], params["layers"]["mlp"])
        x = torch.randn({B}, {S}, dcfg.d_model,
                        generator=torch.Generator().manual_seed(5))
        with Sh.use_mesh(mesh):
            dx = Sh.NamedSharding(mesh, Sh.ax("batch", None, None)).place(x)
            dp = {{k: Sh.NamedSharding(mesh, (("model",),)).place(v)
                  for k, v in layer.items()}}
            aux = whole(Moe.aux_load_balance_loss(dp, dx, dcfg))
        r["aux"] = [float(Moe.aux_load_balance_loss(layer, x, dcfg)),
                    float(aux)]
json.dump(res, open(f"{{out}}/rank{{rank}}.json", "w"))
dist.destroy_process_group()
"""


def write_inputs(out):
    """The cases (config changes and the port's plan_rules on a (2, 2)
    mesh) and every batch, from numpy's seeded generator."""
    from repro_torch.configs.base import ShapeConfig, load_smoke_config
    from repro_torch.launch import steps as TS
    from repro_torch.models.sharding import MeshDesc, use_mesh
    cases = []
    for (arch, impl), name in zip(CASES, NAMES):
        cfg_kw = dict(dtype="float32", remat_policy="full",
                      **({"moe_impl": impl} if impl else {}))
        cfg = load_smoke_config(arch).replace(**cfg_kw)
        shape = ShapeConfig("smoke_train", S, B, "train")
        with use_mesh(MeshDesc("2x2", ("data", "model"), (2, 2))):
            rules = TS.plan_rules(arch, shape, TS.tune_config(cfg, shape))
        cases.append({"name": name, "arch": arch, "cfg": cfg_kw,
                      "rules": {k: list(v) for k, v in rules.items()}})
        rng = np.random.default_rng(len(cases))
        P = cfg.n_patches if cfg.family == "vlm" else 0
        tok = rng.integers(0, cfg.vocab, (B, S - P)).astype(np.int32)
        extra = {}
        if cfg.family == "vlm":
            extra["patches"] = rng.normal(size=(B, P, cfg.d_model)).astype(
                np.float32)
        if cfg.family == "encdec":
            extra["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
                np.float32)
        np.savez(out / f"train_{name}.npz", tokens=tok,
                 labels=np.roll(tok, -1, 1), **extra)
        np.savez(out / f"prefill_{name}.npz", tokens=tok, **extra)
        np.savez(out / f"prompt_{name}.npz", tokens=tok[:, :PROMPT - P],
                 **extra)
        np.save(out / f"token_{name}.npy",
                rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
    (out / "cases.json").write_text(json.dumps(cases))


def _wait(procs, timeout):
    errs = [p.communicate(timeout=timeout)[1] for p in procs]
    failed = [(p.returncode, e[-3000:]) for p, e in zip(procs, errs)
              if p.returncode != 0]
    assert not failed, failed


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_sharded")
    write_inputs(out)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")
    procs = [subprocess.Popen([sys.executable, "-c",
                               REFERENCE.format(src=SRC, B=B, S=S),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    try:
        t0 = time.monotonic()
        while not (out / "params.done").exists():
            assert procs[0].poll() is None, procs[0].communicate()[1][-3000:]
            assert time.monotonic() - t0 < 120, "no reference params"
            time.sleep(0.2)
        procs += [subprocess.Popen(
            [sys.executable, "-c",
             RANK.format(src=SRC, world=WORLD, B=B, S=S), str(r), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(WORLD)]
        _wait(procs, 400)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return json.loads((out / "reference.json").read_text()), ranks


def test_run_sharded_needs_a_bundle_resolved_on_a_mesh():
    from repro_torch.configs.base import ShapeConfig, load_smoke_config
    from repro_torch.launch import steps as TS
    shape = ShapeConfig("smoke_decode", S, B, "decode")
    bundle = TS.step_bundle("smollm_135m", shape,
                            load_smoke_config("smollm_135m"))
    with pytest.raises(ValueError, match="mesh"):
        TS.run_sharded(bundle, (), None)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_step_matches_one_process(records, name):
    for r in (rank[name]["train"] for rank in records[1]):
        for loss in (r["loss_sharded"], r["grad_loss"]):
            assert abs(loss - r["loss_single"]) <= 1e-4 * abs(r["loss_single"])
        assert r["grad_ratio"] <= 1, r["grad_ratio"]
        assert r["param_ratio"] <= 1, r["param_ratio"]
        assert r["moment_ratio"] <= 1, r["moment_ratio"]
        assert r["step"] == 1


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_keeps_adam_specs(records, name):
    for r in (rank[name]["train"] for rank in records[1]):
        assert r["laid_out"] and r["grads_laid_out"]
        assert r["collectives"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_the_reference_jit(records, name):
    ref = records[0][name]
    # the reference's own bound for its sharded loss (2e-2), then ours
    assert abs(ref["sharded"] - ref["single"]) <= 2e-2 * abs(ref["single"])
    for rank in records[1]:
        got = rank[name]["train"]["loss_sharded"]
        assert abs(got - ref["sharded"]) <= 1e-4 * abs(ref["sharded"]), \
            (got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_matches_one_process(records, name):
    for r in (rank[name]["prefill"] for rank in records[1]):
        assert r["logits_err"] <= 1e-4 and r["cache_err"] <= 1e-4, r
        assert r["laid_out"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_decode_matches_one_process_and_gathers_no_cache(records,
                                                                 name):
    for r in (rank[name]["decode"] for rank in records[1]):
        assert r["logits_err"] <= 1e-4 and r["cache_err"] <= 1e-4, r
        assert r["ids_equal"] and r["len"] == PROMPT + 2
        assert r["laid_out"]
        assert r["cache_gathers"] == [], r["cache_gathers"]


@pytest.mark.parametrize("name", ["granite_moe_1b", "grok1_314b"])
def test_sharded_moe_aux_loss_matches_one_process(records, name):
    for rank in records[1]:
        one, sharded = rank[name]["aux"]
        assert abs(one - sharded) <= 1e-5 * abs(one)


def test_remat_recompute_keeps_the_forward_rules_on_another_thread():
    """A CUDA backward recomputes a checkpointed layer on the autograd
    engine's device thread, where the mesh and rules of ``run_sharded``
    (thread-local) are not set. Run the backward on another thread: the
    recompute must lay its blocks out as the forward did. One process is
    rank 0 of 4 through torch's fake process group (no values)."""
    import threading

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import ShapeConfig, load_smoke_config
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.models import sharding as Sh
    from repro_torch.models.layers import tree_leaves, tree_map
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        shape = ShapeConfig("smoke_train", S, B, "train")
        cfg = TS.tune_config(load_smoke_config("smollm_135m").replace(
            dtype="float32", remat_policy="full"), shape)
        bundle = TS.step_bundle("smollm_135m", shape, cfg, mesh=mesh)
        params, _, batch = TS.materialize(
            bundle, torch.Generator().manual_seed(0), "cpu")
        with Sh.use_mesh(mesh), Sh.rules_override(**bundle.rules):
            dp = tree_map(lambda a, s: Sh.NamedSharding(mesh, s).place(a)
                          .requires_grad_(), params, bundle.in_shardings[0])
            db = {k: Sh.NamedSharding(mesh, bundle.in_shardings[2][k])
                  .place(v) for k, v in batch.items()}
            loss = TM.loss_fn(cfg, dp, db)
        errors = []

        def backward():           # outside the mesh and the rules
            try:
                torch.autograd.grad(loss, tree_leaves(dp))
            except Exception as e:
                errors.append(e)
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and errors == [], errors
    finally:
        dist.destroy_process_group()
