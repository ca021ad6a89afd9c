"""The port's logical-axis sharding, step builders, dry run, roofline and
report (``repro_torch.models.sharding``, ``repro_torch.launch``,
``repro_torch.roofline``, ``repro_torch.report``, ``repro_torch.utils``)
against the reference.

The reference's rules and specs need a mesh, so it runs once in a
subprocess with 512 fake host devices (as ``tests/test_dryrun.py``
does): ``plan_rules`` for every dry-run cell on pod256 and pod512, the
param, cache and batch specs on pod256, pod512 and a (2, 4) mesh, and
its dry-run records of the two cells ``tests/test_dryrun.py`` lowers.
Specs cross as lists: one list of mesh axes a tensor dim.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as JU
from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import load_config as j_load_config
from repro.launch import steps as JS
from repro_torch import report as TReport
from repro_torch import roofline as TRoof
from repro_torch import utils as TU
from repro_torch.configs.base import ShapeConfig, load_smoke_config
from repro_torch.core.distributed import INDEX_FIELDS
from repro_torch.configs.base import load_config as t_load_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import MESHES, make_production_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import sharding as Sh
from repro_torch.train import optimizer as TOpt

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")

REF = """
import os, sys, json, tempfile, pathlib
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, {src!r})
import jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs.base import ARCH_IDS, SHAPES, load_config
from repro.launch import steps as S
from repro.launch import dryrun as dr
from repro.launch.mesh import make_production_mesh, make_test_mesh
from repro.models import model as M


def spec(p):
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in p]


def tree(t):
    return jax.tree.map(spec, t, is_leaf=lambda x: isinstance(x, P))


meshes = {{"pod256": make_production_mesh(),
           "pod512": make_production_mesh(multi_pod=True),
           "test2x4": make_test_mesh((2, 4), ("data", "model"))}}
out = {{"rules": {{}}, "params": {{}}, "cache": {{}}, "cache_long": {{}},
        "batch": {{}}}}
for name, mesh in meshes.items():
    with compat.use_mesh(mesh):
        out["rules"][name] = {{f"{{a}}/{{s}}": S.plan_rules(a, s)
                               for a, s in dr.all_cells()}}
        out["params"][name] = {{a: tree(M.param_specs(load_config(a)))
                                for a in ARCH_IDS}}
        out["cache"][name] = {{a: tree(M.cache_specs(load_config(a)))
                               for a in ARCH_IDS}}
        out["cache_long"][name] = {{
            a: tree(M.cache_specs(load_config(a), long_context=True))
            for a in ARCH_IDS}}
        out["batch"][name] = {{
            f"{{a}}/{{s}}": tree(S.batch_inputs(
                S.tune_config(load_config(a), SHAPES[s]), SHAPES[s])[1])
            for a in ARCH_IDS for s in SHAPES}}
dr.RESULTS = pathlib.Path(tempfile.mkdtemp())
out["dryrun"] = {{}}
for a, s in (("qwen3_0p6b", "decode_32k"), ("svfusion_msturing", "search_1k")):
    rec = dr.run_cell(a, s, multi_pod=False, force=True)
    assert rec["ok"], rec.get("error")
    rec.pop("units", None)
    rec.pop("traceback", None)
    out["dryrun"][f"{{a}}/{{s}}"] = rec
print("RESULT::" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    res = subprocess.run([sys.executable, "-c", REF.format(src=SRC)],
                         capture_output=True, text=True, timeout=560)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("RESULT::")]
    return json.loads(line[-1][len("RESULT::"):])


def as_lists(tree):
    """A spec tree of the port as the reference's JSON."""
    if isinstance(tree, dict):
        return {k: as_lists(v) for k, v in tree.items()}
    return [list(part) for part in tree]


def dtype_name(dt):
    return str(dt).split(".")[-1]


# ---------------------------------------------------------------------------
# utils, sharding
# ---------------------------------------------------------------------------

def test_utils_match_the_reference():
    rng = np.random.default_rng(0)
    arrs = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (5,)).astype(np.int32)}}
    jt = {"a": jnp.asarray(arrs["a"]), "b": {"c": jnp.asarray(arrs["b"]["c"])}}
    tt = {"a": torch.from_numpy(arrs["a"]),
          "b": {"c": torch.from_numpy(arrs["b"]["c"])}}
    assert TU.tree_size(tt) == JU.tree_size(jt) == 17
    assert TU.tree_bytes(tt) == JU.tree_bytes(jt) == 68
    assert TU.tree_bytes(TU.cast_tree(tt, torch.bfloat16)) \
        == JU.tree_bytes(JU.cast_tree(jt, jnp.bfloat16))
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 256)):
        assert TU.pad_to_multiple(n, m) == JU.pad_to_multiple(n, m)
    xs = rng.normal(size=37).tolist()
    for p in (0, 1, 50, 90, 99, 100):
        assert TU.percentile(xs, p) == JU.percentile(xs, p)
    assert np.isnan(TU.percentile([], 50)) and np.isnan(JU.percentile([], 50))
    s = TU.shape_struct((2, 3))
    j = JU.shape_struct((2, 3))
    assert s.is_meta and tuple(s.shape) == j.shape \
        and dtype_name(s.dtype) == str(j.dtype)
    assert TU.spec("data", None) == ("data", None)
    timer = TU.Timer()
    for _ in range(3):
        with timer.span("x"):
            pass
    assert timer.counts == {"x": 3} and set(timer.summary()) == {"x"}
    assert TU.block_tree(tt) is tt
    assert TU.current_mesh_axis_sizes() == {}
    with Sh.use_mesh(MESHES["pod512"]):
        assert TU.current_mesh_axis_sizes() == {"pod": 2, "data": 16,
                                                "model": 16}


def test_rules_resolve_and_override():
    assert Sh.ax("batch", None) == ((), ())          # no mesh: replicated
    assert Sh.axis_size("batch") == 1
    with Sh.use_mesh(make_production_mesh(multi_pod=True)):
        assert Sh.mesh_axis_names() == ("pod", "data", "model")
        assert Sh.ax("batch", "tensor", None) == (("pod", "data"),
                                                  ("model",), ())
        assert Sh.axis_size("batch") == 32 and Sh.axis_size("expert") == 1
        with Sh.rules_override(batch=(), tensor=("data", "model")):
            assert Sh.ax("batch", "tensor") == ((), ("data", "model"))
        assert Sh.resolve("kv_seq_long") == ("data", "model")
        assert Sh.shard_shape((33, 7, 5), Sh.ax("batch", "tensor")) \
            == (2, 1, 5)
    assert Sh.current_mesh() is None


def test_placements_shard_a_dim_on_every_axis_it_is_split_over():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, sizes):
            self.sizes = sizes

        def size(self, i):
            return self.sizes[i]
    pl = Sh.placements((("pod", "data"), (), ("model",)), Mesh((2, 4, 2)))
    assert pl == [Shard(0), Shard(0), Shard(2)]
    assert Sh.placements(((), ()), Mesh((2, 4, 2))) == [Replicate()] * 3
    # a split over one device is a copy
    pl = Sh.placements((("pod", "data"), (), ("model",)), Mesh((1, 4, 1)))
    assert pl == [Replicate(), Shard(0), Replicate()]


def test_constraints_return_a_plain_tensor_unchanged():
    x = torch.randn(2, 3, 4)
    cfg = load_smoke_config("smollm_135m").replace(gather_weights=True,
                                                   residual_shard="seq")
    with Sh.use_mesh(MESHES["pod256"]):
        assert Sh.constrain(x, "batch", None, "tensor") is x
        assert Sh.weight_gather(cfg, x, ("fsdp", "tensor")) is x
        assert TL.res_constrain(cfg, x) is x and TL.sp_gather(cfg, x) is x
        assert Sh.replicated_like(x, x) is x and Sh.local(x) is x
        assert Sh.whole_dim(x, 2, 3) is x


# ---------------------------------------------------------------------------
# steps: arithmetic, rules, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_arithmetic_matches_the_reference(arch, shape, ref):
    jc, tc = j_load_config(arch), t_load_config(arch)
    js, ts = SHAPES[shape], TS.SHAPES[shape]
    assert TS.count_params(tc) == JS.count_params(jc)
    assert TS.active_params(tc) == JS.active_params(jc)
    assert TS.moe_flops_factor(tc) == JS.moe_flops_factor(jc)
    assert TS.model_flops(tc, ts) == JS.model_flops(jc, js)
    jt, tt = JS.tune_config(jc, js), TS.tune_config(tc, ts)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert dataclasses.asdict(TS.cost_variant(tc, ts.seq_len)) \
        == dataclasses.asdict(JS.cost_variant(jc, js.seq_len))
    for labels in (True, False):
        jb, _ = JS.batch_inputs(jt, js, with_labels=labels)
        tb, _ = TS.batch_inputs(tt, ts, with_labels=labels)
        assert sorted(tb) == sorted(jb)
        for k in jb:
            assert tuple(tb[k].shape) == jb[k].shape and tb[k].is_meta
            assert dtype_name(tb[k].dtype) == str(jb[k].dtype)
    for mesh in ("pod256", "pod512", "test2x4"):
        desc = MESHES.get(mesh) or Sh.MeshDesc(mesh, ("data", "model"),
                                               (2, 4))
        with Sh.use_mesh(desc):
            got = as_lists(TS.batch_inputs(tt, ts)[1])
        assert got == ref["batch"][mesh][f"{arch}/{shape}"], mesh


@pytest.mark.parametrize("mesh", ["pod256", "pod512"])
def test_plan_rules_match_the_reference(mesh, ref):
    with Sh.use_mesh(MESHES[mesh]):
        for arch, shape in TD.all_cells():
            want = ref["rules"][mesh][f"{arch}/{shape}"]
            got = {k: list(v) for k, v in TS.plan_rules(arch, shape).items()}
            assert got == want, (arch, shape)


@pytest.mark.parametrize("mesh", ["pod256", "pod512", "test2x4"])
def test_param_and_cache_specs_match_the_reference_leaf_by_leaf(mesh, ref):
    desc = MESHES.get(mesh) or Sh.MeshDesc(mesh, ("data", "model"), (2, 4))
    with Sh.use_mesh(desc):
        for arch in ARCH_IDS:
            cfg = t_load_config(arch)
            assert as_lists(TM.param_specs(cfg)) \
                == ref["params"][mesh][arch], arch
            assert as_lists(TM.cache_specs(cfg)) \
                == ref["cache"][mesh][arch], arch
            assert as_lists(TM.cache_specs(cfg, long_context=True)) \
                == ref["cache_long"][mesh][arch], arch
            # the abstract params and cache carry the same leaves
            abs_p = TM.abstract_params(cfg)
            assert set(TL.tree_leaves(TL.tree_map(
                lambda a: a.is_meta, abs_p))) == {True}
            cache = TM.init_cache(cfg, 2, 64, device="meta")
            assert sorted(cache) == sorted(TM.cache_specs(cfg))
            for k, v in cache.items():
                assert len(TM.cache_specs(cfg)[k]) == v.ndim, (arch, k)


def test_adam_specs_mirror_the_params():
    with Sh.use_mesh(MESHES["pod256"]):
        ps = TM.param_specs(t_load_config("smollm_135m"))
        st = TOpt.adam_specs(ps)
    assert st.step == () and st.mu is ps and st.nu is ps


# ---------------------------------------------------------------------------
# dry run
# ---------------------------------------------------------------------------

def test_dryrun_lm_cell_matches_the_reference(ref):
    want = ref["dryrun"]["qwen3_0p6b/decode_32k"]
    got = TD.run_cell("qwen3_0p6b", "decode_32k", "pod256", write=False)
    assert got["ok"], got.get("error")
    for k in ("arch", "shape", "mesh", "n_chips", "rules", "model_flops",
              "kind", "notes"):
        assert got[k] == want[k], k
    assert got["n_chips"] == 256 and got["rules"] == {}
    assert got["model_flops"] == 1_074_815_565_824
    for k in ("argument_bytes", "alias_bytes"):
        assert got["memory"][k] == want["memory"][k], k
    assert got["memory"]["argument_bytes"] == 1_883_836_452
    assert got["memory"]["alias_bytes"] == 1_879_048_196
    # XLA's output adds a 32-byte tuple table to the logits and the cache
    assert got["memory"]["output_bytes"] + 32 == want["memory"]["output_bytes"]
    assert got["flops_counted"] > got["model_flops"] > 0
    assert got["flops_per_device"] == got["flops_counted"] / 256
    assert got["unavailable"] == ["flops", "bytes_accessed", "temp_bytes",
                                  "generated_code_bytes", "collectives"]


def test_dryrun_svfusion_cell_matches_the_reference(ref):
    want = ref["dryrun"]["svfusion_msturing/search_1k"]
    got = TD.run_cell("svfusion_msturing", "search_1k", "pod256",
                      write=False)
    assert got["ok"], got.get("error")
    for k in ("arch", "shape", "mesh", "n_chips", "rules", "model_flops",
              "kind", "notes"):
        assert got[k] == want[k], k
    assert got["model_flops"] == 180_388_626_432
    coll = got["collectives"]
    assert coll["counts"]["all-gather"] == want["collectives"]["counts"][
        "all-gather"] == 4
    assert coll["total_bytes"] == want["collectives"]["total_bytes"] \
        == 2_621_440
    # the reference's compiled step drops the index arrays it never reads
    # (e_in, slot_hid, f_recent: 6,774,288 bytes a device); the port
    # counts the arrays its step reads, which are the rest
    assert got["memory"]["argument_bytes"] \
        == want["memory"]["argument_bytes"] == 469_244_658
    unread = sorted(set(INDEX_FIELDS) - set(TS.SEARCH_READS))
    assert unread == ["e_in", "f_recent", "slot_hid"]
    n_local = 200_000_000 // 256
    assert 4 * n_local * 2 + 4 * 131072 == 6_774_288
    assert got["flops_per_device"] == got["model_flops"] / 256
    assert "flops_counted" in got["unavailable"]
    assert "collectives" not in got["unavailable"]


@pytest.mark.parametrize("mesh", ["h100x1", "h100x4"])
def test_dry_run_covers_every_cell(mesh, monkeypatch):
    """Every cell's record (rules, bundle, memory, collectives) builds on
    the card's meshes; the FLOP count is stubbed here (the full-width
    counts take minutes: ``results/dryrun_torch`` holds them)."""
    monkeypatch.setattr(TD, "counted_flops",
                        lambda arch, shape: {"flops_counted": 1,
                                             "flops_method": "stub"})
    cells = TD.all_cells()
    assert len(cells) == 34
    for arch, shape in cells:
        rec = TD.run_cell(arch, shape, mesh, write=False)
        assert rec["ok"], (arch, shape, rec.get("error"))
        assert rec["n_chips"] == MESHES[mesh].size
        assert set(TD.UNAVAILABLE_HLO) <= set(rec["unavailable"])
        assert ("collectives" in rec) != ("collectives" in rec["unavailable"])
        assert rec["memory"]["argument_bytes"] > 0


def test_cut_depth_keeps_one_layer_of_each_kind():
    for arch in ARCH_IDS:
        cfg = t_load_config(arch)
        cut = TS.cut_depth(cfg)
        if cfg.family == "encdec":
            assert (cut.n_enc_layers, cut.n_dec_layers) == (1, 1)
        elif cfg.family == "hybrid":
            g, _ = TM.hybrid_split(cut)
            assert len(g) == 3 and cut.n_layers == 4
        else:
            assert cut.n_layers == 1


SMALL = {"train": ShapeConfig("train_4k", 24, 2, "train"),
         "prefill": ShapeConfig("prefill_32k", 24, 2, "prefill"),
         "decode": ShapeConfig("decode_32k", 24, 2, "decode")}


@pytest.mark.parametrize("kind", sorted(SMALL))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_units_count_the_whole_step(arch, kind, monkeypatch):
    """On a smoke config, the step at ``cut_depth`` plus each cost unit
    times its multiplier counts exactly the FLOPs of the whole step."""
    monkeypatch.setattr(TS, "load_config", load_smoke_config)
    shape = SMALL[kind]
    if arch == "internvl2_2b":
        shape = dataclasses.replace(
            shape, seq_len=load_smoke_config(arch).n_patches + 24)
    count = TD.counted_flops.__wrapped__
    whole = count(arch, shape, "step")
    units = count(arch, shape, "units")
    assert units["flops_counted"] == whole["flops_counted"] > 0
    assert units["units"], "no cost unit"


def test_materialized_bundles_run_as_the_direct_calls():
    """``materialize`` gives inputs on which the bundle's ``fn`` equals
    the direct call (smoke configs, small shapes, the CPU)."""
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "load_config", load_smoke_config)
        for arch, shape in (("smollm_135m", SMALL["train"]),
                            ("granite_moe_1b", SMALL["prefill"]),
                            ("falcon_mamba_7b", SMALL["decode"]),
                            ("hymba_1p5b", SMALL["decode"])):
            b = TS.build_bundle(arch, shape)
            args = TS.materialize(b, gen, "cpu")
            for got_a, abs_a in zip(TU.tree_leaves(args),
                                    TU.tree_leaves(b.abstract_args)):
                assert got_a.shape == abs_a.shape and \
                    got_a.dtype == abs_a.dtype
            clone = TL.tree_map(lambda a: a.clone(), args[1]) \
                if b.kind == "decode" else None
            got = b.fn(*args)
            cfg = b.cfg
            if b.kind == "train":
                from repro_torch.train.train_loop import make_step
                want = make_step(cfg, TS.adam_config(cfg))(*args)
                assert torch.equal(got[2], want[2])
            elif b.kind == "prefill":
                want = TM.prefill(cfg, args[0], args[1], shape.seq_len)
                assert torch.equal(got[0], want[0])
            else:
                want = TM.decode_step(cfg, args[0], clone, args[2])
                assert torch.equal(got[0], want[0])


# ---------------------------------------------------------------------------
# roofline, report
# ---------------------------------------------------------------------------

def record(**kw):
    rec = {"arch": "a", "shape": "s", "n_chips": 4, "model_flops": 4 * 989e12,
           "flops_counted": 8 * 989e12, "flops_per_device": 2 * 989e12,
           "memory": {"argument_bytes": 3.35e12, "output_bytes": 3.35e12},
           "notes": "n"}
    rec.update(kw)
    return rec


def test_roofline_terms_on_a_hand_made_record():
    t = TRoof.terms(record())
    assert t["t_compute_s"] == pytest.approx(2.0)
    assert t["t_memory_lower_s"] == pytest.approx(2.0)
    assert t["t_collective_s"] == "n/a"          # the LM cells
    assert t["useful_ratio"] == pytest.approx(0.5)
    assert t["roofline_fraction"] == pytest.approx(0.5)
    t = TRoof.terms(record(flops_per_device=989e12,
                           collectives={"total_bytes": 3 * 450e9}))
    assert t["t_collective_s"] == pytest.approx(3.0)
    assert t["dominant"] == "collective" and t["bound_s"] == pytest.approx(3)
    assert "collective" in TRoof.what_would_help(t)
    # an output written in place over its input is counted once
    t = TRoof.terms(record(memory={"argument_bytes": 3.35e12,
                                   "output_bytes": 3.35e12,
                                   "alias_bytes": 3.35e12}))
    assert t["t_memory_lower_s"] == pytest.approx(1.0)
    t = TRoof.terms(record(n_chips=1, flops_per_device=3 * 989e12,
                           collectives={"total_bytes": 1e12}))
    assert t["t_collective_s"] == 0.0 and t["dominant"] == "compute"
    assert t["roofline_fraction"] == pytest.approx(4 / 3)


def test_report_renders_both_card_meshes(tmp_path):
    for mesh in ("h100x1", "h100x4"):
        (tmp_path / mesh).mkdir()
        rec = record(ok=True, n_chips=MESHES[mesh].size)
        (tmp_path / mesh / "a__s.json").write_text(json.dumps(rec))
    text = TReport.render(tmp_path)
    assert "## h100x1: 1 cells" in text and "## h100x4: 1 cells" in text
    assert "EXPERIMENTS" not in text and TReport.OUT.name == "REPORT.md"
    assert TReport.OUT.parent == TRoof.RESULTS


def test_abstract_and_materialized_search_index(monkeypatch):
    b = TS.build_svfusion_bundle(
        dataclasses.replace(TS.SVF_SHAPES["search_1k"], n=512, batch=8,
                            cache_per_chip=16), MESHES["h100x1"])
    idx, q, seed = TS.materialize(b, torch.Generator().manual_seed(0), "cpu")
    assert idx["vectors"].shape == (512, 100) and q.shape == (8, 100)
    assert seed.dtype == torch.int64 and seed.numel() == 1
    assert int(idx["nbrs"].max()) < 512 and bool(idx["alive"].all())
    with pytest.raises(RuntimeError, match="RankMesh"):
        b.fn(idx, q, seed)
