"""The port's sharded search (``repro_torch.core.distributed``) against
the reference's ``make_distributed_search``, exactly.

The reference runs in a subprocess with as many fake host devices as its
mesh has (as ``tests/test_distributed.py`` does), on per-shard graphs of
integer-valued vectors, with part of each shard cached; it writes the
global index arrays, the queries, each shard's ``fold_in`` entry draw
and its result. The port runs one gloo process per device of that mesh,
rank r in device r's place, each searching its own rows with the same
entries; every rank's block of the result must equal the reference's.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as JD
from repro.core.types import SearchParams as JSP
from repro_torch.core import distributed as TD
from repro_torch.core.types import SearchParams

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
N_LOCAL, D, R, B, CACHE = 240, 8, 8, 12, 16
SP = dict(k=6, pool=24, max_iters=32, beam=4)

JAX_SIDE = """
import os, sys, json
spec = json.loads(sys.argv[1])
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + str(int(__import__("math").prod(spec["shape"]))))
sys.path.insert(0, spec["src"])
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.launch.mesh import make_test_mesh
from repro.core.build import build_graph
from repro.core.distributed import make_distributed_search
from repro.core.types import SearchParams

mesh = make_test_mesh(tuple(spec["shape"]), tuple(spec["axes"]))
sp = SearchParams(**spec["sp"])
step = make_distributed_search(mesh, sp, data_axes=tuple(spec["data_axes"]),
                               query_axis=spec["query_axis"])
present = [a for a in spec["data_axes"] if a in spec["axes"]]
S = int(np.prod([mesh.shape[a] for a in present]))
nl, D, R, B, cs = (spec[k] for k in ("n_local", "d", "r", "b", "cache"))
rng = np.random.default_rng(0)
vecs = rng.integers(-4, 5, (S * nl, D)).astype(np.float32)
parts = [build_graph(vecs[s * nl:(s + 1) * nl], R, seed=s) for s in range(S)]
idx = {"vectors": vecs,
       "nbrs": np.concatenate([np.asarray(g.nbrs) for g in parts]),
       "alive": np.concatenate([np.asarray(g.alive) for g in parts]),
       "e_in": np.concatenate([np.asarray(g.e_in) for g in parts]),
       "cache_vectors": np.zeros((S * cs, D), np.float32),
       "slot_hid": np.full((S * cs,), -1, np.int32),
       "h2d": np.full((S * nl,), -1, np.int32),
       "f_recent": rng.random(S * nl).astype(np.float32)}
for s in range(S):                 # cache the first cs // 2 ids of a shard
    hot = np.arange(cs // 2)
    idx["cache_vectors"][s * cs + hot] = vecs[s * nl + hot]
    idx["slot_hid"][s * cs + hot] = hot
    idx["h2d"][s * nl + hot] = hot
Q = rng.integers(-4, 5, (B, D)).astype(np.float32)
key = jax.random.PRNGKey(spec["key"])
bl = B // (mesh.shape[spec["query_axis"]] if spec["query_axis"] else 1)
entries = np.stack([np.asarray(jax.random.randint(
    jax.random.fold_in(key, s), (bl, sp.pool), 0, nl, dtype=jnp.int32))
    for s in range(S)])
with compat.use_mesh(mesh):
    ids, dists = jax.jit(step)({k: jnp.asarray(v) for k, v in idx.items()},
                               jnp.asarray(Q), key)
np.savez(spec["out"], queries=Q, entries=entries, ids=np.asarray(ids),
         dists=np.asarray(dists),
         devices=np.vectorize(lambda d: d.id)(mesh.devices), **idx)
"""

TORCH_SIDE = """
import os, sys, json
spec = json.loads(sys.argv[1])
rank = int(sys.argv[2])
sys.path.insert(0, spec["src"])
import numpy as np, torch, torch.distributed as dist
from repro_torch.convert import shard_rows
from repro_torch.core.distributed import (INDEX_FIELDS, RankMesh,
                                          make_distributed_search)
from repro_torch.core.types import SearchParams

world = int(np.prod(spec["shape"]))
dist.init_process_group("gloo", init_method="file://" + spec["rdzv"],
                        world_size=world, rank=rank)
try:
    z = np.load(spec["out"])
    mesh = RankMesh(spec["shape"], spec["axes"])
    present = [a for a in spec["data_axes"] if a in spec["axes"]]
    S = int(np.prod([mesh.size(a) for a in present]))
    shard = mesh.linear_index(present)
    idx = shard_rows({f: z[f] for f in INDEX_FIELDS}, shard, S, device="cpu")
    q = torch.from_numpy(z["queries"])
    if spec["query_axis"]:
        q = mesh.block(q, spec["query_axis"])
    step = make_distributed_search(mesh, SearchParams(**spec["sp"]),
                                   data_axes=tuple(spec["data_axes"]),
                                   query_axis=spec["query_axis"])
    ids, d = step(idx, q, torch.from_numpy(z["entries"][shard]))
    qi = mesh.index(spec["query_axis"]) if spec["query_axis"] else 0
    np.savez(spec["out"] + f".rank{rank}.npz", ids=ids.numpy(),
             dists=d.numpy(), block=qi)
finally:
    dist.destroy_process_group()
"""


def _run(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(procs, timeout):
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]


LAYOUTS = {
    "data2_x_query2": dict(shape=[2, 2], axes=["data", "model"],
                           data_axes=["data"], query_axis="model"),
    "pod2_x_data2_replicated": dict(shape=[2, 2], axes=["pod", "data"],
                                    data_axes=["pod", "data"],
                                    query_axis=None),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_search_matches_the_reference(layout, tmp_path):
    spec = dict(LAYOUTS[layout], src=SRC, sp=SP, n_local=N_LOCAL, d=D, r=R,
                b=B, cache=CACHE, key=3, out=str(tmp_path / "ref.npz"),
                rdzv=str(tmp_path / "rdzv"))
    arg = json.dumps(spec)
    _wait([_run([JAX_SIDE, arg])], 300)
    z = np.load(spec["out"])
    world = int(np.prod(spec["shape"]))
    # the reference's mesh holds its devices row-major: device r at rank r
    np.testing.assert_array_equal(z["devices"].ravel(), np.arange(world))
    _wait([_run([TORCH_SIDE, arg, str(r)]) for r in range(world)], 120)
    bl = B // (2 if spec["query_axis"] else 1)
    for r in range(world):
        got = np.load(spec["out"] + f".rank{r}.npz")
        rows = slice(int(got["block"]) * bl, (int(got["block"]) + 1) * bl)
        np.testing.assert_array_equal(got["ids"], z["ids"][rows])
        np.testing.assert_allclose(got["dists"], z["dists"][rows],
                                   rtol=0, atol=1e-5)
    assert (z["ids"] >= 0).all()


def test_merge_shard_results_orders_ties_by_lane():
    """Shard-major lanes, the k smallest, equal distances to the lower
    lane (``lax.top_k`` on the negated distances)."""
    ids = torch.tensor([[[0, 1, 2]], [[10, 11, 12]]], dtype=torch.int32)
    d = torch.tensor([[[1.0, 2.0, np.inf]], [[1.0, 1.5, 2.0]]])
    got_ids, got_d = TD.merge_shard_results(ids, d, 4)
    assert got_ids.tolist() == [[0, 10, 11, 1]]
    assert got_d.tolist() == [[1.0, 1.0, 1.5, 2.0]]


def test_shard_index_arrays_and_flops_match_the_reference():
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = JD.shard_index_arrays(4096, 96, 32, 4, 128, vec_dtype=jdt)
        got = TD.shard_index_arrays(4096, 96, 32, 4, 128, vec_dtype=tdt)
        assert set(got) == set(want) == set(TD.INDEX_FIELDS)
        for f, w in want.items():
            assert tuple(got[f].shape) == tuple(w.shape)
            assert got[f].is_meta
            assert str(got[f].dtype).split(".")[1] == str(w.dtype)
    assert TD.analytical_search_flops(SearchParams(**SP), 64, 96, 32) == \
        JD.analytical_search_flops(JSP(**SP), 64, 96, 32)
