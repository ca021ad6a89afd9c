"""The four-card phase's pieces on the CPU: the search bundle drawn a
shard at a time (``launch.steps.materialize(..., shard=)``) in four gloo
processes against one process's merge, the rank harness of
``chip_smoke.py`` (``run_ranks``), the phase's refusal to run on fewer
than four cards, and the rank-device helper (``launch.mesh``).
"""
import argparse
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as SD
from repro_torch.launch import mesh as Mesh
from repro_torch.launch import steps as S
from repro_torch.models.sharding import MeshDesc

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SRC = str(ROOT / "src")
WORLD = 4
TINY = S.SvfShape("tiny", n=4096, dim=100, degree=16, batch=64,
                  cache_per_chip=16)

RANK = """
import sys
sys.path.insert(0, {src!r})
rank, out_dir = int(sys.argv[1]), sys.argv[2]
import numpy as np, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method=f"file://{{out_dir}}/rdzv",
                        world_size={world}, rank=rank)
from repro_torch.core.distributed import RankMesh
from repro_torch.launch import steps as S
rmesh = RankMesh((1, {world}), ("data", "model"))
bundle = S.build_svfusion_bundle(S.SvfShape("tiny", n={n}, dim={dim},
                                            degree={degree}, batch={batch},
                                            cache_per_chip={cache}), rmesh)
shard = rmesh.linear_index(("data", "model"))
idx, q, seed = S.materialize(bundle, torch.Generator().manual_seed(5), "cpu",
                             shard=shard)
ids, d = bundle.fn(idx, q, seed)
np.savez(f"{{out_dir}}/rank{{rank}}.npz", ids=ids.numpy(), dists=d.numpy(),
         queries=q.numpy(), shard=shard, seed=int(seed),
         **{{k: v.numpy() for k, v in idx.items()}})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_cards")
    prog = RANK.format(src=SRC, world=WORLD, n=TINY.n, dim=TINY.dim,
                       degree=TINY.degree, batch=TINY.batch,
                       cache=TINY.cache_per_chip)
    chip_smoke.run_ranks(
        [[sys.executable, "-c", prog, str(r), str(out)] for r in range(WORLD)],
        120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_each_rank_draws_its_own_shard_with_local_ids(ranks):
    n = TINY.n // WORLD
    for r, z in enumerate(ranks):
        assert int(z["shard"]) == r
        assert z["vectors"].shape == (n, TINY.dim)
        assert z["nbrs"].shape == (n, TINY.degree)
        assert z["nbrs"].min() >= 0 and z["nbrs"].max() < n
        assert z["alive"].all() and z["alive"].shape == (n,)
        assert z["h2d"].shape == (n,) and (z["h2d"] == -1).all()
        assert z["cache_vectors"].shape == (TINY.cache_per_chip, TINY.dim)
        np.testing.assert_array_equal(z["queries"], ranks[0]["queries"])
    for r in range(1, WORLD):
        assert not np.array_equal(ranks[r]["vectors"], ranks[0]["vectors"])


def test_every_rank_answers_as_one_process_merges_the_shards(ranks):
    n = TINY.n // WORLD
    q = torch.from_numpy(ranks[0]["queries"])
    res = []
    for s, z in enumerate(ranks):
        idx = {f: torch.from_numpy(z[f]) for f in SD.INDEX_FIELDS}
        ent = SD.shard_entries(int(z["seed"]), s, TINY.batch,
                               S.SVF_PARAMS.pool, n, "cpu")
        res.append(SD.search_shard(idx, q, ent, S.SVF_PARAMS, offset=s * n))
    want_ids, want_d = SD.merge_shard_results(
        torch.stack([r[0] for r in res]), torch.stack([r[1] for r in res]),
        S.SVF_PARAMS.k)
    assert (want_ids >= 0).all() and (want_ids < TINY.n).all()
    for z in ranks:
        np.testing.assert_array_equal(z["ids"], want_ids.numpy())
        np.testing.assert_array_equal(z["dists"], want_d.numpy())


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_shard_draws_on_a_mesh_description(grid):
    """``materialize(shard=)`` reads only the bundle's abstract arguments,
    so a dry-run bundle (a ``MeshDesc``) draws each shard alike."""
    bundle = S.build_svfusion_bundle(TINY, MeshDesc("t", ("data", "model"),
                                                    grid))
    shards = [S.materialize(bundle, torch.Generator().manual_seed(1), "cpu",
                            shard=s) for s in range(WORLD)]
    again = S.materialize(bundle, torch.Generator().manual_seed(1), "cpu",
                          shard=2)
    for idx, q, seed in shards:
        assert idx["vectors"].shape == (TINY.n // WORLD, TINY.dim)
        assert torch.equal(q, shards[0][1]) and int(seed) == 0
    assert all(torch.equal(a, b) for a, b in zip(again[0].values(),
                                                 shards[2][0].values()))
    with pytest.raises(ValueError):
        S.materialize(bundle, torch.Generator(), "cpu", shard=WORLD)


def test_shard_draw_is_for_search_cells_only():
    from repro_torch.configs.base import ShapeConfig, load_smoke_config
    shape = ShapeConfig("smoke_train", 16, 2, "train")
    cfg = load_smoke_config("smollm_135m")
    bundle = S.step_bundle("smollm_135m", shape, cfg)
    with pytest.raises(ValueError):
        S.materialize(bundle, torch.Generator(), "cpu", shard=0)


@pytest.mark.parametrize("grid", [(4,), (2, 2)])
def test_merge_in_step_order(grid):
    """The one-process merge of the phase's check merges over the first
    data axis, then the next, as the sharded step does; on ties the
    step's order decides."""
    g = torch.Generator().manual_seed(2)
    ids = torch.arange(4 * 3 * 5, dtype=torch.int32).reshape(4, 3, 5)
    d = torch.randint(0, 6, (4, 3, 5), generator=g).float().sort(-1).values
    got_i, got_d = chip_smoke.merge_in_step_order(ids, d, list(grid), 5)
    if len(grid) == 1:
        want_i, want_d = SD.merge_shard_results(ids, d, 5)
    else:
        first = [SD.merge_shard_results(ids[[j, 2 + j]], d[[j, 2 + j]], 5)
                 for j in range(2)]
        want_i, want_d = SD.merge_shard_results(
            torch.stack([f[0] for f in first]),
            torch.stack([f[1] for f in first]), 5)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


# ---------------------------------------------------------------------------
# the rank harness
# ---------------------------------------------------------------------------

CHILD = """
import os, sys, time
r, out, bad, show = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
open(f"{out}/pid{r}", "w").write(str(os.getpid()))
print(f"{show} from rank {r}", flush=True)
if r == bad:
    time.sleep(1)
    raise ValueError(f"rank {r} broke")
time.sleep(0 if bad < 0 else 60)
"""


def _children(tmp_path, bad, show="hello"):
    return [[sys.executable, "-c", CHILD, str(r), str(tmp_path), str(bad),
             show] for r in range(WORLD)]


def _gone(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_run_ranks_fails_at_the_first_rank_and_kills_the_rest(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as e:
        chip_smoke.run_ranks(_children(tmp_path, bad=2), 60)
    assert time.monotonic() - t0 < 15
    assert "rank 2 of 4 exited 1" in str(e.value)
    assert "ValueError: rank 2 broke" in str(e.value)
    for r in range(WORLD):
        assert _gone(int((tmp_path / f"pid{r}").read_text()))


def test_run_ranks_times_out_and_kills_every_rank(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match=r"still running after 2 s"):
        chip_smoke.run_ranks(_children(tmp_path, bad=WORLD), 2)
    assert time.monotonic() - t0 < 15
    for r in range(WORLD):
        assert _gone(int((tmp_path / f"pid{r}").read_text()))


def test_run_ranks_shows_one_rank_and_returns_when_all_succeed(tmp_path,
                                                              capfd):
    seconds = chip_smoke.run_ranks(_children(tmp_path, bad=-1, show="hi"),
                                   60, show=1)
    assert 0 < seconds < 15
    out = capfd.readouterr().out
    assert "hi from rank 1" in out and "hi from rank 0" not in out


# ---------------------------------------------------------------------------
# the phase stays out of the default run and refuses fewer cards
# ---------------------------------------------------------------------------

def test_four_cards_is_named_only():
    assert "four_cards" not in chip_smoke.PHASES
    assert "four_cards" in chip_smoke.EXTRA_PHASES


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_four_cards_refuses_fewer_cards(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--only",
                                      "four_cards"])
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code not in (0, None)
    assert "four_cards needs 4 cards" in str(e.value.code)
    with pytest.raises(AssertionError, match="four_cards needs 4 cards"):
        chip_smoke.phase_four_cards(0)


def test_a_rank_exits_by_its_outcome_without_teardown(monkeypatch):
    codes = []
    monkeypatch.setattr(chip_smoke.os, "_exit", codes.append)
    args = argparse.Namespace(four_rank=1, four_init="tcp://localhost:1",
                              seed=0, four_child="unused")
    monkeypatch.setattr(chip_smoke, "four_rank", lambda *a: None)
    chip_smoke.four_cards_child(args)

    def broken(*a):
        raise RuntimeError("a part failed")
    monkeypatch.setattr(chip_smoke, "four_rank", broken)
    chip_smoke.four_cards_child(args)
    assert codes == [0, 1]


def test_four_cards_on_the_command_line_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                          "four_cards"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


# ---------------------------------------------------------------------------
# the rank's device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,rank,want", [
    ("gloo", 0, torch.device("cpu")), ("gloo", 3, torch.device("cpu")),
    ("nccl", 0, torch.device("cuda", 0)), ("nccl", 3, torch.device("cuda", 3))])
def test_rank_device(monkeypatch, backend, rank, want):
    assert Mesh.rank_device(backend, rank) == want
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: backend)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: rank)
    assert Mesh.rank_device() == want
