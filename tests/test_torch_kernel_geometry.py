"""Launch geometry of the port's CUDA kernels.

The CUDA kernels run only on the card, but how each wrapper cuts a call
into blocks, groups and lanes is plain Python (``launch_geometry``) and
is checked here: the choice at the main paths' shapes, the edges (a row
that is not a whole number of 16-byte vectors, K = 1, B = 1, the entry's
C = 64, R = 30, a misaligned view, the wrappers' limits), and, by
replaying the kernels' index arithmetic, that every candidate and every
row element is covered once. The topk_merge network itself is replayed
in ``test_torch_topk_network.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.l2_gather import kernel as L2
from repro_torch.kernels.pq_adc import kernel as PQ
from repro_torch.kernels.row_gather import kernel as RG
from repro_torch.kernels.row_gather.ref import row_gather_ref
from repro_torch.kernels.topk_merge import kernel as TM

FP32, BF16 = 4, 2


def _groups_cover(geo, B, K, nvec):
    """Replay l2_gather_groups' indexing: which lane stores each output
    (b, c), and which (lane, j) loads each 16-byte vector of a row."""
    G, per_warp = geo.group, geo.per_warp
    tiles_per_row = -(-K // 32)
    stores = {}
    for blk in range(geo.grid[0]):
        for warp in range(geo.block // 32):
            tile = blk * L2._WARPS + warp
            if tile >= B * tiles_per_row:
                continue
            b, t = divmod(tile, tiles_per_row)
            for lane in range(32):
                c = t * 32 + lane
                if c < K:
                    stores[(b, c)] = stores.get((b, c), 0) + 1
                # the owner of c reads, at step lane // per_warp, the sum
                # of the group whose lane 0 is src_lane; at step s group g
                # scores the id shuffled from lane s * per_warp + g
                step, src_lane = lane // per_warp, (lane % per_warp) * G
                assert step < G
                assert step * per_warp + src_lane // G == lane
    loads = {}
    for sub in range(G):
        for j in range(geo.per_lane):
            v = j * G + sub
            if v < nvec:
                loads[v] = loads.get(v, 0) + 1
    return stores, loads


@pytest.mark.parametrize("B,K,elem,group,per_lane,blocks", [
    (1024, 512, FP32, 8, 3, 2048),     # device batch round, capacity/cache
    (1024, 64, FP32, 8, 3, 256),       # device batch entry
    (1024, 512, BF16, 4, 3, 2048),     # bf16 cache tier
    (512, 512, FP32, 8, 3, 1024),      # device-mode insert's search
    (512, 64, FP32, 8, 3, 128),        # its entry
])
def test_l2_gather_main_path_geometry(B, K, elem, group, per_lane, blocks):
    geo = L2.launch_geometry(B, K, 96, elem)
    assert geo.path == L2.GROUPS
    assert (geo.group, geo.per_lane, geo.grid) == (group, per_lane,
                                                    (blocks, 1))
    assert geo.per_warp == 32 // group and geo.block == 256
    # D=96 fills every lane: no idle lane on any row
    assert geo.group * geo.per_lane == 96 * elem // 16


@pytest.mark.parametrize("D,elem,path", [
    (97, FP32, L2.ROWS),           # not a whole number of float4
    (100, BF16, L2.ROWS),          # 100 bf16 = 12.5 vectors
    (100, FP32, L2.GROUPS),        # 25 float4: ragged groups of 8
    (7, FP32, L2.ROWS),
    (4, FP32, L2.GROUPS),          # one vector: a lane per candidate
    (512, FP32, L2.GROUPS),        # 128 float4: the widest group row
    (516, FP32, L2.ROWS_VEC),      # 129 float4: past 32 * 4 vectors
    (1024, BF16, L2.GROUPS),
])
def test_l2_gather_paths_by_width(D, elem, path):
    geo = L2.launch_geometry(3, 40, D, elem)
    assert geo.path == path
    if path == L2.GROUPS:
        assert geo.per_lane <= L2._MAX_PER_LANE
        assert geo.group in (1, 2, 4, 8, 16, 32)
        # the narrowest group that fits: half of it would not
        nvec = D * elem // 16
        assert geo.group == 1 or -(-nvec // (geo.group // 2)) \
            > L2._MAX_PER_LANE
    else:
        assert geo.group == 32 and geo.per_warp == 1
        assert geo.grid == (3, 1)


def test_l2_gather_misaligned_operands_take_the_rows_path():
    geo = L2.launch_geometry(4, 512, 96, FP32, aligned=False)
    assert geo.path == L2.ROWS and geo.grid == (4, 8)


@pytest.mark.parametrize("B,K,D,elem", [
    (1, 1, 96, FP32), (3, 1, 96, BF16), (1, 33, 96, FP32),
    (5, 40, 100, FP32), (2, 64, 32, FP32), (9, 31, 4, FP32),
    (2, 70, 512, FP32),
])
def test_l2_gather_groups_cover_every_candidate_and_element(B, K, D, elem):
    geo = L2.launch_geometry(B, K, D, elem)
    assert geo.path == L2.GROUPS
    nvec = D * elem // 16
    stores, loads = _groups_cover(geo, B, K, nvec)
    assert stores == {(b, c): 1 for b in range(B) for c in range(K)}
    assert loads == {v: 1 for v in range(nvec)}
    assert geo.grid[0] == -(-B * -(-K // 32) // L2._WARPS)


def test_l2_gather_limits():
    # rows path at the widest D (the query fills the static 48 KiB of
    # shared memory) and the longest K (65,535 chunks in grid.y)
    assert L2._MAX_D * 4 == 48 * 1024
    geo = L2.launch_geometry(2, L2._MAX_K, L2._MAX_D, FP32)
    assert geo.path == L2.ROWS_VEC and geo.grid == (2, 65535)
    # groups path at the longest K
    geo = L2.launch_geometry(1, L2._MAX_K, 96, FP32)
    assert geo.grid == (-(-L2._MAX_K // 32 // L2._WARPS), 1)
    # a grid past 2^31 - 1 blocks is refused, not wrapped
    with pytest.raises(ValueError, match="exceed the grid"):
        L2.launch_geometry(2 ** 31 - 1, L2._MAX_K, 96, FP32)


def _pq_cover(geo, C):
    """Replay pq_adc_kernel's indexing: which (chunk, thread, p) scores
    each candidate."""
    chunk = geo.block * geo.per_thread
    seen = {}
    for y in range(geo.grid[1]):
        c_end = min((y + 1) * chunk, C)
        for t in range(geo.block):
            for p in range(geo.per_thread):
                c = y * chunk + t + p * geo.block
                if c < c_end:
                    seen[c] = seen.get(c, 0) + 1
    return seen


@pytest.mark.parametrize("C,block,per_thread,chunks", [
    (512, 256, 2, 1),       # a round: beam 16 x degree 32
    (64, 64, 1, 1),         # the entry pool: no idle thread
    (1, 32, 1, 1),
    (33, 64, 1, 1),
    (300, 256, 2, 1),
    (1000, 256, 2, 2),
    (8192, 256, 2, 16),     # the filtered scan's power-of-four buckets
    (32_768, 256, 2, 64),
    (131_072, 256, 2, 256),
])
def test_pq_adc_geometry(C, block, per_thread, chunks):
    geo = PQ.launch_geometry(1024, C)
    assert (geo.block, geo.per_thread, geo.grid) == (block, per_thread,
                                                      (1024, chunks))
    assert geo.block % 32 == 0 and geo.block <= PQ._MAX_THREADS
    assert _pq_cover(geo, C) == {c: 1 for c in range(C)}


@pytest.mark.parametrize("C", [512, 64])
def test_pq_adc_main_path_shapes_idle_no_thread(C):
    geo = PQ.launch_geometry(1024, C)
    assert geo.block * geo.per_thread == C


def test_pq_adc_limits():
    geo = PQ.launch_geometry(1, 1)
    assert geo.grid == (1, 1) and geo.block == 32
    # the longest C the wrapper takes fills grid.y
    geo = PQ.launch_geometry(2, PQ._MAX_C)
    assert geo.grid == (2, 65535)
    assert PQ.launch_geometry(2, PQ._MAX_C + 1).grid[1] == 65536


def _row_gather_replay(geo, table, h2s, ids):
    """Replay row_gather's launch on numpy: the tiles path (a warp per 32
    lanes, each thread resolving its own lane's slot, groups of
    ``geo.group`` threads copying 16-byte vectors of the row whose slot
    they take by shuffle) or the lanes path (a warp per lane). Returns
    the output and how often each (lane, int) was stored."""
    (S, R), N = table.shape, h2s.shape[0]
    flat = ids.reshape(-1)
    lanes = flat.size
    out = np.full((lanes, R), 0x7eadbeef, np.int64)
    stores = np.zeros((lanes, R), np.int64)

    def slot_of(lane):
        if lane >= lanes or flat[lane] < 0:
            return -1
        return int(h2s[min(int(flat[lane]), N - 1)])

    if geo.path == RG.TILES:
        nvec, G = R // 4, geo.group
        for blk in range(geo.grid):
            for warp in range(geo.block // 32):
                base = (blk * RG._TILE_WARPS + warp) * 32
                if base >= lanes:
                    continue
                slot = [slot_of(base + t) for t in range(32)]
                for t in range(32):
                    grp, sub = t // G, t % G
                    for step in range(G):       # G steps of 32 / G rows
                        r = step * geo.per_step + grp
                        assert r < 32
                        sl = slot[r]            # __shfl_sync from lane r
                        if sub >= nvec or base + r >= lanes:
                            continue
                        v = [-1] * 4 if sl < 0 else \
                            table[min(sl, S - 1), 4 * sub:4 * sub + 4]
                        out[base + r, 4 * sub:4 * sub + 4] = v
                        stores[base + r, 4 * sub:4 * sub + 4] += 1
    else:
        for blk in range(geo.grid):
            for warp in range(geo.block // 32):
                lane = blk * RG._LANE_WARPS + warp
                if lane >= lanes:
                    continue
                sl = slot_of(lane)
                for t in range(32):
                    for j in range(t, R, 32):
                        out[lane, j] = -1 if sl < 0 else \
                            table[min(sl, S - 1), j]
                        stores[lane, j] += 1
    return out.reshape(*ids.shape, R), stores


def test_row_gather_main_path_geometry():
    """The fused round's [1024, 16] frontier over R = 32 rows: groups of 8
    threads, one 16-byte vector each, 4 rows a step, 512 warps in 256
    blocks: one wave spread over the card's 132 SMs."""
    geo = RG.launch_geometry(1024 * 16, 32)
    assert geo.path == RG.TILES
    assert (geo.group, geo.per_step, geo.block, geo.grid) == (8, 4, 64, 256)
    assert geo.grid * geo.block // 32 == 512
    assert geo.group * 4 == 32          # a group covers a row, none idle


@pytest.mark.parametrize("lanes,R,aligned,path,group,grid", [
    (16384, 30, True, RG.LANES, 32, 2048),    # not a multiple of 4
    (16384, 32, False, RG.LANES, 32, 2048),   # misaligned table or output
    (16384, 1, True, RG.LANES, 32, 2048),
    (1, 32, True, RG.TILES, 8, 1),            # one lane
    (33, 32, True, RG.TILES, 8, 1),           # two tiles, one block
    (65, 32, True, RG.TILES, 8, 2),
    (100, 4, True, RG.TILES, 1, 2),           # a row is one vector
    (100, 12, True, RG.TILES, 4, 2),          # 3 vectors: one idle thread
    (100, 128, True, RG.TILES, 32, 2),        # the widest tiles row
    (100, 132, True, RG.LANES, 32, 13),       # past 32 vectors
])
def test_row_gather_paths(lanes, R, aligned, path, group, grid):
    geo = RG.launch_geometry(lanes, R, aligned)
    assert (geo.path, geo.group, geo.grid) == (path, group, grid)
    assert geo.per_step * geo.group == 32
    if path == RG.TILES:
        nvec = R // 4
        assert geo.group >= nvec and (geo.group == 1
                                      or geo.group // 2 < nvec)


def test_row_gather_limits():
    """The lanes path at the wrapper's most lanes fills grid.x; the tiles
    path needs 8 times fewer blocks."""
    geo = RG.launch_geometry(RG._MAX_LANES, 30)
    assert geo.grid == RG._MAX_BLOCKS
    geo = RG.launch_geometry(RG._MAX_LANES, 32)
    assert geo.path == RG.TILES
    assert geo.grid == -(-RG._MAX_BLOCKS // 8)


@pytest.mark.parametrize("B,W,R,aligned,res", [
    (4, 16, 32, True, 0.5), (3, 16, 32, True, 1.0), (2, 17, 32, True, 0.5),
    (1, 1, 32, True, 1.0), (3, 5, 30, True, 0.5), (2, 40, 4, True, 0.5),
    (2, 9, 12, True, 0.7), (2, 7, 128, True, 0.7), (3, 11, 32, False, 0.5),
])
def test_row_gather_replay_stores_each_element_once(B, W, R, aligned, res):
    """Every (lane, element) is stored exactly once, and the replayed
    kernel equals the plain version: -1 rows on idle lanes (id < 0) and
    non-resident ids, ids clipped to the directory and slots to the
    table."""
    rng = np.random.default_rng(B * 100 + W + R)
    S, N = 40, 60
    table = rng.integers(-1, N, (S, R)).astype(np.int32)
    h2s = rng.integers(0, S + 3, N).astype(np.int32)     # past S: clipped
    h2s[rng.random(N) >= res] = -1
    ids = rng.integers(-1, N + 4, (B, W)).astype(np.int32)   # past N too
    ids[0, 0] = -1
    geo = RG.launch_geometry(B * W, R, aligned)
    assert geo.path == (RG.TILES if aligned and R % 4 == 0 else RG.LANES)
    out, stores = _row_gather_replay(geo, table, h2s, ids)
    assert (stores == 1).all()
    want = row_gather_ref(torch.from_numpy(table), torch.from_numpy(h2s),
                          torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("B,L,R,lanes,per_lane,chunks,grid", [
    (1024, 64, 512, 64, 2, 9, 256),      # a round's merge
    (1024, 64, 32, 64, 2, 2, 256),
    (1024, 10, 7, 32, 1, 1, 256),        # ragged: one chunk, padded
    (1024, 100, 1000, 128, 4, 9, 256),
    (1024, 256, 40, 256, 8, 2, 256),     # the warp path's longest list
    (1, 1, 0, 32, 1, 1, 1),
    (5, 33, 1, 64, 2, 1, 2),
])
def test_topk_merge_warp_path_geometry(B, L, R, lanes, per_lane, chunks,
                                       grid):
    geo = TM.launch_geometry(B, L, R)
    assert geo.path == TM.WARP
    assert (geo.lanes, geo.per_lane, geo.grid) == (lanes, per_lane, grid)
    assert geo.block == TM._ROWS * 32
    assert geo.lanes >= L and geo.lanes == 32 * geo.per_lane
    assert -(-(L + R) // geo.lanes) == chunks


@pytest.mark.parametrize("L,R,P,per_lane,block", [
    (257, 0, 512, 1, 512), (300, 200, 512, 1, 512),
    (1000, 1000, 2048, 2, 1024), (TM.MAX_LANES - 1, 1, TM.MAX_LANES, 16,
                                  1024),
])
def test_topk_merge_block_path_geometry(L, R, P, per_lane, block):
    """A list past MAX_WARP_L takes the first design: a block per row
    sorting all next_pow2(L + R) lanes."""
    geo = TM.launch_geometry(7, L, R)
    assert geo.path == TM.BLOCK
    assert (geo.lanes, geo.per_lane, geo.block, geo.grid) == (
        P, per_lane, block, 7)
    assert geo.block * geo.per_lane == geo.lanes
