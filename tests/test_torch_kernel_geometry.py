"""Launch geometry of the port's l2_gather and pq_adc kernels.

The CUDA kernels run only on the card, but how each wrapper cuts a call
into blocks, groups and lanes is plain Python (``launch_geometry``) and
is checked here: the choice at the main paths' shapes, the edges (a row
that is not a whole number of 16-byte vectors, K = 1, B = 1, the entry's
C = 64, the wrappers' limits), and, by replaying the kernels' index
arithmetic, that every candidate and every row element is covered once.
"""
import pytest

from repro_torch.kernels.l2_gather import kernel as L2
from repro_torch.kernels.pq_adc import kernel as PQ

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
