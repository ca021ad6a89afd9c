"""A plain replay of the topk_merge kernel's warp network, held equal to
the plain version and the reference.

The CUDA kernel runs only on the card. Its warp path (``topk_merge.cu``,
``topk_merge_warp``) is replayed here on numpy, step for step: the 64-bit
order key and the lane tiebreak; chunks of M = max(32, next_pow2(L))
lanes with padding past L + R; the filter that drops every lane whose
key is at or above the running list's L-th key (a whole chunk when the
warp's ballots are empty) and queues the rest in a ring, in (register,
lane) order; and for each batch of M queued lanes (and the rest at the
end) the descending bitonic sort, the elementwise minimum against the
list and the ascending bitonic merge. Item i of the replay is item i of
the warp (lane i // E, register i % E). Within a thread the kernel
exchanges a pair by one swap and across lanes each side keeps its half;
both are the exchange replayed here. M and E come from the wrapper's
``launch_geometry``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:   # no network route: replay fixed seeded examples
    from _hypothesis_shim import given, settings, st

from repro.kernels.topk_merge.ref import topk_merge_ref as topk_merge_jax
from repro_torch.kernels.topk_merge import kernel as TM
from repro_torch.kernels.topk_merge.ref import topk_merge_ref

PAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def make_key(d, i):
    """The kernel's make_key: ordered bits of d (one NaN after +inf, -0.0
    as +0.0) above id ^ 0x80000000."""
    u = np.ascontiguousarray(d, np.float32).view(np.uint32).copy()
    u[np.isnan(d)] = 0x7FC00000
    u[(u << np.uint32(1)) == 0] = 0
    dk = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    lo = np.ascontiguousarray(i, np.int32).view(np.uint32) ^ np.uint32(
        0x80000000)
    return (dk.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def before(ka, la, kb, lb):
    return (ka < kb) | ((ka == kb) & (la < lb))


def cx_step(k, l, size, s, desc):
    """One compare-exchange step over items [B, M]: i and i ^ s ordered
    ascending when ((i & size) == 0) != desc."""
    i = np.arange(k.shape[1])
    p = i ^ s
    pk, pl = k[:, p], l[:, p]
    asc = ((i & size) == 0) != desc
    lower = (i & s) == 0
    take = before(pk, pl, k, l) == (lower == asc)
    return np.where(take, pk, k), np.where(take, pl, l)


def merge_batch(lk, ll, batch):
    """The kernel's merge_batch: ``batch`` (at most M (key, lane) pairs)
    sorted descending with padding, the elementwise minimum with the
    ascending list [M], then merged ascending."""
    M = lk.size
    log_m = M.bit_length() - 1
    xk = np.full((1, M), PAD)
    xl = np.full((1, M), 0xFFFFFFFF, np.int64)
    xk[0, :len(batch)] = [k for k, _ in batch]
    xl[0, :len(batch)] = [j for _, j in batch]
    for ls in range(1, log_m + 1):
        for lj in range(ls - 1, -1, -1):
            xk, xl = cx_step(xk, xl, 1 << ls, 1 << lj, True)
    take = before(xk, xl, lk[None], ll[None])
    nk, nl = np.where(take, xk, lk[None]), np.where(take, xl, ll[None])
    for lj in range(log_m - 1, -1, -1):
        nk, nl = cx_step(nk, nl, M, 1 << lj, False)
    return nk[0], nl[0]


def warp_network(pd, pi, pv, nd, ni):
    """The warp path on numpy rows. Returns ((d, id, visited), real lanes
    dropped by the filter, merges) summed over the rows."""
    B, L = pd.shape
    R = nd.shape[1]
    geo = TM.launch_geometry(B, L, R)
    assert geo.path == TM.WARP
    M, E, T = geo.lanes, geo.per_lane, L + R
    chunks = -(-T // M)
    d = np.concatenate([pd, nd], 1).astype(np.float32)
    ids = np.concatenate([pi, ni], 1).astype(np.int32)
    vis = np.concatenate([pv, np.zeros((B, R), bool)], 1)
    key = make_key(d, ids)
    # the order in which a chunk's passing items join the ring: register
    # e of every lane (one ballot), then register e + 1
    order = (np.arange(32)[None, :] * E + np.arange(E)[:, None]).ravel()
    lane = np.empty((B, L), np.int64)
    dropped = merges = 0
    for b in range(B):
        lk = np.full(M, PAD)                  # the list starts as padding
        ll = np.full(M, 0xFFFFFFFF, np.int64)
        kth, ring = PAD, []
        for c in range(chunks):
            for i in order:
                j = c * M + i
                k = key[b, j] if j < T else PAD
                if k < kth:
                    ring.append((k, j))
                elif j < T:
                    dropped += 1
            if len(ring) >= M:
                lk, ll = merge_batch(lk, ll, ring[:M])
                ring, kth, merges = ring[M:], lk[L - 1], merges + 1
        if ring:
            lk, ll = merge_batch(lk, ll, ring)
            merges += 1
        lane[b] = ll[:L]
    assert (lane < T).all()                   # no padding in the output
    return ((np.take_along_axis(d, lane, 1), np.take_along_axis(ids, lane, 1),
             np.take_along_axis(vis, lane, 1)), dropped, merges)


def plain(*args):
    out = topk_merge_ref(*(torch.from_numpy(np.asarray(a)) for a in args))
    return tuple(x.numpy() for x in out)


def same(got, want):
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32),
                                  err_msg="d bits")
    np.testing.assert_array_equal(got[1], np.asarray(want[1]), err_msg="id")
    np.testing.assert_array_equal(got[2], np.asarray(want[2]),
                                  err_msg="visited")


VALS = np.array([0.0, -0.0, 0.25, 1.0, np.inf, np.nan], np.float32)


def lanes(rng, B, W, kind):
    if kind == "ties":        # few values and ids: many full (d, id) ties
        d = VALS[rng.integers(0, len(VALS), (B, W))]
        i = rng.integers(-1, 6, (B, W))
    else:                     # half tie values, half uniform
        d = np.where(rng.random((B, W)) < 0.5,
                     VALS[rng.integers(0, len(VALS), (B, W))],
                     rng.random((B, W)))
        i = rng.integers(-1, 64, (B, W))
    return d.astype(np.float32), i.astype(np.int32)


@pytest.mark.parametrize("kind", ["ties", "mixed"])
@pytest.mark.parametrize("L,R", [
    (64, 512), (64, 32), (10, 7), (100, 1000), (1, 0), (1, 1), (33, 0),
    (7, 3), (256, 40), (40, 300), (31, 33), (65, 63), (200, 1), (5, 40),
])
def test_warp_network_equals_plain_version(L, R, kind):
    """L and R on and off multiples of 32, R = 0 and 1, the warp path's
    longest list, ties, +-0, +inf and NaN: bit for bit the plain
    version's (d, id, visited)."""
    rng = np.random.default_rng(L * 1000 + R)
    B = 6
    pd, pi = lanes(rng, B, L, kind)
    nd, ni = lanes(rng, B, R, kind)
    pd[:B // 2] = np.sort(pd[:B // 2], 1)          # sorted pools too
    pv = rng.random((B, L)) < 0.5
    got, _, merges = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
    assert merges >= B                              # every row merges once


@pytest.mark.parametrize("L,R", [(64, 512), (10, 7), (100, 300)])
def test_warp_network_equals_the_reference_oracle(L, R):
    rng = np.random.default_rng(L + R)
    pd, pi = lanes(rng, 3, L, "mixed")
    nd, ni = lanes(rng, 3, R, "mixed")
    pv = rng.random((3, L)) < 0.5
    got, _, _ = warp_network(pd, pi, pv, nd, ni)
    same(got, topk_merge_jax(*map(jnp.asarray, (pd, pi, pv, nd, ni))))


def test_warp_network_drops_lanes_that_cannot_enter():
    """A sorted pool of small distances and new candidates all farther
    (the executor's late rounds): the filter drops every new lane, also
    those that tie the L-th pool lane on (d, id), since they come later,
    and each row merges once (its pool). One better candidate in the last
    chunk is queued and merged at the end."""
    rng = np.random.default_rng(5)
    B, L, R = 4, 64, 512
    pd = np.sort(rng.random((B, L)).astype(np.float32), 1)
    pi = rng.integers(0, 100, (B, L)).astype(np.int32)
    pv = rng.random((B, L)) < 0.5
    nd = (2 + rng.random((B, R))).astype(np.float32)
    ni = rng.integers(0, 100, (B, R)).astype(np.int32)
    nd[1] = pd[1, -1]                               # full ties with the
    ni[1] = pi[1, -1]                               # L-th pool lane
    got, dropped, merges = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
    assert (merges, dropped) == (B, B * R)
    nd[2, -1] = -1.0
    got, dropped, merges = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
    assert (merges, dropped) == (B + 1, B * R - 1)
    assert got[1][2, 0] == ni[2, -1] and not got[2][2, 0]


def test_warp_network_keeps_a_lane_just_inside_the_list():
    """The filter's bound is the L-th key itself: a new lane just ahead of
    it enters at the last place, one equal to it on (d, id) does not."""
    L, R = 64, 512
    pd = np.arange(L, dtype=np.float32)[None]
    pi = np.zeros((1, L), np.int32)
    pv = np.ones((1, L), bool)
    nd = np.full((1, R), 100.0, np.float32)
    ni = np.zeros((1, R), np.int32)
    nd[0, 300], nd[0, 400] = L - 1, L - 1.5     # a tie, then just ahead
    got, dropped, merges = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
    assert got[0][0, -1] == L - 1.5 and not got[2][0, -1]
    assert (merges, dropped) == (2, R - 1)


def test_warp_network_merges_full_batches_on_the_way():
    """Candidates that keep improving fill the ring: a batch of M merges
    as soon as it is full, and its L-th key tightens the filter."""
    B, L, R = 2, 64, 512
    pd = np.full((B, L), 10.0, np.float32)
    pi = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    pv = np.zeros((B, L), bool)
    nd = np.tile(np.linspace(9, 0, R, dtype=np.float32), (B, 1))
    ni = np.tile(np.arange(R, dtype=np.int32), (B, 1))
    got, dropped, merges = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
    assert dropped == 0 and merges == B * (L + R) // L


def test_warp_network_on_the_divergence_inputs():
    """The two inputs on which the Pallas kernel departs from its oracle
    (``test_torch_topk_merge.py``): the network gives the oracle's
    answer, a real (+inf, 5) lane ahead of padding and visited bits in
    lane order on a full tie."""
    inf = np.inf
    a = (np.array([[0.5, inf, inf, inf]], np.float32),
         np.array([[3, 5, 6, 7]], np.int32),
         np.array([[True, True, True, False]]),
         np.array([[0.7, inf]], np.float32), np.array([[9, 8]], np.int32))
    b = (np.array([[.5, .5, .5, .9]], np.float32),
         np.array([[3, 3, 4, 7]], np.int32),
         np.array([[True, False, True, True]]),
         np.array([[.5, .1]], np.float32), np.array([[3, 8]], np.int32))
    for case, ids, vis in ((a, [3, 9, 5, 6], [True, False, True, True]),
                           (b, [8, 3, 3, 3], [False, True, False, False])):
        got, _, _ = warp_network(*case)
        assert got[1][0].tolist() == ids and got[2][0].tolist() == vis
        same(got, topk_merge_jax(*map(jnp.asarray, case)))


def test_make_key_orders_as_the_plain_sort():
    """-0.0 ties +0.0, NaN sorts after +inf, and every real key sits below
    the padding key."""
    d = np.array([np.nan, np.inf, 1.0, 0.0, -0.0, -1.0, -np.inf], np.float32)
    i = np.array([2 ** 31 - 1, 0, 0, 5, 5, -2 ** 31, -1], np.int32)
    k = make_key(d, i)
    assert k[3] == k[4]
    assert k[0] > k[1] > k[2] > k[3] > k[5] > k[6]
    assert (k < PAD).all()


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 256), st.integers(0, 300), st.integers(0, 2 ** 31 - 1))
def test_warp_network_properties(L, R, seed):
    rng = np.random.default_rng(seed)
    kind = "ties" if seed % 2 else "mixed"
    pd, pi = lanes(rng, 2, L, kind)
    nd, ni = lanes(rng, 2, R, kind)
    pv = rng.random((2, L)) < 0.5
    got, _, _ = warp_network(pd, pi, pv, nd, ni)
    same(got, plain(pd, pi, pv, nd, ni))
