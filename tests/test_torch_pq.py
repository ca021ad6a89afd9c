"""The port's PQ lane against the reference: the pq_adc plain version,
the codebook math (LUT, encode, decode, Lloyd steps), the write-through
code mirror, and the PQ lane of ``search_tiered`` on a lossless codebook,
field by field. The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py``; here its wrapper must refuse CPU tensors."""
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as JC
from repro.core import quant as JQ
from repro.core.build import build_tiered_backend as jax_build_tiered
from repro.core.search import search_tiered as jax_search_tiered
from repro.core.types import SearchParams as JaxSearchParams
from repro.kernels.pq_adc.ref import pq_adc_ref as pq_adc_jax
from repro_torch import convert
from repro_torch.core import cache as TC
from repro_torch.core import quant as TQ
from repro_torch.core.search import search_tiered
from repro_torch.core.types import SearchParams
from repro_torch.kernels.ops import adc_gather
from repro_torch.kernels.pq_adc import kernel as K
from repro_torch.kernels.pq_adc.ref import pq_adc_ref

SRC = Path(__file__).resolve().parents[1] / "src"


def _adc_inputs(rng, N, m, Kc, B, C):
    codes = rng.integers(0, Kc, (N, m)).astype(np.uint8)
    lut = rng.random((B, m, Kc)).astype(np.float32)
    ids = rng.integers(0, N, (B, C)).astype(np.int32)
    return codes, lut, ids


def _check_adc(codes, lut, ids):
    got = adc_gather(*map(torch.from_numpy, (codes, lut, ids))).numpy()
    want = np.asarray(pq_adc_jax(*map(jnp.asarray, (codes, lut, ids))))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    return got


@pytest.mark.parametrize("N,m,Kc,B,C", [
    (256, 8, 64, 2, 8), (512, 16, 256, 3, 32), (128, 4, 16, 1, 4),
    (300, 6, 128, 2, 96), (400, 16, 256, 2, 200),
])
def test_pq_adc_plain_matches_reference(N, m, Kc, B, C):
    _check_adc(*_adc_inputs(np.random.default_rng(N + m), N, m, Kc, B, C))


def test_pq_adc_invalid_lanes_are_inf():
    codes, lut, _ = _adc_inputs(np.random.default_rng(1), 64, 8, 16, 2, 8)
    ids = np.array([[-1, 5, -1, 0, 63, -1, 7, 2],
                    [1, -1, 1, 1, -1, 62, 0, -1]], np.int32)
    got = _check_adc(codes, lut, ids)
    assert (got[ids < 0] == np.inf).all() and np.isfinite(got[ids >= 0]).all()


def test_pq_adc_round_batched_id_matrix():
    """Executor round shape: (Q, beam·degree) ids with cross-beam
    duplicates and -1 padding."""
    beam, deg = 4, 16
    rng = np.random.default_rng(0)
    codes, lut, ids = _adc_inputs(rng, 400, 16, 256, 3, beam * deg)
    ids[:, rng.integers(0, beam * deg, 11)] = -1
    ids[0, :deg] = ids[0, deg:2 * deg]
    _check_adc(codes, lut, ids)


def _trained(seed=0, n=600, D=16, m=8, bits=6):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    cb = JQ.train_codebook(vecs, m=m, bits=bits, iters=8, seed=seed)
    return vecs, cb, TQ.codebook_from_array(JQ.codebook_to_array(cb), "cpu")


@pytest.mark.parametrize("m,bits", [(8, 6), (4, 8), (16, 5)])
def test_lut_encode_decode_match_reference(m, bits):
    vecs, jcb, tcb = _trained(seed=m, m=m, bits=bits)
    q = np.random.default_rng(9).normal(size=(5, 16)).astype(np.float32)
    np.testing.assert_array_equal(TQ.encode(tcb, vecs, chunk=128),
                                  JQ.encode(jcb, vecs))
    np.testing.assert_allclose(
        TQ.adc_lut(tcb.centroids, torch.from_numpy(q)).numpy(),
        np.asarray(JQ.adc_lut(jcb.centroids, jnp.asarray(q))),
        rtol=1e-5, atol=1e-5)
    codes = JQ.encode(jcb, vecs)
    np.testing.assert_array_equal(TQ.decode(tcb, codes),
                                  JQ.decode(jcb, codes))
    assert TQ.codebook_to_array(tcb).tobytes() == \
        JQ.codebook_to_array(jcb).tobytes()


def test_choose_m_matches_reference():
    for dim in (1, 8, 17, 24, 32, 96, 100):
        for m in (1, 4, 12, 16, 64):
            assert TQ.choose_m(dim, m) == JQ.choose_m(dim, m)


def test_lloyd_matches_reference_from_its_init():
    """From the reference's own initial centroids (its permutation of the
    sample), the port's Lloyd sweeps give the reference's codebook."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    m, bits, iters, seed = 4, 4, 6, 3
    want = JQ.codebook_to_array(JQ.train_codebook(vecs, m, bits,
                                                  iters=iters, seed=seed))
    sub = vecs.reshape(300, m, 12 // m)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), 300))
    init = sub[perm[np.arange(1 << bits) % 300]].transpose(1, 0, 2)
    got = TQ.lloyd(torch.from_numpy(sub), torch.from_numpy(init.copy()),
                   iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_codebook_reconstruction_bound():
    """The port's own training (torch-drawn init) meets the reference's
    bar: reconstruction MSE under 15% of the variance at K=64."""
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    cb = TQ.train_codebook(vecs, m=8, bits=6, iters=15, seed=0,
                           device="cpu")
    codes = TQ.encode(cb, vecs)
    assert codes.shape == (600, 8) and codes.dtype == np.uint8
    mse = float(((TQ.decode(cb, codes) - vecs) ** 2).mean())
    assert mse < 0.15 * float(vecs.var()), mse
    with pytest.raises(ValueError):
        TQ.train_codebook(vecs, m=8, bits=9, device="cpu")


def test_pq_codes_encode_write_and_synced_mirror():
    vecs, jcb, tcb = _trained(seed=5)
    jpq = JQ.PQCodes(jcb, 800, codes=JQ.encode(jcb, vecs[:500]))
    tpq = convert.pq_codes_from_arrays(JQ.codebook_to_array(jcb),
                                       jpq.codes[:500], 800, device="cpu")
    before = tpq.synced_codes()
    for ids in (np.arange(500, 540), np.array([3, 7, 520, 599])):
        jpq.encode_write(ids, vecs[ids])
        tpq.encode_write(ids, vecs[ids])
    np.testing.assert_array_equal(tpq.codes, jpq.codes)
    assert not before[500:].any()             # pending until synced
    mirror = tpq.synced_codes()
    assert mirror is not before and not before[500:].any()
    np.testing.assert_array_equal(mirror.numpy(),
                                  np.asarray(jpq.synced_codes()))
    assert tpq.synced_codes() is mirror       # nothing pending: same mirror
    assert tpq.encoded == jpq.encoded == 44
    assert (tpq.m, tpq.bits, tpq.code_bytes(), tpq.code_bytes(10)) == \
        (jpq.m, jpq.bits, jpq.code_bytes(), jpq.code_bytes(10))


def _lossless(vecs):
    """The reference's lossless codebook (``tests/test_pq.py``): m = D
    one-dim subspaces, centroid k of subspace s is vecs[k, s], vector i's
    code is i. With integer vectors every LUT entry and ADC sum is exact."""
    n, D = vecs.shape
    cents = np.full((D, 256, 1), 1e6, np.float32)
    cents[:, :n, 0] = vecs.T
    return cents, np.tile(np.arange(n, dtype=np.uint8)[:, None], (1, D))


@pytest.mark.parametrize("rerank_depth", [48, 32], ids=["pool", "32"])
@pytest.mark.parametrize("speculate", [False, True])
def test_pq_lane_matches_reference(rerank_depth, speculate):
    """The per-round PQ lane on the lossless codebook: every
    TieredSearchResult field equals the reference's."""
    rng = np.random.default_rng(3)
    n, D, deg = 220, 12, 8
    vecs = rng.integers(-6, 7, (n, D)).astype(np.float32)
    queries = rng.integers(-6, 7, (4, D)).astype(np.float32)
    sp = SearchParams(k=5, pool=48, max_iters=24, beam=2)
    entries = rng.integers(0, n, (4, sp.pool))
    cents, codes = _lossless(vecs)
    with tempfile.TemporaryDirectory() as td:
        be = jax_build_tiered(vecs, deg, td, host_window=64)
        tbe = convert.tiered_backend_from_arrays(
            td, capacity=be.capacity, dim=D, degree=deg, n=be.n,
            alive=be.alive, e_in=be.e_in, version=be.version, host_window=64)
        try:
            hp = JC.HostPlacement(be.capacity, 16, D)
            thp = TC.HostPlacement(be.capacity, 16, D)
            for p in (hp, thp):
                p.warm(np.arange(0, 32, 2), vecs[0:32:2])
            jpq = JQ.PQCodes(JQ.codebook_from_array(cents), be.capacity,
                             codes=codes)
            tpq = convert.pq_codes_from_arrays(cents, codes, be.capacity,
                                               device="cpu")
            kw = dict(entry_ids=entries, rerank_depth=rerank_depth,
                      speculate=speculate)
            want = jax_search_tiered(be, hp, queries, 0,
                                     JaxSearchParams(*sp), pq=jpq, **kw)
            got = search_tiered(tbe, thp, queries, 0, sp, pq=tpq,
                                device="cpu", **kw)
            for f in got._fields:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)
            assert got.acc_hit.any() and got.iters > 0
            if rerank_depth == sp.pool:   # full re-rank == exact lane
                exact = search_tiered(tbe, thp, queries, 0, sp,
                                      device="cpu", **kw)
                np.testing.assert_array_equal(got.ids, exact.ids)
                np.testing.assert_array_equal(got.dists, exact.dists)
        finally:
            be.close()
            tbe.close()


def test_new_kernel_modules_import_without_nvcc():
    code = ("import sys; from repro_torch.kernels import _build, ops; "
            "from repro_torch.kernels.pq_adc import kernel as a; "
            "from repro_torch.kernels.row_gather import kernel as b; "
            "assert not _build._libs and a.launches == b.launches == 0; "
            "assert set(_build.SOURCES) == {'l2_gather', 'pq_adc', "
            "'row_gather'}; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


def test_pq_adc_wrapper_refuses_cpu_tensors():
    codes = torch.zeros(8, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        K.pq_adc(codes, torch.zeros(2, 4, 16),
                 torch.zeros(2, 3, dtype=torch.int32))
    assert K.launches == 0


def test_plain_version_clips_ids_and_indexes_by_code():
    """Ids clip to the table; uint8 codes index the LUT as integers (not
    as a boolean mask)."""
    codes = torch.tensor([[0, 3], [2, 1]], dtype=torch.uint8)
    lut = torch.arange(8, dtype=torch.float32).reshape(1, 2, 4)
    out = pq_adc_ref(codes, lut, torch.tensor([[-1, 0, 1, 9]],
                                              dtype=torch.int32))
    assert out.tolist() == [[np.inf, 0 + 7, 2 + 5, 2 + 5]]
