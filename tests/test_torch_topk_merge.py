"""The port's topk_merge against the reference.

On the CPU ``ops.pool_merge`` takes the plain PyTorch version; it is
held here against the reference's jnp oracle (``topk_merge_ref``) and its
Pallas kernel (interpret mode) on the sweep and the property test of
``test_kernels.py``, and against the oracle on +inf lanes, -1 ids and
full (d, id) ties. Two inputs pin where the Pallas kernel departs from
its own oracle (padding that outranks a real +inf lane; a full tie that
leaves ``visited`` order-dependent): the port follows the oracle. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here we check only that nothing of it is built on
import and that its wrapper refuses CPU tensors.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:   # no network route: replay fixed seeded examples
    from _hypothesis_shim import given, settings, st

from repro.kernels.topk_merge.kernel import topk_merge as topk_merge_pallas
from repro.kernels.topk_merge.ref import topk_merge_ref as topk_merge_jax
from repro_torch.kernels import _build
from repro_torch.kernels.ops import pool_merge
from repro_torch.kernels.topk_merge import kernel as K
from repro_torch.kernels.topk_merge.ref import topk_merge_ref

SRC = Path(__file__).resolve().parents[1] / "src"
KEY = jax.random.PRNGKey(7)


def port(pd, pi, pv, nd, ni):
    out = pool_merge(*(torch.from_numpy(np.array(x)) for x in
                       (pd, pi, pv, nd, ni)))
    return tuple(x.numpy() for x in out)


def same(got, want):
    for g, w, name in zip(got, want, ("d", "id", "visited")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("L,R", [(8, 4), (16, 8), (64, 32), (32, 32)])
def test_twin_matches_reference_sweep(L, R):
    """``test_kernels.py``'s sweep: the oracle and the Pallas kernel agree
    there, and so does the port."""
    B = 3
    pd = jax.random.uniform(KEY, (B, L))
    pi = jax.random.randint(KEY, (B, L), 0, 10_000)
    pv = jax.random.bernoulli(KEY, 0.5, (B, L))
    nd = jax.random.uniform(jax.random.PRNGKey(3), (B, R))
    ni = jax.random.randint(jax.random.PRNGKey(3), (B, R), 10_000, 20_000)
    args = [np.asarray(x) for x in (pd, pi, pv, nd, ni)]
    got = port(*args)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32 \
        and got[2].dtype == bool
    same(got, topk_merge_jax(pd, pi, pv, nd, ni))
    same(got, topk_merge_pallas(pd, pi, pv, nd, ni, interpret=True))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.integers(1, 24), st.integers(0, 2 ** 31 - 1))
def test_twin_properties(L, R, seed):
    """``test_kernels.py``'s invariants: output sorted ascending; the
    best-L multiset of the concatenated distances is preserved; and the
    twin equals numpy's stable lexsort of the same lanes."""
    rng = np.random.default_rng(seed)
    pd = np.sort(rng.random((2, L), np.float32), axis=1)
    pi = rng.integers(0, 1000, (2, L)).astype(np.int32)
    pv = rng.random((2, L)) < 0.3
    nd = rng.random((2, R), np.float32)
    ni = rng.integers(1000, 2000, (2, R)).astype(np.int32)
    got = port(pd, pi, pv, nd, ni)
    assert (np.diff(got[0], axis=1) >= 0).all()
    d = np.concatenate([pd, nd], 1)
    np.testing.assert_array_equal(got[0], np.sort(d, 1)[:, :L])
    i = np.concatenate([pi, ni], 1)
    v = np.concatenate([pv, np.zeros((2, R), bool)], 1)
    order = np.stack([np.lexsort((i[b], d[b])) for b in range(2)])[:, :L]
    same(got, [np.take_along_axis(x, order, 1) for x in (d, i, v)])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L,R", [(4, 2), (16, 16), (64, 512), (7, 3)])
def test_twin_matches_reference_on_inf_lanes_and_full_ties(seed, L, R):
    """Distances from {0, 0.5, 1, +inf} (and -0.0) and ids from a small
    range including -1: +inf lanes with valid ids, -1 pads, and many full
    (d, id) ties with different visited bits, on sorted and unsorted
    pools."""
    rng = np.random.default_rng(seed)
    B = 5
    vals = np.array([0, 0.5, 1, np.inf], np.float32)
    pd = vals[rng.integers(0, 4, (B, L))]
    pd[0] = np.sort(pd[0])
    pd[1, 0] = -0.0
    pi = rng.integers(-1, 6, (B, L)).astype(np.int32)
    pv = rng.random((B, L)) < 0.5
    nd = vals[rng.integers(0, 4, (B, R))]
    ni = rng.integers(-1, 6, (B, R)).astype(np.int32)
    got = port(pd, pi, pv, nd, ni)
    want = topk_merge_jax(*map(jnp.asarray, (pd, pi, pv, nd, ni)))
    same(got, want)
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  np.asarray(want[0]).view(np.uint32))


def test_divergences_of_the_pallas_kernel_from_its_oracle():
    """(a) The Pallas kernel pads with (+inf, -1) and orders by (d, id), so
    its pads outrank a real (+inf, id >= 0) lane. (b) Its bitonic network
    is not stable, so a full (d, id) tie leaves ``visited`` order-
    dependent. The oracle's stable lexsort does neither; the port follows
    the oracle."""
    a = (np.array([[0.5, np.inf, np.inf, np.inf]], np.float32),
         np.array([[3, 5, 6, 7]], np.int32),
         np.array([[True, True, True, False]]),
         np.array([[0.7, np.inf]], np.float32), np.array([[9, 8]], np.int32))
    b = (np.array([[.5, .5, .5, .9]], np.float32),
         np.array([[3, 3, 4, 7]], np.int32),
         np.array([[True, False, True, True]]),
         np.array([[.5, .1]], np.float32), np.array([[3, 8]], np.int32))
    for case, ref_ids, ref_v, kern_ids, kern_v in (
            (a, [3, 9, 5, 6], [True, False, True, True],
             [3, 9, -1, -1], [True, False, False, False]),
            (b, [8, 3, 3, 3], [False, True, False, False],
             [8, 3, 3, 3], [False, True, True, True])):
        want = topk_merge_jax(*map(jnp.asarray, case))
        kern = topk_merge_pallas(*map(jnp.asarray, case), interpret=True)
        np.testing.assert_array_equal(np.asarray(want[1])[0], ref_ids)
        np.testing.assert_array_equal(np.asarray(want[2])[0], ref_v)
        np.testing.assert_array_equal(np.asarray(kern[1])[0], kern_ids)
        np.testing.assert_array_equal(np.asarray(kern[2])[0], kern_v)
        same(port(*case), want)


class _FakeCuda:
    """Stands in for a CUDA tensor where the sandbox has none."""
    is_cuda = True
    device = torch.device("cuda", 0)
    dtype = torch.float32

    def is_contiguous(self):
        return True

    def dim(self):
        return 2


def test_pool_merge_refuses_mixed_devices():
    z = [torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
         torch.zeros(2, 4, dtype=torch.bool), torch.zeros(2, 3),
         torch.zeros(2, 3, dtype=torch.int32)]
    with pytest.raises(ValueError, match="CUDA"):
        pool_merge(*z[:4], _FakeCuda())
    with pytest.raises(ValueError, match="CUDA"):
        pool_merge(_FakeCuda(), *z[1:])
    assert K.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise
    before anything is built or counted."""
    with pytest.raises(ValueError, match="CUDA"):
        K.topk_merge(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
                     torch.zeros(2, 4, dtype=torch.bool), torch.zeros(2, 3),
                     torch.zeros(2, 3, dtype=torch.int32))
    assert K.launches == 0 and K._fns is None
    assert "topk_merge" in _build.SOURCES


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel's module builds nothing and needs no nvcc."""
    code = ("import repro_torch.kernels.ops, sys; "
            "from repro_torch.kernels import _build; "
            "from repro_torch.kernels.topk_merge import kernel; "
            "assert not _build._libs and kernel.launches == 0; "
            "assert kernel._fns is None and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


def test_plain_version_is_the_stable_lexsort():
    """A direct case: equal (d, id) keeps pool lanes before new lanes and
    earlier lanes first, so the visited bits follow the input order."""
    pd = torch.tensor([[1.0, 1.0, 2.0]])
    pi = torch.tensor([[4, 4, 1]], dtype=torch.int32)
    pv = torch.tensor([[False, True, True]])
    nd = torch.tensor([[1.0, 0.0]])
    ni = torch.tensor([[4, 9]], dtype=torch.int32)
    d, i, v = topk_merge_ref(pd, pi, pv, nd, ni)
    assert d.tolist() == [[0.0, 1.0, 1.0]]
    assert i.tolist() == [[9, 4, 4]]
    assert v.tolist() == [[False, False, True]]
