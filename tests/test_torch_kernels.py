"""The port's l2_gather against the reference.

On the CPU the port's entry point takes the plain PyTorch version; it is
held here against the reference's jnp oracle and its Pallas kernel (in
interpret mode) on the sweep of ``test_kernels.py``. The CUDA kernel is
held against the plain version on the card by ``chip_smoke.py``; here we
check only that nothing of it is built or needed on import, and that its
wrapper refuses CPU tensors instead of falling back.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2_gather.kernel import l2_gather as l2_gather_pallas
from repro.kernels.l2_gather.ref import l2_gather_ref as l2_gather_jax
from repro_torch.kernels import _build
from repro_torch.kernels.l2_gather import kernel as K
from repro_torch.kernels.l2_gather.ref import l2_gather_ref
from repro_torch.kernels.ops import gather_l2

SRC = Path(__file__).resolve().parents[1] / "src"


def _both(table, ids, qs, dtype):
    """The same numpy inputs as (jax, torch) arrays of ``dtype``."""
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    j = (jnp.asarray(table, jd), jnp.asarray(ids, jnp.int32),
         jnp.asarray(qs, jd))
    t = (torch.from_numpy(table).to(td),
         torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(qs).to(td))
    return j, t


def _check(table, ids, qs, dtype="float32", rtol=None, atol=None):
    D = table.shape[1]
    tol = 1e-4 if dtype == "float32" else 2e-2
    rtol = tol if rtol is None else rtol
    atol = tol * D if atol is None else atol
    j, t = _both(table, ids, qs, dtype)
    got = gather_l2(*t).numpy()
    assert got.dtype == np.float32
    for want in (np.asarray(l2_gather_jax(*j)),
                 np.asarray(l2_gather_pallas(*j, interpret=True))):
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return got


@pytest.mark.parametrize("N,D,B,K", [
    (256, 32, 2, 8), (512, 64, 4, 16), (1024, 128, 3, 32), (128, 256, 1, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_gather_matches_reference(N, D, B, K, dtype):
    rng = np.random.default_rng(N + D)
    table = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(0, N, (B, K))
    qs = rng.normal(size=(B, D)).astype(np.float32)
    _check(table, ids, qs, dtype)


def test_l2_gather_duplicate_and_boundary_ids():
    rng = np.random.default_rng(1)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    ids = np.array([[0, 0, 63, 63, 1, 2, 3, 1]])
    qs = rng.normal(size=(1, 16)).astype(np.float32)
    _check(table, ids, qs, rtol=1e-4, atol=1e-3)


def test_l2_gather_invalid_lanes_are_inf():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    ids = np.array([[-1, 5, -1, 0, 63, -1, 7, 2]])
    qs = rng.normal(size=(1, 16)).astype(np.float32)
    got = _check(table, ids, qs, rtol=1e-4, atol=1e-3)
    assert (got[ids < 0] == np.inf).all()
    assert np.isfinite(got[ids >= 0]).all()


def test_l2_gather_round_batched_id_matrix():
    """Executor round shape: the (Q, beam·degree) id matrix of a whole
    expansion round, with duplicates across beam slots and -1 padding."""
    beam, deg = 4, 32
    rng = np.random.default_rng(0)
    table = rng.normal(size=(512, 64)).astype(np.float32)
    ids = rng.integers(0, 512, (3, beam * deg))
    ids[:, rng.integers(0, beam * deg, 17)] = -1
    ids[0, :deg] = ids[0, deg:2 * deg]
    qs = rng.normal(size=(3, 64)).astype(np.float32)
    _check(table, ids, qs, rtol=1e-4, atol=1e-2)


def test_l2_gather_integer_data_is_exact():
    """Integer-valued inputs: every partial sum is an integer below 2^24,
    so the port and the reference agree bit for bit (what the executor
    parity tests rely on)."""
    rng = np.random.default_rng(3)
    table = rng.integers(-8, 9, (300, 96)).astype(np.float32)
    ids = rng.integers(-1, 300, (5, 40))
    qs = rng.integers(-8, 9, (5, 96)).astype(np.float32)
    j, t = _both(table, ids, qs, "float32")
    np.testing.assert_array_equal(gather_l2(*t).numpy(),
                                  np.asarray(l2_gather_jax(*j)))


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel's module builds nothing and needs no nvcc."""
    code = ("import repro_torch.kernels.ops, sys; "
            "from repro_torch.kernels import _build; "
            "from repro_torch.kernels.l2_gather import kernel; "
            "assert not _build._libs and kernel.launches == 0; "
            "assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise
    before anything is built or counted."""
    t = torch.zeros(8, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    q = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        K.l2_gather(t, ids, q)
    assert K.launches == 0


def test_kernel_build_needs_nvcc():
    """Where there is no CUDA toolkit, building raises instead of quietly
    serving the plain version."""
    if _build._target("l2_gather")[1].exists():
        pytest.skip("a built library is present")
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("l2_gather")
    else:
        pytest.skip("nvcc is installed here")


def test_plain_version_clips_out_of_range_ids():
    """Ids are clipped to the table before the gather (no wrap to the last
    row for -1, no index error past the end)."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    q = torch.zeros(1, 3)
    out = l2_gather_ref(table, torch.tensor([[-1, 0, 3, 9]],
                                            dtype=torch.int32), q)
    assert out[0, 0] == np.inf
    assert out[0, 2] == out[0, 3] == float((table[3] ** 2).sum())
