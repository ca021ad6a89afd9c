"""The port's in-degree count (``ops.in_degree``, kernel ``e_in_count``)
against the reference's ``compute_e_in``.

On the CPU the entry point takes the plain PyTorch version; it is held
here against the reference on tables with empty (-1) slots, all-empty
tail rows, the last id and no slots at all. The CUDA kernel is held
bit-equal to the plain version on the card by ``chip_smoke.py``; here we
check that its wrapper refuses CPU tensors instead of falling back, its
grid, and, by replaying its index arithmetic, that every id of the table
is read once (``tests/test_torch_pq.py`` checks that no kernel is built
or needs nvcc on import).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.build import compute_e_in as compute_e_in_jax
from repro_torch.core.build import compute_e_in
from repro_torch.kernels.e_in_count import kernel as K
from repro_torch.kernels.e_in_count.ref import e_in_count_ref
from repro_torch.kernels.ops import in_degree


def _table(seed, rows, R, n_max, live, empty=0.2):
    """[rows, R] int32: ``live`` rows of ids below ``n_max`` with a share
    ``empty`` of -1 slots, then all -1 rows."""
    rng = np.random.default_rng(seed)
    t = np.full((rows, R), -1, np.int32)
    t[:live] = rng.integers(0, n_max, (live, R))
    t[:live][rng.random((live, R)) < empty] = -1
    return t


@pytest.mark.parametrize("case,rows,R,n_max,live", [
    ("random_with_holes", 100, 7, 128, 100),
    ("random_with_holes", 300, 32, 300, 300),
    ("empty_tail_rows", 256, 32, 256, 40),
    ("empty_tail_rows", 90, 7, 90, 13),
    ("last_id", 64, 7, 64, 64),
    ("last_id", 64, 32, 80, 50),
    ("empty_table", 0, 7, 16, 0),
    ("empty_table", 0, 32, 16, 0),
])
def test_in_degree_matches_reference(case, rows, R, n_max, live):
    t = _table(rows + R, rows, R, n_max, live)
    if case == "last_id":
        t[0, :] = n_max - 1
        t[live - 1, -1] = n_max - 1
    got = in_degree(torch.from_numpy(t), n_max)
    want = np.asarray(compute_e_in_jax(jnp.asarray(t), n_max))
    assert got.dtype == torch.int32 and got.shape == (n_max,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(compute_e_in(torch.from_numpy(t), n_max), got)
    assert int(got.sum()) == int((t >= 0).sum())
    if case == "last_id":
        assert int(got[-1]) >= R


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise
    before anything is built or counted."""
    with pytest.raises(ValueError, match="CUDA"):
        K.e_in_count(torch.zeros(8, 4, dtype=torch.int32), 8)
    assert K.launches == 0 and K._fns is None


@pytest.mark.parametrize("total,sms,blocks", [
    ((1 << 21) * 32, 132, 1056),      # the cells' table: 8 blocks an SM
    (262_144 * 32, 132, 1056),
    (20_000 * 32, 132, 625),          # one vector a thread, fewer blocks
    (7, 132, 1), (1, 132, 1), (0, 132, 1),
])
def test_e_in_count_geometry(total, sms, blocks):
    assert K.launch_geometry(total, sms) == blocks


def _replay(total, head, blocks, threads=256, unroll=4):
    """Replay e_in_count_kernel's indexing: how many times each id of a
    ``total``-id table (``head`` ids before the first 16-byte boundary)
    is read."""
    reads = np.zeros(total, np.int64)
    nvec = (total - head) >> 2
    tail = head + nvec * 4
    stride = blocks * threads
    for gid in range(stride):
        i = gid
        if i < head + (total - tail):
            reads[i if i < head else tail + (i - head)] += 1
        while i + (unroll - 1) * stride < nvec:
            for u in range(unroll):
                v = i + u * stride
                reads[head + 4 * v:head + 4 * v + 4] += 1
            i += unroll * stride
        while i < nvec:
            reads[head + 4 * i:head + 4 * i + 4] += 1
            i += stride
    return reads


@pytest.mark.parametrize("total", [1, 3, 6, 9, 4097, 20_011, 70_000])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_e_in_count_replay_reads_each_id_once(total, offset):
    """Every id is read once, whatever the table's 16-byte offset (the
    source's head: (16 - address % 16) % 16 / 4 ids, at most the table)
    and whether the grid strides over the table or not."""
    head = min((4 - offset) % 4, total)
    for blocks in (1, 3, K.launch_geometry(total, 4)):
        assert (_replay(total, head, blocks) == 1).all()


def test_plain_version_is_the_ports_first_formula():
    """The plain version keeps the port's index_add_ formula: an id past
    n_max is clamped to the last bin (no caller makes one; the kernel and
    the reference drop it)."""
    t = torch.tensor([[0, 5, -1], [-1, -1, 2]], dtype=torch.int32)
    assert e_in_count_ref(t, 4).tolist() == [1, 0, 1, 1]
    assert e_in_count_ref(t, 8).tolist() == [1, 0, 1, 0, 0, 1, 0, 0]
