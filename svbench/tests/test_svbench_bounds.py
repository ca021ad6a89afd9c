"""The frozen byte counts against chip_smoke.py's arithmetic."""
import pytest
import torch

import chip_smoke
from svbench import bounds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_bytes_equal_chip_smoke(dtype):
    g = torch.Generator().manual_seed(3)
    table = torch.randn(5000, 96, generator=g).to(dtype)
    ids = torch.randint(-1, 5000, (64, 512), generator=g, dtype=torch.int32)
    ids[3, :40] = 17                      # duplicates
    q = torch.randn(64, 96, generator=g)
    nbytes, ops = bounds.l2_call(table, ids, q)
    ms, by = chip_smoke.l2_gather_bound_ms(table, ids)
    assert by == "bytes"
    assert float(nbytes) == pytest.approx(
        ms * 1e-3 * chip_smoke.HBM_BYTES_PER_S, rel=1e-12)
    assert ops == 3 * 64 * 512 * 96
    assert float(bounds.least_seconds(nbytes, ops)) == pytest.approx(
        ms * 1e-3, rel=1e-12)


def test_adc_bytes_follow_the_pq_bound():
    g = torch.Generator().manual_seed(4)
    codes = torch.randint(0, 256, (4000, 16), generator=g,
                          dtype=torch.uint8)
    lut = torch.rand(32, 16, 256, generator=g)
    ids = torch.randint(-1, 4000, (32, 64), generator=g, dtype=torch.int32)
    nbytes, ops = bounds.adc_call(codes, lut, ids)
    uniq = torch.unique(ids[ids >= 0]).numel()
    # phase_kernel_pq: uniq * m + B*C*4 + B*m*K*4 + B*C*4
    assert int(nbytes) == uniq * 16 + 32 * 64 * 4 + 32 * 16 * 256 * 4 \
        + 32 * 64 * 4
    assert ops == 32 * 64 * 16


def test_unique_valid_counts_rows_inside_the_table():
    ids = torch.tensor([[3, 3, -1, 7], [7, 9, 12, 0]])
    assert int(bounds.unique_valid(ids, 10)) == 4     # 0, 3, 7, 9
