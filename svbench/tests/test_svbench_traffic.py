"""The generators repeat from a seed, and the Zipf mix takes its share."""
import numpy as np
import pytest
import torch

from svbench import data, harness, load
from svbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, -5, 2 ** 40])
def test_stream_seeds_repeat_and_differ(seed):
    a, b = data.stream_seeds(seed), data.stream_seeds(seed)
    assert a == b and len(set(a.values())) == len(a)
    assert all(0 <= v < 2 ** 64 for v in a.values())
    torch.Generator().manual_seed(max(a.values()))   # accepted


@pytest.mark.parametrize("name", ["deep1b_device.search_uniform",
                                  "deep1b_tiered_pq.search_zipf"])
def test_inputs_repeat_from_a_seed(name):
    cell = tiny_cell(name)
    one = harness.make_inputs(cell, 2 ** 31 + 3, "cpu")
    two = harness.make_inputs(cell, 2 ** 31 + 3, "cpu")
    other = harness.make_inputs(cell, 2 ** 31 + 4, "cpu")
    for i in (1, 2):
        np.testing.assert_array_equal(one[i], two[i])
        assert not np.array_equal(one[i], other[i])
    for m in (64, 7):
        np.testing.assert_array_equal(one[3](m), two[3](m))


def test_zipf_top_tenth_takes_two_thirds():
    p = data.zipf_probs(1024, 1.0, seed=9)
    h = lambda n: (1.0 / np.arange(1, n + 1)).sum()    # noqa: E731
    assert data.top_share(p, 0.1) == pytest.approx(h(102) / h(1024))
    assert 0.66 < data.top_share(p, 0.1) < 0.70
    seeds = data.stream_seeds(5)
    c = data.query_clusters(200_000, 1024, {"zipf": 1.0}, seeds,
                            "cpu").numpy()
    counts = np.bincount(c, minlength=1024)
    hot = np.argsort(-data.zipf_probs(1024, 1.0, seeds["zipf"]))[:102]
    assert counts[hot].sum() / len(c) == pytest.approx(
        data.top_share(p, 0.1), abs=0.01)
    assert data.query_clusters(10, 1024, "uniform", seeds, "cpu") is None


def test_frozen_generator_draws_as_chip_smoke():
    import chip_smoke
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    a = chip_smoke.synthetic_descriptors(g1, 5000, 96, "cpu")(3000)
    b = data.synthetic_descriptors(g2, 5000, 96, "cpu")(3000)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_query_blocks_are_fixed_by_client_and_request():
    t = {"request_queries": 64, "clients": 16}
    tr = load.Traffic(None, t, np.zeros((1 << 20, 2)), None, 10)
    offs = [tr.qoff(c, j) for c in range(16) for j in range(3)]
    assert len(set(offs)) == len(offs)
    assert tr.qoff(3, 5) == ((3 * 1024 + 5) % 16384) * 64


def test_oldest_pops_in_write_order():
    o = load.Oldest(5)
    o.push([5, 6, 7])
    np.testing.assert_array_equal(o.pop(3), [0, 1, 2])
    np.testing.assert_array_equal(o.pop(4), [3, 4, 5, 6])
    np.testing.assert_array_equal(o.pop(4), [7])
