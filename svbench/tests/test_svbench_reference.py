"""The plain reference and the comparison's pieces on small cases."""
import numpy as np
import pytest
import torch

from svbench import check
from svbench.reference.exact import Mirror, topk_alive


def naive_topk(q, x, alive, k):
    out = []
    for i in range(len(q)):
        d = ((x - q[i]) ** 2).sum(1).astype(np.float64)
        ids = [j for j in np.argsort(d, kind="stable") if alive[i, j]][:k]
        out.append(ids + [-1] * (k - len(ids)))
    return np.array(out)


@pytest.mark.parametrize("block_rows", [7, 1 << 20])
def test_topk_equals_a_naive_sort(block_rows):
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (300, 12)).astype(np.float32)
    x += rng.random((300, 12)).astype(np.float32) * 1e-2  # no ties
    q = rng.normal(size=(40, 12)).astype(np.float32)
    alive = rng.random((40, 300)) < 0.7
    alive[0, :] = False
    alive[1, :5] = True
    alive[1, 5:] = False
    got = topk_alive(torch.as_tensor(q), torch.as_tensor(x),
                     torch.as_tensor(alive), 10, block_rows=block_rows)
    np.testing.assert_array_equal(got.numpy(), naive_topk(q, x, alive, 10))


def _answers(pool, ids, dists, ts, te):
    Q = len(ids)
    return check.Answers(pool, np.arange(Q), np.full(Q, ts), np.full(Q, te),
                         np.asarray(ids, np.int64),
                         np.asarray(dists, np.float32), np.arange(Q))


def test_mirror_times_and_wrong_ids():
    m = Mirror(np.zeros((4, 2), np.float32))
    m.insert([4, 5], np.ones((2, 2), np.float32), 10.0, 11.0)
    m.delete([0], 12.0, 13.0)
    vec, ins_start, ins_ack, del_start, del_ack = m.arrays()
    assert vec.shape == (6, 2) and ins_ack[4] == 11.0
    assert del_start[0] == 12.0 and del_ack[0] == 13.0
    assert np.isinf(del_ack[1])
    pool = np.zeros((3, 2), np.float32)
    # row 0 deleted before submit, row 5 inserted after the answer,
    # a -1, an id never written and a repeat: five wrong; rows 1-3 fine
    ids = [[0, 1], [5, 2], [-1, 3], [9, 1], [2, 2]]
    a = check.Answers(pool, np.zeros(5, int), np.full(5, 14.0),
                      np.array([14.5, 9.0, 14.5, 14.5, 14.5]),
                      np.asarray(ids), np.zeros((5, 2), np.float32),
                      np.arange(5))
    assert check.wrong_ids(a, ins_start, del_ack) == 5


def test_dist_gap_and_recall():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    pool = rng.normal(size=(16, 8)).astype(np.float32)
    m = Mirror(x)
    vec, *times = m.arrays()
    alive = np.ones((16, 200), bool)
    truth = naive_topk(pool, x, alive, 10)
    d = ((x[truth] - pool[:, None]) ** 2).sum(-1)
    ans = _answers(pool, truth, d, 1.0, 2.0)
    v = torch.as_tensor(vec)
    assert check.dist_gap(ans, v, "cpu") < 1e-6
    assert check.recall(ans, np.arange(16), v, times, 10, "cpu") == 1.0
    half = truth.copy()
    half[:, 5:] = truth[:, :5] + 0      # duplicates: not in the truth twice
    assert check.recall(_answers(pool, half, d, 1.0, 2.0), np.arange(16),
                        v, times, 10, "cpu") == pytest.approx(0.5)
    off = _answers(pool, truth, d * 1.01, 1.0, 2.0)
    assert check.dist_gap(off, v, "cpu") == pytest.approx(0.01, rel=1e-3)


def test_recall_drops_rows_a_write_overlapped():
    x = np.arange(20, dtype=np.float32)[:, None] * np.ones((1, 2),
                                                          np.float32)
    m = Mirror(x[:10])
    m.insert(np.arange(10, 20), x[10:], 5.0, 6.0)
    m.delete([0], 5.5, 7.0)          # row 0 is being deleted at t=6
    vec, *times = m.arrays()
    pool = np.zeros((1, 2), np.float32)
    # submitted at 6.5, answered at 6.6: rows 10-19 alive, row 0 in flight
    ans = check.Answers(pool, np.zeros(1, int), np.array([6.5]),
                        np.array([6.6]), np.array([[0] + list(range(1, 10))]),
                        np.zeros((1, 10), np.float32), np.zeros(1, int))
    r = check.recall(ans, np.arange(1), torch.as_tensor(vec), times, 10,
                     "cpu")
    assert r == pytest.approx(9 / 10)   # rows 1-9 of the truth's 1-10


def test_judge_directions():
    ok = {"a": check.entry(0, 0), "b": check.entry(0.95, 0.9, ">=")}
    assert check.judge(ok)
    assert not check.judge(dict(ok, c=check.entry(1, 0)))
    assert not check.judge(dict(ok, c=check.entry(0.5, 0.9, ">=")))
    assert not check.judge(dict(ok, c=check.entry(None, 0.9, ">=")))
