"""The comparison fails what it must: the control (the reference in the
precision below the configuration's, in the program's place), and the
harness driving a run whose timed path is broken underneath."""
import pytest

from svbench import faults
from svbench.tests.tiny import run_tiny, tiny_cell

CELLS = ["deep1b_device.search_uniform", "deep1b_tiered_pq.search_zipf"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    r = run_tiny(cell, control=True)
    assert r["correct"] is False
    gap = r["checks"]["dist_gap"]
    assert gap["value"] > gap["limit"]
    # the control is exact: it fails on precision alone
    for k in ("unanswered", "reused_ids", "wrong_ids"):
        assert r["checks"][k]["value"] == 0, k


def test_the_sound_run_is_correct_on_the_guarantees():
    r = run_tiny(tiny_cell(CELLS[0]))
    for k in ("unanswered", "reused_ids", "wrong_ids", "index_lost"):
        assert r["checks"][k]["value"] == 0, k
    for k in ("dist_gap", "fresh_self_miss"):
        assert r["checks"][k]["value"] <= r["checks"][k]["limit"], k


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,fails", [pytest.param(*p, id=i) for i, p in (
    ("_alter_answers-fails0", (faults.alter_answers,
                               ("dist_gap", "wrong_ids"))),
    ("_lose_inserts-fails1", (faults.lose_inserts,
                              ("reused_ids", "index_lost", "wal_lost"))),
    ("_ignore_deletes-fails2", (faults.ignore_deletes,
                                ("wrong_ids", "index_lost", "wal_lost"))),
    ("publish_late", (faults.publish_late, ("fresh_self_miss",))),
)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault, fails):
    cell = tiny_cell(name)
    fault(monkeypatch.setattr, cell.config["mode"])
    r = run_tiny(cell, seconds=1.0)
    assert r["correct"] is False
    failed = {k for k, c in r["checks"].items()
              if c["value"] is None or ((c["value"] < c["limit"])
                                        if c["must"] == ">="
                                        else (c["value"] > c["limit"]))}
    assert failed & set(fails), r["checks"]
