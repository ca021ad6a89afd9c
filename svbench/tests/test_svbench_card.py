"""On the card: a short run of each cell through the entry, correct, and
the control of the device cell, not correct. Run on the chip machine:
``python -m pytest svbench/tests -m card``."""
import json
import subprocess
import sys

import pytest

from svbench import spec

ENTRY = spec.ROOT / "svbench"


def _run(script, cell, seed, seconds=3):
    out = subprocess.run(
        [sys.executable, str(ENTRY / script), "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec._load(
    spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_a_short_run_is_correct(card, cell):
    r = _run("run.py", cell, 2 ** 31 + 17)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.card
def test_the_control_is_not_correct_on_the_card(card):
    r = _run("control.py", "deep1b_device.search_uniform", 2 ** 31 + 19)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > r["checks"]["dist_gap"][
        "limit"]
