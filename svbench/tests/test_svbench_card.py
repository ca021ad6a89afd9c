"""On the card: a short run of each cell through the entry, correct, and
the control of the device cell, not correct; the profiler's device
events naming their card; and a run on four cards through the replicas
(``replicas.py``), counted and traced on each. Run on the chip machine:
``python -m pytest svbench/tests -m card`` (``-s`` prints the four-card
runs' lines)."""
import json
import subprocess
import sys
import time

import pytest

from svbench import harness, spec
from svbench import trace as tr_mod
from svbench.tests import replicas
from svbench.tests.tiny import four_card_cell

ENTRY = spec.ROOT / "svbench"


def _run(script, cell, seed, seconds=3):
    out = subprocess.run(
        [sys.executable, str(ENTRY / script), "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", [
    pytest.param(w["name"], marks=pytest.mark.card(chips=w["chips"]))
    for w in spec._load(spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_a_short_run_is_correct(card, cell):
    r = _run("run.py", cell, 2 ** 31 + 17)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == spec.load_cell(cell).chips


@pytest.mark.card
def test_the_control_is_not_correct_on_the_card(card):
    r = _run("control.py", "deep1b_device.search_uniform", 2 ** 31 + 19)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > r["checks"]["dist_gap"][
        "limit"]


@pytest.mark.card
def test_device_events_name_their_card(card, tmp_path):
    """Kernels, copies and fills on every card of the host, traced: each
    device event carries its card as the ``device`` argument, which the
    slice's reduction keeps the cards apart by."""
    import torch
    cards = tuple(range(torch.cuda.device_count()))
    s = tr_mod.Slice("cuda", str(tmp_path / "t.json"), cards)
    s.start()
    for c in cards:
        d = torch.device("cuda", c)
        x = torch.rand(1 << 20, device=d)
        torch.sort(x)
        x.zero_()
        torch.tensor([1.0, 2.0], device=d).cpu()
    s.stop()
    s.prof.export_chrome_trace(str(tmp_path / "e.json"))
    events = [e for e in json.loads((tmp_path / "e.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"
        and e.get("cat") in tr_mod.Slice.DEVICE_CATS]
    seen = {}
    for e in events:
        key = (e["cat"], e.get("args", {}).get("device"))
        seen[key] = seen.get(key, 0) + 1
    print(f"device events by (category, device): {seen}")
    assert all(d in cards for _, d in seen), seen
    for c in cards:
        assert seen.get(("kernel", c)) and seen.get(("gpu_memcpy", c)), seen
    out = tr_mod.reduce_events(json.loads((tmp_path / "e.json").read_text())[
        "traceEvents"], s.t1 - s.t0, cards)
    assert all(b > 0 for b in out["busy_s_per_card"]), out


@pytest.mark.card(chips=4)
@pytest.mark.parametrize("trace", [False, True])
def test_four_cards_through_the_replicas(card, trace, monkeypatch):
    """A cell on four cards, one engine a card: correct, counted as four
    cards, and, traced, every card busy and the scored op read on all."""
    summaries = []
    reduce = tr_mod.Slice.reduce

    def kept(self, top=10):
        summaries.append(reduce(self, top))
        return summaries[-1]
    monkeypatch.setattr(tr_mod.Slice, "reduce", kept)
    lines = []
    r = harness.run_cell(four_card_cell(), 2 ** 31 + 23 + trace, 10.0,
                         trace, "cuda", time.perf_counter(),
                         under_test=replicas, log=lines.append)
    print("\n".join(lines))
    print(json.dumps(r))
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 4
    if trace:
        (s,) = summaries
        assert len(s["busy_s_per_card"]) == 4
        assert all(b > 0 for b in s["busy_s_per_card"]), s
        assert "l2_gather_roofline" in r["metrics"], r["metrics"]
