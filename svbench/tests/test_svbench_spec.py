"""BENCHMARK.json against the contract's form, and every name it uses
found as a file of its own."""
import json
import re

import pytest

from svbench import spec

B = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_limits():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert B["paths"] == ["svbench"]
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            yield e["name"]
    for w in B["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in B["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


def test_units_texts_and_uniqueness():
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))
    texts = [w["why"] for w in B["workloads"]] + [
        c["why"] for c in B["configs"]] + [c["source"] for c in B["configs"]] \
        + [m["layer"] for m in B["per_layer"]] + B["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert len({(w["config"], w["traffic"]) for w in B["workloads"]}) == \
        len(B["workloads"])


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in B["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
        assert callable(spec.reader(m["name"]))
    assert "dist_gap" in c.limits
    assert c.chips in (1, 4)


def test_four_card_cells_within_their_share():
    """A cell takes four cards only where what it measures exists across
    cards: at most a quarter of the cells, rounded down, and always one."""
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(B["workloads"]) // 4)


def test_config_files_and_reduced_keys():
    for c in B["configs"]:
        path = spec.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("svbench/")
        cfg = json.loads(path.read_text())
        for k in c["reduced"]:
            assert k in cfg and k in cfg["published"], k
            assert not k.endswith(("_dim", "_rank"))
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])
