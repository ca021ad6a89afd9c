"""Find a cell's parts by name: ``BENCHMARK.json`` names the cell, and the
cell names its configuration (``svbench/configs/<config>.json``) and
traffic mix (``svbench/traffic/<traffic>.json``); its correctness limits
are ``svbench/limits/<cell>.json`` and each per-layer metric's reader is
``svbench/metrics/<metric>.py``. Adding a cell or a metric adds files
and edits none."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _load(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path.name}; "
                       f"known: {', '.join(cells)}")
    w = cells[name]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load(HERE / "configs" / f"{w['config']}.json"),
                traffic=_load(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric: str):
    """The ``read(ctx)`` function of ``svbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"svbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
