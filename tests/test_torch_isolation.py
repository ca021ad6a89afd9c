"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the reference package, and the smoke
script refuses to run without a GPU."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    assert not imported_roots(path) & FORBIDDEN


def test_importing_the_engine_loads_no_jax():
    code = ("import sys, repro_torch.core.engine, repro_torch.convert, "
            "repro_torch.models.model, repro_torch.serve.rag, "
            "repro_torch.train.train_loop, repro_torch.train.checkpoint, "
            "repro_torch.models.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.steps, repro_torch.launch.dryrun, "
            "repro_torch.roofline, repro_torch.report, repro_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"),
                        "PATH": "/usr/bin:/bin"})


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_gpu():
    res = _smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    res = _smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
