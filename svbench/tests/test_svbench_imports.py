"""Nothing under svbench/ imports JAX or the JAX package, compared by
whole top-level name (the port's ``repro_torch`` begins with ``repro``),
and nothing reads the JAX benchmarks' folder."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                  p.parts)


def _top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_import(path):
    bad = set(_top_names(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"
    assert "benchmarks/" not in path.read_text().replace(
        "svbench/", "") or path.name == Path(__file__).name


def test_top_name_is_compared_whole(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import x\n"
                 "import repro.core\n")
    assert set(_top_names(p)) == {"repro_torch", "repro"}
    assert set(_top_names(p)) & FORBIDDEN == {"repro"}


def test_a_run_loads_no_jax():
    """A tiny run in a fresh process leaves no JAX module loaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from svbench.tests.tiny import run_tiny, tiny_cell\n"
            "from svbench.harness import forbidden_modules\n"
            "run_tiny(tiny_cell('deep1b_tiered_pq.search_zipf'), "
            "seconds=0.5)\n"
            "print(forbidden_modules())\n" % (str(HERE.parent),
                                              str(HERE.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
