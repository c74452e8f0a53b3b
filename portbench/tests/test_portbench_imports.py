"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` passes), and the plain
references import nothing of the program."""

import ast
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(harness.HERE).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.HERE / "refs").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_forbidden_names_are_compared_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN


DRY = """
import sys
sys.path[:0] = [{src!r}, {root!r}, {tests!r}]
from conftest import tiny
from portbench import harness
harness.run_cell(tiny({cell!r}), 3, 0.5, False, "cpu", log=lambda m: None)
print(sorted({{m.split('.')[0] for m in sys.modules}} & {forbidden!r}))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_a_run_loads_no_jax(cell):
    code = DRY.format(src=str(harness.ROOT / "src"), root=str(harness.ROOT),
                      tests=str(harness.HERE / "tests"), cell=cell, forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
