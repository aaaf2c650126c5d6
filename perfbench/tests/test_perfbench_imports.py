"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` passes), and the reference
imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) >= 10
    assert HERE / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts
             or p.name in ("weights.py", "arch.py", "markov.py")],
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "repro_torch" not in path.read_text()
