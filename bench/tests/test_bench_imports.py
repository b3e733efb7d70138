"""No module of the benchmark imports JAX, Flax or the JAX package (top-level
names compared whole), the plain references import nothing of the program,
and nothing reads the JAX package's benchmark folder."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "harness" not in top_level_imports(path)


def test_names_are_compared_whole():
    from harness.runner import FORBIDDEN as names

    assert set(names) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_packages_benchmarks(path):
    assert '"benchmarks' not in path.read_text() and "'benchmarks" not in path.read_text()
