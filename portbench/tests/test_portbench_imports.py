"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program, by top-level module name compared
whole (``fadtk_tpu_torch`` begins with ``fadtk_tpu``)."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "fadtk_tpu"}
FILES = sorted(PB.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_check_compares_whole_names():
    assert "fadtk_tpu_torch" not in JAX


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PB)) for p in FILES])
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "fadtk_tpu_torch" not in names and "portbench" not in names
    text = path.read_text()
    assert "from .." not in text  # only its own siblings
