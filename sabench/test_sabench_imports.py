"""No module of the benchmark imports JAX or the JAX package or reads the
JAX package's `benchmarks/` folder, and the yardstick (the reference, the
arithmetic, the generators) imports nothing of the program. Names are
compared by their whole top-level part (before the first dot):
`repro_torch` begins with `repro` and is not `repro`."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "stats.py", "corpus.py")
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def string_constants(source: str) -> list:
    return [node.value for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)]


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    source = path.read_text()
    assert not top_level_imports(source) & FORBIDDEN
    if path.name != Path(__file__).name:
        assert not any(s == "benchmarks" or s.startswith("benchmarks/")
                       for s in string_constants(source))


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports((HERE / name).read_text())


def test_names_are_compared_whole():
    assert top_level_imports("import repro_torch.api\n"
                             "from repro_torch import bsp\n") \
        .isdisjoint(FORBIDDEN)
    assert top_level_imports("from repro.api import x\n") <= FORBIDDEN
    assert top_level_imports("import jax.numpy as jnp\n") <= FORBIDDEN
