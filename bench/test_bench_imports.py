"""What the benchmark imports: nothing of the JAX package, by whole
top-level name (the port's ``repro_torch`` begins with ``repro``), and in
the yardstick (reference, arithmetic, traffic, comparison, trace reader)
nothing of the port either."""
from __future__ import annotations

import ast

import pytest

from bench.cell import ROOT
from bench.run import forbidden_modules

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "refcada.py", "flops.py", "traffic.py",
             "judge.py", "devtrace.py")
SOURCES = sorted((ROOT / "bench").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(ROOT / "bench" / name)


def test_the_metric_readers_import_only_the_yardstick():
    for path in (ROOT / "bench" / "metrics").glob("*.py"):
        assert top_level_imports(path) <= {"bench", "__future__", "math"}


def test_forbidden_modules_compare_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "torch",
                              "jaxtyping"]) == []
    assert forbidden_modules(["repro.core.flat", "jax.numpy", "jaxlib",
                              "flax", "torch"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]
