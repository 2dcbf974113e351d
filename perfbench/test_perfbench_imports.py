"""What the benchmark may import: nothing under ``perfbench/`` names the JAX
stack or the JAX package (top-level module names compared whole: the port's
``repro_torch`` begins with ``repro``), and the plain reference imports
nothing of the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from perfbench import harness

FILES = sorted(harness.BENCH_DIR.rglob("*.py"))


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN_MODULES), (path, tops)


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.BENCH_DIR / "reference").rglob("*.py")):
        for m in _imports(path):
            assert m.split(".")[0] in {"__future__", "math", "typing", "torch", "numpy"} or \
                m.startswith("perfbench.reference"), (path, m)


def test_forbidden_modules_are_matched_whole():
    import sys

    assert "repro_torch" not in harness.FORBIDDEN_MODULES
    names = harness.forbidden_loaded()
    assert set(names) <= set(harness.FORBIDDEN_MODULES)
    assert all(n.split(".")[0] in sys.modules for n in names)
