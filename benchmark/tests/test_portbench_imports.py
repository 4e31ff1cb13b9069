"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the plain reference imports nothing of the
program."""

import ast
import sys
import types

from benchmark import harness


def test_whole_name_check(monkeypatch):
    for name in ("acav100m_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert "acav100m_torch" not in found and "jaxtyping" not in found
    for name in ("acav100m_tpu.ops", "jaxlib.xla_client", "optax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"acav100m_tpu", "jaxlib", "optax"} <= set(harness.forbidden_modules())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert "acav100m_torch" not in set(_imports(path)), path
