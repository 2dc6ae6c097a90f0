"""What the benchmark may import: no module under portbench/ imports
jax, jaxlib, flax or the JAX package (compairr_tpu, compared as a whole
top-level name: compairr_tpu_torch begins with it); the harness imports
nothing of the repository but portbench and the port; the reference
imports nothing of the port."""

import ast
import os
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "compairr_tpu"}
THIRD_PARTY = {"numpy", "torch"}


def sources(sub=""):
    out = []
    for root, _, names in os.walk(os.path.join(PB, sub)):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def rel(p):
    return os.path.relpath(p, PB)


@pytest.mark.parametrize("path", sources(), ids=rel)
def test_no_jax(path):
    assert not FORBIDDEN & set(roots(path))


@pytest.mark.parametrize(
    "path", [p for p in sources() if "tests" not in rel(p).split(os.sep)],
    ids=rel)
def test_harness_imports(path):
    allowed = set(sys.stdlib_module_names) | THIRD_PARTY | {
        "portbench", "compairr_tpu_torch"}
    assert set(roots(path)) <= allowed


@pytest.mark.parametrize("path", sources("reference"), ids=rel)
def test_reference_imports(path):
    assert set(roots(path)) <= set(sys.stdlib_module_names) | {"numpy"}


def test_loaded_modules_compared_by_whole_top_level_name(monkeypatch):
    import types

    from portbench.run import loaded_forbidden

    monkeypatch.setitem(sys.modules, "compairr_tpu_torch_x.y",
                        types.ModuleType("compairr_tpu_torch_x.y"))
    assert loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "compairr_tpu.ops",
                        types.ModuleType("compairr_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert loaded_forbidden() == ["compairr_tpu", "jaxlib"]
