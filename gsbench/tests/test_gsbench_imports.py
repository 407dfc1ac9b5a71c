"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``gsjax_torch`` begins with ``gsjax``)."""

import ast
import os

import pytest

from gsbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "gsjax"}


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(harness.ROOT, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "gsjax_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    assert "gsjax_torch" not in FORBIDDEN and "gsjax" in FORBIDDEN
    src = "import gsjax_torch.ops\nfrom gsjax.ops import x\n"
    tree = ast.parse(src)
    got = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
           for n in tree.body}
    assert got & FORBIDDEN == {"gsjax"}
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "gsjax")


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "gsjax_torch_fake", types.ModuleType("gsjax_torch_fake"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gsjax.ops", types.ModuleType("gsjax.ops"))
    assert harness.forbidden_modules() == ["gsjax"]
