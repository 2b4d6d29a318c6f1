"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level module names,
the part before the first dot, compared whole)."""

import ast

from perfbench.tests.perfbench_tiny import ROOT

JAX = {"jax", "jaxlib", "flax", "kosmosx_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _files(sub=""):
    return sorted((ROOT / "perfbench" / sub).rglob("*.py"))


def test_no_jax_anywhere():
    files = _files()
    assert len(files) > 20
    for f in files:
        assert not JAX & set(_imports(f)), f


def test_the_reference_takes_nothing_from_the_program():
    files = _files("reference")
    assert files
    for f in files:
        names = set(_imports(f))
        assert "kosmosx_torch" not in names and not JAX & names, f
        text = f.read_text()
        assert "perfbench.port" not in text and "drivers" not in text, f


def test_names_compared_whole():
    # the port's name begins with the JAX package's; only whole names count
    assert "kosmosx_torch".split(".", 1)[0] not in JAX
