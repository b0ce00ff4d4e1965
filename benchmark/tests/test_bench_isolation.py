"""No module the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "sarlacc_tpu"}


def _modules():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    bad = set(_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [p for p in _modules() if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "sarlacc_tpu_torch" not in set(_imports(path))


def test_names_compare_whole():
    # the port's name begins with the JAX package's: a prefix test would fail it
    assert "sarlacc_tpu_torch" not in FORBIDDEN
