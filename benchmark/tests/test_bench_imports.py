"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program under test."""

import ast
import os

import pytest

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "panopticnerf_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", _sources(BENCH_DIR), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources(os.path.join(BENCH_DIR, "reference")),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"panopticnerf_tpu_torch", "harness"}


def test_the_whole_name_is_compared():
    from harness.core import FORBIDDEN_MODULES

    assert "panopticnerf_tpu_torch" not in FORBIDDEN_MODULES
    assert set(FORBIDDEN_MODULES) == FORBIDDEN
