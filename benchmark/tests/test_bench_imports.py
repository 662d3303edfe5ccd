"""No module of the benchmark imports JAX or the JAX package, by the
top-level name compared whole, and the reference imports nothing of the
program."""
import ast
import os

import pytest

import bench_tiny

BENCH = os.path.join(bench_tiny.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "deepards_tpu"}


def modules():
    for base, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p))
def test_reference_imports_no_program(path):
    assert "deepards_tpu_torch" not in set(imported(path))


def test_the_program_name_is_not_the_jax_package():
    assert "deepards_tpu_torch".split(".")[0] not in FORBIDDEN
