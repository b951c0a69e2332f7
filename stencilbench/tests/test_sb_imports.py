"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os

import pytest

from stencilbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "drstencil_tpu"}
# the reference and the inputs it shares with the harness
REFERENCE = ("reference.py", "work.py")


def modules():
    for dirpath, _, files in os.walk(cells.ROOT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".", 1)[0] for name in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_nothing_of_the_program(name):
    names = set(imported(os.path.join(cells.ROOT, name)))
    assert not [n for n in names if n.startswith("drstencil_tpu")]
    assert not [n for n in names if n.startswith("stencilbench")]


def test_the_cone_check_imports_nothing_of_the_program():
    """``cones`` runs the reference on crops; of the benchmark it takes the
    reference alone."""
    names = set(imported(os.path.join(cells.ROOT, "cones.py")))
    assert not [n for n in names if n.startswith("drstencil_tpu")]
    assert {n for n in names if n.startswith("stencilbench")} == {
        "stencilbench"}
