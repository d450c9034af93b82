"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``mlqem_tpu_torch`` is the system under test,
``mlqem_tpu`` is not allowed), and the reference imports nothing of the
program."""
import ast
import os

import pytest

from qem_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "mlqem_tpu"}
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.HERE)
               for f in fs if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert "mlqem_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference"
                                  + os.sep in p],
                         ids=os.path.basename)
def test_reference_is_independent_of_the_program(path):
    assert "mlqem_tpu_torch" not in set(top_level_imports(path))
