"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``benchmark/`` (top-level names compared whole), and
nothing of the port under ``benchmark/reference/``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "ditto_tts_tpu"}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_top_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_imports(path))
    assert "ditto_tts_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}


def test_the_port_name_is_compared_whole():
    # the port's name begins with the JAX package's: it is not forbidden
    assert "ditto_tts_tpu_torch".split(".")[0] not in JAX
