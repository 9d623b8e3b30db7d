"""No module of the benchmark imports JAX or the JAX package, and none of
the reference imports the program: top-level names compared whole (the
port's name begins with the JAX package's)."""

import ast

import pytest

from benchmark.harness import spec

EVERYWHERE = {"jax", "jaxlib", "flax", "elastic_tpu_agent"}
IN_REFERENCE = EVERYWHERE | {"elastic_tpu_agent_torch"}
SOURCES = sorted(spec.BENCH_DIR.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_forbidden_import(path):
    refused = (IN_REFERENCE if "reference" in path.relative_to(
        spec.BENCH_DIR).parts else EVERYWHERE)
    found = set(top_level_imports(path)) & refused
    assert not found, f"{path} imports {sorted(found)}"


def test_check_compares_whole_names():
    from benchmark.harness.device import FORBIDDEN

    assert "elastic_tpu_agent_torch" not in FORBIDDEN
    assert set(FORBIDDEN) == EVERYWHERE
