"""Nothing under portbench/ imports JAX, flax or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (the port's name begins with the JAX package's)."""

import ast

import pytest

from portbench.bench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "avlmaps_tpu"}
FILES = sorted(p for p in registry.BENCH_DIR.rglob("*.py")
               if "_cache" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(registry.BENCH_DIR)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    (registry.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert "avlmaps_torch" not in set(top_level_imports(path))


def test_compares_whole_names():
    assert "avlmaps_torch" not in FORBIDDEN
    assert "avlmaps_torch".split(".")[0] != "avlmaps_tpu"
