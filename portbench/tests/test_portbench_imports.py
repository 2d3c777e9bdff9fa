"""Nothing under portbench/ imports JAX, its libraries or the JAX package,
and nothing under portbench/reference/ imports the program: top-level module
names compared whole (kpdiff_tpu_torch begins with kpdiff_tpu and is allowed
outside the reference)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "kpdiff_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(folder: Path):
    return sorted(folder.rglob("*.py"))


@pytest.mark.parametrize("path", sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & BANNED


@pytest.mark.parametrize("path", sources(BENCH / "reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "kpdiff_tpu_torch" not in set(top_level_imports(path))


def test_the_check_compares_whole_names():
    assert "kpdiff_tpu_torch".split(".")[0] not in BANNED
    assert "kpdiff_tpu.models".split(".")[0] in BANNED


def test_harness_finds_banned_modules(monkeypatch):
    import sys
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "kpdiff_tpu_torch_like", types.ModuleType("kpdiff_tpu_torch_like"))
    assert "kpdiff_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "kpdiff_tpu.fake", types.ModuleType("kpdiff_tpu.fake"))
    assert "kpdiff_tpu" in harness.banned_modules()
