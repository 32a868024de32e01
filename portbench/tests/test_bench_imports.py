"""What the harness may import: never `jax`, `jaxlib`, `flax` or the JAX
package, judged on each module's whole top-level name (the port's name
begins with the JAX package's); and the plain reference nothing of the
program."""
import ast
from pathlib import Path

import pytest

from portbench import run, spec

SOURCES = sorted(p for p in spec.PACKAGE.rglob("*.py"))


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_whole_top_level_names():
    assert run.forbidden_modules(["embeddingtables_tpu_torch",
                                  "embeddingtables_tpu_torch.ops",
                                  "jax_like", "flaxen", "torch"]) == []
    assert run.forbidden_modules(["embeddingtables_tpu.ops", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == \
        ["embeddingtables_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(spec.PACKAGE)))
def test_no_harness_module_imports_jax(path):
    assert run.forbidden_modules(_imports(path)) == []


@pytest.mark.parametrize("path", sorted(
    (spec.PACKAGE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not {m for m in _imports(path)
                if m.split(".")[0].startswith("embeddingtables_tpu")}
