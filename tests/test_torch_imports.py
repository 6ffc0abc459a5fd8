"""The port's import rule: no module of ``touchgs_torch/``, nor
``chip_smoke.py``, imports JAX or the JAX package, not even lazily inside a
function.  Each file is parsed with ``ast``; only the tests import both."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "touchgs_tpu")
FILES = sorted(ROOT.glob("touchgs_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree: ast.AST):
    """(line, module) of every import statement in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(tree: ast.AST) -> list:
    return [(line, mod) for line, mod in _imports(tree)
            if mod.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _forbidden(ast.parse(path.read_text(), filename=str(path)))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_catches_every_form():
    src = ("import jax\nimport jaxlib.xla_client\n"
           "from touchgs_tpu.ops import tiles\n"
           "def f():\n    import jax.numpy as jnp\n"
           "import numpy\nfrom . import sibling\n")
    assert [m for _, m in _forbidden(ast.parse(src))] == [
        "jax", "jaxlib.xla_client", "touchgs_tpu.ops", "jax.numpy"]


def test_files_found():
    assert len(FILES) > 20
    assert ROOT / "touchgs_torch" / "ops" / "rasterize_tiled.py" in FILES
