"""The port's subpackages re-export what the JAX package's do: for every
``touchgs_tpu/<pkg>/__init__.py``, read with ``ast`` (no JAX import), each
name it imports is an attribute of ``touchgs_torch.<pkg>``, and the same
object as in the port's module at the counterpart path."""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = sorted(p.parent.name for p in
                  (ROOT / "touchgs_tpu").glob("*/__init__.py"))


def reexports(pkg: str) -> list:
    """(module, name) of every ``from touchgs_tpu.X import name`` in the
    JAX subpackage's ``__init__.py``."""
    tree = ast.parse((ROOT / "touchgs_tpu" / pkg / "__init__.py").read_text())
    return [(node.module, alias.asname or alias.name)
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names]


def test_packages_found():
    assert {"data", "models", "native", "ops", "train", "utils",
            "vision"} <= set(PACKAGES)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_reexports_the_jax_packages_names(pkg):
    names = reexports(pkg)
    assert names, f"touchgs_tpu/{pkg}/__init__.py re-exports nothing"
    port = importlib.import_module(f"touchgs_torch.{pkg}")
    for module, name in names:
        assert module.startswith("touchgs_tpu."), module
        source = importlib.import_module(
            "touchgs_torch." + module[len("touchgs_tpu."):])
        assert getattr(port, name) is getattr(source, name), (pkg, name)
