"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole)."""
import ast
from pathlib import Path

PB = Path(__file__).resolve().parents[1]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for p in PB.rglob("*.py"):
        assert not top_level_imports(p) & {"jax", "jaxlib", "flax",
                                           "touchgs_tpu", "bench",
                                           "bench_torch", "tools"}, p


def test_reference_imports_nothing_of_the_program():
    for p in (PB / "reference").rglob("*.py"):
        assert "touchgs_torch" not in top_level_imports(p), p
    for p in (PB / "counts").rglob("*.py"):
        assert "touchgs_torch" not in top_level_imports(p), p
