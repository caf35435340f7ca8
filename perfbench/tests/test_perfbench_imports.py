"""What the benchmark may import: nothing under ``perfbench/`` imports
``jax`` or the JAX package ``repro``, and the reference imports neither
nor ``repro_torch``. Modules are compared by their whole top-level name:
``repro_torch`` is not ``repro``."""

import ast

import _paths
import pytest

PERFBENCH = _paths.ROOT / "perfbench"
FILES = sorted(PERFBENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(PERFBENCH)))
def test_no_jax_and_no_jax_package(path):
    bad = top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_no_program(path):
    bad = top_level_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                     "repro_torch", "perfbench"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.sql\nfrom reprox import y\n")
    assert top_level_imports(f) == {"repro_torch", "reprox"}
    f.write_text("import repro.sql\n")
    assert top_level_imports(f) == {"repro"}
