"""The port stands alone: no module of `mliis_tpu_torch/`, nor chip_smoke.py
or the port's scripts in experiments/, imports JAX, flax or anything of the
JAX package `mliis_tpu` (an AST scan of every import statement, top level
or nested)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mliis_tpu")
SOURCES = sorted((ROOT / "mliis_tpu_torch").rglob("*.py")) + sorted(
    (ROOT / "experiments").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_sources_found():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "{} imports {}".format(path.relative_to(ROOT), bad)


def test_the_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from mliis_tpu.ops import augment\n"
                     "import mliis_tpu_torch.ops\n")
    assert [m for m in _imported_modules(probe) if _forbidden(m)] == [
        "mliis_tpu.ops"]
