"""The port stands alone: no module of `mliis_tpu_torch/`, nor chip_smoke.py
or the port's scripts in experiments/, imports JAX, flax or anything of the
JAX package `mliis_tpu` (an AST scan of every import statement, top level
or nested), nor holds a string path into `mliis_tpu/` that it could read a
file through (docstrings and `file.py:line` citations aside)."""
import ast
import pathlib
import re

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


_CITATION = re.compile(r"^[\w./]+\.py:\d+$")


def _path_strings(path):
    """The string constants of a source, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docstrings.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings:
            yield node.value


def _into_jax_package(text):
    """True for a path with a `mliis_tpu` component (a citation aside)."""
    return not _CITATION.match(text) and "mliis_tpu" in re.split(r"[/\\]",
                                                                 text)


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


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_paths_into_the_jax_package(path):
    bad = [t for t in _path_strings(path) if _into_jax_package(t)]
    assert not bad, "{} names {}".format(path.relative_to(ROOT), bad)


def test_the_scan_catches_a_path_into_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        '"""Reads mliis_tpu/data/x.txt."""\n'
        'import os\n'
        'A = os.path.join(ROOT, "mliis_tpu", "data")\n'
        'B = "../mliis_tpu/data/fss_train_set.txt"\n'
        'C = "mliis_tpu_torch/data/fss_train_set.txt"\n'
        'D = "mliis_tpu/ops/pallas_augment.py:188"\n')
    assert {t for t in _path_strings(probe) if _into_jax_package(t)} == {
        "mliis_tpu", "../mliis_tpu/data/fss_train_set.txt"}
