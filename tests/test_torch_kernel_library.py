"""The hand-written kernels' one seam, `ops/kernel_library`, on the CPU:
the sources it finds, the headers each library's digest follows, the
launch's count and error, and that the model and the loss head reach the
kernels without the augmentation module."""
import ast
import collections
import contextlib
import pathlib
import shutil

import pytest
import torch

from mliis_tpu_torch.ops import kernel_library

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mliis_tpu_torch"


def test_sources_are_the_stems_of_every_cu_file():
    stems = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert kernel_library.sources() == stems
    assert {"full_pass", "cheap_pass", "light_augment", "resized_ce",
            "batch_norm_act"} <= set(stems)


@pytest.mark.parametrize("header, changed", [
    ("row_ring.cuh", {"cheap_pass", "light_augment"}),
    ("philox.cuh", {"cheap_pass", "light_augment", "full_pass"}),
    ("cheap_ops.cuh", {"cheap_pass", "full_pass"}),
])
def test_a_header_edit_rebuilds_only_the_sources_that_include_it(
        tmp_path, monkeypatch, header, changed):
    """In a copy of csrc/, an edit to a header changes the library path of
    each source that includes it, directly or through another header
    (full_pass reaches philox.cuh through cheap_ops.cuh), and of no other
    source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PORT / "csrc", csrc)
    monkeypatch.setattr(kernel_library, "CSRC_DIR", str(csrc))
    before = {s: kernel_library.library_path(s)
              for s in kernel_library.sources()}
    with open(csrc / header, "a") as f:
        f.write("\n// an edit\n")
    after = {s: kernel_library.library_path(s)
             for s in kernel_library.sources()}
    assert {s for s in before if before[s] != after[s]} == changed


@pytest.fixture
def fake_card(monkeypatch):
    """`torch.cuda.device` and the current stream stood in for, and a fresh
    launch table."""
    devices = []

    @contextlib.contextmanager
    def device(d):
        devices.append(d)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0x5EED + (index or 0), raising=False)
    monkeypatch.setattr(kernel_library, "launches", collections.Counter())
    return devices


def test_launch_appends_the_stream_and_counts_a_success(fake_card):
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    dev = torch.device("cuda", 1)
    kernel_library.launch("probe", fn, dev, 3, 4.5)
    kernel_library.launch("probe", fn, dev, 6, 7.5)
    assert calls == [(3, 4.5, 0x5EEE), (6, 7.5, 0x5EEE)]
    assert fake_card == [dev, dev]
    assert kernel_library.launches == {"probe": 2}


def test_a_failed_launch_raises_with_its_kernel_and_code_and_counts_nothing(
        fake_card):
    with pytest.raises(RuntimeError, match=r"probe kernel launch failed: "
                                           r"cudaError 700"):
        kernel_library.launch("probe", lambda *a: 700, torch.device("cuda"))
    assert kernel_library.launches["probe"] == 0
    assert dict(kernel_library.launches) == {}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from ("{}.{}".format(node.module, alias.name)
                        for alias in node.names)


MODEL_SIDE = [PORT / "ops" / "resized_ce.py",
              PORT / "ops" / "batch_norm_act.py"] + sorted(
    (PORT / "models").glob("*.py"))


@pytest.mark.parametrize("path", MODEL_SIDE,
                         ids=[str(p.relative_to(ROOT)) for p in MODEL_SIDE])
def test_the_model_and_the_head_import_nothing_of_the_augmentation(path):
    bad = [m for m in _imports(path) if "augment_kernels" in m]
    assert not bad, bad
