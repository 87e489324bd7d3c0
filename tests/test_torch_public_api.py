"""The JAX package's remaining public helpers in the port, each against
its JAX counterpart: the metrics, the tree arithmetic, EfficientLab's hard
class map, the manifests, the shard count and the native writer's probe,
exactly (inputs on a grid of 1/8 keep every float sum exact); and the
package data a non-editable install must carry."""
import fnmatch
import pathlib
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.data import manifests as jman
from mliis_tpu.data import native_loader as jnative
from mliis_tpu.data import tfrecord as jtfr
from mliis_tpu.models import efficientlab as jlab
from mliis_tpu.ops import meta_math as jmm
from mliis_tpu.ops import metrics as jmet
from mliis_tpu_torch.data import manifests as tman
from mliis_tpu_torch.data import native_loader as tnative
from mliis_tpu_torch.data import tfrecord as ttfr
from mliis_tpu_torch.models import efficientlab as tlab
from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops import meta_math as tmm
from mliis_tpu_torch.ops import metrics as tmet

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _grid(rng, shape):
    """float32 values k / 8, k in 0..8."""
    return (rng.integers(0, 9, shape) / 8.0).astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return out_j, out_t


def _assert_equal(out_j, out_t):
    if isinstance(out_j, tuple):
        for a, b in zip(out_j, out_t):
            _assert_equal(a, b)
        return
    np.testing.assert_array_equal(np.asarray(out_t), np.asarray(out_j))


@pytest.mark.parametrize("kw", [{}, dict(class_channel=None),
                                dict(round_labels=False, epsilon=1e-3)],
                         ids=["fg", "all_channels", "raw_labels"])
def test_hard_iou_matches_jax(kw):
    rng = np.random.default_rng(0)
    for _ in range(5):
        pred, label = _grid(rng, (6, 5, 2)), _grid(rng, (6, 5, 2))
        _assert_equal(*_both(jmet.hard_iou, tmet.hard_iou, pred, label,
                             **kw))


@pytest.mark.parametrize("name,kw", [
    ("soft_iou_flat", {}), ("soft_binary_iou", {}),
    ("soft_binary_iou", dict(foreground_channel=0)),
    ("soft_multiclass_iou", {}),
    ("soft_multiclass_iou", dict(exclude_bg_channel=True))],
    ids=["flat", "binary", "binary_bg", "multiclass", "multiclass_no_bg"])
def test_soft_ious_match_jax(name, kw):
    rng = np.random.default_rng(1)
    shape = (4, 24) if name == "soft_iou_flat" else (4, 3, 2, 2)
    y, y_hat = _grid(rng, shape), _grid(rng, shape)
    _assert_equal(*_both(getattr(jmet, name), getattr(tmet, name), y, y_hat,
                         **kw))


def test_measure_and_iou_img_match_jax():
    rng = np.random.default_rng(2)
    y, pred = _grid(rng, (5, 7)), _grid(rng, (5, 7))
    counts_j, counts_t = _both(jmet.measure, tmet.measure, y, pred,
                               thresh=0.4)
    _assert_equal(counts_j, counts_t)
    tp, _, fp, fn = counts_t
    _assert_equal(jmet.iou_img(*(jnp.asarray(int(v)) for v in
                                 (tp, fp, fn))), tmet.iou_img(tp, fp, fn))
    _assert_equal(jmet.iou_img(0, 0, 0), tmet.iou_img(0, 0, 0))


@pytest.mark.parametrize("weights", [[1.0, 0.0, 0.5], [0.0, 0.0, 0.0]],
                         ids=["masked_slot", "all_masked"])
def test_tree_weighted_mean_and_dot_match_jax(weights):
    rng = np.random.default_rng(3)
    tree = {"a": _grid(rng, (3, 4)), "b": _grid(rng, (3, 2, 2))}
    other = {"a": _grid(rng, (3, 4)), "b": _grid(rng, (3, 2, 2))}
    w = np.asarray(weights, np.float32)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    out_j = jmm.tree_weighted_mean_over_axis(jt, jnp.asarray(w))
    out_t = tmm.tree_weighted_mean_over_axis(tt, torch.from_numpy(w))
    for k in tree:
        _assert_equal(out_j[k], out_t[k])
    _assert_equal(jmm.tree_dot(jt, {k: jnp.asarray(v)
                                    for k, v in other.items()}),
                  tmm.tree_dot(tt, {k: torch.from_numpy(v)
                                    for k, v in other.items()}))


def test_predictions_from_probabilities_match_jax():
    probs = _grid(np.random.default_rng(4), (2, 3, 3, 2))
    for thresh in (0.5, 0.25):
        _assert_equal(*_both(jlab.predictions_from_probabilities,
                             tlab.predictions_from_probabilities, probs,
                             thresh=thresh))


def test_manifests_match_jax():
    for name in ("get_fss_test_set", "get_fss_train_set",
                 "get_fp_k_test_set"):
        assert getattr(tman, name)() == getattr(jman, name)(), name
    assert len(tman.get_fss_train_set()) == 760
    assert len(tman.get_fss_test_set()) == 240


def test_count_examples_in_tfrecords_matches_jax(tmp_path):
    """Two gzip shards (3 and 5 records) and one plain record file."""
    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate((3, 5)):
        path = str(tmp_path / "shard{}.tfrecord.gzip".format(i))
        ttfr.write_segmentation_shard(
            path, rng.integers(0, 256, (n, 4, 4, 3)).astype(np.uint8),
            rng.integers(0, 2, (n, 4, 4)).astype(np.uint8))
        paths.append(path)
    plain = str(tmp_path / "plain.tfrecord")
    ttfr.write_tfrecord_file(plain, [b"a", b"bc"], gzipped=False)
    paths.append(plain)
    assert ttfr.count_examples_in_tfrecords(paths) == \
        jtfr.count_examples_in_tfrecords(paths) == 10


def test_native_writer_probe_matches_jax():
    assert tnative.native_writer_available() == \
        jnative.native_writer_available()


def _package_data():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def _covered(path, package_data):
    """True if a package-data pattern of the package holding `path` (or
    of one above it) matches it."""
    rel = path.relative_to(ROOT)
    for package, patterns in package_data.items():
        base = pathlib.Path(*package.split("."))
        if base in rel.parents:
            inner = rel.relative_to(base).as_posix()
            if any(fnmatch.fnmatch(inner, p) for p in patterns):
                return True
    return False


def test_package_data_names_every_file_the_port_reads():
    """The manifests the port reads and every kernel source and header it
    builds at first use are named by pyproject.toml's package data, so a
    non-editable install carries them."""
    data = _package_data()
    port = ROOT / "mliis_tpu_torch"
    needed = sorted((port / "data").glob("*.txt")) + sorted(
        (port / "csrc").glob("*.cu")) + sorted((port / "csrc").glob("*.cuh"))
    names = {p.name for p in needed}
    assert {"fss_train_set.txt", "fss_test_set.txt",
            "fp-k_test_set.txt"} <= names
    assert {f for s in kernel_library.sources()
            for f in kernel_library.source_files(s)} <= names
    missing = [str(p.relative_to(ROOT)) for p in needed
               if not _covered(p, data)]
    assert not missing, missing
    assert not _covered(ROOT / "mliis_tpu_torch" / "ops" / "augment.py",
                        data)
