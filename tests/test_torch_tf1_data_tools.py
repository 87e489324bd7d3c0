"""The TF1 import and the data tools against the JAX package: the TF1 name
map and its import into a model, the native tfrecord reader and writer,
the task store's loader, the FSS-1000 converters and the store check.

The TF1-named dicts are built from a model's own paths through
`expected_tf1_names` (the inverse grammar), with depthwise kernels put
back in TF's [kh, kw, C, 1] layout, as tests/test_tf1_totality.py builds
them; no TF installation is needed.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.data import convert as jconvert
from mliis_tpu.data import debug as jdebug
from mliis_tpu.data import native_loader as jnative
from mliis_tpu.data import task_store as jts
from mliis_tpu.meta.inner_loop import ModelState as JModelState
from mliis_tpu.models import tf1_import as jtf1
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu.utils import checkpoint as jckpt
from mliis_tpu_torch.data import convert as tconvert
from mliis_tpu_torch.data import debug as tdebug
from mliis_tpu_torch.data import manifests
from mliis_tpu_torch.data import native_loader as tnative
from mliis_tpu_torch.data import task_store as tts
from mliis_tpu_torch.data import tfrecord as ttfrecord
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.models import tf1_import as ttf1
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_decoders import nested


def _model(scope, rsd, seed):
    model = EfficientLab(feature_extractor_name=scope, rsd=rsd,
                         final_layer_dropout_rate=0.5)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _tf_vars(flat, expected):
    """{tf1 name: array in TF layout} from a flat state and its names."""
    out = {}
    for path, tf_name in expected.items():
        value = flat[path]
        if tf_name.endswith("depthwise_kernel"):
            value = np.transpose(value, (0, 1, 3, 2))
        out[tf_name] = value
    return out


@pytest.mark.parametrize("scope,rsd", [("efficientnet-b0", (2, 4)),
                                       ("efficientnet-b3", (2, 4))],
                         ids=["b0", "b3"])
def test_tf1_import_matches_jax(scope, rsd):
    """b0 (blocks_0 is expand-less) and b3 (136-channel reduction_4, so
    upsample projections): both packages name every leaf alike, convert
    the TF1 dict to the same arrays, import the whole of it, and their
    eval forwards of the imported weights agree within 1e-5."""
    template = _model(scope, rsd, 0)
    flat_t = tckpt.params_to_jax(template)
    source = tckpt.params_to_jax(_model(scope, rsd, 1))
    jparams = nested(flat_t, "params/")
    jstats = nested(flat_t, "batch_stats/")
    expected = ttf1.expected_tf1_names(flat_t, scope)
    assert expected == jtf1.expected_tf1_names(jparams, jstats, scope)
    tf_vars = _tf_vars(source, expected)

    ours = ttf1.convert_tf1_vars(
        tf_vars, backbone_scope=scope,
        target_paths=ttf1.flat_state_paths(flat_t))
    ref = jtf1.convert_tf1_vars(
        tf_vars, backbone_scope=scope,
        target_paths=jtf1.flat_state_paths(jparams, jstats))
    ttf1.assert_complete_import(ours, flat_t)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    no_target = ttf1.convert_tf1_vars(tf_vars, backbone_scope=scope)
    assert sorted(no_target) == sorted(jtf1.convert_tf1_vars(
        tf_vars, backbone_scope=scope))

    tstate = tckpt.import_tf1_var_map(
        ours, til.init_model_state(template, til.OptimizerConfig()),
        lambda n: n)
    jstate = jckpt.import_tf1_var_map(
        ref, JModelState(jparams, jstats, None), lambda n: n)
    model = EfficientLab(feature_extractor_name=scope, rsd=rsd)
    til.load_state(model, tstate)
    assert tckpt.params_to_jax(model).keys() == source.keys()
    for k, v in tckpt.params_to_jax(model).items():
        np.testing.assert_array_equal(v, source[k], err_msg=k)
    images = np.random.default_rng(0).uniform(
        0, 255, (2, 32, 32, 3)).astype(np.float32)
    jmodel = JaxEfficientLab(feature_extractor_name=scope, rsd=rsd)
    jlog, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(images))
    with torch.no_grad():
        tlog, _ = model(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=0)


def test_depthwise_kernel_takes_the_ports_layout():
    """A TF depthwise kernel [kh, kw, C, 1] lands as [C, 1, kh, kw], each
    channel's taps in place."""
    template = _model("efficientnet-b0", (2,), 0)
    state = til.init_model_state(template, til.OptimizerConfig())
    name = "efficientnet-b0/blocks_1/depthwise_conv2d/depthwise_kernel"
    kernel = np.arange(3 * 3 * 96, dtype=np.float32).reshape(3, 3, 96, 1)
    converted = ttf1.convert_tf1_vars({name: kernel})
    out = tckpt.import_tf1_var_map(converted, state, lambda n: n)
    got = out.params["efficientnet_b0.blocks_1.depthwise_conv.kernel"]
    assert tuple(got.shape) == (96, 1, 3, 3)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  kernel[..., 0].transpose(2, 0, 1))


@pytest.mark.parametrize("name", [
    "efficientnet-b0/blocks_0/tpu_batch_normalization/gamma",
    "efficientnet-b0/blocks_0/conv2d/kernel",
    "efficientnet-b0/blocks_1/tpu_batch_normalization_2/moving_variance",
    "decode/decode_skip_connections_3/conv2d/kernel",
    "decode/decode_skip_connections_1/batch_normalization_3/beta",
    "decode/final_layer_weights/bias",
    "efficientnet-b0/blocks_1/conv2d/kernel/ExponentialMovingAverage",
])
def test_map_tf1_name_matches_jax(name):
    """The expand-less block's shifted numbering and the EMA names map as
    in the JAX package, with and without the target paths."""
    flat = tckpt.params_to_jax(_model("efficientnet-b0", (2, 4), 0))
    jpaths = jtf1.flat_state_paths(nested(flat, "params/"),
                                   nested(flat, "batch_stats/"))
    assert ttf1.flat_state_paths(flat) == jpaths
    assert ttf1.map_tf1_name(name, target_paths=ttf1.flat_state_paths(
        flat)) == jtf1.map_tf1_name(name, target_paths=jpaths)
    assert ttf1.map_tf1_name(name) == jtf1.map_tf1_name(name)


def _store_arrays(n=3, size=16, seed=0):
    store = make_synthetic_store(num_tasks=n, examples_per_task=6,
                                 image_size=size, seed=seed)
    counts = np.array([6, 4, 0][:n])
    images = np.concatenate([store.images[i, :c]
                             for i, c in enumerate(counts)])
    masks = np.concatenate([store.masks[i, :c] for i, c in enumerate(counts)])
    return store, images, masks, counts


@pytest.mark.parametrize("native", [True, False])
def test_native_loader_round_trip(tmp_path, monkeypatch, native):
    """write_shards then read_shards (the native library, and the Python
    codec in its place) equal the Python codec's arrays, the JAX package's
    native reader and the examples written; an empty shard reads as 0."""
    assert tnative.native_loader_available()
    if not native:
        monkeypatch.setattr(tnative, "_load_library", lambda: None)
    assert tnative.reader_name() == ("native" if native else "Python")
    _, images, masks, counts = _store_arrays()
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    paths = [str(tmp_path / "t{}.tfrecord.gzip".format(i)) for i in range(3)]
    tnative.write_shards(paths, images, masks, offsets, counts)
    got = tnative.read_shards(paths, 16, 6)
    ref = jnative.read_shards(paths, 16, 6)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2], counts)
    for i, path in enumerate(paths):
        assert tnative.count_examples(path) == counts[i]
        imgs, msks = ttfrecord.read_segmentation_shard(path, 16)
        lo, hi = offsets[i], offsets[i] + counts[i]
        np.testing.assert_array_equal(imgs, images[lo:hi])
        np.testing.assert_array_equal(msks, masks[lo:hi])
        np.testing.assert_array_equal(got[0][i, :counts[i]], imgs)
    single = str(tmp_path / "one.tfrecord.gzip")
    tnative.write_shard(single, images[:2], masks[:2])
    np.testing.assert_array_equal(
        ttfrecord.read_segmentation_shard(single, 16)[0], images[:2])


def test_load_task_store_matches_jax(tmp_path, capsys):
    """tfrecord and npz shards, an empty shard skipped: the same store as
    the JAX package's loader, and the reader named."""
    store, images, masks, counts = _store_arrays()
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    paths = [str(tmp_path / "{}.tfrecord.gzip".format(n))
             for n in store.names]
    tnative.write_shards(paths, images, masks, offsets, counts)
    np.savez(tmp_path / "z_extra.npz", images=images[:3], masks=masks[:3])
    ours = tts.load_task_store(str(tmp_path), image_size=16)
    assert "with the native reader" in capsys.readouterr().out
    ref = jts.load_task_store(str(tmp_path), image_size=16)
    assert ours.names == ref.names and len(ours.names) == 3
    for a, b in ((ours.images, ref.images), (ours.masks, ref.masks),
                 (ours.counts, ref.counts)):
        np.testing.assert_array_equal(a, b)


def _fss_dir(root):
    """Three FSS-1000-style class directories written with PIL: a test
    class, a grayscale image, a three-channel mask, a wrong-sized image
    and an image without its mask."""
    from PIL import Image
    rng = np.random.default_rng(0)
    classes = [manifests.TEST_TASK_IDS[0], "aaa_train", "zzz_train"]
    for c, name in enumerate(classes):
        d = root / name
        d.mkdir(parents=True)
        for i in range(1, 4):
            img = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
            msk = (rng.random((24, 24)) > 0.5).astype(np.uint8) * 255
            if c == 1 and i == 1:
                Image.fromarray(img[..., 0]).save(d / "1.jpg")
            else:
                Image.fromarray(img).save(d / "{}.jpg".format(i))
            if c == 2 and i == 2:
                Image.fromarray(np.stack([msk] * 3, -1)).save(d / "2.png")
            else:
                Image.fromarray(msk).save(d / "{}.png".format(i))
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
                        ).save(d / "4.jpg")
        Image.fromarray(np.zeros((20, 24), np.uint8)).save(d / "4.png")
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
                        ).save(d / "5.jpg")
    return classes


@pytest.mark.parametrize("fmt", ["tfrecord", "npz"])
def test_fss_1000_converter_matches_jax(tmp_path, fmt):
    """Per-task shards: the same files holding the same arrays as the JAX
    package's converter writes."""
    _fss_dir(tmp_path / "fss")
    ours = tconvert.convert_fss_1000(str(tmp_path / "fss"),
                                     str(tmp_path / "t"), fmt, 24,
                                     num_workers=1)
    ref = jconvert.convert_fss_1000(str(tmp_path / "fss"),
                                    str(tmp_path / "j"), fmt, 24,
                                    num_workers=1)
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in ref] and len(ours) == 3
    a = tts.load_task_store(str(tmp_path / "t"), image_size=24)
    b = jts.load_task_store(str(tmp_path / "j"), image_size=24)
    np.testing.assert_array_equal(a.counts, [3, 3, 3])
    for x, y in ((a.images, b.images), (a.masks, b.masks),
                 (a.counts, b.counts)):
        np.testing.assert_array_equal(x, y)


def test_fss_1000_joint_converter_matches_jax(tmp_path):
    """Joint shards: the same split files, class list and class-index
    maps as the JAX package's."""
    classes = _fss_dir(tmp_path / "fss")
    kw = dict(num_val_tasks=1, examples_per_shard=2, image_dims=24,
              num_workers=1)
    ours = tconvert.convert_fss_1000_joint(str(tmp_path / "fss"),
                                           str(tmp_path / "t"), **kw)
    ref = jconvert.convert_fss_1000_joint(str(tmp_path / "fss"),
                                          str(tmp_path / "j"), **kw)
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in ref]
    for split in ("train", "val", "test"):
        a = tconvert.load_joint_shards(str(tmp_path / "t"), split, 24)
        b = jconvert.load_joint_shards(str(tmp_path / "j"), split, 24)
        assert a[2] == b[2] == sorted(classes)
        assert a[0].shape[0] == 3
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("fault", [None, "values", "empty"])
def test_check_task_store_matches_jax(fault):
    """A good store passes; one with a non-binary mask value or a task
    without examples fails; both packages say the same lines."""
    store = make_synthetic_store(num_tasks=3, examples_per_task=4,
                                 image_size=8, seed=0)
    if fault == "values":
        store.masks[1, 2, 0, 0] = 7
    elif fault == "empty":
        store.counts[2] = 0
    lines = ([], [])
    ours = tdebug.check_task_store(store, log_fn=lines[0].append)
    ref = jdebug.check_task_store(
        jts.TaskStore(store.images, store.masks, store.counts, store.names),
        log_fn=lines[1].append)
    assert ours is ref is (fault is None)
    assert lines[0] == lines[1]


def test_plot_mask_picks_the_first_nonzero_channel(tmp_path):
    mask = np.zeros((8, 8, 3), np.float32)
    mask[2, 2, 1] = 1
    kw = dict(show=False)
    assert tdebug.plot_mask(mask, save_path=str(tmp_path / "m.png"),
                            **kw) == jdebug.plot_mask(mask, **kw) == 1
    assert os.path.exists(tmp_path / "m.png")
    assert tdebug.plot_mask(mask[..., 0], **kw) == -1
