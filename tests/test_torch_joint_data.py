"""The joint slice's data, loss and checkpoint modules against the JAX
package's: manifests and the split, the tfrecord codec and the store and
joint-shard loaders, the joint dataset, the sparse CE loss, and
checkpoints written by one package and read by the other."""
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.data import convert as jconvert
from mliis_tpu.data import manifests as jmanifests
from mliis_tpu.data import task_store as jts
from mliis_tpu.data import tfrecord as jtfrecord
from mliis_tpu.data.synthetic import make_synthetic_store as jax_store
from mliis_tpu.joint import trainer as jtrainer
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.utils import checkpoint as jckpt
from mliis_tpu_torch.data import convert as tconvert
from mliis_tpu_torch.data import manifests as tmanifests
from mliis_tpu_torch.data import task_store as tts
from mliis_tpu_torch.data import tfrecord as ttfrecord
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils import checkpoint as tckpt
from tests.torch_tiny_model import TorchTinySeg


def test_manifests_and_split_match_jax():
    """The port's own copies of the three lists give JAX's lists, and the
    reproducible and seeded splits pick the same tasks."""
    assert os.path.dirname(os.path.abspath(tmanifests.__file__)).endswith(
        os.path.join("mliis_tpu_torch", "data"))
    assert tmanifests.TRAIN_TASK_IDS == jmanifests.TRAIN_TASK_IDS
    assert tmanifests.TEST_TASK_IDS == jmanifests.TEST_TASK_IDS
    assert tmanifests.FP_K_TEST_TASK_IDS == jmanifests.FP_K_TEST_TASK_IDS
    assert len(tmanifests.TRAIN_TASK_IDS) == 760
    assert len(tmanifests.TEST_TASK_IDS) == 240
    names = tmanifests.TRAIN_TASK_IDS
    assert tmanifests.split_train_test_tasks(names, 50, True) == \
        jmanifests.split_train_test_tasks(names, 50, True)
    assert tmanifests.split_train_test_tasks(
        names, 7, rng=random.Random(3)) == jmanifests.split_train_test_tasks(
            names, 7, rng=random.Random(3))
    tmanifests.assert_train_test_split(names, tmanifests.TEST_TASK_IDS)
    with pytest.raises(AssertionError):
        tmanifests.assert_train_test_split(names, names[:1])


def _assert_stores_equal(port, ref):
    assert port.names == ref.names
    for field in ("images", "masks", "counts"):
        a, b = getattr(port, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_task_store_loader_matches_jax(tmp_path):
    """Per-task shards written by the JAX codec (tasks of 3 and 5 images,
    an empty shard and an npz task) load to identical stores, with and
    without `max_examples`; subsets and npz round trips agree."""
    store = make_synthetic_store(num_tasks=3, examples_per_task=5,
                                 image_size=16, seed=2)
    for t, n in zip(range(2), (3, 5)):
        jtfrecord.write_segmentation_shard(
            str(tmp_path / "{}.tfrecord.gzip".format(store.names[t])),
            store.images[t, :n], store.masks[t, :n])
    jtfrecord.write_segmentation_shard(str(tmp_path / "empty.tfrecord.gzip"),
                                       store.images[0, :0],
                                       store.masks[0, :0])
    np.savez(str(tmp_path / "{}.npz".format(store.names[2])),
             images=store.images[2, :4], masks=store.masks[2, :4])
    for max_examples in (None, 4):
        port = tts.load_task_store(str(tmp_path), image_size=16,
                                   max_examples=max_examples)
        ref = jts.load_task_store(str(tmp_path), image_size=16,
                                  max_examples=max_examples)
        _assert_stores_equal(port, ref)
    assert port.num_tasks == 3 and port.image_size == 16
    _assert_stores_equal(port.subset([2, 0]), ref.subset([2, 0]))
    names = [port.names[1], port.names[0]]
    _assert_stores_equal(port.subset_by_names(names),
                         ref.subset_by_names(names))
    path = str(tmp_path / "store.npz")
    port.save_npz(path)
    _assert_stores_equal(tts.TaskStore.load_npz(path),
                         jts.TaskStore.load_npz(path))
    assert tts.task_name_from_path("a/bus.tfrecord.gzip") == "bus"
    assert tts.find_task_shards(str(tmp_path)) == jts.find_task_shards(
        str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tts.load_task_store(str(tmp_path / "none"))


def test_joint_shards_and_codec_match_jax(tmp_path):
    """Joint shards of uint16 class maps (ids past 255) written by the JAX
    codec read back identically through the port's `load_joint_shards`;
    a shard the port writes decodes identically in JAX; the CRC matches."""
    rng = np.random.default_rng(0)
    classes = ["class_{:04d}".format(i) for i in range(600)]
    for split, n in (("train_000", 3), ("train_001", 2), ("test_000", 2)):
        jtfrecord.write_segmentation_shard(
            str(tmp_path / "{}.tfrecord.gzip".format(split)),
            rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8),
            rng.integers(0, 600, (n, 8, 8)).astype(np.uint16))
    (tmp_path / "classes.txt").write_text("\n".join(classes) + "\n")
    for split in ("train", "test", "val"):
        port = tconvert.load_joint_shards(str(tmp_path), split, 8)
        ref = jconvert.load_joint_shards(str(tmp_path), split, 8)
        assert port[2] == ref[2] == classes
        for a, b in zip(port[:2], ref[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    images = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    masks = (rng.random((2, 8, 8)) > 0.5).astype(np.uint8) * 255
    path = str(tmp_path / "port.tfrecord.gzip")
    ttfrecord.write_segmentation_shard(path, images, masks)
    for a, b in zip(jtfrecord.read_segmentation_shard(path, 8),
                    (images, masks)):
        np.testing.assert_array_equal(a, b)
    assert ttfrecord.crc32c(b"123456789") == jtfrecord.crc32c(b"123456789") \
        == 0xE3069283


def test_joint_dataset_matches_jax():
    """Identical images, labels and class ids from the same store, with the
    sorted class list and with a given one."""
    port_store = make_synthetic_store(num_tasks=5, examples_per_task=4,
                                      image_size=16, seed=1)
    ref_store = jax_store(num_tasks=5, examples_per_task=4, image_size=16,
                          seed=1)
    sub = [3, 1, 4]
    given = sorted(port_store.names, reverse=True)
    for names in (None, given):
        port = ttrainer.joint_dataset_from_task_store(port_store.subset(sub),
                                                      names)
        ref = jtrainer.joint_dataset_from_task_store(ref_store.subset(sub),
                                                     names)
        assert port.class_names == ref.class_names
        assert port.num_examples == ref.num_examples == 12
        for a, b in ((port.images, ref.images), (port.labels, ref.labels)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert set(np.unique(port.labels)) == {0} | {
        given.index(port_store.names[t]) + 1 for t in sub}


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_sparse_loss_matches_jax(rng, label_smoothing):
    """`F.cross_entropy(label_smoothing=eps)` computes the JAX package's
    (1-eps) CE(label) + eps mean_c CE(c): within 1e-6, on NHWC logits as
    the model returns them (a view of NCHW) and on contiguous NHWC ones."""
    logits = rng.normal(size=(2, 6, 5, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, (2, 6, 5)).astype(np.int32)
    ref = float(jtrainer.sparse_segmentation_loss(
        jnp.asarray(logits), jnp.asarray(labels), label_smoothing))
    nchw = torch.from_numpy(logits.transpose(0, 3, 1, 2).copy())
    for t in (nchw.permute(0, 2, 3, 1), torch.from_numpy(logits)):
        port = float(ttrainer.sparse_segmentation_loss(
            t, torch.from_numpy(labels), label_smoothing))
        assert abs(port - ref) <= 1e-6 * max(1.0, abs(ref)), (port, ref)


def _nested(flat, collection):
    out = {}
    for key, value in flat.items():
        if key.startswith(collection):
            node = out
            parts = key[len(collection):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(value)
    return out


def _jax_state(flat_params, opt_v, step):
    return jil.ModelState(_nested(flat_params, "params/"),
                          _nested(flat_params, "batch_stats/"),
                          jil.OptState(jnp.int32(step),
                                       _nested(opt_v, "opt_v/")))


def _randomized_state(model, opt_name, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.copy_(torch.randn(t.shape, generator=gen))
    state = til.init_model_state(model, til.OptimizerConfig(opt_name))
    v = {k: torch.randn(t.shape, generator=gen) for k, t in
         state.opt.v.items()}
    return state._replace(opt=til.OptState(torch.tensor(7, dtype=torch.int32),
                                           v))


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt_name):
    """A port checkpoint restores through JAX `restore_checkpoint` into a
    JAX template (flax layout): every array equal, the step too."""
    model = TorchTinySeg(n_output_channels=5)
    state = _randomized_state(model, opt_name, 0)
    tckpt.save_checkpoint(str(tmp_path), state, 3)
    flat = tckpt.params_to_jax(model)
    zeros = {k: np.zeros_like(v) for k, v in flat.items()}
    v_flat = {"opt_v/" + k.replace(".", "/"): np.zeros(
        tckpt._to_flax(v).shape, np.float32) for k, v in state.opt.v.items()}
    restored, meta = jckpt.restore_checkpoint(str(tmp_path),
                                              _jax_state(zeros, v_flat, 0))
    assert meta["step"] == 3 and int(restored.opt.step) == 7
    ref = jckpt.flatten_tree(restored.params, "params/")
    ref.update(jckpt.flatten_tree(restored.batch_stats, "batch_stats/"))
    assert set(ref) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(ref[k], flat[k], err_msg=k)
    for k, v in state.opt.v.items():
        np.testing.assert_array_equal(
            jckpt.flatten_tree(restored.opt.v, "")[k.replace(".", "/")],
            tckpt._to_flax(v), err_msg=k)


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A JAX checkpoint of EfficientLab-b0 (n_classes=4) restores through
    the port: in full, equal to what JAX saved; with
    filter_to_scopes=["efficientnet_b0"] only the backbone (params and
    running stats) comes from it; with filter_out_scope the final layer
    keeps the template's. `latest_checkpoint` follows the index file."""
    src = EfficientLab(n_classes=4, rsd=(2,))
    src_state = _randomized_state(src, "sgd", 1)
    flat = tckpt.params_to_jax(src)
    v_flat = {"opt_v/" + k.replace(".", "/"): np.zeros((), np.float32)
              for k in src_state.opt.v}
    for step in (2, 4):
        jckpt.save_checkpoint(str(tmp_path), _jax_state(flat, v_flat, step),
                              step)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith(
        "model.ckpt-4.npz")
    target = EfficientLab(n_classes=4, rsd=(2,))
    template = _randomized_state(target, "sgd", 2)
    full, meta = tckpt.restore_checkpoint(str(tmp_path), template)
    assert meta["step"] == 4 and int(full.opt.step) == 4
    src_tree = dict(src_state.params, **src_state.batch_stats)
    for tree in (full.params, full.batch_stats):
        for k, v in tree.items():
            torch.testing.assert_close(v, src_tree[k], rtol=0, atol=0)

    backbone, _ = tckpt.restore_checkpoint(
        str(tmp_path), template, filter_to_scopes=["efficientnet_b0"])
    tmpl_tree = dict(template.params, **template.batch_stats)
    for tree in (backbone.params, backbone.batch_stats):
        for k, v in tree.items():
            want = src_tree[k] if k.startswith("efficientnet_b0.") \
                else tmpl_tree[k]
            torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    head, _ = tckpt.restore_checkpoint(
        str(tmp_path), template, filter_out_scope="final_layer_weights")
    for k, v in head.params.items():
        want = tmpl_tree[k] if k.startswith("final_layer_weights.") \
            else src_tree[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(
            str(tmp_path), _randomized_state(EfficientLab(n_classes=6,
                                                          rsd=(2,)), "sgd",
                                             3))
