"""The port's joint trainer and CLI against the JAX package's, on the tiny
model (tests/tiny_model.py and its torch twin) in float32 on the CPU.

Augmentation, dropout and drop-connect are off and the batch indices are
injected, so both trainers compute the same deterministic steps from the
same weights (`params_from_jax`)."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.joint import trainer as jtrainer
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.utils.checkpoint import flatten_tree
from mliis_tpu_torch.cli import joint_train as tcli
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.ops import augment_kernels
from mliis_tpu_torch.utils import checkpoint as tckpt
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG = 16


def _datasets(num_tasks=4, examples=6, seed=0):
    store = make_synthetic_store(num_tasks=num_tasks,
                                 examples_per_task=examples, image_size=IMG,
                                 seed=seed)
    port = ttrainer.joint_dataset_from_task_store(store)
    ref = jtrainer.JointDataset(port.images, port.labels, port.class_names)
    return port, ref


def _pair(n_out, seed=0):
    """The flax TinySeg's init state and the torch twin carrying it."""
    jmodel = TinySeg(n_output_channels=n_out)
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(seed), IMG,
                                  jil.OptimizerConfig("sgd"))
    flat = flatten_tree(jstate.params, "params/")
    flat.update(flatten_tree(jstate.batch_stats, "batch_stats/"))
    tmodel = TorchTinySeg(n_output_channels=n_out)
    tmodel.load_state_dict(tckpt.params_from_jax(flat), strict=True)
    return jmodel, jstate, tmodel


def test_sgd_steps_and_val_step_match_jax():
    """K=3 SGD steps (batch 4, lr 0.05, label smoothing 0.1, l2) on
    injected batches: losses 1e-5 rel; params and running stats 2e-5 abs +
    1e-4 rel; then the val step's IoU and loss 1e-5 rel."""
    ds, jds = _datasets()
    jmodel, jstate, tmodel = _pair(ds.num_classes + 1)
    kw = dict(batch_size=4, learning_rate=0.05, label_smoothing=0.1,
              augment=False, l2=True)
    jt = jtrainer.JointTrainer(jmodel, jds, jds, jtrainer.JointTrainConfig(
        **kw), jil.OptimizerConfig("sgd"))
    tt = ttrainer.JointTrainer(tmodel, ds, ds, ttrainer.JointTrainConfig(
        **kw), til.OptimizerConfig("sgd"), device="cpu")
    idx = np.random.default_rng(1).integers(0, ds.num_examples, (3, 4))
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    jout, jlosses = jt._train_launch(
        jax.tree_util.tree_map(jnp.copy, jstate), jnp.asarray(idx),
        jax.random.split(jax.random.PRNGKey(2), 3), jnp.float32(0.05))
    opt, tlosses = tstate.opt, []
    for k in range(3):
        opt, loss = tt.train_step(opt, torch.from_numpy(idx[k]), None, 0.05)
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-5)
    ref = tckpt.params_from_jax(dict(
        flatten_tree(jout.params, "params/"),
        **flatten_tree(jout.batch_stats, "batch_stats/")))
    port = dict(tmodel.named_parameters(), **dict(tmodel.named_buffers()))
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().numpy(), ref[k].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    assert int(opt.step) == int(jout.opt.step) == 3

    vidx = np.random.default_rng(3).integers(0, ds.num_examples, (4,))
    jiou, jloss = jt._val_step(jout, jnp.asarray(vidx))
    tiou, tloss = tt.val_step(torch.from_numpy(vidx))
    np.testing.assert_allclose(float(tiou), float(jiou), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_train_step_augments_with_one_launch_route():
    """With `augment` the step routes through `fused_light_augment` (its
    plain version on CPU tensors, so no kernel launch is counted) and
    moves the params; `use_pallas_augment=False` names the plain version."""
    ds, _ = _datasets()
    _, _, tmodel = _pair(ds.num_classes + 1)
    logs = []
    tt = ttrainer.JointTrainer(
        tmodel, ds, ds, ttrainer.JointTrainConfig(batch_size=4),
        device="cpu", log_fn=logs.append)
    assert tt._augment is augment_kernels.fused_light_augment
    assert "plain version" in logs[0] and "cpu" in logs[0]
    start = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    opt = til.init_model_state(tmodel, til.OptimizerConfig("sgd")).opt
    before = augment_kernels.fused_light_augment.launches
    opt, loss = tt.train_step(opt, torch.arange(4),
                              torch.arange(4, dtype=torch.int32), 0.05)
    assert augment_kernels.fused_light_augment.launches == before
    assert bool(torch.isfinite(loss))
    assert any(not torch.equal(v, start[k])
               for k, v in tmodel.named_parameters())
    off = ttrainer.JointTrainer(
        tmodel, ds, ds, ttrainer.JointTrainConfig(use_pallas_augment=False),
        device="cpu", log_fn=logs.append)
    assert off._augment is augment_kernels.fused_light_augment_reference


def test_joint_trainer_learns(tmp_path):
    """The port's copy of the JAX package's learning check (10 epochs x 10
    steps at batch 8, lr 0.05 -> 0.01, augment off): the last val loss is
    below half the initial one, and a checkpoint and the metrics stream are
    written."""
    ds, _ = _datasets(num_tasks=6, examples=10)
    _, _, tmodel = _pair(ds.num_classes + 1)
    cfg = ttrainer.JointTrainConfig(
        batch_size=8, epochs=10, steps_per_epoch=10, learning_rate=0.05,
        final_learning_rate=0.01, augment=False, l2=False, eval_interval=1,
        val_batches=4, steps_per_launch=5, save_checkpoint_every_n_epochs=100)
    tt = ttrainer.JointTrainer(tmodel, ds, ds, cfg, device="cpu")
    state = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    gen = torch.Generator().manual_seed(5)
    _, init_loss = tt.val_step(torch.randint(0, ds.num_examples, (8,),
                                             generator=gen))
    logs = []
    out = tt.train(state, str(tmp_path), torch.Generator().manual_seed(1),
                   log_fn=logs.append)
    losses = [float(m.group(1)) for line in logs
              for m in [re.search(r"\(loss ([0-9.eE+-]+)\)", line)] if m]
    assert len(losses) == cfg.epochs
    assert losses[-1] < 0.5 * float(init_loss), (float(init_loss), losses)
    assert int(out.opt.step) == 100
    assert os.path.exists(tmp_path / "model.ckpt-9.npz")
    with open(tmp_path / "joint_train_metrics.jsonl") as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags.count("step_seconds") == 100 and "val_IoU" in tags


def test_cli_runs_and_checkpoints(tmp_path, capsys):
    """The port's CLI, as tests/test_joint_kshot.py runs the JAX one
    (EfficientLab-b0, --test_on_val_set, 8 synthetic tasks at 16^2, plain
    augmentation), then once with the default route: it prints "Val IoU",
    writes a checkpoint in flax layout that restores into its state, and
    --mesh_data raises."""
    common = ["--synthetic", "--synthetic_tasks", "8", "--image_size", "16",
              "--rsd", "2", "--sgd", "--loss_name", "ce", "--batch_size",
              "4", "--epochs", "1", "--steps_per_epoch", "2",
              "--eval_interval", "1", "--val_batches", "1"]
    tcli.main(common + ["--test_on_val_set", "--num_val_tasks", "2",
                        "--pallas_augment", "off", "--checkpoint",
                        str(tmp_path / "a")], device="cpu")
    out = capsys.readouterr().out
    assert "Val IoU" in out
    assert os.path.exists(tmp_path / "a" / "model.ckpt-0.npz")
    state = tcli.main(common + ["--augment", "--l2", "--checkpoint",
                                str(tmp_path / "b")], device="cpu")
    out = capsys.readouterr().out
    assert "Val IoU" in out and "fused_light_augment" in out
    with np.load(tmp_path / "b" / "model.ckpt-0.npz") as z:
        assert z["params/final_layer_weights/kernel"].shape == (1, 1, 112, 9)
    restored, _ = tckpt.restore_checkpoint(str(tmp_path / "b"), state)
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(common + ["--mesh_data", "2"], device="cpu")


def test_chunked_head_matches_whole(monkeypatch):
    """The train step's CE and the val step, taken a batch chunk at a time
    (here chunks of 3, 3 and 2 images, as the 2^31 cap cuts batch 64 at
    1001 channels, 224^2 into 42 and 22), equal the whole-batch versions:
    loss and gradient within 1e-6 rel, IoU and val loss within 1e-6 rel."""
    ds, _ = _datasets(num_tasks=6, examples=10)
    _, _, tmodel = _pair(ds.num_classes + 1)
    tt = ttrainer.JointTrainer(tmodel, ds, ds, ttrainer.JointTrainConfig(
        batch_size=8), device="cpu")
    idx = torch.arange(8) * 7
    images = tt._images[idx].float()
    labels = tt._labels[idx]
    low, _ = tmodel(images, train=False, upsample=False)
    low = low.detach().requires_grad_(True)
    logits, _ = tmodel(images, train=False)
    whole = ttrainer.sparse_segmentation_loss(logits, labels, 0.1)
    g_whole = torch.autograd.grad(
        ttrainer.resized_cross_entropy(low, labels, 0.1), low)[0]
    iou_whole, val_whole = tt.val_step(idx)
    monkeypatch.setattr(ttrainer, "_MAX_ELEMENTS",
                        3 * (ds.num_classes + 1) * IMG * IMG + 1)
    assert ttrainer._chunk(8, ds.num_classes + 1, IMG, IMG) == 3
    chunked = ttrainer.resized_cross_entropy(low, labels, 0.1)
    g_chunked = torch.autograd.grad(chunked, low)[0]
    np.testing.assert_allclose(float(chunked.detach()), float(whole.detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(g_chunked.numpy(), g_whole.numpy(),
                               rtol=1e-6, atol=1e-12)
    iou, val = tt.val_step(idx)
    np.testing.assert_allclose(float(iou), float(iou_whole), rtol=1e-6)
    np.testing.assert_allclose(float(val), float(val_whole), rtol=1e-6)
