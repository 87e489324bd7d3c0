"""The port's meta-training loop `train_gecko` against the JAX package's.

Both sides meta-train TinySeg (the same weights: tests/torch_tiny_model.py
loads the flax init) for 3 FOMAML* meta-iters on the same synthetic
stores, augmentation and dropout off, the JAX package on its chained step.
The port is handed, through `draw_fn`, the indices that the JAX loop's
key chain draws (one split a meta-step, two more at an interval
evaluation, train.py's order), so both compute the same function in
float32 on the CPU: params, running stats and the optimizer step agree
within 2e-5 abs + 1e-4 rel (the chained step's tolerance). The loop
itself is held to the JAX package's: the meta-step anneal at every iter,
the interval evaluators' protocol, the checkpoint names and rotation, the
best-seen checkpoint's metadata, the deadline and phase_timings.jsonl.
"""
import dataclasses
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import pytest
import torch

import mliis_tpu.meta.train as jtrain
import mliis_tpu_torch.meta.train as ttrain
from mliis_tpu.data.synthetic import make_synthetic_store
from mliis_tpu.meta import episodes as jep
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import learners as jlr
from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.meta import episodes as tep
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_meta import _assert_state_close, _jax_draws, _jax_flat
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG = 16
META = dict(num_shots=6, inner_batch_size=2, inner_iters=3,
            meta_batch_size=3, foml=True, tail_shots=2, augment=False,
            aug_rate=0.5)
LOOP = dict(meta_iters=3, meta_step_size=0.3, meta_step_size_final=0.1,
            eval_interval=2, eval_inner_batch_size=3, eval_inner_iters=2,
            num_eval_shots=5, num_tasks_to_eval=2,
            save_checkpoint_every_n_meta_iters=2, save_best_seen=True,
            lr=0.01)


def _torch_store(store):
    return TaskStore(store.images, store.masks, store.counts, store.names)


def _injected_draws(key, counts, jcfg, n_max, num_tasks, loop):
    """The draws of each meta-iter of the JAX loop's key chain."""
    draws = []
    for i in range(loop.meta_iters):
        key, step_key = jax.random.split(key)
        draws.append(_jax_draws(step_key, counts, jcfg, n_max, num_tasks))
        if i % loop.eval_interval == 0:
            for _ in ("train", "test"):
                key, _ = jax.random.split(key)
    return iter(draws)


def _recording(monkeypatch, module, name, sink):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.append(out)
        return out

    monkeypatch.setattr(module, name, wrapper)


@pytest.fixture(scope="module")
def stores():
    train = make_synthetic_store(num_tasks=6, examples_per_task=10,
                                 image_size=IMG, seed=0)
    test = make_synthetic_store(num_tasks=4, examples_per_task=10,
                                image_size=IMG, seed=1)
    return train, test


def _models():
    jmodel = TinySeg()
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMG,
                                  jil.OptimizerConfig("sgd"))
    tmodel = TorchTinySeg()
    tmodel.load_state_dict(params_from_jax(_jax_flat(jstate)), strict=True)
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    return jmodel, jstate, tmodel, tstate


@pytest.fixture(scope="module")
def runs(stores, tmp_path_factory):
    """Both loops, 3 meta-iters from the same state and stores; returns
    {side: (final state, save dir, log lines, meta-step sizes)}."""
    train, test = stores
    jmodel, jstate, tmodel, tstate = _models()
    jcfg = jlr.MetaTrainConfig(**META)
    jloop = jtrain.TrainLoopConfig(chain_tasks=True, **LOOP)
    root = tmp_path_factory.mktemp("loops")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        sizes = []
        _recording(mp, jtrain, "meta_step_size_schedule", sizes)
        logs = []
        state = jtrain.train_gecko(
            jmodel, jstate, train, test, str(root / "jax"),
            jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg, jloop,
            jax.random.PRNGKey(7), log_fn=logs.append,
            eval_task_chunk_size=2)
        out["jax"] = (state, str(root / "jax"), logs, sizes)
    with pytest.MonkeyPatch.context() as mp:
        sizes = []
        _recording(mp, ttrain, "meta_step_size_schedule", sizes)
        draws = _injected_draws(jax.random.PRNGKey(7),
                                jnp.asarray(train.counts), jcfg, 10,
                                train.num_tasks, jloop)
        logs = []
        state = ttrain.train_gecko(
            tmodel, tstate, _torch_store(train), _torch_store(test),
            str(root / "torch"), til.LossConfig(),
            til.OptimizerConfig("sgd"), tlr.MetaTrainConfig(**META),
            ttrain.TrainLoopConfig(**LOOP), torch.Generator().manual_seed(0),
            log_fn=logs.append, device="cpu",
            draw_fn=lambda *a: next(draws))
        out["torch"] = (state, str(root / "torch"), logs, sizes)
    return out


def test_train_gecko_matches_jax(runs):
    """3 meta-iters with the JAX draws injected: params, running stats and
    the optimizer step within 2e-5 abs + 1e-4 rel."""
    _assert_state_close(runs["torch"][0], runs["jax"][0], atol=2e-5,
                        rtol=1e-4)
    moved = _models()[3]
    assert any(float((runs["torch"][0].params[k] - v).abs().max()) > 1e-4
               for k, v in moved.params.items())


def test_meta_step_anneal_matches_jax(runs):
    """The linear anneal from 0.3 toward 0.1, at every meta-iter."""
    assert runs["torch"][3] == runs["jax"][3]
    assert runs["torch"][3] == pytest.approx([0.3, 0.3 - 0.2 / 3,
                                              0.3 - 0.4 / 3])


def test_checkpoints_and_logs_match_jax(runs):
    """The same files: periodic checkpoints at steps 0 and 2 (rotation to 2
    kept, the last step saved), one best-seen checkpoint under best_eval/
    with its `best_iou` (its step follows each side's evaluation draws),
    the metrics streams and phase_timings.jsonl; the same log lines apart
    from their numbers and the best-seen lines."""
    def shape(lines):
        return [re.sub(r"-?\d+(\.\d*)?([eE][-+]?\d+)?", "#", str(line))
                for line in lines if not str(line).startswith("Highest")]

    names = {side: sorted(os.listdir(runs[side][1])) for side in runs}
    assert names["torch"] == names["jax"]
    assert "model.ckpt-0.npz" in names["torch"]
    assert "model.ckpt-2.npz" in names["torch"]
    best = {side: sorted(os.listdir(os.path.join(runs[side][1],
                                                 "best_eval")))
            for side in runs}
    assert shape(best["torch"]) == shape(best["jax"])
    for side in runs:
        ckpt = [n for n in best[side] if n.endswith(".npz.json")]
        assert len(ckpt) == 1
        with open(os.path.join(runs[side][1], "best_eval", ckpt[0])) as f:
            assert set(json.load(f)) == {"best_iou", "step"}
    assert shape(runs["torch"][2]) == shape(runs["jax"][2])


def test_phase_timings_have_every_phase(runs):
    path = os.path.join(runs["torch"][1], "phase_timings.jsonl")
    with open(path) as f:
        summary = json.loads(f.readline())
    assert set(summary) == {"meta_step", "eval_train", "eval_test"}
    assert summary["meta_step"]["count"] == 3
    assert summary["eval_train"]["count"] == 2


def test_interval_evaluators_inherit_training_protocol(stores, tmp_path,
                                                       monkeypatch):
    """The interval evaluators run the training protocol (replacement, the
    LR scheduler and its decay, weight decay, augmentation and its route),
    field for field as the JAX loop hands it to its evaluators, the chunk
    size and the chunk strategy included."""
    train, test = stores
    jmodel, jstate, tmodel, tstate = _models()
    protocol = dict(num_shots=6, inner_batch_size=3, inner_iters=2,
                    meta_batch_size=2, foml=False, augment=False,
                    replacement=True, lr_scheduler="step_decay",
                    lr_decay_rate=0.25, lr_decay_after_n_steps=1,
                    weight_decay_rate=0.5, pallas_augment=False)
    loop = dict(LOOP, meta_iters=1, eval_interval=5, transductive=True,
                save_best_seen=False)
    captured = {"jax": [], "torch": []}
    for side, module in (("jax", jtrain), ("torch", ttrain)):
        real = module.GeckoEvaluator

        class Capture(real):
            def __init__(self, model, loss_cfg, opt_cfg, eval_cfg, store,
                         _sink=captured[side], **kw):
                _sink.append(eval_cfg)
                super().__init__(model, loss_cfg, opt_cfg, eval_cfg, store,
                                 **kw)

        monkeypatch.setattr(module, "GeckoEvaluator", Capture)
    jtrain.train_gecko(jmodel, jstate, train, test, str(tmp_path / "j"),
                       jil.LossConfig(), jil.OptimizerConfig("sgd"),
                       jlr.MetaTrainConfig(**protocol),
                       jtrain.TrainLoopConfig(chain_tasks=True, **loop),
                       jax.random.PRNGKey(7), log_fn=lambda *a: None,
                       eval_task_chunk_size=1)
    ttrain.train_gecko(tmodel, tstate, _torch_store(train),
                       _torch_store(test), str(tmp_path / "t"),
                       til.LossConfig(), til.OptimizerConfig("sgd"),
                       tlr.MetaTrainConfig(**protocol),
                       ttrain.TrainLoopConfig(chain_tasks=True, **loop),
                       torch.Generator().manual_seed(0),
                       log_fn=lambda *a: None, device="cpu",
                       eval_task_chunk_size=1)
    assert len(captured["torch"]) == len(captured["jax"]) == 2
    for tcfg, jcfg in zip(captured["torch"], captured["jax"]):
        port = dataclasses.asdict(tcfg)
        ref = dataclasses.asdict(jcfg)
        assert port == ref
        assert port["replacement"] and port["pallas_augment"] is False
        assert port["weight_decay_rate"] == 0.5


def test_deadline_stops_the_loop(stores, tmp_path):
    """A deadline in the past ends the loop after its first meta-step, with
    that step's checkpoint written."""
    train, test = stores
    _, _, tmodel, tstate = _models()
    logs = []
    ttrain.train_gecko(tmodel, tstate, _torch_store(train),
                       _torch_store(test), str(tmp_path), til.LossConfig(),
                       til.OptimizerConfig("sgd"),
                       tlr.MetaTrainConfig(**META),
                       ttrain.TrainLoopConfig(**dict(
                           LOOP, meta_iters=50, eval_interval=100,
                           time_deadline=time.time() - 1.0)),
                       torch.Generator().manual_seed(0), log_fn=logs.append,
                       device="cpu")
    assert "Time deadline reached at step 0" in logs
    assert sorted(n for n in os.listdir(str(tmp_path))
                  if n.endswith(".npz")) == ["model.ckpt-0.npz"]


@pytest.mark.parametrize("replacement", [False, True])
def test_zero_step_draws_match_jax(stores, replacement):
    """A FOMAML* task of one inner step (UHO's meta-fine-tune at an estimate
    of 1 step) draws a [0, batch] index matrix, as the JAX package does,
    and the meta-step adapts on the tail alone."""
    jidx = jep.batch_indices(jax.random.PRNGKey(0), 4, 2, 0, replacement)
    tidx = tep.batch_indices(torch.Generator(), 4, 2, 0, replacement)
    assert tuple(tidx.shape) == tuple(jidx.shape) == (0, 2)
    train, _ = stores
    _, _, tmodel, tstate = _models()
    cfg = tlr.MetaTrainConfig(**dict(META, inner_iters=1,
                                     replacement=replacement))
    imgs, msks, counts = _torch_store(train).to_torch("cpu")
    draws = tlr.draw_meta_step(0, counts, cfg, n_max=10)
    out = tlr.make_chained_train_step(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), cfg)(
        tstate, imgs, msks, draws, 1.0, 0.01)
    assert int(out.opt.step) == 1
    assert any(not torch.equal(out.params[k], v)
               for k, v in tstate.params.items())
