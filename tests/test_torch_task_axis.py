"""The port's task axis (`models/layers.task_axis`): T tasks computed in
one forward, backward and augmentation launch, held against T one-task
runs of the port and against the JAX package's vmapped strategies.

- The layers, EfficientLab's ASPP and skip decoding, and `augment_batches`
  under a task axis of 3 against three separate calls: the same draws
  from the same generators, so the differences are float rounding
  (augmentation bit-exact).
- The batched meta-step (`learners.make_train_step`) and the microbatched
  one against `mliis_tpu.meta.learners`' with the JAX key discipline's
  draws injected, augmentation and dropout off, at the chained test's bar
  (tests/test_torch_meta.py): 2e-5 abs + 1e-4 rel.
- The batched step against the port's chained step with augmentation,
  dropout and drop-connect on, the same slot generators: 1e-5.
- The batched evaluation chunk against JAX's vmapped episode and the
  port's chained chunk; `run_metasegnet` with each strategy flag.
"""
import contextlib
import dataclasses
import io
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import evaluate as jev
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import learners as jlr
from mliis_tpu_torch.cli import args as targs
from mliis_tpu_torch.cli import run_metasegnet
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import episodes as tep
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.meta import train as ttrain
from mliis_tpu_torch.models import layers
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops import augment as taug
from mliis_tpu_torch.parallel import mesh as mesh_lib
from tests.test_torch_evaluate import _jax_draws as _jax_episode_draws
from tests.test_torch_meta import (IMAGE, _assert_state_close, _jax_draws,
                                   tiny)  # noqa: F401 (the fixture)

T = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's tests on one intra-op thread, restored after: the
    suite runs files in parallel workers, and these EfficientLab steps
    would otherwise claim every core beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _generators(seed, n=T):
    return [torch.Generator().manual_seed(seed + t) for t in range(n)]


def _task_params(module, seed):
    """T sets of the module's params and buffers: its own, perturbed by a
    different draw for each task (positive where a variance must be)."""
    g = torch.Generator().manual_seed(seed)
    sets = []
    for _ in range(T):
        tree = {}
        for k, v in list(module.named_parameters()) + list(
                module.named_buffers()):
            noise = 0.2 * torch.randn(v.shape, generator=g)
            tree[k] = (v.detach() * (1.0 + noise.abs()) if k.endswith("var")
                       else v.detach() + noise)
        sets.append(tree)
    return sets


def _stack(trees):
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _fold(xs):
    """T NCHW maps -> the folded [B, T*C, H, W]."""
    b, c, h, w = xs[0].shape
    return torch.stack(xs, dim=1).reshape(b, len(xs) * c, h, w)


def _unfold(x, t):
    b, tc, h, w = x.shape
    return x.reshape(b, t, tc // t, h, w)


def _call(module, tree, *args, **kwargs):
    return torch.func.functional_call(module, tree, args, kwargs)


def _relative_gap(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / float(b.abs().max())


def _state_gap(a, b):
    trees = [(a.params, b.params), (a.batch_stats, b.batch_stats)]
    return max(float((x[k] - y[k]).abs().max()) for x, y in trees
               for k in x)


CONVS = {
    "3x3": dict(in_features=4, features=6, kernel_size=3),
    "5x5_stride2": dict(in_features=4, features=6, kernel_size=5, stride=2),
    "depthwise": dict(in_features=6, features=6, kernel_size=3, groups=6,
                      use_bias=False),
    "1x1_dilated": dict(in_features=6, features=5, kernel_size=3,
                        dilation=2),
    "1x1": dict(in_features=5, features=7, kernel_size=1),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_under_task_axis_matches_separate_calls(name):
    """A conv over the folded map with stacked kernels (T x the groups)
    equals each task's conv with its own kernel, within 1e-6 of the
    output's largest magnitude (a grouped conv sums in another order)."""
    conv = layers.Conv2d(**CONVS[name])
    conv.reset_parameters(torch.Generator().manual_seed(0))
    trees = _task_params(conv, 1)
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(2, conv.kernel.shape[1] * conv.groups, 9, 9,
                      generator=g) for _ in range(T)]
    with layers.task_axis(T):
        out = _unfold(_call(conv, _stack(trees), _fold(xs)), T)
    for t in range(T):
        ref = _call(conv, trees[t], xs[t])
        assert float((out[:, t] - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max())


@pytest.mark.parametrize("train,always", [(True, False), (False, False),
                                          (False, True)],
                         ids=["train", "eval", "batch_stats_eval"])
def test_batch_norm_under_task_axis_matches_separate_calls(train, always):
    """Per-task moments, scale and bias, and (in training) per-task
    running stats updated in the stacked buffers, within 1e-6."""
    bn = layers.FusedBatchNorm(5, always_batch_stats=always)
    trees = _task_params(bn, 3)
    g = torch.Generator().manual_seed(4)
    xs = [3.0 * torch.randn(4, 5, 6, 6, generator=g) + t for t in range(T)]
    stacked = _stack(trees)
    with layers.task_axis(T):
        out = _unfold(_call(bn, stacked, _fold(xs), train), T)
    for t in range(T):
        own = {k: v.clone() for k, v in trees[t].items()}
        ref = _call(bn, own, xs[t], train)
        np.testing.assert_allclose(out[:, t].numpy(), ref.numpy(),
                                   atol=1e-6, rtol=0)
        for k in ("mean", "var"):
            np.testing.assert_allclose(stacked[k][t].numpy(),
                                       own[k].numpy(), atol=1e-6, rtol=0)
        if not train:
            assert torch.equal(stacked["mean"][t], trees[t]["mean"])


def test_drop_connect_and_dropout_draw_each_task_from_its_generator():
    """Each task's drop-connect and dropout masks come from its own
    generator at one task's shape: bit for bit the one-task call's."""
    g = torch.Generator().manual_seed(5)
    xs = [torch.randn(4, 3, 5, 5, generator=g) for _ in range(T)]
    for fn, rate in ((layers.drop_connect, 0.4),
                     (layers.traced_dropout, 0.3)):
        with layers.task_axis(T):
            out = _unfold(fn(_generators(10), _fold(xs), rate), T)
        for t, gen in enumerate(_generators(10)):
            assert torch.equal(out[:, t], fn(gen, xs[t], rate)), fn.__name__


def test_task_cat_keeps_each_tasks_channels():
    """`layers.cat` on folded maps is each task's own channel concat."""
    g = torch.Generator().manual_seed(6)
    a = [torch.randn(2, 3, 4, 4, generator=g) for _ in range(T)]
    b = [torch.randn(2, 5, 4, 4, generator=g) for _ in range(T)]
    with layers.task_axis(T):
        out = _unfold(layers.cat([_fold(a), _fold(b)]), T)
    for t in range(T):
        assert torch.equal(out[:, t], torch.cat([a[t], b[t]], dim=1))
    assert torch.equal(layers.cat([a[0], b[0]]), torch.cat([a[0], b[0]], 1))


def _world_of_one(tmp_path, monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return mesh_lib.world(1, "cpu", str(tmp_path))


def test_sync_bn_under_task_axis_equals_one_task_forwards(tmp_path,
                                                          monkeypatch):
    """A sync-BN batch norm (axis "data") under a task axis of 3, in a
    world of 1 on a data mesh of 1: each task's output and updated running
    stats equal its one-task sync-BN forward's within 1e-6 (the stacked
    [2, T*C] moments pass one all-reduce)."""
    bn = layers.FusedBatchNorm(5, axis_name="data")
    trees = _task_params(bn, 3)
    g = torch.Generator().manual_seed(4)
    xs = [3.0 * torch.randn(4, 5, 6, 6, generator=g) + t for t in range(T)]
    stacked = _stack(trees)
    with _world_of_one(tmp_path, monkeypatch) as dev, mesh_lib.bound(
            mesh_lib.make_data_mesh(1, dev)):
        with layers.task_axis(T):
            out = _unfold(_call(bn, stacked, _fold(xs), True), T)
        for t in range(T):
            own = {k: v.clone() for k, v in trees[t].items()}
            ref = _call(bn, own, xs[t], True)
            np.testing.assert_allclose(out[:, t].numpy(), ref.numpy(),
                                       atol=1e-6, rtol=0)
            for k in ("mean", "var"):
                np.testing.assert_allclose(stacked[k][t].numpy(),
                                           own[k].numpy(), atol=1e-6,
                                           rtol=0)


def test_batched_adapt_on_a_data_axis_of_one(tiny, tmp_path, monkeypatch):
    """`make_batched_adapt_fn(data_shard=)` with the sync-BN TinySeg on a
    data axis of 1 (world of 1), augmentation on: the same adaptation as
    without a shard, within 1e-6; with `precompute_augment` it refuses, as
    the JAX package's adapt does."""
    _, _, tmodel, tstate = tiny
    synced = mesh_lib.sync_bn_copy(tmodel)
    g = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (T, 6, IMAGE, IMAGE, 3), generator=g
                         ).to(torch.uint8)
    msks = ((torch.rand(T, 6, IMAGE, IMAGE, generator=g) > 0.5)
            .to(torch.uint8) * 255)
    idx = torch.randint(0, 6, (T, 3, 4), generator=g)
    args = (til.stack_states([tstate] * T), imgs, msks, idx)
    ref, _ = til.make_batched_adapt_fn(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"))(
        *args, _generators(60), [0.05] * 3, aug_rate=1.0)
    shard = til.DataShardSpec(mesh_lib.DATA_AXIS, 1)
    with _world_of_one(tmp_path, monkeypatch) as dev, mesh_lib.bound(
            mesh_lib.make_data_mesh(1, dev)):
        out, _ = til.make_batched_adapt_fn(
            synced, til.LossConfig(), til.OptimizerConfig("sgd"),
            data_shard=shard)(*args, _generators(60), [0.05] * 3,
                              aug_rate=1.0)
    assert _state_gap(out, ref) <= 1e-6
    with pytest.raises(ValueError):
        til.make_batched_adapt_fn(synced, til.LossConfig(),
                                  til.OptimizerConfig("sgd"),
                                  precompute_augment=True, data_shard=shard)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_augment_batches_slices_each_tasks_whole_batch_draws(route,
                                                             monkeypatch):
    """A data shard's rows [2, 4) of 3 tasks' batches of 4, augmented with
    `key_offset=2, key_total=4`: bit for bit those rows of the whole
    batches' augmentation from the same generators."""
    if route == "split":
        monkeypatch.setattr(taug, "PALLAS_FUSED_SINGLE_LAUNCH", False)
    g = torch.Generator().manual_seed(8)
    images = torch.randint(0, 256, (T, 4, 16, 16, 3), generator=g).float()
    masks = tep.onehot_mask((torch.rand(T, 4, 16, 16, generator=g) > 0.5)
                            .to(torch.uint8) * 255)
    whole_i, whole_m = taug.augment_batches(_generators(90), images, masks,
                                            0.2)
    part_i, part_m = taug.augment_batches(
        _generators(90), images[:, 2:], masks[:, 2:], 0.2, key_offset=2,
        key_total=4)
    assert torch.equal(part_i, whole_i[:, 2:])
    assert torch.equal(part_m, whole_m[:, 2:])


@pytest.mark.parametrize("route", ["fused", "split", "non_square"])
def test_augment_batches_equals_one_call_a_task(route, monkeypatch):
    """`augment_batches` with 3 generators gives, bit for bit, what three
    `augment_batch` calls give, on the fused route (one `full_pass` over
    the 3 x 4 samples), the split route (two `cheap_pass` and one
    rotation) and non-square planes (split)."""
    if route == "split":
        monkeypatch.setattr(taug, "PALLAS_FUSED_SINGLE_LAUNCH", False)
    h, w = (24, 32) if route == "non_square" else (32, 32)
    g = torch.Generator().manual_seed(7)
    images = torch.randint(0, 256, (T, 4, h, w, 3), generator=g).float()
    masks = tep.onehot_mask((torch.rand(T, 4, h, w, generator=g) > 0.5)
                            .to(torch.uint8) * 255)
    out_i, out_m = taug.augment_batches(_generators(20), images, masks, 0.2)
    for t, gen in enumerate(_generators(20)):
        ref_i, ref_m = taug.augment_batch(gen, images[t], masks[t], 0.2)
        assert torch.equal(out_i[t], ref_i) and torch.equal(out_m[t], ref_m)
    assert not torch.equal(out_i, images)


@pytest.mark.parametrize("precompute", [False, True],
                         ids=["in_loop", "precomputed"])
def test_batched_adapt_equals_one_adapt_a_task(tiny, precompute):
    """`make_batched_adapt_fn` on 3 tasks (TinySeg, 3 augmented steps at
    rate 1, dropout 0.3) against `make_adapt_fn` on each task with the
    same generator, in-loop and with the batches precomputed (bf16-staged):
    each task's params, running stats and losses within 1e-6."""
    _, _, tmodel, tstate = tiny
    g = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (T, 6, IMAGE, IMAGE, 3), generator=g
                         ).to(torch.uint8)
    msks = ((torch.rand(T, 6, IMAGE, IMAGE, generator=g) > 0.5)
            .to(torch.uint8) * 255)
    idx = torch.randint(0, 6, (T, 3, 4), generator=g)
    kw = dict(precompute_augment=precompute)
    batched, losses = til.make_batched_adapt_fn(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), **kw)(
        til.stack_states([tstate] * T), imgs, msks, idx, _generators(60),
        [0.05] * 3, drop_rate=0.3, aug_rate=1.0)
    adapt = til.make_adapt_fn(tmodel, til.LossConfig(),
                              til.OptimizerConfig("sgd"), **kw)
    for t, (out, gen) in enumerate(zip(til.unstack_states(batched),
                                       _generators(60))):
        ref, ref_losses = adapt(tstate, imgs[t], msks[t], idx[t], gen,
                                [0.05] * 3, drop_rate=0.3, aug_rate=1.0)
        assert _state_gap(out, ref) <= 1e-6
        np.testing.assert_allclose(losses[t].numpy(), ref_losses.numpy(),
                                   rtol=1e-6)
    assert int(batched.opt.step) == 3


def _store():
    return make_synthetic_store(num_tasks=4, examples_per_task=8,
                                image_size=IMAGE, seed=0)


def _jax_step_inputs(store):
    return (jnp.asarray(store.images), jnp.asarray(store.masks),
            jnp.asarray(store.counts))


@pytest.mark.parametrize("foml,tail_shots", [(True, 2), (True, None),
                                             (False, None)],
                         ids=["fomaml_star", "fomaml", "reptile"])
def test_batched_meta_step_matches_jax_vmapped_step(tiny, foml, tail_shots):
    """`learners.make_train_step` (3 tasks x 4 inner steps on a task axis,
    the last on the raw tail for FOMAML*; augment and dropout off) against
    the JAX package's vmapped `make_train_step` from the same state with
    its draws injected: params, running stats and the step count within
    2e-5 abs + 1e-4 rel."""
    jmodel, jstate, tmodel, tstate = tiny
    store = _store()
    kw = dict(num_shots=6, inner_batch_size=2, inner_iters=4,
              meta_batch_size=3, foml=foml, tail_shots=tail_shots,
              augment=False, aug_rate=0.5)
    jcfg, tcfg = jlr.MetaTrainConfig(**kw), tlr.MetaTrainConfig(**kw)
    key = jax.random.PRNGKey(5)
    jout = jax.jit(jlr.make_train_step(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg,
        n_max=8))(jstate, *_jax_step_inputs(store), key, jnp.float32(0.5),
                  jnp.float32(0.05))
    draws = _jax_draws(key, jnp.asarray(store.counts), jcfg, 8, 4)
    make = tlr.make_fomaml_train_step if foml else \
        tlr.make_reptile_train_step
    tout = make(tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), tcfg)(
        tstate, torch.from_numpy(store.images),
        torch.from_numpy(store.masks), draws, 0.5, 0.05)
    _assert_state_close(tout, jout, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("pad_tail", [False, True],
                         ids=["ragged", "padded"])
def test_microbatched_step_matches_jax(tiny, pad_tail):
    """A meta-batch of 5 in groups of 2 (2 + 2 + 1, the tail ragged or
    padded) against the JAX package's `make_microbatched_train_step`, each
    group's draws those of its `fold_in(key, g)` injected into its slots:
    within 2e-5 abs + 1e-4 rel."""
    jmodel, jstate, tmodel, tstate = tiny
    store = _store()
    kw = dict(num_shots=6, inner_batch_size=2, inner_iters=3,
              meta_batch_size=5, foml=True, tail_shots=2, augment=False)
    jcfg, tcfg = jlr.MetaTrainConfig(**kw), tlr.MetaTrainConfig(**kw)
    key = jax.random.PRNGKey(9)
    jout = jlr.make_microbatched_train_step(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg, n_max=8,
        group_size=2, pad_tail=pad_tail)(
        jstate, *_jax_step_inputs(store), key, jnp.float32(0.5),
        jnp.float32(0.05))
    ids, tasks = [], []
    for g, size in enumerate((2, 2, 1)):
        part = _jax_draws(jax.random.fold_in(key, g),
                          jnp.asarray(store.counts),
                          dataclasses.replace(jcfg, meta_batch_size=size),
                          8, 4)
        ids.append(part.task_ids)
        tasks += part.tasks
    draws = tlr.MetaStepDraws(torch.cat(ids), tasks, _generators(30, 5))
    tout = tlr.make_microbatched_train_step(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), tcfg,
        group_size=2, pad_tail=pad_tail)(
        tstate, torch.from_numpy(store.images),
        torch.from_numpy(store.masks), draws, 0.5, 0.05)
    _assert_state_close(tout, jout, atol=2e-5, rtol=1e-4)


# EfficientLab's float32 batch norms amplify rounding where a channel's
# batch is small: at 32^2 the deepest maps are 2 x 2, and a grouped conv's
# other order of sums moves a 3-step adaptation at lr 0.05 by 0.14 (its
# change: 1.04). At 64^2, batch 4 and the benchmark's lr 5e-4 the gap is
# 2.8e-7, so these tests run there.
LAB_SIZE, LAB_LR = 64, 5e-4


def test_sharded_step_runs_its_slots_on_a_task_axis(tiny, tmp_path,
                                                    monkeypatch):
    """`make_sharded_train_step` on a task mesh of 1 runs the rank's slots
    on a task axis (the JAX package's vmap of them) unless `chain_local`:
    TinySeg, FOMAML* with augmentation on, 3 tasks x 4 steps; both forms
    within 1e-6 of the chained step (the same draws)."""
    _, _, tmodel, tstate = tiny
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    store = _store()
    imgs, msks, counts = store.to_torch("cpu")
    cfg = tlr.MetaTrainConfig(num_shots=6, inner_batch_size=2, inner_iters=4,
                              meta_batch_size=3, foml=True, tail_shots=2,
                              aug_rate=0.9)
    opt = til.OptimizerConfig("sgd")
    ref = tlr.make_chained_train_step(tmodel, til.LossConfig(), opt, cfg)(
        tstate, imgs, msks, tlr.draw_meta_step(2, counts, cfg, 8), 0.5, 0.05)
    with mesh_lib.world(1, "cpu", str(tmp_path)) as dev:
        mesh = mesh_lib.make_task_mesh(1, dev)
        for chain_local in (False, True):
            out = mesh_lib.make_sharded_train_step(
                tmodel, til.LossConfig(), opt, cfg, mesh,
                chain_local=chain_local)(
                tstate, imgs, msks, tlr.draw_meta_step(2, counts, cfg, 8),
                0.5, 0.05)
            assert _state_gap(out, ref) <= 1e-6, chain_local
    assert _state_gap(ref, tstate) > 1e-3


def _lab(seed=0, **kw):
    """EfficientLab-b0 rsd (2,) with final dropout 0.5 and its default
    drop-connect 0.2, weights from `seed`."""
    model = EfficientLab(rsd=(2,), final_layer_dropout_rate=0.5, **kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("strategy", ["batched", "microbatched"])
def test_task_axis_steps_equal_chained_step_with_every_draw_on(strategy):
    """EfficientLab-b0 at 64^2, FOMAML* (3 tasks x 2 steps at batch 4, the
    second on the raw tail of 2; lr 5e-4), augmentation (rate 0.9), final
    dropout and drop-connect on: the batched step, and the microbatched
    one in groups of 2, from the same state and slot generators as the
    chained step draw the same, so every param and running stat agrees
    within 1e-5."""
    model = _lab()
    store = make_synthetic_store(num_tasks=4, examples_per_task=8,
                                 image_size=LAB_SIZE, seed=1)
    imgs, msks, counts = (torch.from_numpy(a) for a in (
        store.images, store.masks, store.counts))
    cfg = tlr.MetaTrainConfig(num_shots=6, inner_batch_size=4, inner_iters=2,
                              meta_batch_size=3, foml=True, tail_shots=2,
                              aug_rate=0.9)
    opt = til.OptimizerConfig("sgd")
    state = til.init_model_state(model, opt)
    if strategy == "batched":
        step = tlr.make_train_step(model, til.LossConfig(), opt, cfg)
    else:
        step = tlr.make_microbatched_train_step(model, til.LossConfig(), opt,
                                                cfg, group_size=2)
    chained = tlr.make_chained_train_step(model, til.LossConfig(), opt, cfg)
    out = step(state, imgs, msks, tlr.draw_meta_step(11, counts, cfg, 8),
               0.5, LAB_LR)
    ref = chained(state, imgs, msks, tlr.draw_meta_step(11, counts, cfg, 8),
                  0.5, LAB_LR)
    assert _state_gap(out, ref) <= 1e-5
    assert _state_gap(ref, state) > 1e-3
    assert int(out.opt.step) == int(ref.opt.step) == 2


def test_batched_episodes_match_jax_vmapped_episodes(tiny):
    """Three evaluation episodes on a task axis
    (`make_batched_adapt_and_predict_fn`, transductive, augment and dropout
    off) against the JAX package's episode vmapped over the same tasks
    and keys (its evaluator's chunk), the draws injected: the query
    probabilities within 1e-5 abs and the per-image IoUs equal."""
    jmodel, jstate, tmodel, tstate = tiny
    store = make_synthetic_store(num_tasks=5, examples_per_task=10,
                                 image_size=IMAGE, seed=0)
    kw = dict(num_shots=5, test_shots=5, inner_batch_size=4, inner_iters=4,
              augment=False, transductive=True, task_chunk_size=3)
    jcfg, tcfg = jev.EvalConfig(**kw), tev.EvalConfig(**kw)
    rows = [4, 1, 2]
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    jcore = jev.make_adapt_and_predict_fn(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg, n_max=10)
    _, _, jmasks, jprobs = jax.jit(jax.vmap(
        jcore, in_axes=(None, 0, 0, 0, 0, None, None, None)))(
        jstate, *(jnp.asarray(a[rows]) for a in (store.images, store.masks,
                                                 store.counts)),
        keys, jnp.float32(0.05), jnp.float32(0.0), jnp.float32(0.5))
    draws = [_jax_episode_draws(k, jnp.asarray(store.counts[r]), jcfg, 10)
             for k, r in zip(keys, rows)]
    core = tev.make_batched_adapt_and_predict_fn(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), tcfg)
    _, _, tmasks, tprobs = core(
        tstate, torch.from_numpy(store.images[rows]),
        torch.from_numpy(store.masks[rows]), draws, _generators(40), 0.05,
        drop_rate=0.0)
    np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("transductive", [True, False],
                         ids=["transductive", "per_query_batch_stats"])
def test_batched_chunk_equals_chained_chunk(tiny, transductive):
    """The evaluator in chunks of 2 on a task axis and with `chain_chunk`
    (TinySeg at 32^2, 4 steps at batch 4, lr 0.05, augmentation and
    dropout 0.3 on) over 5 tasks, a ragged last chunk: the same IoUs and,
    episode by episode, the adapted state and the probabilities within
    1e-5."""
    _, _, tmodel, tstate = tiny
    store = make_synthetic_store(num_tasks=5, examples_per_task=10,
                                 image_size=IMAGE, seed=2)
    runs = []
    for chain in (True, False):
        cfg = tev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=4,
                             inner_iters=4, transductive=transductive,
                             use_batch_stats_at_predict=not transductive,
                             task_chunk_size=2, chain_chunk=chain)
        ev = tev.GeckoEvaluator(tmodel, til.LossConfig(),
                                til.OptimizerConfig("sgd"), cfg, store,
                                device="cpu")
        seen = {}
        ious = ev.evaluate_tasks(
            tstate, [3, 0, 4, 1, 2], torch.Generator().manual_seed(8), 0.05,
            drop_rate=0.3,
            on_episode=lambda j, a, q, p: seen.setdefault(j, (a, p)))
        runs.append((ious, seen))
    (a_ious, a_seen), (b_ious, b_seen) = runs
    np.testing.assert_allclose(b_ious, a_ious, atol=1e-6)
    assert sorted(b_seen) == list(range(5))
    for j in range(5):
        assert _state_gap(b_seen[j][0], a_seen[j][0]) <= 1e-5
        np.testing.assert_allclose(b_seen[j][1].numpy(),
                                   a_seen[j][1].numpy(), atol=1e-5)


def test_aspp_and_skip_decoding_under_task_axis_match_per_task_runs():
    """EfficientLab-b0 with ASPP and skip decoding, rsd (2,), at 64^2: one
    training forward of 3 tasks (each its own weights and generator:
    drop-connect, ASPP's and the final dropout on) against three one-task
    forwards, the logits and every updated running stat within 1e-5 of
    their largest magnitude (a grouped conv sums in another order, and the
    batch norms amplify it: the logits differ by 4.5e-4 of 111); then the
    eval forwards, likewise."""
    model = EfficientLab(rsd=(2,), spatial_pyramid_pooling=True,
                         skip_decoding=True, final_layer_dropout_rate=0.5)
    model.reset_parameters(torch.Generator().manual_seed(2))
    base = dict(list(model.named_parameters())
                + list(model.named_buffers()))
    trees = [{k: base[k].detach() + 0.05 * (v - base[k].detach())
              for k, v in tree.items()}   # keep the activations tame
             for tree in _task_params(model, 12)]
    g = torch.Generator().manual_seed(13)
    images = 255.0 * torch.rand(T, 2, LAB_SIZE, LAB_SIZE, 3, generator=g)
    stacked = _stack(trees)
    for train in (True, False):
        with layers.task_axis(T):
            logits, probs = _call(model, stacked, images, train=train,
                                  generator=_generators(50))
        assert logits.shape == (T, 2, LAB_SIZE, LAB_SIZE, 2)
        for t, gen in enumerate(_generators(50)):
            ref, _ = _call(model, trees[t], images[t], train=train,
                           generator=gen)
            assert _relative_gap(logits[t], ref) <= 1e-5
            if train:
                for k, _ in model.named_buffers():
                    assert _relative_gap(stacked[k][t], trees[t][k]) <= 1e-5, k


CLI_FLAGS = (
    "--synthetic --synthetic_tasks 5 --image_size 64 --rsd 2 --sgd "
    "--loss_name bce_dice --inner-batch 4 --train-shots 6 --inner-iters 2 "
    "--learning-rate 0.0005 --meta-iters 1 --meta-batch 3 --eval-interval 1 "
    "--eval-samples 1 --shots 5 --eval-batch 4 --eval-iters 1 "
    "--transductive --serially_eval_all_test_tasks --meta-step 0.1 "
    "--foml --foml-tail 2 --augment --aug_rate 0.5 --l2 "
    "--task_chunk_size 2")


def test_run_metasegnet_selects_each_strategy(tmp_path, monkeypatch):
    """The CLI on the CPU with no strategy flag (the meta-batch and the
    evaluation chunks on a task axis), with `--task_group_size 2` (groups
    2 + 1) and with `--chain_tasks --chain_eval_chunk`: train_gecko
    builds the step `mliis_tpu/meta/train.py:91-127` selects, and the
    three runs draw the same, so their final states agree within 1e-5 and
    their grep lines are equal."""
    built = []
    for name in ("make_train_step", "make_microbatched_train_step",
                 "make_chained_train_step"):
        real = getattr(ttrain, name)

        def spy(*a, _real=real, _name=name, **k):
            built.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(ttrain, name, spy)
    runs = {}
    for tag, extra in (("batched", ""), ("groups", "--task_group_size 2"),
                       ("chained", "--chain_tasks --chain_eval_chunk")):
        out = io.StringIO()
        argv = shlex.split("{} {} --checkpoint {}".format(
            CLI_FLAGS, extra, tmp_path / tag))
        with contextlib.redirect_stdout(out):
            state = run_metasegnet.main(argv, device="cpu")
        grep = [ln for ln in out.getvalue().splitlines()
                if ln.startswith("Mean IoU over all meta-test tasks:")]
        runs[tag] = (state, grep)
    assert built == ["make_train_step", "make_microbatched_train_step",
                     "make_chained_train_step"]
    ref_state, ref_grep = runs["chained"]
    for tag in ("batched", "groups"):
        state, grep = runs[tag]
        assert grep == ref_grep and len(grep) == 1
        assert _state_gap(state, ref_state) <= 1e-5, tag


def test_strategy_flags_reach_configs():
    """tests/test_cli.py's check on the port's parser: the four flags reach
    the loop and evaluation configs, and their defaults select the task
    axis."""
    a = targs.argument_parser().parse_args(
        ["--chain_tasks", "--chain_eval_chunk", "--task_group_size", "3",
         "--task_chunk_size", "4"])
    loop, ev = targs.train_loop_config(a), targs.eval_config(a)
    assert loop.chain_tasks and loop.chain_eval_chunk
    assert loop.task_group_size == 3
    assert ev.chain_chunk and ev.task_chunk_size == 4
    default = targs.argument_parser().parse_args([])
    loop, ev = targs.train_loop_config(default), targs.eval_config(default)
    assert not loop.chain_tasks and not loop.chain_eval_chunk
    assert loop.task_group_size is None
    assert not ev.chain_chunk and ev.task_chunk_size == 2
