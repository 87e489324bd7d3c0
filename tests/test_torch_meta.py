"""The port's inner loop and meta-learner against the JAX package's.

The torch counterpart of tests/tiny_model.py's TinySeg
(tests/torch_tiny_model.py) carries the same weights as the flax one
(copied from the JAX init), the batch and task indices come from the JAX
key discipline, and augmentation and dropout are off, so both sides
compute the same deterministic function in float32 on the CPU. Tolerances
allow for float32 conv and reduction order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import episodes as jep
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import learners as jlr
from mliis_tpu.utils.checkpoint import flatten_tree
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import episodes as tep
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMAGE = 32


def _jax_flat(state):
    flat = flatten_tree(state.params, "params/")
    flat.update(flatten_tree(state.batch_stats, "batch_stats/"))
    return flat


def _assert_state_close(tstate, jstate, atol, rtol):
    ref = params_from_jax(_jax_flat(jstate))
    port = dict(tstate.params)
    port.update(tstate.batch_stats)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), ref[k].numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)
    assert int(tstate.opt.step) == int(jstate.opt.step)


@pytest.fixture(scope="module")
def tiny():
    jmodel = TinySeg()
    opt_cfg = jil.OptimizerConfig("sgd")
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMAGE,
                                  opt_cfg)
    tmodel = TorchTinySeg()
    tmodel.load_state_dict(params_from_jax(_jax_flat(jstate)), strict=True)
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    return jmodel, jstate, tmodel, tstate


def test_sgd_steps_match_jax(tiny, rng):
    """6 SGD steps, augment off, fixed index matrix, lr 0.05, bce_dice + l2:
    params and running stats within 2e-5 abs + 1e-4 rel (float32 conv and
    reduction order over six dependent steps)."""
    jmodel, jstate, tmodel, tstate = tiny
    imgs = rng.integers(0, 256, (6, IMAGE, IMAGE, 3)).astype(np.uint8)
    msks = (rng.random((6, IMAGE, IMAGE)) > 0.5).astype(np.uint8) * 255
    idx = rng.integers(0, 6, (6, 4))
    lrs = np.full((6,), 0.05, np.float32)
    jadapt = jil.make_adapt_fn(jmodel, jil.LossConfig(), jil.OptimizerConfig(
        "sgd"), augment=False)
    jout, jloss = jadapt(jstate, jnp.asarray(imgs), jnp.asarray(msks),
                         jnp.asarray(idx),
                         jax.random.split(jax.random.PRNGKey(1), 6),
                         jnp.asarray(lrs))
    tadapt = til.make_adapt_fn(tmodel, til.LossConfig(),
                               til.OptimizerConfig("sgd"), augment=False)
    tout, tloss = tadapt(tstate, torch.from_numpy(imgs),
                         torch.from_numpy(msks), torch.from_numpy(idx),
                         torch.Generator().manual_seed(0), lrs)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    _assert_state_close(tout, jout, atol=2e-5, rtol=1e-4)
    # adapt trained the module; the snapshot it started from is untouched
    _assert_state_close(tstate, jstate, atol=0, rtol=0)


def test_precomputed_augmentation_matches_in_loop(tiny, rng):
    """precompute_augment=True draws the same augmentations from the same
    generator (TinySeg has no drop-connect and dropout is off) and only
    stages the batches in bf16: 3 steps with `full_pass` on agree with the
    in-loop path within 1e-3 abs + 1e-2 rel, and both moved the params."""
    _, _, tmodel, tstate = tiny
    imgs = torch.from_numpy(rng.integers(0, 256, (6, IMAGE, IMAGE, 3)
                                         ).astype(np.uint8))
    msks = torch.from_numpy((rng.random((6, IMAGE, IMAGE)) > 0.5).astype(
        np.uint8) * 255)
    idx = torch.from_numpy(rng.integers(0, 6, (3, 4)))
    outs = []
    for pre in (False, True):
        adapt = til.make_adapt_fn(tmodel, til.LossConfig(),
                                  til.OptimizerConfig("sgd"),
                                  precompute_augment=pre)
        out, _ = adapt(tstate, imgs, msks, idx,
                       torch.Generator().manual_seed(3), [0.05] * 3,
                       aug_rate=1.0)
        outs.append(out)
    for k, v in outs[0].params.items():
        np.testing.assert_allclose(outs[1].params[k].numpy(), v.numpy(),
                                   atol=1e-3, rtol=1e-2, err_msg=k)
    for out in outs:
        assert sum(float((out.params[k] - v).abs().sum())
                   for k, v in tstate.params.items()) > 0


def _jax_draws(key, counts, cfg, n_max, num_tasks):
    """The index draws of jlr.make_chained_train_step for `key`
    (learners.py:110-155 for Reptile, FOMAML and FOMAML*), each slot with
    a generator of its own for what it draws inside the step."""
    k_tasks, k_inner = jax.random.split(key)
    task_ids = jep.slot_task_ids(k_tasks, num_tasks, cfg.meta_batch_size)
    task_keys = jep.slot_keys(k_inner, cfg.meta_batch_size)
    tail = cfg.tail_shots if cfg.foml else None
    tasks = []
    for i in range(cfg.meta_batch_size):
        if cfg.foml:
            k_shots, k_split, k_batches, _, _ = jax.random.split(
                task_keys[i], 5)
        else:
            k_shots, k_batches, _ = jax.random.split(task_keys[i], 3)
        shot = jep.sample_shot_indices(k_shots, counts[task_ids[i]],
                                       cfg.num_shots, n_max)
        if tail is None:
            idx = jep.batch_indices(k_batches, cfg.num_shots,
                                    cfg.inner_batch_size, cfg.inner_iters,
                                    cfg.replacement)
            train_rel = tail_rel = None
        else:
            train_rel, tail_rel = jep.split_support_query(
                k_split, cfg.num_shots, tail)
            idx = jep.batch_indices(k_batches, cfg.num_shots - tail,
                                    cfg.inner_batch_size,
                                    cfg.inner_iters - 1, cfg.replacement)
        tasks.append(tlr.TaskDraws(*(
            None if a is None else torch.tensor(np.asarray(a)).long()
            for a in (shot, train_rel, tail_rel, idx))))
    return tlr.MetaStepDraws(torch.tensor(np.asarray(task_ids)).long(),
                             tasks, [tep.slot_generator(0, s, "cpu")
                                     for s in range(cfg.meta_batch_size)])


@pytest.mark.parametrize("foml,tail_shots", [(True, 2), (True, None),
                                             (False, None)],
                         ids=["fomaml_star", "fomaml", "reptile"])
def test_chained_meta_step_matches_jax(tiny, foml, tail_shots):
    """One chained meta-step (3 tasks x 4 inner steps, the last one on the
    raw tail batch for FOMAML*; augment and dropout off) from the same
    state with the JAX draws injected: params, running stats and the
    optimizer step agree within 2e-5 abs + 1e-4 rel."""
    jmodel, jstate, tmodel, tstate = tiny
    store = make_synthetic_store(num_tasks=4, examples_per_task=8,
                                 image_size=IMAGE, seed=0)
    kw = dict(num_shots=6, inner_batch_size=2, inner_iters=4,
              meta_batch_size=3, foml=foml, tail_shots=tail_shots,
              augment=False, aug_rate=0.5)
    jcfg = jlr.MetaTrainConfig(**kw)
    tcfg = tlr.MetaTrainConfig(**kw)
    key = jax.random.PRNGKey(5)
    jstep = jlr.make_chained_train_step(jmodel, jil.LossConfig(),
                                        jil.OptimizerConfig("sgd"), jcfg,
                                        n_max=8)
    jout = jstep(jstate, jnp.asarray(store.images), jnp.asarray(store.masks),
                 jnp.asarray(store.counts), key, jnp.float32(0.5),
                 jnp.float32(0.05))
    draws = _jax_draws(key, jnp.asarray(store.counts), jcfg, 8, 4)
    tstep = tlr.make_chained_train_step(tmodel, til.LossConfig(),
                                        til.OptimizerConfig("sgd"), tcfg)
    tout = tstep(tstate, torch.from_numpy(store.images),
                 torch.from_numpy(store.masks), draws, 0.5, 0.05)
    _assert_state_close(tout, jout, atol=2e-5, rtol=1e-4)


def test_port_draws_have_the_reference_invariants():
    """The port's own draws: shots valid and distinct, train/tail a
    disjoint partition, batches cycling through epochs of the train
    shots, task ids in range."""
    gen = torch.Generator().manual_seed(0)
    cfg = tlr.MetaTrainConfig(num_shots=6, inner_batch_size=4, inner_iters=7,
                              meta_batch_size=5, foml=True, tail_shots=2)
    counts = torch.tensor([8, 7, 8, 3], dtype=torch.int32)
    d = tlr.draw_meta_step(0, counts, cfg, n_max=8)
    assert d.task_ids.shape == (5,) and int(d.task_ids.max()) < 4
    for tid, t in zip(d.task_ids.tolist(), d.tasks):
        assert (t.shot_idx < counts[tid]).all()
        if counts[tid] >= 6:
            assert len(set(t.shot_idx.tolist())) == 6
        assert sorted(t.train_rel.tolist() + t.tail_rel.tolist()) \
            == list(range(6))
        flat = t.idx_matrix.reshape(-1).tolist()
        assert t.idx_matrix.shape == (6, 4)
        for s in range(0, len(flat) - 3, 4):
            assert sorted(flat[s:s + 4]) == list(range(4))
    rep = tep.replacement_batch_indices(gen, 6, 4, 5, None)
    assert all(len(set(r.tolist())) == 4 for r in rep)
    with pytest.raises(ValueError, match="batch_size"):
        tep.batch_indices(gen, 5, 8, 3, replacement=True)


def test_adam_and_schedules_match_jax():
    """Adam(beta1=0) with TF's lr_t over 3 steps, the lr schedulers and the
    meta step anneal: float32 formulae, 1e-6 rel + 1e-6 abs (the port takes
    lr_t in float64, JAX in float32)."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3)]
    cfg = dict(name="adam", beta2=0.99, epsilon=1e-8)
    jp = {"w": jnp.asarray(p0)}
    jopt = jil.init_opt_state(jp, jil.OptimizerConfig(**cfg))
    tp = torch.from_numpy(p0.copy())
    topt = til.init_opt_state({"w": tp}, til.OptimizerConfig(**cfg))
    for g in grads:
        jp, jopt = jil.apply_optimizer(jp, {"w": jnp.asarray(g)}, jopt, 0.1,
                                       jil.OptimizerConfig(**cfg))
        topt = til.apply_optimizer_([tp], [torch.from_numpy(g)], topt, 0.1,
                                    til.OptimizerConfig(**cfg))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(topt.v["w"].numpy(), np.asarray(jopt.v["w"]),
                               rtol=1e-6)
    for name in ("fixed", "cosine_anneal", "step"):
        np.testing.assert_allclose(
            til.make_lr_array(0.3, 12, name).numpy(),
            np.asarray(jil.make_lr_array(0.3, 12, name)), rtol=1e-6)
    assert tlr.meta_step_size_schedule(3, 10, 0.1, 1e-5) == \
        jlr.meta_step_size_schedule(3, 10, 0.1, 1e-5)
