"""The port's sync-BN, sharded evaluation, data-parallel joint trainer and
the guards of its meshes, on a spawned gloo world of 4
(tests/torch_mesh_worker.py), against the full batch, the port's
unsharded evaluators and joint step, and the JAX package."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.joint import trainer as jtrainer
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.models import layers as jlayers
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import uho_eval as tuho
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests import torch_mesh_worker as worker
from tests.test_torch_meta import _jax_flat
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG, WORLD = 16, 4
EVAL_STORE = dict(num_tasks=6, examples_per_task=10, image_size=IMG, seed=4)
EVAL = dict(num_shots=5, test_shots=5, inner_batch_size=4, inner_iters=2,
            augment=True)
ES = dict(num_shots=5, test_shots=5)
ES_CALL = dict(min_steps=1, max_steps=3, inner_batch_size=4, lr=0.05,
               aug_rate=0.5, eval_tasks_with_median_early_stopping_iterations=True)
TASKS = [4, 0, 5, 1, 3]   # 5 tasks on 4 ranks: shares of 2, 2, 1 and 0
JOINT_STORE = dict(num_tasks=4, examples_per_task=6, image_size=IMG, seed=1)
JOINT = {"kernel_route": dict(augment=True, use_pallas_augment=None),
         "plain_route": dict(augment=True, use_pallas_augment=False),
         "no_augment": dict(augment=False)}
GUARDS = {"indivisible_inner_batch": "multiple of the data-mesh size",
          "no_sync_bn_axis": "bn_axis_name='data'",
          "mesh_size_not_world": "need 2 devices for a 2-rank mesh",
          "joint_without_sync_bn": "bn_axis_name='data'",
          "unbound_axis": "unbound axis name: data"}


def _tiny_pair(n_out=2):
    jmodel = TinySeg(n_output_channels=n_out)
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMG,
                                  jil.OptimizerConfig("sgd"))
    return jmodel, jstate, params_from_jax(_jax_flat(jstate))


def _bn_inputs():
    rng = np.random.default_rng(0)
    return dict(
        x=torch.from_numpy(rng.normal(1.0, 3.0, (8, 3, 4, 4))
                           .astype(np.float32)),
        w=torch.from_numpy(rng.normal(size=(8, 3, 4, 4)).astype(np.float32)),
        bn={"scale": torch.tensor([1.5, 0.5, 2.0]),
            "bias": torch.tensor([0.1, -0.2, 0.3]),
            "mean": torch.tensor([0.2, 0.0, -0.1]),
            "var": torch.tensor([1.0, 2.0, 0.5])})


def _joint_batches(ds, steps=3, batch=8):
    rng = np.random.default_rng(5)
    return ([torch.from_numpy(rng.integers(0, ds.num_examples, (batch,)))
             for _ in range(steps)],
            [torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (batch,))
                              .astype(np.int32)) for _ in range(steps)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, _, state_dict = _tiny_pair()
    ds = ttrainer.joint_dataset_from_task_store(
        make_synthetic_store(**JOINT_STORE))
    _, _, joint_sd = _tiny_pair(ds.num_classes + 1)
    idx, seeds = _joint_batches(ds)
    cases = [dict(name="sync_bn", kind="sync_bn", **_bn_inputs()),
             dict(name="evaluation", kind="evaluation",
                  state_dict=state_dict, store=EVAL_STORE, eval=EVAL,
                  tasks=TASKS, seed=7, es=ES, es_call=ES_CALL),
             dict(name="guards", kind="guards", state_dict=state_dict)]
    for name, kw in JOINT.items():
        cases.append(dict(name="joint_" + name, kind="joint_steps",
                          state_dict=joint_sd, store=JOINT_STORE,
                          cfg=dict(batch_size=8, l2=True, **kw), idx=idx,
                          seeds=seeds))
    return worker.spawn(WORLD, str(tmp_path_factory.mktemp("world")), cases)


class _BN(nn.Module):
    @nn.compact
    def __call__(self, x):
        return jlayers.batch_norm(x, True)


def test_sync_bn_matches_full_batch(runs):
    """A batch of 8 split 2 a rank over a 4-rank data axis: the ranks'
    outputs and input gradients, put together, the sum of their parameter
    gradients and every rank's running stats equal the JAX package's
    full-batch batch norm (forward, vjp and updated stats) within 1e-6
    abs + 1e-5 rel."""
    inp = _bn_inputs()
    nhwc = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 3, 1))  # noqa
    variables = {"params": {"batch_normalization": {
        k: jnp.asarray(inp["bn"][k].numpy()) for k in ("scale", "bias")}},
        "batch_stats": {"batch_normalization": {
            k: jnp.asarray(inp["bn"][k].numpy()) for k in ("mean", "var")}}}

    def forward(params, x):
        return _BN().apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           mutable=["batch_stats"])

    out, mutated = forward(variables["params"], nhwc(inp["x"]))
    _, pull = jax.vjp(lambda p, x: forward(p, x)[0], variables["params"],
                      nhwc(inp["x"]))
    gparams, gx = pull(nhwc(inp["w"]))
    ranks = runs["sync_bn"]
    close = dict(atol=1e-6, rtol=1e-5)
    to_nhwc = lambda key: np.concatenate(  # noqa
        [r[key].numpy() for r in ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(to_nhwc("out"), np.asarray(out), **close)
    np.testing.assert_allclose(to_nhwc("grad_x"), np.asarray(gx), **close)
    for name in ("scale", "bias"):
        np.testing.assert_allclose(
            sum(r["grad_" + name] for r in ranks).numpy(),
            np.asarray(gparams["batch_normalization"][name]), **close)
    for r in ranks:
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                r[name].numpy(),
                np.asarray(mutated["batch_stats"]["batch_normalization"]
                           [name]), **close)


def _port_evaluators():
    model = TorchTinySeg()
    model.load_state_dict(_tiny_pair()[2], strict=True)
    store = make_synthetic_store(**EVAL_STORE)
    state = til.init_model_state(model, til.OptimizerConfig("sgd"))
    ev = tev.GeckoEvaluator(model, til.LossConfig(),
                            til.OptimizerConfig("sgd"), tev.EvalConfig(**EVAL),
                            store, device="cpu")
    es = tuho.EarlyStoppingEvaluator(model, til.LossConfig(),
                                     til.OptimizerConfig("sgd"), store,
                                     device="cpu", **ES)
    return state, ev, es


def test_sharded_gecko_evaluator_matches_unsharded(runs):
    """GeckoEvaluator(mesh=) over 5 tasks on 4 ranks, augmentation on:
    every rank returns the unsharded evaluator's per-task IoUs (same seed)
    within 1e-5."""
    state, ev, _ = _port_evaluators()
    ref = ev.evaluate_tasks(state, TASKS, torch.Generator().manual_seed(7),
                            0.05, aug_rate=0.5)
    for r in runs["evaluation"]:
        np.testing.assert_allclose(r["ious"], ref, atol=1e-5)


def test_sharded_early_stopping_matches_unsharded(runs):
    """EarlyStoppingEvaluator(mesh=) over the 6 tasks with the median-step
    re-evaluation: every rank returns the unsharded evaluator's names,
    best step counts and IoUs within 1e-5."""
    state, _, es = _port_evaluators()
    names, steps, ious = es.evaluate_with_early_stopping(
        state, torch.Generator().manual_seed(7), eval_all_tasks=True,
        **ES_CALL)
    for r in runs["evaluation"]:
        assert r["names"] == names and r["steps"] == steps
        np.testing.assert_allclose(r["es_ious"], ious, atol=1e-5)


def _unsharded_joint(cfg):
    ds = ttrainer.joint_dataset_from_task_store(
        make_synthetic_store(**JOINT_STORE))
    model = TorchTinySeg(n_output_channels=ds.num_classes + 1)
    model.load_state_dict(_tiny_pair(ds.num_classes + 1)[2], strict=True)
    trainer = ttrainer.JointTrainer(model, ds, ds,
                                    ttrainer.JointTrainConfig(**cfg),
                                    til.OptimizerConfig("sgd"), device="cpu")
    opt = til.init_model_state(model, til.OptimizerConfig("sgd")).opt
    losses = []
    for idx, seeds in zip(*_joint_batches(ds)):
        opt, loss = trainer.train_step(opt, idx, seeds, 0.05)
        losses.append(float(loss))
    state = til.snapshot(model, opt)
    return dict(state.params, **state.batch_stats), losses


def _assert_joint_close(ranks, ref, losses):
    """Losses 1e-5 rel; params and running stats 2e-5 abs + 1e-4 rel (the
    tolerances of tests/test_torch_joint_train.py's JAX comparison)."""
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        port = dict(r["params"], **r["batch_stats"])
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                       atol=2e-5, rtol=1e-4, err_msg=k)
        assert r["step"] == 3


@pytest.mark.parametrize("route", ["kernel_route", "plain_route"])
def test_data_parallel_joint_step_matches_full_batch(runs, route):
    """3 augmented joint steps at batch 8 split 2 a rank (sync-BN, the
    whole batch's seeds sliced, `fused_light_augment`'s wrapper or its
    plain version): every rank holds the full-batch step's losses, params
    and running stats."""
    ref, losses = _unsharded_joint(dict(batch_size=8, l2=True,
                                        **JOINT[route]))
    _assert_joint_close(runs["joint_" + route], ref, losses)


def test_data_parallel_joint_step_matches_jax(runs):
    """Without augmentation, the data-parallel steps hold the JAX
    package's full-batch joint launch from the same weights and
    batches."""
    ds = ttrainer.joint_dataset_from_task_store(
        make_synthetic_store(**JOINT_STORE))
    jmodel, jstate, _ = _tiny_pair(ds.num_classes + 1)
    jds = jtrainer.JointDataset(ds.images, ds.labels, ds.class_names)
    jt = jtrainer.JointTrainer(jmodel, jds, jds, jtrainer.JointTrainConfig(
        batch_size=8, augment=False, l2=True), jil.OptimizerConfig("sgd"))
    idx, _ = _joint_batches(ds)
    jout, jlosses = jt._train_launch(
        jax.tree_util.tree_map(jnp.copy, jstate),
        jnp.asarray(np.stack([i.numpy() for i in idx])),
        jax.random.split(jax.random.PRNGKey(2), 3), jnp.float32(0.05))
    _assert_joint_close(runs["joint_no_augment"],
                        params_from_jax(_jax_flat(jout)),
                        np.asarray(jlosses))


@pytest.mark.parametrize("guard", list(GUARDS))
def test_mesh_guards(runs, guard):
    """Misconfigured meshes fail loudly on every rank: an inner batch that
    does not split over the data axis, a (task, data) mesh or a joint
    trainer without the sync-BN model, a mesh of another size than the
    world, a sync-BN forward with no mesh bound."""
    for r in runs["guards"]:
        assert GUARDS[guard] in r[guard], r[guard]
