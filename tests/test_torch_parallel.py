"""The port's sharded meta-steps (`parallel/mesh.make_sharded_train_step`)
against the JAX package and against the port's own world of 1, and the
early-stopping evaluator on a world of 2 against the unsharded one.

Gloo worlds of 4 and 2 are spawned once each (tests/torch_mesh_worker.py,
which imports no JAX) and run every case; this process computes the
references. Against JAX, the JAX step runs unsharded with its draws
injected into the port, augmentation and dropout off, as
tests/test_torch_meta.py does; the JAX package's own tests hold its
sharded steps to its unsharded one (tests/test_parallel.py). Against the
port's world of 1, the port draws its own slot-indexed streams with
augmentation on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import learners as jlr
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests import torch_mesh_worker as worker
from tests.test_torch_meta import _jax_draws, _jax_flat
from tests.test_torch_parallel_eval import (ES, ES_CALL, EVAL, EVAL_STORE,
                                            TASKS, _port_evaluators)
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG, N_MAX = 16, 10
STORE = dict(num_tasks=8, examples_per_task=N_MAX, image_size=IMG, seed=0)
MSS, LR = 0.3, 0.01
# Task axis: meta-batch 5 on 4 ranks pads (slots [0, 1], [2, 3], [4], []).
TASK_CFG = dict(num_shots=6, inner_batch_size=3, inner_iters=2,
                meta_batch_size=5, augment=False)
TASK_ALGOS = {"fomaml_star": dict(foml=True, tail_shots=2),
              "fomaml": dict(foml=True, tail_shots=None),
              "reptile": dict(foml=False)}
# (task, data) axes: every inner batch of 4 splits over the data axis.
MESH2D_CFG = dict(num_shots=6, inner_batch_size=4, inner_iters=3,
                  meta_batch_size=3, augment=False)
# (mesh, algorithm, chain_local, loss terms beside bce_dice + l2, key):
# without chain_local a rank's slots run on a task axis beside the data
# axis; the 1x2 step runs both ways from the same key.
MESH2D = {"2x2_fomaml_star": ((2, 2), dict(foml=True, tail_shots=2), True,
                              {}, 50),
          "2x2_reptile": ((2, 2), dict(foml=False), False, {}, 51),
          "1x2_fomaml_star": ((1, 2), dict(foml=True, tail_shots=2), False,
                              dict(darc1=True, label_smoothing=0.1), 52),
          "1x2_fomaml_star_chained": ((1, 2), dict(foml=True, tail_shots=2),
                                      True, dict(darc1=True,
                                                 label_smoothing=0.1), 52)}
# The port against its world of 1: its own draws, augmentation on.
OWN = {"task4": (4, (4,)), "2x2": (4, (2, 2)), "task2": (2, (2,)),
       "1x2": (2, (1, 2))}
OWN_CFG = dict(num_shots=6, inner_batch_size=4, inner_iters=3,
               meta_batch_size=5, foml=True, tail_shots=2, augment=True,
               aug_rate=0.7)


@pytest.fixture(scope="module")
def tiny():
    jmodel = TinySeg()
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMG,
                                  jil.OptimizerConfig("sgd"))
    return jmodel, jstate, params_from_jax(_jax_flat(jstate))


def _jax_case(name, mesh, cfg, tiny, key, chain_local=False, loss=None):
    """A case with the JAX draws of `key` injected, and the JAX package's
    unsharded step from the same state and key."""
    loss = loss or {}
    jmodel, jstate, state_dict = tiny
    store = make_synthetic_store(**STORE)
    jcfg = jlr.MetaTrainConfig(**cfg)
    draws = _jax_draws(key, jnp.asarray(store.counts), jcfg, N_MAX,
                       store.num_tasks)
    jstep = jax.jit(jlr.make_chained_train_step(
        jmodel, jil.LossConfig(**loss), jil.OptimizerConfig("sgd"), jcfg,
        N_MAX))
    ref = jstep(jstate, jnp.asarray(store.images), jnp.asarray(store.masks),
                jnp.asarray(store.counts), key, jnp.float32(MSS),
                jnp.float32(LR))
    case = dict(name=name, kind="meta_step", mesh=mesh, cfg=cfg, loss=loss,
                store=STORE, n_max=N_MAX, state_dict=state_dict, seed=0,
                injected=(draws.task_ids, [tuple(t) for t in draws.tasks]),
                meta_step_size=MSS, lr=LR, chain_local=chain_local)
    return case, ref


def _own_case(name, mesh, state_dict, seed):
    return dict(name=name, kind="meta_step", mesh=mesh, cfg=OWN_CFG,
                loss={}, store=STORE, n_max=N_MAX, state_dict=state_dict,
                seed=seed, meta_step_size=MSS, lr=LR)


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    """Every case on its world; returns {name: (rank results, reference)}."""
    cases = {4: [], 2: []}
    refs = {}
    for i, (algo, kw) in enumerate(TASK_ALGOS.items()):
        case, refs["task4_" + algo] = _jax_case(
            "task4_" + algo, (4,), dict(TASK_CFG, **kw), tiny,
            jax.random.PRNGKey(40 + i))
        cases[4].append(case)
    for name, (mesh, kw, chain, loss, seed) in MESH2D.items():
        case, refs[name] = _jax_case(name, mesh, dict(MESH2D_CFG, **kw),
                                     tiny, jax.random.PRNGKey(seed), chain,
                                     loss)
        cases[mesh[0] * mesh[1]].append(case)
    zero = dict(_own_case("task4_reptile_zero", (4,), tiny[2], 3),
                cfg=dict(TASK_CFG, meta_batch_size=3, foml=False),
                meta_step_size=0.0)
    cases[4].append(zero)
    for seed, (name, (world, mesh)) in enumerate(OWN.items()):
        cases[world].append(_own_case("own_" + name, mesh, tiny[2], seed))
    cases[2].append(dict(name="evaluation", kind="evaluation",
                         state_dict=tiny[2],
                         store=EVAL_STORE, eval=EVAL, tasks=TASKS, seed=7,
                         es=ES, es_call=ES_CALL))
    results = {}
    for world, world_cases in cases.items():
        results.update(worker.spawn(
            world, str(tmp_path_factory.mktemp("world{}".format(world))),
            world_cases))
    return {name: (results[name], refs.get(name)) for name in results}


def _jax_ref_dict(jstate):
    return params_from_jax(_jax_flat(jstate))


def _assert_ranks_close(ranks, ref, step, atol, rtol):
    """Every rank's params and running stats within atol + rtol of `ref`
    (a {name: tensor} of both), and its optimizer step equal."""
    for r, out in enumerate(ranks):
        port = dict(out["params"], **out["batch_stats"])
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_allclose(
                port[k].numpy(), ref[k].numpy(), atol=atol, rtol=rtol,
                err_msg="rank {} {}".format(r, k))
        assert out["step"] == step


@pytest.mark.parametrize("algo", list(TASK_ALGOS))
def test_task_sharded_step_matches_jax(runs, algo):
    """Meta-batch 5 on a 4-rank task axis (one rank holds only padded
    slots), the JAX draws injected: every rank's params, running stats
    and step within 2e-5 abs + 1e-4 rel of the JAX package's step."""
    ranks, ref = runs["task4_" + algo]
    _assert_ranks_close(ranks, _jax_ref_dict(ref), int(ref.opt.step),
                        atol=2e-5, rtol=1e-4)


def test_sharded_reptile_zero_step_identity(runs, tiny):
    """Reptile at meta step size 0 (meta-batch 3 on 4 ranks) leaves the
    params where they were."""
    ranks, _ = runs["task4_reptile_zero"]
    for out in ranks:
        for k, v in out["params"].items():
            np.testing.assert_allclose(v.numpy(), tiny[2][k].numpy(),
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(MESH2D))
def test_2d_task_data_step_matches_jax(runs, name):
    """A (task, data) mesh with the sync-BN model, a rank's slots on a task
    axis or (`chain_local`) one after another: every inner batch of 4
    splits over 2 data ranks, with bce_dice + l2 (and, on 1x2, darc1 and
    label smoothing) summed across the axis; every rank within 2e-5 abs +
    1e-4 rel of the JAX package's unsharded step."""
    ranks, ref = runs[name]
    _assert_ranks_close(ranks, _jax_ref_dict(ref), int(ref.opt.step),
                        atol=2e-5, rtol=1e-4)


def test_2d_step_on_a_task_axis_equals_chained_local(runs):
    """The 1x2 FOMAML* step with the rank's 3 slots on a task axis beside
    the data axis, against the same step with `chain_local`, from the same
    draws: every rank's params and running stats within 1e-6."""
    chained = runs["1x2_fomaml_star_chained"][0][0]
    _assert_ranks_close(runs["1x2_fomaml_star"][0],
                        dict(chained["params"], **chained["batch_stats"]),
                        chained["step"], atol=1e-6, rtol=0)


def test_early_stopping_on_a_world_of_2_equals_unsharded(runs):
    """EarlyStoppingEvaluator(mesh=) on a task mesh of 2 (each rank traces
    its 3 of the 6 tasks in chunks of 2 on a task axis), with the
    median-step re-evaluation: both ranks return the unsharded evaluator's
    (chunks of 4) names, best steps and IoUs (within 1e-5)."""
    state, _, es = _port_evaluators()
    names, steps, ious = es.evaluate_with_early_stopping(
        state, torch.Generator().manual_seed(7), eval_all_tasks=True,
        **ES_CALL)
    for r in runs["evaluation"][0]:
        assert r["names"] == names and r["steps"] == steps
        np.testing.assert_allclose(r["es_ious"], ious, atol=1e-5)


@pytest.mark.parametrize("name", list(OWN))
def test_world_of_n_equals_world_of_1(runs, tiny, name):
    """The port's own slot-indexed draws with augmentation on (FOMAML*,
    meta-batch 5, aug rate 0.7): a world of N (task axis, or task and
    data axes with sync-BN) computes the unsharded chained step's state
    within 1e-6."""
    ranks, _ = runs["own_" + name]
    seed = list(OWN).index(name)
    model = TorchTinySeg()
    model.load_state_dict(tiny[2], strict=True)
    cfg = tlr.MetaTrainConfig(**OWN_CFG)
    images, masks, counts = make_synthetic_store(**STORE).to_torch("cpu")
    state = til.init_model_state(model, til.OptimizerConfig("sgd"))
    out = tlr.make_chained_train_step(
        model, til.LossConfig(), til.OptimizerConfig("sgd"), cfg)(
        state, images, masks, tlr.draw_meta_step(seed, counts, cfg, N_MAX),
        MSS, LR)
    _assert_ranks_close(ranks, dict(out.params, **out.batch_stats),
                        int(out.opt.step), atol=1e-6, rtol=0)
