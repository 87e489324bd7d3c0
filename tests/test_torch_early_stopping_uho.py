"""Early stopping and UHO in the port against the JAX package's.

  - `EarlyStopper` and `walk_trace` give exactly the JAX package's
    decisions, best steps and best metrics on random traces.
  - The copied GP search (`meta/uho.py`) gives bit-identical suggestions
    from the same numpy seed and history, and the same CSV.
  - The early-stopping trace on TinySeg (the same weights on both sides),
    with the JAX key chain's batch indices injected and augmentation and
    dropout off, agrees within 1e-3 abs per step: the val IoU is a hard
    IoU, so a pixel whose probability ties 0.5 within float32 rounding may
    flip.
  - The UHO search writes its CSV under the JAX package's name, with its
    columns.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mliis_tpu.data.synthetic import make_synthetic_store
from mliis_tpu.meta import early_stopping as jes
from mliis_tpu.meta import episodes as jep
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import uho as juho
from mliis_tpu.meta import uho_eval as jue
from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.meta import early_stopping as tes
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import uho as tuho
from mliis_tpu_torch.meta import uho_eval as tue
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_meta import _jax_flat
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG = 16


@pytest.mark.parametrize("seed", range(6))
def test_stopper_and_walk_trace_match_jax(seed):
    """Random traces, patiences and step floors: every continue decision,
    the best step and the best metric are the JAX package's, exactly."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        trace = np.round(rng.random(int(rng.integers(1, 40))), 2)
        patience = int(rng.integers(0, 6))
        min_steps = int(rng.integers(0, 5))
        increase = bool(rng.integers(0, 2))
        assert tes.walk_trace(trace, patience, min_steps) == \
            jes.walk_trace(trace, patience, min_steps)
        j = jes.EarlyStopper(patience, increase, min_steps)
        t = tes.EarlyStopper(patience, increase, min_steps)
        for step, metric in enumerate(trace):
            assert t.continue_training(metric, step + 1) == \
                j.continue_training(metric, step + 1)
            assert (t.best_metric(), t.best_num_steps()) == \
                (j.best_metric(), j.best_num_steps())


def _objective(values):
    return float(sum((np.log(v) + 3.0) ** 2 for v in values))


def test_gp_suggestions_are_bit_identical():
    """Two dims (log-uniform real, integer uniform), 5 random then 15 EI
    suggestions from seed 3, each told the same objective: every
    suggestion equal, bit for bit."""
    suggestions = {}
    for side, mod in (("jax", juho), ("torch", tuho)):
        dims = [mod.Dimension(1e-4, 1e-1, "lr"),
                mod.Dimension(2, 16, "batch", is_integer=True,
                              prior="uniform")]
        opt = mod.GPOptimizer(dims, n_initial_points=5, seed=3)
        out = []
        for _ in range(20):
            x = opt.ask()
            out.append(x)
            opt.tell(x, _objective(x[:1]) + 0.01 * x[1])
        suggestions[side] = out
    assert suggestions["torch"] == suggestions["jax"]


def test_gp_search_loop_and_csv_match_jax(tmp_path):
    """The whole search with one deterministic objective: the same best
    configuration and step, and the same CSV text (the port writes it with
    the csv module, the JAX package with pandas)."""
    def eval_fn(lr=None, **_):
        peak = 1.0 - (np.log10(lr) + 2) ** 2
        return ["t1", "t2"], [3, int(10 * lr) + 1], [peak, peak / 2]

    out = {}
    for side, mod in (("jax", juho), ("torch", tuho)):
        path = str(tmp_path / "{}.csv".format(side))
        best = mod.lr_droprate_aug_rate_batch_size_gp_search(
            eval_fn, {"lr": None, "drop_rate": None, "aug_rate": 0.5,
                      "inner_batch_size": 8},
            lr_search_range_low=1e-4, lr_search_range_high=1e-1,
            drop_rate_search_range_low=0.1, drop_rate_search_range_high=0.3,
            n=8, m=2, save_results_to=path, log_fn=lambda *a: None)
        with open(path) as f:
            out[side] = (best, f.read())
    assert out["torch"] == out["jax"]
    assert out["torch"][1].splitlines()[0] == \
        "task_ID,best_num_steps,mIoU,lr,drop_rate"


@pytest.fixture(scope="module")
def tiny():
    jmodel = TinySeg()
    opt_cfg = jil.OptimizerConfig("sgd")
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMG,
                                  opt_cfg)
    tmodel = TorchTinySeg()
    tmodel.load_state_dict(params_from_jax(_jax_flat(jstate)), strict=True)
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    store = make_synthetic_store(num_tasks=3, examples_per_task=10,
                                 image_size=IMG, seed=0)
    return jmodel, jstate, tmodel, tstate, store


def test_early_stopping_trace_matches_jax(tiny):
    """8 steps at batch 4 on a 5-shot support set, val mIoU after each
    step, lr 0.05, bce_dice + l2: within 1e-3 abs per step."""
    jmodel, jstate, tmodel, tstate, store = tiny
    images, masks = store.images[0], store.masks[0]
    sup, val = [0, 2, 4, 6, 8], [1, 3, 5, 7, 9]
    key = jax.random.PRNGKey(11)
    jtrace_fn = jes.make_early_stopping_trace_fn(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), max_steps=8,
        inner_batch_size=4, augment=False, support_size=5, val_size=5)
    jtrace = jtrace_fn(jstate, jnp.asarray(images[sup]),
                       jnp.asarray(masks[sup]), jnp.asarray(images[val]),
                       jnp.asarray(masks[val]), key, jnp.float32(0.05),
                       jnp.float32(0.0), None)
    k_batches, _ = jax.random.split(key)
    idx = np.array(jep.batch_indices(k_batches, 5, 4, 8, False))
    ttrace_fn = tes.make_early_stopping_trace_fn(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"), augment=False)
    ttrace = ttrace_fn(tstate, torch.from_numpy(images[sup]),
                       torch.from_numpy(masks[sup]),
                       torch.from_numpy(images[val]),
                       torch.from_numpy(masks[val]), torch.from_numpy(idx),
                       torch.Generator().manual_seed(0), 0.05, 0.0, None)
    assert ttrace.shape == (8,)
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace),
                               atol=1e-3, rtol=0)
    assert float(ttrace.max() - ttrace.min()) > 0  # the probe moved


def _evaluators(tiny):
    jmodel, jstate, tmodel, tstate, store = tiny
    kw = dict(num_shots=5, test_shots=5, augment=False, patience=3)
    jev = jue.EarlyStoppingEvaluator(jmodel, jil.LossConfig(l2=False),
                                     jil.OptimizerConfig("sgd"), store,
                                     task_chunk_size=3, **kw)
    tev = tue.EarlyStoppingEvaluator(
        tmodel, til.LossConfig(l2=False), til.OptimizerConfig("sgd"),
        TaskStore(store.images, store.masks, store.counts, store.names),
        device="cpu", **kw)
    return jev, tev


def test_evaluate_with_early_stopping_runs(tiny):
    """The port's evaluator over every task: a best step in [1, 8] and an
    IoU in [0, 1] per task; with min == max steps it skips the trace and
    re-evaluates every task at that step count."""
    _, tev = _evaluators(tiny)
    _, _, _, tstate, _ = tiny
    gen = torch.Generator().manual_seed(1)
    names, steps, ious = tev.evaluate_with_early_stopping(
        tstate, gen, min_steps=1, max_steps=8, inner_batch_size=4, lr=0.02,
        eval_all_tasks=True)
    assert len(names) == len(steps) == len(ious) == 3
    assert all(1 <= s <= 8 for s in steps)
    assert all(0.0 <= i <= 1.0 for i in ious)
    names, steps, ious = tev.evaluate_with_early_stopping(
        tstate, gen, min_steps=2, max_steps=2, inner_batch_size=4, lr=0.02,
        eval_all_tasks=True)
    assert steps == [2, 2, 2] and len(ious) == 3


def test_uho_csv_matches_jax(tiny, tmp_path):
    """Both searches, 2 configs at 1-3 steps: the same file name (with
    `_5-shot` before the extension), the same columns, one row per task
    and config, and a learning rate inside the range."""
    jev, tev = _evaluators(tiny)
    _, jstate, _, tstate, _ = tiny
    kw = dict(min_steps=1, max_steps=3, num_configs_to_sample=2,
              lr_search_range_low=0.001, lr_search_range_high=0.1,
              log_fn=lambda *a: None)
    for side in "jt":
        os.makedirs(str(tmp_path / side))
    jlr, jsteps = jue.optimize_update_hyperparams(
        jev, jstate, jax.random.PRNGKey(2), save_dir=str(tmp_path / "j"),
        **kw)
    tlr, tsteps = tue.optimize_update_hyperparams(
        tev, tstate, torch.Generator().manual_seed(2),
        save_dir=str(tmp_path / "t"), **kw)
    os.makedirs(str(tmp_path / "j"), exist_ok=True)
    names = {side: os.listdir(str(tmp_path / side)) for side in "jt"}
    assert names["t"] == names["j"] == [
        "GP_val-set_hyper_param_search_results_5-shot.csv"]
    frames = {side: pd.read_csv(str(tmp_path / side / names[side][0]))
              for side in "jt"}
    assert list(frames["t"].columns) == list(frames["j"].columns)
    assert len(frames["t"]) == len(frames["j"]) == 2 * 3
    assert 0.001 <= tlr <= 0.1 and 1 <= tsteps <= 3
    # The GP's first suggestion is drawn before any result: the same lr.
    assert frames["t"]["lr"][0] == frames["j"]["lr"][0]
