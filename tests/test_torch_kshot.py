"""The port's k-shot learning curves (`meta/kshot.py`) against the JAX
package's protocol (the reference's eval.py:190-243 and
reptile.py:393-441, as tests/test_joint_kshot.py holds it).

Both sides run on the same two-task store (40 and 12 examples) with the
evaluators' work replaced by recorders: the early-stopping evaluator
returns a step count made from its episode shape, and the evaluation
returns an IoU made from its EvalConfig. So what is compared is the
protocol itself, exactly: which k runs early stopping on which 80/20
split (`k_eff`, `val_shots = int(0.2 k_eff)`), the step counts chosen
(the early-stopping median, the fixed `eval_inner_iters`, or the iteration
range with estimation off), every EvalConfig handed to an evaluator (over
the fields both EvalConfigs have; `task_chunk_size` and `chain_chunk` are
JAX-only, as tests/test_torch_cli.py states), the ks and mIoUs returned,
and the CSV's header and rows.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mliis_tpu.data.task_store import TaskStore as JTaskStore
from mliis_tpu.meta import evaluate as jev
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import kshot as jks
from mliis_tpu.meta import uho_eval as jue
from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import kshot as tks
from mliis_tpu_torch.meta import uho_eval as tue
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG = 8
JAX_ONLY = {"task_chunk_size", "chain_chunk"}


def _arrays():
    rng = np.random.default_rng(0)
    tasks = []
    for n in (40, 12):
        images = rng.integers(0, 256, (n, IMG, IMG, 3)).astype(np.uint8)
        masks = (rng.random((n, IMG, IMG)) > 0.5).astype(np.uint8) * 255
        tasks.append((images, masks))
    return tasks, ["wide", "narrow"]


def _record(monkeypatch, side, es_mod, ev_mod, log):
    """Replace the early-stopping run and the evaluation by recorders."""
    def fake_es(self, state, key, min_steps, max_steps, inner_batch_size=8,
                lr=5e-4, drop_rate=None, aug_rate=0.5, task_indices=None,
                **kw):
        log.append(("es", self.num_shots, self.test_shots, min_steps,
                    max_steps, inner_batch_size, lr, aug_rate,
                    tuple(task_indices), self.pallas_augment))
        steps = [self.num_shots + 2 * self.test_shots, 3]
        return ["t"] * 2, steps, [0.5, 0.5]

    def fake_eval(self, state, task_indices, key, lr, drop_rate=None,
                  aug_rate=0.5):
        cfg = dataclasses.asdict(self.config)
        for k in JAX_ONLY:
            cfg.pop(k, None)
        log.append(("eval", tuple(sorted(cfg.items())), tuple(task_indices),
                    lr, drop_rate, aug_rate))
        c = self.config
        return np.array([0.01 * c.num_shots + 0.001 * c.inner_iters
                         + 0.0001 * c.test_shots])

    monkeypatch.setattr(es_mod.EarlyStoppingEvaluator,
                        "evaluate_with_early_stopping", fake_es)
    monkeypatch.setattr(ev_mod.GeckoEvaluator, "evaluate_tasks", fake_eval)


def _stores():
    tasks, names = _arrays()
    return (JTaskStore.from_task_arrays(tasks, names),
            TaskStore.from_task_arrays(tasks, names))


def test_k_shot_curves_protocol_matches_jax(monkeypatch, tmp_path):
    """k in {1, 5, 10, 50, 400} on a 40-example and a 12-example task, 2
    repetitions: the same early-stopping calls, EvalConfigs, ks, mIoUs and
    CSV, exactly."""
    jstore, tstore = _stores()
    logs = {"jax": [], "torch": []}
    _record(monkeypatch, "jax", jue, jev, logs["jax"])
    _record(monkeypatch, "torch", tue, tev, logs["torch"])
    kw = dict(num_samples=2, k_range=[1, 5, 10, 50, 400],
              eval_inner_batch_size=8, eval_inner_iters=4, lr=0.02,
              aug_rate=0.5, log_fn=lambda *a: None)
    jout = jks.run_k_shot_learning_curves_experiment(
        TinySeg(), jil.LossConfig(), jil.OptimizerConfig("sgd"), None,
        jstore, jax.random.PRNGKey(0), pallas_augment=False,
        csv_outpath=str(tmp_path / "jax.csv"), **kw)
    tout = tks.run_k_shot_learning_curves_experiment(
        TorchTinySeg(), til.LossConfig(), til.OptimizerConfig("sgd"), None,
        tstore, torch.Generator(), pallas_augment=False, device="cpu",
        csv_outpath=str(tmp_path / "torch.csv"), **kw)
    assert logs["torch"] == logs["jax"]
    assert tout == jout
    with open(str(tmp_path / "jax.csv"), newline="") as f:
        jcsv = f.read()
    with open(str(tmp_path / "torch.csv"), newline="") as f:
        assert f.read() == jcsv
    assert jcsv.splitlines()[0] == "k,mIoU"
    assert len(jcsv.splitlines()) == 1 + 2 * 2 * 5
    # What the protocol did: the 40-example task holds 20 query images, so
    # k_eff is min(k, 20); k_eff 10 and 20 run early stopping on 8 + 2 and
    # 16 + 4 shots; the 12-example task holds 11, so k_eff is 1 throughout.
    es = [entry[1:3] for entry in logs["torch"] if entry[0] == "es"]
    assert es == [(8, 2), (16, 4), (16, 4)] * 2
    shots = [dict(entry[1])["num_shots"] for entry in logs["torch"]
             if entry[0] == "eval"]
    assert shots == [1, 5, 10, 20, 20] * 2 + [1] * 10
    iters = [dict(entry[1])["inner_iters"] for entry in logs["torch"]
             if entry[0] == "eval"][:5]
    assert iters == [4, 4, int(np.median([12, 3])), int(np.median([24, 3])),
                     int(np.median([24, 3]))]


@pytest.mark.parametrize("estimate", [True, False])
def test_iteration_protocol_matches_jax(monkeypatch, estimate):
    """With estimation on, ks below the early-stopping gate keep the fixed
    eval_inner_iters; with it off, the iteration range applies per k (its
    last value past its end)."""
    jstore, tstore = _stores()
    logs = {"jax": [], "torch": []}
    _record(monkeypatch, "jax", jue, jev, logs["jax"])
    _record(monkeypatch, "torch", tue, tev, logs["torch"])
    kw = dict(k_range=[1, 4, 8, 12], iter_range=[2, 3], test_samples=20,
              inner_batch_size=8, lr=0.01, eval_inner_iters=6,
              estimate_inner_iters_with_early_stopping=estimate,
              log_fn=lambda *a: None)
    jres = jks.evaluate_k_shot_range(
        TinySeg(), jil.LossConfig(), jil.OptimizerConfig("sgd"), None,
        jstore, 0, jax.random.PRNGKey(1), **kw)
    tres = tks.evaluate_k_shot_range(
        TorchTinySeg(), til.LossConfig(), til.OptimizerConfig("sgd"), None,
        tstore, 0, torch.Generator(), device="cpu", **kw)
    assert tres == jres
    assert logs["torch"] == logs["jax"]
    iters = [dict(e[1])["inner_iters"] for e in logs["torch"]
             if e[0] == "eval"]
    assert iters == ([6, 6, 6, int(np.median([10 + 2 * 2, 3]))]
                     if estimate else [2, 3, 3, 3])


def test_evaluator_cache_builds_each_shape_once():
    """Evaluators are kept by episode shape: asking again for a shape
    builds nothing new, and the early-stopping evaluator is kept by its
    (num_shots, test_shots)."""
    _, tstore = _stores()
    cache = tks.EvaluatorCache(TorchTinySeg(), til.LossConfig(),
                               til.OptimizerConfig("sgd"), tstore,
                               pallas_augment=False, device="cpu")
    cfg = tev.EvalConfig(num_shots=4, test_shots=2, inner_batch_size=2,
                         inner_iters=1, pallas_augment=cache.pallas_augment)
    assert cache.gecko(cfg) is cache.gecko(dataclasses.replace(cfg))
    assert cache.early_stopping(8, 2) is cache.early_stopping(8, 2)
    assert cache.early_stopping(8, 2).pallas_augment is False
    assert cache.constructions == 2


def test_k_shot_curves_run_on_tiny_model(tmp_path):
    """Unpatched, on TinySeg: one row per (task, k), IoUs in [0, 1]."""
    _, tstore = _stores()
    model = TorchTinySeg()
    state = til.init_model_state(model, til.OptimizerConfig("sgd"))
    path = str(tmp_path / "k-shot-results.csv")
    ks, results = tks.run_k_shot_learning_curves_experiment(
        model, til.LossConfig(l2=False), til.OptimizerConfig("sgd"), state,
        tstore, torch.Generator().manual_seed(0), k_range=[1, 12],
        eval_inner_batch_size=4, eval_inner_iters=2, lr=0.01,
        csv_outpath=path, device="cpu", log_fn=lambda *a: None)
    assert ks == [1, 12, 1, 12]
    assert all(0.0 <= r <= 1.0 for r in results)
    with open(path) as f:
        assert len(f.read().splitlines()) == 5
