"""Meta-training learns in the port: the torch counterpart of
tests/test_convergence.py's FOMAML* check, through `train_gecko`.

TinySeg is meta-trained with FOMAML* (last-step displacement on a disjoint
un-augmented tail batch) by `meta/train.train_gecko` on 12 synthetic
tasks, with test_convergence.py's hyperparameters (Adam, lr 0.01, meta
step 1.0, 6 shots, tail 2, 6 inner steps at batch 4, meta-batch 4, 16^2,
augmentation off), and its held-out adaptation IoU (6 tasks of another
seed, 5 shots + 5 query, 8 steps) must rise by at least MIN_IMPROVEMENT
over the initial state's. An outer-update sign flip, a broken running-stat
average or a corrupted meta-batch mean fails here where one-step algebra
checks pass. Slow: 60 meta-steps and three evaluations.
"""
import pytest
import torch

from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta.evaluate import EvalConfig, GeckoEvaluator
from mliis_tpu_torch.meta.inner_loop import (LossConfig, OptimizerConfig,
                                             init_model_state)
from mliis_tpu_torch.meta.learners import MetaTrainConfig
from mliis_tpu_torch.meta.train import TrainLoopConfig, train_gecko
from tests.torch_tiny_model import TorchTinySeg

pytestmark = pytest.mark.slow

IMG = 16
LR = 0.01
FOML_META_STEP = 1.0
MIN_IMPROVEMENT = 0.15


def test_fomaml_star_meta_training_learns(tmp_path):
    store = make_synthetic_store(num_tasks=12, examples_per_task=10,
                                 image_size=IMG, seed=0)
    test_store = make_synthetic_store(num_tasks=6, examples_per_task=10,
                                      image_size=IMG, seed=99)
    model = TorchTinySeg()
    init = torch.Generator().manual_seed(0)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(init)
    loss_cfg = LossConfig(l2=False)
    opt_cfg = OptimizerConfig(name="adam")
    state = init_model_state(model, opt_cfg)
    evaluator = GeckoEvaluator(
        model, loss_cfg, opt_cfg,
        EvalConfig(num_shots=5, test_shots=5, inner_batch_size=4,
                   inner_iters=8, augment=False), test_store, device="cpu")

    def held_out_iou(st, seed):
        iou, _ = evaluator.evaluate(st, torch.Generator().manual_seed(seed),
                                    LR, eval_all_tasks=True, aug_rate=None)
        return iou

    init_iou = held_out_iou(state, 1000)
    meta_cfg = MetaTrainConfig(num_shots=6, inner_batch_size=4,
                               inner_iters=6, meta_batch_size=4, foml=True,
                               tail_shots=2, augment=False)
    evals = []
    for segment in range(3):   # 30, 45 and 60 meta-steps, as calibrated
        iters = 30 if segment == 0 else 15
        state = train_gecko(
            model, state, store, test_store, str(tmp_path / str(segment)),
            loss_cfg, opt_cfg, meta_cfg,
            TrainLoopConfig(meta_iters=iters, meta_step_size=FOML_META_STEP,
                            meta_step_size_final=FOML_META_STEP,
                            eval_interval=1000, eval_inner_batch_size=4,
                            eval_inner_iters=8, num_tasks_to_eval=1, lr=LR,
                            save_checkpoint_every_n_meta_iters=1000),
            torch.Generator().manual_seed(7 + segment),
            log_fn=lambda *a: None, device="cpu")
        evals.append(held_out_iou(state, 2000 + segment))
    assert max(evals) - init_iou >= MIN_IMPROVEMENT, \
        "FOMAML* meta-training did not learn: init {} evals {}".format(
            init_iou, evals)
