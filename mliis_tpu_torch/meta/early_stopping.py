"""Early stopping: the patience-based stopper and the per-step probe.

The port of the JAX package's `meta/early_stopping.py`. `EarlyStopper` and
`walk_trace` are copied: the stopper ends training when the metric has
not improved for `patience` evaluations, and `walk_trace` applies it to a
per-step metric trace, finding what stopping live would find. The trace
itself, which the JAX package computes as one scanned program, is a loop
of the port's `sgd_step` here, with the val set's mean hard IoU taken
after every step.
"""
import operator
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig, load_state,
                                             sgd_step)
from mliis_tpu_torch.ops.metrics import batched_hard_iou


class EarlyStopper:
    """Computes the stopping criterion given a metric and a patience."""

    def __init__(self, patience: int = 10, metric_should_increase: bool = True,
                 min_steps: int = 0):
        self.patience = patience
        self.metric_should_increase = metric_should_increase
        self.eval_operator = operator.gt if metric_should_increase \
            else operator.lt
        self._best_metric = None
        self._best_num_steps = min_steps if min_steps > 0 else None
        self.num_evals_without_improving = 0
        self.min_steps = min_steps

    def continue_training(self, metric, total_steps_taken) -> bool:
        if total_steps_taken <= self.min_steps:
            self._best_metric = metric
            return True
        elif (self._best_metric is None
              or self.eval_operator(metric, self._best_metric)):
            self.num_evals_without_improving = 0
            self._best_metric = metric
            self._best_num_steps = total_steps_taken
        else:
            self.num_evals_without_improving += 1
            if self.num_evals_without_improving > self.patience:
                return False
        return True

    def best_metric(self):
        return self._best_metric

    def best_num_steps(self):
        return self._best_num_steps


def walk_trace(trace, patience: int = 50, min_steps: int = 0
               ) -> Tuple[int, float]:
    """Apply EarlyStopper to a per-step metric trace; returns
    (best_num_steps, best_metric), what live stopping would find."""
    stopper = EarlyStopper(patience=patience, min_steps=min_steps)
    for step, metric in enumerate(np.asarray(trace)):
        if not stopper.continue_training(float(metric), step + 1):
            break
    return stopper.best_num_steps(), stopper.best_metric()


def make_early_stopping_trace_fn(model: torch.nn.Module,
                                 loss_config: LossConfig,
                                 opt_config: OptimizerConfig, *,
                                 augment: bool = True,
                                 weight_decay_rate: float = 1.0,
                                 pallas_augment: Optional[bool] = None
                                 ) -> Callable:
    """trace(state, support_images_u8, support_masks_u8, val_images_u8,
    val_masks_u8, idx_matrix, generator, lr, drop_rate, aug_rate) -> [steps]
    val mean hard IoU after each inner step, one step per row of
    idx_matrix [steps, batch] (indices into the support set). The module
    is loaded with `state` and trained in place; `state` is untouched."""
    step_fn = sgd_step(model, loss_config, opt_config, weight_decay_rate)
    kernels = pallas_augment is not False

    def trace_fn(state: ModelState, support_images_u8, support_masks_u8,
                 val_images_u8, val_masks_u8, idx_matrix, generator, lr,
                 drop_rate, aug_rate) -> torch.Tensor:
        load_state(model, state)
        opt = state.opt
        val_images = val_images_u8.float()
        val_masks = episodes.onehot_mask(val_masks_u8)
        trace = []
        for idx in idx_matrix:
            images, masks = episodes.assemble_batch(
                support_images_u8, support_masks_u8, idx, generator,
                aug_rate=aug_rate, augment=augment, kernels=kernels)
            opt, _ = step_fn(opt, images, masks, generator, lr, drop_rate)
            with torch.no_grad():
                probs = model(val_images, train=False)[1]
                ious = batched_hard_iou((probs > 0.5).float(), val_masks)
            trace.append(torch.nanmean(ious))
        return torch.stack(trace)

    return trace_fn
