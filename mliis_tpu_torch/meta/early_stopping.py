"""Early stopping: the patience-based stopper and the per-step probe.

The port of the JAX package's `meta/early_stopping.py`. `EarlyStopper` and
`walk_trace` are copied: the stopper ends training when the metric has
not improved for `patience` evaluations, and `walk_trace` applies it to a
per-step metric trace, finding what stopping live would find. The trace
itself, which the JAX package computes as one scanned program, is a loop
of the port's `sgd_step` here, with the val set's mean hard IoU taken
after every step; `make_batched_early_stopping_trace_fn` traces T tasks
at once on a task axis, as the JAX package vmaps its trace.
"""
import operator
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig,
                                             batched_sgd_step, load_state,
                                             sgd_step, step_batches,
                                             task_axis_state, task_forward)
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
                                 precompute_augment: bool = False,
                                 pallas_augment: Optional[bool] = None
                                 ) -> Callable:
    """trace(state, support_images_u8, support_masks_u8, val_images_u8,
    val_masks_u8, idx_matrix, generator, lr, drop_rate, aug_rate) -> [steps]
    val mean hard IoU after each inner step, one step per row of
    idx_matrix [steps, batch] (indices into the support set). The module
    is loaded with `state` and trained in place; `state` is untouched.
    `precompute_augment` augments every step's batch before the first
    step, staged in bf16, as `inner_loop.make_adapt_fn` does."""
    step_fn = sgd_step(model, loss_config, opt_config, weight_decay_rate)
    kernels = pallas_augment is not False

    def trace_fn(state: ModelState, support_images_u8, support_masks_u8,
                 val_images_u8, val_masks_u8, idx_matrix, generator, lr,
                 drop_rate, aug_rate) -> torch.Tensor:
        load_state(model, state)
        opt = state.opt
        val_images = val_images_u8.float()
        val_masks = episodes.onehot_mask(val_masks_u8)

        def batch(i):
            return episodes.assemble_batch(
                support_images_u8, support_masks_u8, idx_matrix[i],
                generator, aug_rate=aug_rate, augment=augment,
                kernels=kernels)

        trace = []
        for images, masks in step_batches(batch, idx_matrix.shape[0],
                                          precompute_augment and augment):
            opt, _ = step_fn(opt, images, masks, generator, lr, drop_rate)
            with torch.no_grad():
                probs = model(val_images, train=False)[1]
                ious = batched_hard_iou((probs > 0.5).float(), val_masks)
            trace.append(torch.nanmean(ious))
        return torch.stack(trace)

    return trace_fn


def make_batched_early_stopping_trace_fn(model: torch.nn.Module,
                                         loss_config: LossConfig,
                                         opt_config: OptimizerConfig, *,
                                         augment: bool = True,
                                         weight_decay_rate: float = 1.0,
                                         precompute_augment: bool = False,
                                         pallas_augment: Optional[bool] = None
                                         ) -> Callable:
    """The trace of T tasks on a task axis (the JAX package's trace under
    `jax.vmap`): trace(states, support_images_u8 [T, S, H, W, 3],
    support_masks_u8 [T, S, H, W], val_images_u8 [T, V, H, W, 3],
    val_masks_u8 [T, V, H, W], idx_matrix [T, steps, batch], generators,
    lr, drop_rate, aug_rate) -> [T, steps]. `states` is stacked
    (`inner_loop.stack_states`) and left untouched; the module's own
    parameters are not used. Each step gathers and augments the T batches
    in one pass (one `full_pass` launch at T x batch), takes one step of
    `inner_loop.batched_sgd_step`, then probes: one eval-mode forward of
    the T val sets and per task the nanmean of its hard IoUs. Task t draws
    only from generators[t], in the order the one-task trace draws from
    its generator, so each row is that task's one-task trace up to float
    rounding."""
    params_order = [k for k, _ in model.named_parameters()]
    step_fn = batched_sgd_step(model, loss_config, opt_config,
                               weight_decay_rate)
    kernels = pallas_augment is not False

    def trace_fn(states: ModelState, support_images_u8, support_masks_u8,
                 val_images_u8, val_masks_u8, idx_matrix, generators, lr,
                 drop_rate, aug_rate) -> torch.Tensor:
        generators = list(generators)
        params, buffers, opt = task_axis_state(
            states, support_images_u8.device, params_order)
        val_images = val_images_u8.float()
        val_masks = episodes.onehot_mask(val_masks_u8)
        t = val_images.shape[0]

        def batch(i):
            return episodes.assemble_batches(
                support_images_u8, support_masks_u8, idx_matrix[:, i],
                generators, aug_rate=aug_rate, augment=augment,
                kernels=kernels)

        trace = []
        for images, masks in step_batches(batch, idx_matrix.shape[1],
                                          precompute_augment and augment):
            opt, _ = step_fn(params, buffers, opt, images, masks,
                             generators, lr, drop_rate)
            with torch.no_grad():
                probs = task_forward(model, params, buffers, val_images,
                                     train=False)[1]
                ious = batched_hard_iou((probs > 0.5).float().flatten(0, 1),
                                        val_masks.flatten(0, 1))
            trace.append(torch.nanmean(ious.reshape(t, -1), dim=1))
        return torch.stack(trace, dim=1)

    return trace_fn
