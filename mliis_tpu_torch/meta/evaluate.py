"""K-shot evaluation: per task, adapt a copy of the state on its support set
and score its query set.

The port of the JAX package's `meta/evaluate.py` (the reference's
reptile.py:127-294 semantics, the path behind run.sh): per task, sample
num_shots + test_shots examples -> a shuffled support/query split ->
`inner_iters` SGD steps on augmented support batches -> predict the query
set -> per-image hard IoU -> nanmean. Every task starts from the state the
caller gives, which is never changed: `adapt` loads it into the module and
returns a new snapshot.

Tasks run one after another (the JAX package's `chain_chunk` semantics);
the padded duplicate tasks the JAX package computes and discards to keep
one compiled shape have no counterpart, and neither do its chunk sizes.
The draws of an episode (shots, split, batch index matrix) are made by
`draw_episode` and passed in, as `learners.draw_meta_step` does for a
meta-step, so a test can inject the indices the JAX key discipline yields.
The random numbers inside an episode (augmentation, dropout, drop-connect)
come from the generator passed to it.

Predictions use the population batch-norm statistics (train=False), or,
with `use_batch_stats_at_predict` (the reference's legacy no-is_training
mode), batch statistics over the query batch (transductive) or over the
support batch plus one query at a time; the running statistics that
forward updates are discarded, as the JAX package discards them.
"""
import dataclasses
import random as pyrandom
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig, make_adapt_fn,
                                             make_lr_array)
from mliis_tpu_torch.ops.metrics import batched_hard_iou, ci95, nanmean


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    num_shots: int = 5
    test_shots: int = 5
    inner_batch_size: int = 8
    inner_iters: int = 59
    replacement: bool = False
    transductive: bool = False
    augment: bool = True
    precompute_augment: bool = False
    lr_scheduler: str = "fixed"
    lr_decay_rate: float = 0.5
    lr_decay_after_n_steps: int = 5
    use_batch_stats_at_predict: bool = False
    weight_decay_rate: float = 1.0


class EpisodeDraws(NamedTuple):
    """One episode's indices: num_shots + test_shots shots into the task
    row, their support/query split, and the batch index matrix
    [inner_iters, inner_batch_size] into the support set."""
    shot_idx: torch.Tensor
    support_rel: torch.Tensor
    query_rel: torch.Tensor
    idx_matrix: torch.Tensor


def draw_episode(generator: torch.Generator, count: torch.Tensor,
                 config: EvalConfig, n_max: int) -> EpisodeDraws:
    """The draws of one episode, on `count`'s device."""
    dev = count.device
    total = config.num_shots + config.test_shots
    shot_idx = episodes.sample_shot_indices(generator, count, total, n_max)
    support_rel, query_rel = episodes.split_support_query(
        generator, total, config.test_shots, dev)
    idx = episodes.batch_indices(generator, config.num_shots,
                                 config.inner_batch_size, config.inner_iters,
                                 config.replacement, dev)
    return EpisodeDraws(shot_idx, support_rel, query_rel, idx)


def make_adapt_and_predict_fn(model: torch.nn.Module,
                              loss_config: LossConfig,
                              opt_config: OptimizerConfig,
                              config: EvalConfig):
    """The episode protocol: adapt_and_predict(state, task_images_u8,
    task_masks_u8, draws, generator, lr, drop_rate=None, aug_rate=None) ->
    (adapted ModelState, query images float32, query masks one-hot, query
    probs float32)."""
    adapt = make_adapt_fn(model, loss_config, opt_config,
                          weight_decay_rate=config.weight_decay_rate,
                          augment=config.augment,
                          precompute_augment=config.precompute_augment)

    def predict(support_images, query_images, generator):
        if not config.use_batch_stats_at_predict:
            return model(query_images, train=False)[1]
        if config.transductive:
            return model(query_images, train=True,
                         final_layer_dropout_rate=0.0,
                         generator=generator)[1]
        # One query appended to the support batch; its prediction
        # (reptile.py:515-524).
        support = support_images.float()
        return torch.stack([
            model(torch.cat([support, q[None]]), train=True,
                  final_layer_dropout_rate=0.0, generator=generator)[1][-1]
            for q in query_images])

    def adapt_and_predict(state: ModelState, task_images_u8, task_masks_u8,
                          draws: EpisodeDraws, generator, lr,
                          drop_rate=None, aug_rate=None):
        support_idx = draws.shot_idx[draws.support_rel]
        query_idx = draws.shot_idx[draws.query_rel]
        support_images = task_images_u8[support_idx]
        lrs = make_lr_array(lr, config.inner_iters, config.lr_scheduler,
                            config.lr_decay_rate,
                            config.lr_decay_after_n_steps)
        adapted, _ = adapt(state, support_images, task_masks_u8[support_idx],
                           draws.idx_matrix, generator, lrs,
                           drop_rate=drop_rate, aug_rate=aug_rate)
        query_images = task_images_u8[query_idx].float()
        query_masks = episodes.onehot_mask(task_masks_u8[query_idx])
        with torch.no_grad():
            probs = predict(support_images, query_images, generator)
        return adapted, query_images, query_masks, probs.float()

    return adapt_and_predict


def make_eval_task_fn(model: torch.nn.Module, loss_config: LossConfig,
                      opt_config: OptimizerConfig, config: EvalConfig):
    """eval_task(state, task_images_u8, task_masks_u8, draws, generator,
    lr, drop_rate=None, aug_rate=None) -> per-query-image hard IoUs
    [test_shots]."""
    core = make_adapt_and_predict_fn(model, loss_config, opt_config, config)

    def eval_task(state, task_images_u8, task_masks_u8, draws, generator,
                  lr, drop_rate=None, aug_rate=None):
        _, _, query_masks, probs = core(state, task_images_u8,
                                        task_masks_u8, draws, generator, lr,
                                        drop_rate, aug_rate)
        return batched_hard_iou((probs > 0.5).float(), query_masks)

    return eval_task


class GeckoEvaluator:
    """Task-by-task evaluation over a TaskStore held on `device` (the card
    unless the caller asks for the CPU). The module is moved there; the
    state given to `evaluate` may lie anywhere and is never changed."""

    def __init__(self, model: torch.nn.Module, loss_config: LossConfig,
                 opt_config: OptimizerConfig, config: EvalConfig,
                 store: TaskStore, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.store = store
        self._model = model.to(self.device)
        self._images, self._masks, self._counts = store.to_torch(self.device)
        self._eval_task = make_eval_task_fn(model, loss_config, opt_config,
                                            config)

    def _default_drop_rate(self) -> float:
        """None drop_rate means the model's own final dropout rate."""
        rate = getattr(self._model, "final_layer_dropout_rate", None)
        return float(rate) if rate else 0.0

    def evaluate_tasks(self, state: ModelState, task_indices: List[int],
                       generator: torch.Generator, lr: float,
                       drop_rate: Optional[float] = None,
                       aug_rate: Optional[float] = 0.5) -> np.ndarray:
        """Per-task mean IoU for the given task indices, one task after
        another; `generator` lies on the evaluator's device."""
        drop_rate = self._default_drop_rate() if drop_rate is None \
            else drop_rate
        n_max = self._images.shape[1]
        results = np.zeros((len(task_indices),), np.float64)
        for j, i in enumerate(task_indices):
            draws = draw_episode(generator, self._counts[i], self.config,
                                 n_max)
            ious = self._eval_task(state, self._images[i], self._masks[i],
                                   draws, generator, lr, drop_rate, aug_rate)
            results[j] = np.nanmean(ious.cpu().numpy())
        return results

    def evaluate(self, state: ModelState, generator: torch.Generator,
                 lr: float, eval_all_tasks: bool = False,
                 num_tasks_to_sample: int = 1,
                 drop_rate: Optional[float] = None,
                 aug_rate: Optional[float] = 0.5,
                 rng: Optional[pyrandom.Random] = None
                 ) -> Tuple[float, Dict[str, float]]:
        """One evaluation sample over the store: every task, or a random
        subsample of `num_tasks_to_sample` (shuffled by `rng`). Returns the
        mean IoU and {task name: IoU}."""
        indices = list(range(self.store.num_tasks))
        if not eval_all_tasks:
            (rng or pyrandom).shuffle(indices)
            indices = indices[:num_tasks_to_sample]
        ious = self.evaluate_tasks(state, indices, generator, lr, drop_rate,
                                   aug_rate)
        task_iou_map = {self.store.names[i]: float(iou)
                        for i, iou in zip(indices, ious)}
        return nanmean(ious), task_iou_map


def evaluate_gecko(evaluator: GeckoEvaluator, state: ModelState,
                   generator: torch.Generator, lr: float,
                   num_samples: int = 2,
                   serially_eval_all_tasks: bool = True,
                   num_tasks_to_sample: int = 1,
                   drop_rate: Optional[float] = None,
                   aug_rate: Optional[float] = 0.5,
                   log_fn=print) -> Tuple[float, Dict[str, List[float]]]:
    """Repeated-sample evaluation (the reference's eval.py:18-90): per-task
    IoU lists over `num_samples` runs, logged as mean +/- 95% CI."""
    mean_ious = []
    task_iou_map: Dict[str, List[float]] = {}
    for _ in range(num_samples):
        mean_iou, sample_map = evaluator.evaluate(
            state, generator, lr, eval_all_tasks=serially_eval_all_tasks,
            num_tasks_to_sample=num_tasks_to_sample, drop_rate=drop_rate,
            aug_rate=aug_rate)
        for name, val in sample_map.items():
            task_iou_map.setdefault(name, []).append(val)
        mean_ious.append(mean_iou)

    all_ious = [v for vals in task_iou_map.values() for v in vals]
    log_fn("Mean of all {} task-splits: {} +/- 95% CI: {}".format(
        len(all_ious), nanmean(all_ious), ci95(all_ious)))
    nan_count = int(np.count_nonzero(np.isnan(mean_ious)))
    log_fn("{} NaN values out of total number of samples: {}".format(
        nan_count, num_samples))
    return nanmean(mean_ious), task_iou_map
