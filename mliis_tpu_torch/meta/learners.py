"""Reptile and FOMAML/FOMAML* meta-steps, with the meta-batch run one task
after another (the JAX package's chained step).

Reference semantics (the JAX package's `meta/learners.py`):
  - Reptile: adapt each task for inner_iters steps; theta <- theta +
    eps * (mean adapted - theta).
  - FOMAML: the update is the displacement of the LAST inner step only,
    averaged over tasks and scaled by eps. With tail_shots ("FOMAML*") the
    support set splits into train/tail: inner_iters - 1 augmented batches
    come from train and the last step runs on the raw tail batch.
  - Batch-norm running stats and optimizer slots are averaged over the
    tasks' final states.

The draws of a meta-step (task ids; per task the shots, the train/tail
split and the batch index matrix) are made by `draw_meta_step` and passed
to the step, so a test can inject the indices the JAX key discipline
yields. The streams are slot-indexed: slot s draws its task id, its
indices and, inside the step, its augmentation, dropout and drop-connect
from its own generator (`MetaStepDraws.generators`), seeded from the
meta-step's seed and s, so any subset of the slots can run anywhere
(`parallel/mesh.make_sharded_train_step`) and draw what it draws here.
"""
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (DataShardSpec, LossConfig,
                                             ModelState, OptimizerConfig,
                                             Tree, make_adapt_fn,
                                             make_lr_array)
from mliis_tpu_torch.ops import meta_math


@dataclasses.dataclass(frozen=True)
class MetaTrainConfig:
    num_shots: int = 10              # train_shots
    inner_batch_size: int = 8
    inner_iters: int = 59
    replacement: bool = False
    meta_batch_size: int = 5
    foml: bool = False
    tail_shots: Optional[int] = None  # FOMAML* when set
    sample_train_val_with_replacement: bool = False
    augment: bool = True
    aug_rate: Optional[float] = None  # None -> Augmenter default gate (6/7)
    weight_decay_rate: float = 1.0
    precompute_augment: bool = False
    # None or True: the augmentation kernels; False: their plain versions.
    pallas_augment: Optional[bool] = None
    lr_scheduler: str = "fixed"
    lr_decay_rate: float = 0.5
    lr_decay_after_n_steps: int = 5


class TaskDraws(NamedTuple):
    """One task's indices: shots into the task row, the train/tail split
    into the shots (tail_rel None without a tail), and the batch index
    matrix into the train shots."""
    shot_idx: torch.Tensor
    train_rel: Optional[torch.Tensor]
    tail_rel: Optional[torch.Tensor]
    idx_matrix: torch.Tensor


class MetaStepDraws(NamedTuple):
    """Every slot's task id, draws and generator (which the step goes on
    drawing from)."""
    task_ids: torch.Tensor
    tasks: List[TaskDraws]
    generators: List[torch.Generator]


def draw_task(generator: torch.Generator, count: torch.Tensor,
              config: MetaTrainConfig, n_max: int) -> TaskDraws:
    dev = count.device
    shot_idx = episodes.sample_shot_indices(generator, count,
                                            config.num_shots, n_max)
    tail = config.tail_shots if config.foml else None
    if tail is None:
        idx = episodes.batch_indices(generator, config.num_shots,
                                     config.inner_batch_size,
                                     config.inner_iters, config.replacement,
                                     dev)
        return TaskDraws(shot_idx, None, None, idx)
    train_shots = config.num_shots - tail
    if config.sample_train_val_with_replacement:
        train_rel, tail_rel = episodes.split_with_replacement(
            generator, config.num_shots, train_shots, tail, dev)
    else:
        train_rel, tail_rel = episodes.split_support_query(
            generator, config.num_shots, tail, dev)
    idx = episodes.batch_indices(generator, train_shots,
                                 config.inner_batch_size,
                                 config.inner_iters - 1, config.replacement,
                                 dev)
    return TaskDraws(shot_idx, train_rel, tail_rel, idx)


def draw_meta_step(seed: int, counts: torch.Tensor,
                   config: MetaTrainConfig, n_max: int) -> MetaStepDraws:
    """Per slot, from the slot's own generator (`episodes.slot_generator`
    of `seed` and the slot): its task id (uniform with replacement) and
    its task's draws."""
    dev = counts.device
    generators = [episodes.slot_generator(seed, s, dev)
                  for s in range(config.meta_batch_size)]
    task_ids = torch.cat([episodes.sample_task_ids(g, counts.shape[0], 1,
                                                   dev)
                          for g in generators])
    tasks = [draw_task(g, torch.index_select(counts, 0,
                                             task_ids[i:i + 1])[0],
                       config, n_max)
             for i, g in enumerate(generators)]
    return MetaStepDraws(task_ids, tasks, generators)


def make_per_task_fn(model, loss_config: LossConfig,
                     opt_config: OptimizerConfig, config: MetaTrainConfig,
                     data_shard: Optional[DataShardSpec] = None):
    """per_task(state, task_images_u8, task_masks_u8, draws, generator, lr)
    -> (update, final ModelState): `update` is the FOMAML last-step
    displacement or, for Reptile, the adapted params.

    `data_shard` splits every augmented inner batch over a bound mesh data
    axis (`inner_loop.DataShardSpec`). The FOMAML* tail step is not split:
    its tail batch need not divide the axis, so every shard runs the whole
    raw tail batch alike, as in the JAX package."""
    adapt = make_adapt_fn(model, loss_config, opt_config,
                          weight_decay_rate=config.weight_decay_rate,
                          augment=config.augment,
                          precompute_augment=config.precompute_augment,
                          pallas_augment=config.pallas_augment,
                          data_shard=data_shard)

    def lr_array(lr):
        return make_lr_array(lr, config.inner_iters, config.lr_scheduler,
                             config.lr_decay_rate,
                             config.lr_decay_after_n_steps)

    if not config.foml:
        def per_task(state, task_images_u8, task_masks_u8, draws, generator,
                     lr):
            # Reptile does not forward aug_rate: the default gate applies.
            adapted, _ = adapt(state, task_images_u8[draws.shot_idx],
                               task_masks_u8[draws.shot_idx],
                               draws.idx_matrix, generator, lr_array(lr))
            return adapted.params, adapted

        return per_task

    adapt_raw = make_adapt_fn(model, loss_config, opt_config,
                              weight_decay_rate=config.weight_decay_rate,
                              augment=False)
    aug_rate = config.aug_rate

    def per_task(state, task_images_u8, task_masks_u8, draws: TaskDraws,
                 generator, lr):
        support_images = task_images_u8[draws.shot_idx]
        support_masks = task_masks_u8[draws.shot_idx]
        lrs = lr_array(lr)
        if draws.tail_rel is not None:
            pre_tail, _ = adapt(state, support_images[draws.train_rel],
                                support_masks[draws.train_rel],
                                draws.idx_matrix, generator, lrs[:-1],
                                aug_rate=aug_rate)
            tail = draws.tail_rel.shape[0]
            tail_idx = torch.arange(tail, device=draws.tail_rel.device)[None]
            final, _ = adapt_raw(pre_tail, support_images[draws.tail_rel],
                                 support_masks[draws.tail_rel], tail_idx,
                                 generator, lrs[-1:])
        else:
            pre_tail, _ = adapt(state, support_images, support_masks,
                                draws.idx_matrix[:-1], generator, lrs[:-1],
                                aug_rate=aug_rate)
            final, _ = adapt(pre_tail, support_images, support_masks,
                             draws.idx_matrix[-1:], generator, lrs[-1:],
                             aug_rate=aug_rate)
        return meta_math.tree_sub(final.params, pre_tail.params), final

    return per_task


def apply_outer_update(state: ModelState, mean_update, meta_step_size,
                       foml: bool):
    """theta + eps*mean(displacements) (FOMAML) or
    theta + eps*(mean(adapted) - theta) (Reptile)."""
    if foml:
        return meta_math.tree_add(
            state.params, meta_math.tree_scale(mean_update, meta_step_size))
    return meta_math.tree_interpolate(state.params, mean_update,
                                      meta_step_size)


def sum_over_slots(per_task, state: ModelState, store_images,
                   store_masks, draws: MetaStepDraws, slots: Sequence[int],
                   lr) -> Tuple[Tree, Tree, Tree]:
    """Sums of the updates, the final batch stats and the final optimizer
    slots of the tasks in `slots`, run one after another, each from
    `state` with its slot's draws and generator."""
    sum_u = meta_math.tree_zeros_like(state.params)
    sum_bn = meta_math.tree_zeros_like(state.batch_stats)
    sum_v = meta_math.tree_zeros_like(state.opt.v)
    for i in slots:
        tid = draws.task_ids[i:i + 1]
        update, final = per_task(
            state, torch.index_select(store_images, 0, tid)[0],
            torch.index_select(store_masks, 0, tid)[0], draws.tasks[i],
            draws.generators[i], lr)
        sum_u = meta_math.tree_add(sum_u, update)
        sum_bn = meta_math.tree_add(sum_bn, final.batch_stats)
        sum_v = meta_math.tree_add(sum_v, final.opt.v)
    return sum_u, sum_bn, sum_v


def finish_meta_step(state: ModelState, sums: Tuple[Tree, Tree, Tree],
                     config: MetaTrainConfig, meta_step_size) -> ModelState:
    """The outer update from the meta-batch's sums: the means over its
    `meta_batch_size` tasks of the updates, batch stats and optimizer
    slots. Every task takes `inner_iters` optimizer steps from `state`."""
    sum_u, sum_bn, sum_v = sums
    inv_m = 1.0 / config.meta_batch_size
    new_params = apply_outer_update(state,
                                    meta_math.tree_scale(sum_u, inv_m),
                                    meta_step_size, config.foml)
    new_opt = state.opt._replace(v=meta_math.tree_scale(sum_v, inv_m),
                                 step=state.opt.step + config.inner_iters)
    return ModelState(new_params, meta_math.tree_scale(sum_bn, inv_m),
                      new_opt)


def make_chained_train_step(model, loss_config: LossConfig,
                            opt_config: OptimizerConfig,
                            config: MetaTrainConfig):
    """train_step(state, store_images, store_masks, draws, meta_step_size,
    lr) -> new ModelState, the meta-batch's tasks run one after another;
    `draws` from `draw_meta_step`."""
    per_task = make_per_task_fn(model, loss_config, opt_config, config)
    slots = range(config.meta_batch_size)

    def train_step(state: ModelState, store_images, store_masks,
                   draws: MetaStepDraws, meta_step_size, lr) -> ModelState:
        return finish_meta_step(
            state, sum_over_slots(per_task, state, store_images, store_masks,
                                  draws, slots, lr),
            config, meta_step_size)

    return train_step


def meta_step_size_schedule(step: int, meta_iters: int, initial: float,
                            final: float) -> float:
    """Linear anneal."""
    frac_done = step / meta_iters
    return frac_done * final + (1.0 - frac_done) * initial
