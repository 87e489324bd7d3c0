"""Reptile and FOMAML/FOMAML* meta-steps: the meta-batch on a task axis
(`make_train_step`, the JAX package's vmapped step and its default), in
task groups (`make_microbatched_train_step`, `--task_group_size`) or one
task after another (`make_chained_train_step`, `--chain_tasks`).

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

The task-axis steps run the slots' tasks together
(`inner_loop.make_batched_adapt_fn`): each inner step makes one
`full_pass` launch for all of them and one forward and backward. Slot s
still draws everything from its own generator, in the order the chained
step draws it, so the strategies compute the same function of the same
draws and differ only by float rounding. A task group is a run of
consecutive slots, so the groups of `make_microbatched_train_step` draw
what the whole meta-batch draws; the JAX package instead folds a key per
group (its learners.py:415-423), so there the two strategies agree in
distribution, not draw for draw.
"""
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (DataShardSpec, LossConfig,
                                             ModelState, OptimizerConfig,
                                             Tree, make_adapt_fn,
                                             make_batched_adapt_fn,
                                             make_lr_array, stack_states)
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


def make_batched_per_task_fn(model, loss_config: LossConfig,
                             opt_config: OptimizerConfig,
                             config: MetaTrainConfig,
                             data_shard: Optional[DataShardSpec] = None):
    """`make_per_task_fn` on a task axis: per_tasks(state, task_images_u8
    [T, n, H, W, 3], task_masks_u8 [T, n, H, W], draws (T TaskDraws),
    generators (T), lr) -> (updates, finals), both stacked [T, ...]: task
    t from `state` with draws[t] and generators[t]. The FOMAML* tail step
    runs on the task axis too: every task's tail has tail_shots samples.
    `data_shard` splits every task's augmented inner batches over a bound
    mesh data axis; the tail step runs whole on every data rank, as in
    `make_per_task_fn`."""
    adapt = make_batched_adapt_fn(
        model, loss_config, opt_config,
        weight_decay_rate=config.weight_decay_rate, augment=config.augment,
        precompute_augment=config.precompute_augment,
        pallas_augment=config.pallas_augment, data_shard=data_shard)
    gather = episodes.gather_tasks

    def lr_array(lr):
        return make_lr_array(lr, config.inner_iters, config.lr_scheduler,
                             config.lr_decay_rate,
                             config.lr_decay_after_n_steps)

    def stacked(draws, field):
        return torch.stack([getattr(d, field) for d in draws])

    if not config.foml:
        def per_tasks(state, task_images_u8, task_masks_u8, draws,
                      generators, lr):
            shots = stacked(draws, "shot_idx")
            adapted, _ = adapt(stack_states([state] * len(draws)),
                               gather(task_images_u8, shots),
                               gather(task_masks_u8, shots),
                               stacked(draws, "idx_matrix"), generators,
                               lr_array(lr))
            return adapted.params, adapted

        return per_tasks

    adapt_raw = make_batched_adapt_fn(
        model, loss_config, opt_config,
        weight_decay_rate=config.weight_decay_rate, augment=False)
    aug_rate = config.aug_rate

    def per_tasks(state, task_images_u8, task_masks_u8, draws, generators,
                  lr):
        shots = stacked(draws, "shot_idx")
        support_images = gather(task_images_u8, shots)
        support_masks = gather(task_masks_u8, shots)
        idx = stacked(draws, "idx_matrix")
        lrs = lr_array(lr)
        states = stack_states([state] * len(draws))
        if draws[0].tail_rel is not None:
            train_rel = stacked(draws, "train_rel")
            tail_rel = stacked(draws, "tail_rel")
            pre_tail, _ = adapt(states, gather(support_images, train_rel),
                                gather(support_masks, train_rel), idx,
                                generators, lrs[:-1], aug_rate=aug_rate)
            tail_idx = torch.arange(tail_rel.shape[1],
                                    device=tail_rel.device).expand(
                len(draws), 1, -1)
            final, _ = adapt_raw(pre_tail, gather(support_images, tail_rel),
                                 gather(support_masks, tail_rel), tail_idx,
                                 generators, lrs[-1:])
        else:
            pre_tail, _ = adapt(states, support_images, support_masks,
                                idx[:, :-1], generators, lrs[:-1],
                                aug_rate=aug_rate)
            final, _ = adapt(pre_tail, support_images, support_masks,
                             idx[:, -1:], generators, lrs[-1:],
                             aug_rate=aug_rate)
        return meta_math.tree_sub(final.params, pre_tail.params), final

    return per_tasks


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


def slot_inputs(store_images, store_masks, draws: MetaStepDraws,
                slots: Sequence[int]):
    """The task rows, draws and generators of the meta-batch slots
    `slots`: ([T, n, H, W, 3], [T, n, H, W], T TaskDraws, T generators)."""
    tids = draws.task_ids[list(slots)]
    return (torch.index_select(store_images, 0, tids),
            torch.index_select(store_masks, 0, tids),
            [draws.tasks[i] for i in slots],
            [draws.generators[i] for i in slots])


def sum_over_slots_batched(per_tasks, state: ModelState, store_images,
                           store_masks, draws: MetaStepDraws,
                           slots: Sequence[int], lr
                           ) -> Tuple[Tree, Tree, Tree]:
    """`sum_over_slots` with the tasks of `slots` run together on a task
    axis (`make_batched_per_task_fn`); the sums are taken in slot order."""
    updates, finals = per_tasks(state, *slot_inputs(
        store_images, store_masks, draws, slots), lr)
    sums = [meta_math.tree_zeros_like(state.params),
            meta_math.tree_zeros_like(state.batch_stats),
            meta_math.tree_zeros_like(state.opt.v)]
    for t in range(len(slots)):
        for i, tree in enumerate((updates, finals.batch_stats,
                                  finals.opt.v)):
            sums[i] = meta_math.tree_add(sums[i],
                                         {k: v[t] for k, v in tree.items()})
    return tuple(sums)


def _mean_state_over_tasks(states: ModelState) -> Tuple[Tree, object]:
    """The batch stats and optimizer slots of stacked final states,
    averaged over the task axis; the step count is shared."""
    batch_stats = meta_math.tree_mean_over_axis(states.batch_stats)
    opt_v = meta_math.tree_mean_over_axis(states.opt.v)
    return batch_stats, states.opt._replace(v=opt_v)


def make_train_step(model, loss_config: LossConfig,
                    opt_config: OptimizerConfig, config: MetaTrainConfig):
    """train_step(state, store_images, store_masks, draws, meta_step_size,
    lr) -> new ModelState, the meta-batch's tasks run together on a task
    axis (the JAX package's vmapped `make_train_step`): one `full_pass`
    launch and one forward and backward an inner step for all of them.
    Reptile or FOMAML/FOMAML* by `config.foml`; `draws` from
    `draw_meta_step`."""
    per_tasks = make_batched_per_task_fn(model, loss_config, opt_config,
                                         config)
    slots = range(config.meta_batch_size)

    def train_step(state: ModelState, store_images, store_masks,
                   draws: MetaStepDraws, meta_step_size, lr) -> ModelState:
        updates, finals = per_tasks(state, *slot_inputs(
            store_images, store_masks, draws, slots), lr)
        new_params = apply_outer_update(
            state, meta_math.tree_mean_over_axis(updates), meta_step_size,
            config.foml)
        new_bn, new_opt = _mean_state_over_tasks(finals)
        return ModelState(new_params, new_bn, new_opt)

    return train_step


def make_reptile_train_step(model, loss_config, opt_config, config):
    if config.foml:
        raise ValueError("make_reptile_train_step needs foml=False")
    return make_train_step(model, loss_config, opt_config, config)


def make_fomaml_train_step(model, loss_config, opt_config, config):
    if not config.foml:
        raise ValueError("make_fomaml_train_step needs foml=True")
    return make_train_step(model, loss_config, opt_config, config)


def make_group_train_step(model, loss_config: LossConfig,
                          opt_config: OptimizerConfig,
                          config: MetaTrainConfig, group_size: int):
    """group_step(state, store_images, store_masks, draws, meta_step_size,
    lr, num_real) -> the meta-step of one group: `draws` holds
    `group_size` slots run together on a task axis, of which the first
    `num_real` carry weight (the rest pad a ragged tail group and are
    computed and dropped, as in the JAX package)."""
    per_tasks = make_batched_per_task_fn(model, loss_config, opt_config,
                                         config)
    slots = range(group_size)

    def group_step(state: ModelState, store_images, store_masks,
                   draws: MetaStepDraws, meta_step_size, lr,
                   num_real: int) -> ModelState:
        if len(draws.tasks) != group_size:
            raise ValueError("a group of {} slots got {}".format(
                group_size, len(draws.tasks)))
        updates, finals = per_tasks(state, *slot_inputs(
            store_images, store_masks, draws, slots), lr)

        def wmean(tree):
            return {k: v[:num_real].sum(0) / num_real
                    for k, v in tree.items()}

        new_params = apply_outer_update(state, wmean(updates),
                                        meta_step_size, config.foml)
        new_opt = finals.opt._replace(v=wmean(finals.opt.v))
        return ModelState(new_params, wmean(finals.batch_stats), new_opt)

    return group_step


def _clone_generator(generator: torch.Generator) -> torch.Generator:
    """A generator that stands where `generator` stands."""
    clone = torch.Generator(device=generator.device)
    clone.set_state(generator.get_state())
    return clone


def make_microbatched_train_step(model, loss_config: LossConfig,
                                 opt_config: OptimizerConfig,
                                 config: MetaTrainConfig, group_size: int,
                                 pad_tail: bool = False):
    """train_step(state, store_images, store_masks, draws, meta_step_size,
    lr) -> new ModelState, the meta-batch run as ceil(m / g) groups of up
    to `group_size` consecutive slots, each group on a task axis
    (`make_group_train_step`), combined with the weights size / m:
    theta + sum_g w_g (theta_g - theta), likewise the batch stats and
    optimizer slots (the JAX package's `make_microbatched_train_step`).
    Both outer updates are linear in the per-task results, so this is the
    whole meta-batch's step up to float rounding.

    A ragged tail group (5 = 2 + 2 + 1) runs at its own size, or with
    `pad_tail` at `group_size`, its extra slots copies of its last slot
    (the same task, draws and a generator standing where the slot's
    stands) at weight 0: the JAX package's one-compiled-shape mode, which
    the port keeps for the flag's sake and which only adds work."""
    m = config.meta_batch_size
    starts = list(range(0, m, group_size))
    sizes = [min(group_size, m - s) for s in starts]
    steps = {}
    for size in set(sizes):
        width = group_size if pad_tail else size
        if width not in steps:
            steps[width] = make_group_train_step(
                model, loss_config, opt_config, config, width)
    weights = [size / m for size in sizes]

    def combine(base, groups):
        return {k: v + sum(w * (g[k] - v) for w, g in zip(weights, groups))
                for k, v in base.items()}

    def train_step(state: ModelState, store_images, store_masks,
                   draws: MetaStepDraws, meta_step_size, lr) -> ModelState:
        group_states = []
        for start, size in zip(starts, sizes):
            sl = slice(start, start + size)
            group = MetaStepDraws(draws.task_ids[sl], draws.tasks[sl],
                                  draws.generators[sl])
            width = group_size if pad_tail else size
            if width > size:   # pad with copies of the last real slot
                pad = width - size
                group = MetaStepDraws(
                    torch.cat([group.task_ids,
                               group.task_ids[-1:].expand(pad)]),
                    group.tasks + [group.tasks[-1]] * pad,
                    group.generators + [_clone_generator(
                        group.generators[-1]) for _ in range(pad)])
            group_states.append(steps[width](
                state, store_images, store_masks, group, meta_step_size, lr,
                size))
        new_opt = state.opt._replace(
            v=combine(state.opt.v, [g.opt.v for g in group_states]),
            step=group_states[0].opt.step)
        return ModelState(
            combine(state.params, [g.params for g in group_states]),
            combine(state.batch_stats,
                    [g.batch_stats for g in group_states]), new_opt)

    return train_step


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
