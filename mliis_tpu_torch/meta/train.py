"""The meta-training loop: `train_gecko`.

The port of the JAX package's `meta/train.py`. Orchestration stays on the
host: per meta-step, the annealed meta-step size, the draws, one
meta-step; every `eval_interval`
steps a train and a test evaluation whose IoUs go to `MetricsWriter`
scalars and drive the best-seen checkpoint; periodic checkpoints (and the
last step's) rotated to `max_checkpoints_to_keep`; an early exit at a
time deadline; the per-meta-step time line; and the `PhaseTimer` summary
appended to `phase_timings.jsonl`.

The step is chosen as the JAX package chooses it (its meta/train.py:91-
127): with `mesh_tasks`, the sharded step (each rank's slots chained
with `chain_tasks`, on a task axis without); else with `chain_tasks`
the chained step (`learners.make_chained_train_step`); else with
`task_group_size` the microbatched step
(`learners.make_microbatched_train_step`); else the meta-batch on a task
axis (`learners.make_train_step`). The strategies make the same draws
and the same outer math. The interval evaluators run their tasks
`eval_task_chunk_size` at a time on a task axis, or one after another
with `chain_eval_chunk`. With `mesh_tasks` the meta-batch shards over a
task mesh of that many ranks (`parallel/mesh.make_sharded_train_step`);
with `mesh_data`
> 1 as well, over a (mesh_tasks, mesh_data) mesh whose training model is
a sync-BN copy of `model`, while the interval evaluators keep `model` and
shard their tasks over a task mesh of all the ranks. Every rank runs this
loop; rank 0 alone writes the metrics, checkpoints and phase timings and
logs. The draws of a meta-step come from `draw_fn(seed, counts,
meta_config, n_max)`, `learners.draw_meta_step` unless a caller (a test
injecting the JAX key discipline's indices) passes another; the seed is
drawn from `generator`, the same on every rank.
"""
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.evaluate import EvalConfig, GeckoEvaluator
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig)
from mliis_tpu_torch.meta.learners import (MetaTrainConfig, draw_meta_step,
                                           make_chained_train_step,
                                           make_microbatched_train_step,
                                           make_train_step,
                                           meta_step_size_schedule)
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.utils import checkpoint as ckpt_lib
from mliis_tpu_torch.utils.logging import (MetricsWriter,
                                           log_estimated_time_remaining)
from mliis_tpu_torch.utils.profiling import PhaseTimer


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    meta_iters: int = 50000
    meta_step_size: float = 0.1
    meta_step_size_final: float = 0.1
    eval_interval: int = 10
    eval_inner_batch_size: int = 8
    eval_inner_iters: int = 59
    num_eval_shots: int = 5
    num_tasks_to_eval: int = 100
    save_checkpoint_every_n_meta_iters: int = 100
    max_checkpoints_to_keep: int = 2
    save_best_seen: bool = False
    time_deadline: Optional[float] = None
    lr: float = 5e-4
    transductive: bool = False
    aug_rate: Optional[float] = None
    # Run the meta-batch in task groups of this size (the microbatched
    # step) when set.
    task_group_size: Optional[int] = None
    # Run the meta-batch's tasks one after another (the chained step); with
    # mesh_tasks, each rank's slots.
    chain_tasks: bool = False
    # Run the interval evaluators' chunks one task after another.
    chain_eval_chunk: bool = False
    # When > 0, shard the meta-batch (and the evaluators' tasks) over a
    # task mesh of this many ranks (parallel/mesh.py).
    mesh_tasks: int = 0
    # When > 1 (with mesh_tasks), meta-train on a (mesh_tasks, mesh_data)
    # mesh: every inner batch also splits over the data axis, with sync-BN.
    mesh_data: int = 0


def train_gecko(model: torch.nn.Module, state: ModelState,
                train_store: TaskStore, test_store: TaskStore,
                save_dir: str, loss_config: LossConfig,
                opt_config: OptimizerConfig, meta_config: MetaTrainConfig,
                loop_config: TrainLoopConfig, generator: torch.Generator,
                log_fn: Callable = print, device=None,
                draw_fn: Callable = draw_meta_step,
                eval_task_chunk_size: int = 8) -> ModelState:
    """Run meta-training on `device` (the card unless the caller asks for
    the CPU; with a mesh, this rank's card; `generator` lies there too);
    returns the final ModelState. The interval evaluators take
    `eval_task_chunk_size` tasks at a time."""
    cfg = loop_config
    if cfg.mesh_data and cfg.mesh_data > 1 and not cfg.mesh_tasks:
        raise ValueError(
            "mesh_data > 1 requires mesh_tasks (the 2D mesh is "
            "mesh_tasks x mesh_data; use mesh_tasks=1 for pure data "
            "parallelism) -- refusing to silently train unsharded")
    os.makedirs(save_dir, exist_ok=True)
    mesh = None
    if cfg.mesh_tasks:
        n_data = max(cfg.mesh_data, 1)
        dev = mesh_lib.init_world(cfg.mesh_tasks * n_data, device, save_dir)
        mesh = mesh_lib.make_task_mesh(cfg.mesh_tasks * n_data, dev)
        train_mesh, train_model = mesh, model.to(dev)
        if n_data > 1:
            train_mesh = mesh_lib.make_task_data_mesh(cfg.mesh_tasks, n_data,
                                                      dev)
            train_model = mesh_lib.sync_bn_copy(model)
        train_step = mesh_lib.make_sharded_train_step(
            train_model, loss_config, opt_config, meta_config, train_mesh,
            chain_local=cfg.chain_tasks)
        state = mesh_lib.replicate_to_mesh(state, train_mesh)
    else:
        dev = resolve_device(device)
        if cfg.chain_tasks:
            train_step = make_chained_train_step(model, loss_config,
                                                 opt_config, meta_config)
        elif cfg.task_group_size:
            train_step = make_microbatched_train_step(
                model, loss_config, opt_config, meta_config,
                group_size=cfg.task_group_size)
        else:
            train_step = make_train_step(model, loss_config, opt_config,
                                         meta_config)
    model.to(dev)
    writes = mesh_lib.is_writer()
    log_fn = mesh_lib.writer_log(log_fn)
    # The interval evaluators inherit the training run's protocol, so the
    # IoUs that pick the best-seen checkpoint follow the configured one.
    eval_cfg = EvalConfig(
        num_shots=cfg.num_eval_shots,
        inner_batch_size=cfg.eval_inner_batch_size,
        inner_iters=cfg.eval_inner_iters,
        replacement=meta_config.replacement,
        transductive=cfg.transductive,
        augment=meta_config.augment,
        precompute_augment=meta_config.precompute_augment,
        pallas_augment=meta_config.pallas_augment,
        lr_scheduler=meta_config.lr_scheduler,
        lr_decay_rate=meta_config.lr_decay_rate,
        lr_decay_after_n_steps=meta_config.lr_decay_after_n_steps,
        weight_decay_rate=meta_config.weight_decay_rate,
        task_chunk_size=eval_task_chunk_size,
        chain_chunk=cfg.chain_eval_chunk)
    evaluators = {
        "train": GeckoEvaluator(model, loss_config, opt_config, eval_cfg,
                                train_store, device=dev, mesh=mesh),
        "test": GeckoEvaluator(model, loss_config, opt_config, eval_cfg,
                               test_store, device=dev, mesh=mesh),
    }
    writers = {split: MetricsWriter(save_dir, split) if writes else None
               for split in ("train", "test")}
    store_images, store_masks, store_counts = train_store.to_torch(dev)
    n_max = store_images.shape[1]

    best_eval_iou = -np.inf
    best_save_dir = os.path.join(save_dir, "best_eval")
    timer = PhaseTimer(dev)

    for i in range(cfg.meta_iters):
        begin_time = time.time()
        cur_meta_step_size = meta_step_size_schedule(
            i, cfg.meta_iters, cfg.meta_step_size, cfg.meta_step_size_final)
        with timer.phase("meta_step"):
            draws = draw_fn(episodes.draw_seed(generator), store_counts,
                            meta_config, n_max)
            state = train_step(state, store_images, store_masks, draws,
                               cur_meta_step_size, cfg.lr)

        if i % cfg.eval_interval == 0:
            mean_ious = []
            for split in ("train", "test"):
                with timer.phase("eval_" + split):
                    mean_iou, _ = evaluators[split].evaluate(
                        state, generator, lr=cfg.lr, eval_all_tasks=False,
                        num_tasks_to_sample=cfg.num_tasks_to_eval,
                        aug_rate=cfg.aug_rate)
                if writes:
                    writers[split].scalar("IoU", mean_iou, i)
                    writers[split].scalar("meta_step_size",
                                          cur_meta_step_size, i)
                mean_ious.append(mean_iou)
            log_fn("Train step %d: train=%f test=%f"
                   % (i, mean_ious[0], mean_ious[1]))

            if cfg.save_best_seen and mean_ious[1] > best_eval_iou:
                best_eval_iou = mean_ious[1]
                log_fn("Highest test-set evaluation IoU seen at step {}: {}"
                       .format(i, best_eval_iou))
                if writes:
                    ckpt_lib.save_checkpoint(
                        best_save_dir, state, i, max_to_keep=1,
                        metadata={"best_iou": best_eval_iou})

        if writes and (i % cfg.save_checkpoint_every_n_meta_iters == 0
                       or i == cfg.meta_iters - 1):
            ckpt_lib.save_checkpoint(save_dir, state, i,
                                     max_to_keep=cfg.max_checkpoints_to_keep)
        if cfg.time_deadline is not None:
            late = time.time() > cfg.time_deadline
            if mesh is not None:   # every rank stops at the same step
                late = mesh_lib.any_rank(late, dev)
            if late:
                log_fn("Time deadline reached at step {}".format(i))
                break
        log_estimated_time_remaining(begin_time, i, cfg.meta_iters,
                                     log_fn=log_fn)

    for w in writers.values():
        if w is not None:
            w.close()
    timer.dump(os.path.join(save_dir, "phase_timings.jsonl") if writes
               else None, log_fn=log_fn)
    return state
