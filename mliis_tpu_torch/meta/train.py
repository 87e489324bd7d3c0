"""The meta-training loop: `train_gecko`.

The port of the JAX package's `meta/train.py`. Orchestration stays on the
host: per meta-step, the annealed meta-step size, the draws, one chained
meta-step (`learners.make_chained_train_step`); every `eval_interval`
steps a train and a test evaluation whose IoUs go to `MetricsWriter`
scalars and drive the best-seen checkpoint; periodic checkpoints (and the
last step's) rotated to `max_checkpoints_to_keep`; an early exit at a
time deadline; the per-meta-step time line; and the `PhaseTimer` summary
appended to `phase_timings.jsonl`.

The JAX package's step strategies (vmapped, task groups, chained) make
the same draws and do the same outer math; the port always chains its
tasks. Its mesh strategies (`mesh_tasks`, `mesh_data`) are not ported and
raise. The draws of a meta-step come from `draw_fn(generator, counts,
meta_config, n_max)`, `learners.draw_meta_step` unless a caller (a test
injecting the JAX key discipline's indices) passes another.
"""
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta.evaluate import EvalConfig, GeckoEvaluator
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig)
from mliis_tpu_torch.meta.learners import (MetaTrainConfig, draw_meta_step,
                                           make_chained_train_step,
                                           meta_step_size_schedule)
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
    # Task-sharded (and task x data) meta-training: not ported.
    mesh_tasks: int = 0
    mesh_data: int = 0


def train_gecko(model: torch.nn.Module, state: ModelState,
                train_store: TaskStore, test_store: TaskStore,
                save_dir: str, loss_config: LossConfig,
                opt_config: OptimizerConfig, meta_config: MetaTrainConfig,
                loop_config: TrainLoopConfig, generator: torch.Generator,
                log_fn: Callable = print, device=None,
                draw_fn: Callable = draw_meta_step) -> ModelState:
    """Run meta-training on `device` (the card unless the caller asks for
    the CPU; `generator` lies there too); returns the final ModelState."""
    cfg = loop_config
    if cfg.mesh_tasks or cfg.mesh_data:
        raise NotImplementedError(
            "mesh_tasks / mesh_data: task- and data-sharded meta-training "
            "is not ported (ROADMAP.md, queue A, item 6)")
    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    model.to(dev)
    train_step = make_chained_train_step(model, loss_config, opt_config,
                                         meta_config)
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
        weight_decay_rate=meta_config.weight_decay_rate)
    evaluators = {
        "train": GeckoEvaluator(model, loss_config, opt_config, eval_cfg,
                                train_store, device=dev),
        "test": GeckoEvaluator(model, loss_config, opt_config, eval_cfg,
                               test_store, device=dev),
    }
    writers = {split: MetricsWriter(save_dir, split)
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
            draws = draw_fn(generator, store_counts, meta_config, n_max)
            state = train_step(state, store_images, store_masks, draws,
                               generator, cur_meta_step_size, cfg.lr)

        if i % cfg.eval_interval == 0:
            mean_ious = []
            for split in ("train", "test"):
                with timer.phase("eval_" + split):
                    mean_iou, _ = evaluators[split].evaluate(
                        state, generator, lr=cfg.lr, eval_all_tasks=False,
                        num_tasks_to_sample=cfg.num_tasks_to_eval,
                        aug_rate=cfg.aug_rate)
                writers[split].scalar("IoU", mean_iou, i)
                writers[split].scalar("meta_step_size", cur_meta_step_size, i)
                mean_ious.append(mean_iou)
            log_fn("Train step %d: train=%f test=%f"
                   % (i, mean_ious[0], mean_ious[1]))

            if cfg.save_best_seen and mean_ious[1] > best_eval_iou:
                best_eval_iou = mean_ious[1]
                log_fn("Highest test-set evaluation IoU seen at step {}: {}"
                       .format(i, best_eval_iou))
                ckpt_lib.save_checkpoint(best_save_dir, state, i,
                                         max_to_keep=1,
                                         metadata={"best_iou": best_eval_iou})

        if (i % cfg.save_checkpoint_every_n_meta_iters == 0
                or i == cfg.meta_iters - 1):
            ckpt_lib.save_checkpoint(save_dir, state, i,
                                     max_to_keep=cfg.max_checkpoints_to_keep)
        if cfg.time_deadline is not None and time.time() > cfg.time_deadline:
            log_fn("Time deadline reached at step {}".format(i))
            break
        log_estimated_time_remaining(begin_time, i, cfg.meta_iters,
                                     log_fn=log_fn)

    for w in writers.values():
        w.close()
    timer.dump(os.path.join(save_dir, "phase_timings.jsonl"), log_fn=log_fn)
    return state
