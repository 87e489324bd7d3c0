"""Early-stopping evaluation and the UHO search.

The port of the JAX package's `meta/uho_eval.py`:
  - `EarlyStoppingEvaluator.evaluate_with_early_stopping`: per task, split
    num_shots + test_shots examples into support and val, adapt up to
    max_steps while probing the val set after every step, walk the trace
    with the patience stopper, and collect (task, best steps, best mIoU);
    optionally re-evaluate every task at the MEDIAN best step count.
  - `optimize_update_hyperparams`: the GP search over {lr, drop_rate,
    aug_rate, inner_batch_size} with the above as its objective; writes the
    per-config CSV (with `_{shots}-shot` before its extension) and returns
    (best lr, median steps).
The traces run `task_chunk_size` tasks at a time on a task axis
(`early_stopping.make_batched_early_stopping_trace_fn`, the JAX package's
vmap of its trace), or one after another with `chain_chunk`; so does the
median-step re-evaluation (`evaluate.GeckoEvaluator`). An evaluation
draws one seed from the generator passed in, and its task j draws from
its own generator (`episodes.slot_generator`), so both strategies trace
the same function of the same draws. With a mesh each task rank traces
its share of the tasks in chunks of ceil(task_chunk_size / task ranks)
and the (steps, IoU) pairs are all-reduced into place, so every rank
walks the same GP search; rank 0 alone writes its CSV. As in the JAX
package, a mesh drops `chain_chunk`.
"""
import os
import random as pyrandom
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta import episodes, uho
from mliis_tpu_torch.meta.early_stopping import (
    make_batched_early_stopping_trace_fn, make_early_stopping_trace_fn,
    walk_trace)
from mliis_tpu_torch.meta.evaluate import (EvalConfig, GeckoEvaluator,
                                           draw_episode)
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig, stack_states)
from mliis_tpu_torch.parallel import mesh as mesh_lib


class EarlyStoppingEvaluator:
    """Early-stopping evaluation over a TaskStore held on `device` (the
    card unless the caller asks for the CPU); with a `mesh`, its tasks
    shard over the task axis (and `chain_chunk` is dropped, as in the JAX
    package)."""

    def __init__(self, model: torch.nn.Module, loss_config: LossConfig,
                 opt_config: OptimizerConfig, store: TaskStore,
                 num_shots: int = 5, test_shots: int = 5,
                 replacement: bool = False, augment: bool = True,
                 weight_decay_rate: float = 1.0, patience: int = 50,
                 pallas_augment: Optional[bool] = None, device=None,
                 mesh=None, task_chunk_size: int = 4,
                 chain_chunk: bool = False):
        self.device = resolve_device(device)
        self.task_chunk_size = task_chunk_size
        self.chain_chunk = chain_chunk and mesh is None
        self.mesh = mesh
        self.model = model.to(self.device)
        self.loss_config = loss_config
        self.opt_config = opt_config
        self.store = store
        self.num_shots = num_shots
        self.test_shots = test_shots
        self.replacement = replacement
        self.augment = augment
        self.weight_decay_rate = weight_decay_rate
        self.patience = patience
        self.pallas_augment = pallas_augment
        self._images, self._masks, self._counts = store.to_torch(self.device)
        kw = dict(augment=augment, weight_decay_rate=weight_decay_rate,
                  pallas_augment=pallas_augment)
        self._trace = make_early_stopping_trace_fn(model, loss_config,
                                                   opt_config, **kw)
        self._batched_trace = make_batched_early_stopping_trace_fn(
            model, loss_config, opt_config, **kw)
        # Median-step re-evaluation evaluators, keyed by their EvalConfig:
        # the GP search asks for the same step counts again and again.
        self._gecko_cache: Dict[EvalConfig, GeckoEvaluator] = {}

    def _trace_tasks(self, state: ModelState, rows: List[int],
                     generators: List[torch.Generator], max_steps: int,
                     inner_batch_size: int, lr: float, drop_rate: float,
                     aug_rate) -> np.ndarray:
        """The [len(rows), max_steps] val mIoU traces of the store rows
        `rows`, row k's episode drawn from generators[k]: one after
        another with `chain_chunk`, else together on a task axis."""
        cfg = EvalConfig(num_shots=self.num_shots,
                         test_shots=self.test_shots,
                         inner_batch_size=inner_batch_size,
                         inner_iters=max_steps, replacement=self.replacement)
        parts = []
        for row, g in zip(rows, generators):
            draws = draw_episode(g, self._counts[row], cfg,
                                 self._images.shape[1])
            support = draws.shot_idx[draws.support_rel]
            val = draws.shot_idx[draws.query_rel]
            images, masks = self._images[row], self._masks[row]
            parts.append((images[support], masks[support], images[val],
                          masks[val], draws.idx_matrix))
        if self.chain_chunk:
            traces = torch.stack([self._trace(state, *part, g, lr, drop_rate,
                                              aug_rate)
                                  for part, g in zip(parts, generators)])
        else:
            traces = self._batched_trace(
                stack_states([state] * len(rows)),
                *(torch.stack(t) for t in zip(*parts)), generators, lr,
                drop_rate, aug_rate)
        return traces.cpu().numpy()

    def evaluate_with_early_stopping(
            self, state: ModelState, generator: torch.Generator,
            min_steps: int, max_steps: int, inner_batch_size: int = 8,
            lr: float = 5e-4, drop_rate: Optional[float] = None,
            aug_rate: Optional[float] = 0.5, eval_all_tasks: bool = False,
            num_tasks_to_sample: int = 20,
            eval_tasks_with_median_early_stopping_iterations: bool = False,
            rng: Optional[pyrandom.Random] = None,
            task_indices: Optional[List[int]] = None
            ) -> Tuple[List[str], List[int], List[float]]:
        """Returns (task_names, best num steps per task, IoU scores).

        `task_indices` restricts the run to those store rows (the k-shot
        curves probe one task at a time); otherwise every task, or a
        shuffled sample of `num_tasks_to_sample`."""
        if task_indices is not None:
            indices = list(task_indices)
        else:
            indices = list(range(self.store.num_tasks))
            if not eval_all_tasks:
                (rng or pyrandom).shuffle(indices)
                indices = indices[:num_tasks_to_sample]
        task_names = [self.store.names[i] for i in indices]

        if min_steps != max_steps:
            if drop_rate is None:  # the model's own rate
                default = getattr(self.model, "final_layer_dropout_rate",
                                  None)
                drop_rate = float(default) if default else 0.0
            seed = episodes.draw_seed(generator)
            n = len(indices)
            walked = torch.zeros((2, n), dtype=torch.float64,
                                 device=self.device)
            positions = list(range(n) if self.mesh is None
                             else mesh_lib.share(n, self.mesh))
            ranks = 1 if self.mesh is None else mesh_lib.axis_size_of(
                self.mesh, mesh_lib.TASK_AXIS)
            chunk = -(-self.task_chunk_size // ranks)
            for start in range(0, len(positions), chunk):
                js = positions[start:start + chunk]
                traces = self._trace_tasks(
                    state, [indices[j] for j in js],
                    [episodes.slot_generator(seed, j, self.device)
                     for j in js], max_steps, inner_batch_size, lr,
                    drop_rate, aug_rate)
                for j, trace in zip(js, traces):
                    walked[:, j] = torch.tensor(walk_trace(
                        trace, patience=self.patience, min_steps=min_steps),
                        dtype=torch.float64)
            if self.mesh is not None:
                walked = mesh_lib.all_reduce_sum(
                    [walked], self.mesh.get_group(mesh_lib.TASK_AXIS))[0]
            num_steps = [int(v) for v in walked[0].tolist()]
            ious = walked[1].tolist()
            estimated_best_num_steps = int(np.median(num_steps))
        else:
            estimated_best_num_steps = min_steps
            num_steps = [estimated_best_num_steps] * len(indices)
            ious = []

        if (eval_tasks_with_median_early_stopping_iterations
                or min_steps == max_steps):
            eval_cfg = EvalConfig(
                num_shots=self.num_shots, test_shots=self.test_shots,
                inner_batch_size=inner_batch_size,
                inner_iters=max(estimated_best_num_steps, 1),
                replacement=self.replacement, augment=self.augment,
                weight_decay_rate=self.weight_decay_rate,
                pallas_augment=self.pallas_augment,
                task_chunk_size=self.task_chunk_size,
                chain_chunk=self.chain_chunk)
            evaluator = self._gecko_cache.get(eval_cfg)
            if evaluator is None:
                evaluator = GeckoEvaluator(self.model, self.loss_config,
                                           self.opt_config, eval_cfg,
                                           self.store, device=self.device,
                                           mesh=self.mesh)
                self._gecko_cache[eval_cfg] = evaluator
            per_task = evaluator.evaluate_tasks(state, indices, generator, lr,
                                                drop_rate, aug_rate)
            ious = [float(x) for x in per_task]

        return task_names, list(num_steps), list(ious)


def optimize_update_hyperparams(
        es_evaluator: EarlyStoppingEvaluator, state: ModelState,
        generator: torch.Generator, min_steps: int = 0, max_steps: int = 80,
        num_configs_to_sample: int = 100,
        num_train_val_data_splits_to_sample_per_config: int = 1,
        lr_search_range_low: float = 0.0005, lr_search_range_high: float = 0.05,
        drop_rate_search_range_low: float = 0.2,
        drop_rate_search_range_high: float = 0.2,
        aug_rate_search_range_low: float = 0.5,
        aug_rate_search_range_high: float = 0.5,
        batch_size_search_range_low: int = 8,
        batch_size_search_range_high: int = 8,
        serially_eval_all_tasks: bool = True, num_tasks_to_sample: int = 20,
        eval_tasks_with_median_early_stopping_iterations: bool = False,
        save_dir: Optional[str] = None,
        results_csv_name: str = "GP_val-set_hyper_param_search_results.csv",
        num_shots: int = 5, estimator: str = "GP",
        log_fn=print) -> Tuple[float, int]:
    """GP search over update hyperparams; returns (best_lr, best step num)."""
    assert estimator in uho.SUPPORTED_SEARCH_ALGS

    def eval_fn(lr=None, drop_rate=None, aug_rate=None, inner_batch_size=8,
                **_):
        return es_evaluator.evaluate_with_early_stopping(
            state, generator, min_steps=min_steps, max_steps=max_steps,
            inner_batch_size=int(inner_batch_size),
            lr=lr if lr is not None else 5e-4,
            drop_rate=drop_rate, aug_rate=aug_rate,
            eval_all_tasks=serially_eval_all_tasks,
            num_tasks_to_sample=num_tasks_to_sample,
            eval_tasks_with_median_early_stopping_iterations=(
                eval_tasks_with_median_early_stopping_iterations))

    before_ext, ext = os.path.splitext(results_csv_name)
    results_csv_name = "{}_{}-shot{}".format(before_ext, num_shots, ext)
    save_results_to = os.path.join(save_dir, results_csv_name) \
        if save_dir is not None else results_csv_name
    if not mesh_lib.is_writer():
        save_results_to = None

    params = {uho.LEARNING_RATE_NAME: None, uho.DROPOUT_RATE_NAME: None,
              uho.AUG_RATE_NAME: 0.5, uho.BATCH_SIZE_NAME: 8}
    return uho.lr_droprate_aug_rate_batch_size_gp_search(
        eval_fn, params,
        lr_search_range_low=lr_search_range_low,
        lr_search_range_high=lr_search_range_high,
        drop_rate_search_range_low=drop_rate_search_range_low,
        drop_rate_search_range_high=drop_rate_search_range_high,
        aug_rate_search_range_low=aug_rate_search_range_low,
        aug_rate_search_range_high=aug_rate_search_range_high,
        batch_size_search_range_low=batch_size_search_range_low,
        batch_size_search_range_high=batch_size_search_range_high,
        n=num_configs_to_sample,
        m=num_train_val_data_splits_to_sample_per_config,
        save_results_to=save_results_to, log_fn=log_fn)
