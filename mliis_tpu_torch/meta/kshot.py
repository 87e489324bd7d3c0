"""K-shot learning-curve experiments (the FP-k benchmark).

The port of the JAX package's `meta/kshot.py`: for each task and each k
in the k-range, adapt on k support examples and measure the mIoU on up to
20 held-out query images; for k_eff >= 10 the step count is first
estimated by early stopping on an 80/20 split of the support set (at most
500 steps), else the caller's fixed `eval_inner_iters` is used (the
iteration range applies only with estimation off). Rows (k, mIoU) are
appended to k-shot-results.csv.

Evaluators are built over the whole task store and kept by their episode
shape (`EvaluatorCache`), as the JAX package keeps its compiled kernels;
`constructions` counts the builds.
"""
import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta.evaluate import EvalConfig, GeckoEvaluator
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig)
from mliis_tpu_torch.meta.uho_eval import EarlyStoppingEvaluator

DEFAULT_K_RANGE = [1, 5, 10, 50, 100, 200, 400]
DEFAULT_ITER_RANGE = [1, 5, 10, 25, 50, 100, 200]


class EvaluatorCache:
    """Evaluators over one store on one device, kept by episode shape."""

    def __init__(self, model: torch.nn.Module, loss_config: LossConfig,
                 opt_config: OptimizerConfig, store: TaskStore,
                 pallas_augment: Optional[bool] = None, device=None):
        self.model = model
        self.loss_config = loss_config
        self.opt_config = opt_config
        self.store = store
        self.pallas_augment = pallas_augment
        self.device = resolve_device(device)
        self._gecko: Dict[EvalConfig, GeckoEvaluator] = {}
        self._es: Dict[Tuple[int, int], EarlyStoppingEvaluator] = {}
        self.constructions = 0

    def gecko(self, config: EvalConfig) -> GeckoEvaluator:
        ev = self._gecko.get(config)
        if ev is None:
            ev = GeckoEvaluator(self.model, self.loss_config,
                                self.opt_config, config, self.store,
                                device=self.device)
            self._gecko[config] = ev
            self.constructions += 1
        return ev

    def early_stopping(self, num_shots: int,
                       test_shots: int) -> EarlyStoppingEvaluator:
        key = (num_shots, test_shots)
        ev = self._es.get(key)
        if ev is None:
            ev = EarlyStoppingEvaluator(
                self.model, self.loss_config, self.opt_config, self.store,
                num_shots=num_shots, test_shots=test_shots, augment=True,
                task_chunk_size=1, pallas_augment=self.pallas_augment,
                device=self.device)
            self._es[key] = ev
            self.constructions += 1
        return ev


def evaluate_k_shot_range(model, loss_config: LossConfig,
                          opt_config: OptimizerConfig, state: ModelState,
                          task_store: TaskStore, task_index: int,
                          generator: torch.Generator,
                          k_range: Sequence[int] = DEFAULT_K_RANGE,
                          iter_range: Sequence[int] = DEFAULT_ITER_RANGE,
                          test_samples: int = 20,
                          inner_batch_size: int = 8, lr: float = 5e-4,
                          aug_rate: float = 0.5,
                          eval_inner_iters: int = 5,
                          early_stopping_min_val_samples: int = 5,
                          estimate_inner_iters_with_early_stopping: bool = True,
                          max_es_steps: int = 500,
                          cache: Optional[EvaluatorCache] = None,
                          pallas_augment: Optional[bool] = None,
                          device=None, log_fn=print) -> List[float]:
    """mIoU for one task across the k-range."""
    if cache is None:
        cache = EvaluatorCache(model, loss_config, opt_config, task_store,
                               pallas_augment=pallas_augment, device=device)
    count = int(task_store.counts[task_index])
    test_samples = min(test_samples, max(count - 1, 1))
    mious = []
    for i, k in enumerate(k_range):
        k_eff = min(k, max(count - test_samples, 1))
        if estimate_inner_iters_with_early_stopping:
            inner_iters = eval_inner_iters
        else:
            inner_iters = (iter_range[i] if i < len(iter_range)
                           else iter_range[-1])
        if (estimate_inner_iters_with_early_stopping
                and k_eff >= early_stopping_min_val_samples * 2):
            val_shots = int(0.2 * k_eff)
            es = cache.early_stopping(num_shots=k_eff - val_shots,
                                      test_shots=val_shots)
            _, steps, _ = es.evaluate_with_early_stopping(
                state, generator, min_steps=1, max_steps=max_es_steps,
                inner_batch_size=inner_batch_size, lr=lr, aug_rate=aug_rate,
                task_indices=[task_index])
            inner_iters = max(int(np.median(steps)), 1)
            log_fn("{}-shot: early stopping chose {} steps".format(
                k, inner_iters))
        eval_cfg = EvalConfig(num_shots=k_eff, test_shots=test_samples,
                              inner_batch_size=min(inner_batch_size, k_eff),
                              inner_iters=inner_iters, transductive=True,
                              augment=True,
                              pallas_augment=cache.pallas_augment,
                              task_chunk_size=1)
        per_task = cache.gecko(eval_cfg).evaluate_tasks(
            state, [task_index], generator, lr, aug_rate=aug_rate)
        mious.append(float(per_task[0]))
        log_fn("{}-shot mIoU: {}".format(k, mious[-1]))
    return mious


def run_k_shot_learning_curves_experiment(
        model, loss_config: LossConfig, opt_config: OptimizerConfig,
        state: ModelState, dataset: TaskStore, generator: torch.Generator,
        num_samples: int = 1, k_range: Sequence[int] = DEFAULT_K_RANGE,
        iter_range: Optional[Sequence[int]] = None,
        eval_inner_batch_size: int = 8, eval_inner_iters: int = 5,
        lr: float = 5e-4, aug_rate: float = 0.5, test_samples: int = 20,
        csv_outpath: Optional[str] = "k-shot-results.csv",
        cache: Optional[EvaluatorCache] = None,
        pallas_augment: Optional[bool] = None, device=None,
        log_fn=print) -> Tuple[List[int], List[float]]:
    """num_samples repetitions x tasks x k-range; returns (ks, mIoUs) and
    appends the rows to the CSV."""
    if iter_range is None:
        iter_range = DEFAULT_ITER_RANGE
    if cache is None:
        cache = EvaluatorCache(model, loss_config, opt_config, dataset,
                               pallas_augment=pallas_augment, device=device)
    ks: List[int] = []
    results: List[float] = []
    for task_index in range(dataset.num_tasks):
        for _ in range(num_samples):
            res = evaluate_k_shot_range(
                model, loss_config, opt_config, state, dataset, task_index,
                generator, k_range=k_range, iter_range=iter_range,
                test_samples=test_samples,
                inner_batch_size=eval_inner_batch_size,
                eval_inner_iters=eval_inner_iters, lr=lr,
                aug_rate=aug_rate, cache=cache, log_fn=log_fn)
            log_fn("k-shot results {}".format(dict(zip(k_range, res))))
            results.extend(res)
            ks.extend(k_range)

    if csv_outpath is not None:
        exists = os.path.isfile(csv_outpath)
        with open(csv_outpath, "a" if exists else "w", newline="") as f:
            writer = csv.writer(f)
            if not exists:
                writer.writerow(["k", "mIoU"])
            for k, miou in zip(ks, results):
                writer.writerow([k, miou])
    return ks, results
