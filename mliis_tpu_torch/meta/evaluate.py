"""K-shot evaluation: per task, adapt a copy of the state on its support set
and score its query set.

The port of the JAX package's `meta/evaluate.py` (the reference's
reptile.py:127-294 semantics, the path behind run.sh): per task, sample
num_shots + test_shots examples -> a shuffled support/query split ->
`inner_iters` SGD steps on augmented support batches -> predict the query
set -> per-image hard IoU -> nanmean. Every task starts from the state the
caller gives, which is never changed: `adapt` loads it into the module and
returns a new snapshot.

Tasks run in chunks of `task_chunk_size` on a task axis (the JAX
package's vmapped chunk, its default; `make_batched_adapt_and_predict_fn`:
one `full_pass` launch an inner step for the chunk's tasks, one forward
and backward), or, with `chain_chunk`, one after another. A ragged last
chunk runs at its own size: the duplicates of the last task the JAX
package pads it with to keep one compiled shape have no counterpart.
Both ways a task draws the same from its own generator, so they give the
same IoUs up to float rounding. The draws of an episode (shots, split,
batch index matrix) are made by `draw_episode` and passed in, as
`learners.draw_meta_step` does for a meta-step, so a test can inject the
indices the JAX key discipline yields.
The streams are slot-indexed: an evaluation of a list of tasks draws one
seed from the caller's generator, and the list's task j draws its episode
and everything inside it (augmentation, dropout, drop-connect) from its own
generator (`episodes.slot_generator` of the seed and j). With a mesh
(`GeckoEvaluator(mesh=)`, `parallel/mesh.make_sharded_eval_chunk`) each
task rank evaluates its contiguous share of the list and the IoUs are
all-reduced into place, so every rank returns what one rank alone would.

Predictions use the population batch-norm statistics (train=False), or,
with `use_batch_stats_at_predict` (the reference's legacy no-is_training
mode), batch statistics over the query batch (transductive) or over the
support batch plus one query at a time; the running statistics that
forward updates are discarded, as the JAX package discards them.

The exports (`evaluate(save_fine_tuned_checkpoints=...)` and the
SAVE_PREDICTIONS overlays) are written from the adapted state, query
images and probabilities of the very episode the evaluation scored: each
task's fine-tuned checkpoint at `<dir>/<task>/<eval_sample>/` and its
overlays are the episode behind the reported IoU. The JAX package gets
the same artifacts by running each task's adaptation a second time with
the same key (mliis_tpu/meta/evaluate.py:291-297); the port's episodes
draw from a `torch.Generator`, which a second run would have to replay,
so it keeps the first run's results and spends no device time on a
second. Under a mesh rank 0 alone writes them: its own share from the
scored episodes, the other ranks' tasks by replaying their episodes from
their generators.
"""
import dataclasses
import os
import random as pyrandom
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.meta.inner_loop import (LossConfig, ModelState,
                                             OptimizerConfig, make_adapt_fn,
                                             make_batched_adapt_fn,
                                             make_lr_array, stack_states,
                                             task_forward, unstack_states)
from mliis_tpu_torch.ops.metrics import batched_hard_iou, ci95, nanmean
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.utils import checkpoint as ckpt_lib
from mliis_tpu_torch.utils import viz


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
    # None or True: the augmentation kernels; False: their plain versions.
    pallas_augment: Optional[bool] = None
    lr_scheduler: str = "fixed"
    lr_decay_rate: float = 0.5
    lr_decay_after_n_steps: int = 5
    use_batch_stats_at_predict: bool = False
    weight_decay_rate: float = 1.0
    # Tasks adapted and predicted together on a task axis.
    task_chunk_size: int = 2
    # Run each chunk's tasks one after another instead.
    chain_chunk: bool = False


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
                          precompute_augment=config.precompute_augment,
                          pallas_augment=config.pallas_augment)

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


def make_batched_adapt_and_predict_fn(model: torch.nn.Module,
                                      loss_config: LossConfig,
                                      opt_config: OptimizerConfig,
                                      config: EvalConfig):
    """The episode protocol of T tasks on a task axis:
    adapt_and_predict(state, task_images_u8 [T, n, H, W, 3], task_masks_u8
    [T, n, H, W], draws (T EpisodeDraws), generators (T), lr,
    drop_rate=None, aug_rate=None) -> (adapted stacked ModelState, query
    images [T, Q, H, W, 3], query masks one-hot, query probs [T, Q, H, W,
    2]): task t as `make_adapt_and_predict_fn`'s function gives it with
    draws[t] and generators[t]. The predict's train-mode forwards update a
    copy of the running stats, which is dropped."""
    adapt = make_batched_adapt_fn(
        model, loss_config, opt_config,
        weight_decay_rate=config.weight_decay_rate, augment=config.augment,
        precompute_augment=config.precompute_augment,
        pallas_augment=config.pallas_augment)
    gather = episodes.gather_tasks

    def predict(adapted, support_images, query_images, generators):
        params = adapted.params
        buffers = {k: v.clone() for k, v in adapted.batch_stats.items()}

        def forward(images, train):
            kw = dict(final_layer_dropout_rate=0.0, generator=generators) \
                if train else {}
            return task_forward(model, params, buffers, images, train=train,
                                **kw)[1]

        if not config.use_batch_stats_at_predict:
            return forward(query_images, False)
        if config.transductive:
            return forward(query_images, True)
        support = support_images.float()
        return torch.stack([
            forward(torch.cat([support, query_images[:, q:q + 1]], dim=1),
                    True)[:, -1]
            for q in range(query_images.shape[1])], dim=1)

    def adapt_and_predict(state: ModelState, task_images_u8, task_masks_u8,
                          draws, generators, lr, drop_rate=None,
                          aug_rate=None):
        support_idx = torch.stack([d.shot_idx[d.support_rel] for d in draws])
        query_idx = torch.stack([d.shot_idx[d.query_rel] for d in draws])
        support_images = gather(task_images_u8, support_idx)
        lrs = make_lr_array(lr, config.inner_iters, config.lr_scheduler,
                            config.lr_decay_rate,
                            config.lr_decay_after_n_steps)
        adapted, _ = adapt(stack_states([state] * len(draws)),
                           support_images, gather(task_masks_u8, support_idx),
                           torch.stack([d.idx_matrix for d in draws]),
                           generators, lrs, drop_rate=drop_rate,
                           aug_rate=aug_rate)
        query_images = gather(task_images_u8, query_idx).float()
        query_masks = episodes.onehot_mask(gather(task_masks_u8, query_idx))
        with torch.no_grad():
            probs = predict(adapted, support_images, query_images,
                            generators)
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


def make_eval_chunk_fn(model: torch.nn.Module, loss_config: LossConfig,
                       opt_config: OptimizerConfig, config: EvalConfig,
                       mesh=None):
    """eval_chunk(state, store_images, store_masks, store_counts,
    task_indices, seed, lr, drop_rate, aug_rate, on_episode=None) ->
    per-task mean IoU [len(task_indices)] float64: task j of the list
    (store row task_indices[j]) draws from `episodes.slot_generator(seed,
    j)`. The tasks run `config.task_chunk_size` at a time on a task axis,
    or one after another with `config.chain_chunk`. With a `mesh`, this
    rank evaluates its share of the list (`mesh.share`), in chunks of
    ceil(task_chunk_size / task ranks) (the JAX package's chunk tiles the
    mesh), and the IoUs are all-reduced over the task axis.
    `on_episode(j, adapted, query_images, probs)` sees each episode this
    rank scored. The episode itself is `eval_chunk.episode(state,
    store_images, store_masks, store_counts, task_indices, j, seed, lr,
    drop_rate, aug_rate)`."""
    core = make_adapt_and_predict_fn(model, loss_config, opt_config, config)
    batched = None if config.chain_chunk else \
        make_batched_adapt_and_predict_fn(model, loss_config, opt_config,
                                          config)

    def episode(state, images, masks, counts, task_indices, j, seed, lr,
                drop_rate, aug_rate):
        i = task_indices[j]
        generator = episodes.slot_generator(seed, j, images.device)
        draws = draw_episode(generator, counts[i], config, images.shape[1])
        return core(state, images[i], masks[i], draws, generator, lr,
                    drop_rate, aug_rate)

    def episodes_together(state, images, masks, counts, task_indices, js,
                          seed, lr, drop_rate, aug_rate):
        """The episodes of the list positions `js` on a task axis, one
        result tuple a position."""
        rows = torch.as_tensor([task_indices[j] for j in js],
                               device=images.device)
        generators = [episodes.slot_generator(seed, j, images.device)
                      for j in js]
        draws = [draw_episode(g, counts[task_indices[j]], config,
                              images.shape[1])
                 for j, g in zip(js, generators)]
        adapted, query_images, query_masks, probs = batched(
            state, images[rows], masks[rows], draws, generators, lr,
            drop_rate, aug_rate)
        return list(zip(unstack_states(adapted), query_images, query_masks,
                        probs))

    def eval_chunk(state, images, masks, counts, task_indices, seed, lr,
                   drop_rate, aug_rate, on_episode=None) -> np.ndarray:
        n = len(task_indices)
        positions = list(range(n) if mesh is None
                         else mesh_lib.share(n, mesh))
        chunk = 1
        if batched is not None:
            ranks = 1 if mesh is None else mesh_lib.axis_size_of(
                mesh, mesh_lib.TASK_AXIS)
            chunk = -(-config.task_chunk_size // ranks)
        results = np.zeros((n,), np.float64)
        for start in range(0, len(positions), chunk):
            js = positions[start:start + chunk]
            if batched is None:
                outs = [episode(state, images, masks, counts, task_indices,
                                js[0], seed, lr, drop_rate, aug_rate)]
            else:
                outs = episodes_together(state, images, masks, counts,
                                         task_indices, js, seed, lr,
                                         drop_rate, aug_rate)
            for j, (adapted, query_images, query_masks, probs) in zip(
                    js, outs):
                if on_episode is not None:
                    on_episode(j, adapted, query_images, probs)
                ious = batched_hard_iou((probs > 0.5).float(), query_masks)
                results[j] = np.nanmean(ious.cpu().numpy())
        if mesh is not None:
            results = mesh_lib.all_reduce_sum(
                [torch.from_numpy(results).to(images.device)],
                mesh.get_group(mesh_lib.TASK_AXIS))[0].cpu().numpy()
        return results

    eval_chunk.episode = episode
    return eval_chunk


class GeckoEvaluator:
    """Chunked evaluation over a TaskStore held on `device` (the card
    unless the caller asks for the CPU). The module is moved there; the
    state given to `evaluate` may lie anywhere and is never changed. With
    a `mesh` (a task axis over the world's ranks, each rank's device
    holding a copy of the store) the tasks shard over the task axis."""

    def __init__(self, model: torch.nn.Module, loss_config: LossConfig,
                 opt_config: OptimizerConfig, config: EvalConfig,
                 store: TaskStore, device=None, mesh=None):
        self.device = resolve_device(device)
        self.config = config
        self.store = store
        self.mesh = mesh
        self._model = model.to(self.device)
        self._images, self._masks, self._counts = store.to_torch(self.device)
        if mesh is None:
            self._eval_chunk = make_eval_chunk_fn(model, loss_config,
                                                  opt_config, config)
        else:
            self._eval_chunk = mesh_lib.make_sharded_eval_chunk(
                model, loss_config, opt_config, config, mesh)

    def _default_drop_rate(self) -> float:
        """None drop_rate means the model's own final dropout rate."""
        rate = getattr(self._model, "final_layer_dropout_rate", None)
        return float(rate) if rate else 0.0

    def evaluate_tasks(self, state: ModelState, task_indices: List[int],
                       generator: torch.Generator, lr: float,
                       drop_rate: Optional[float] = None,
                       aug_rate: Optional[float] = 0.5,
                       on_episode=None) -> np.ndarray:
        """Per-task mean IoU for the given task indices, in chunks of
        `task_chunk_size` on a task axis or one after another
        (`chain_chunk`; this rank's share of them under a mesh);
        `generator` lies on the evaluator's device and gives the
        evaluation's seed.
        `on_episode(j, adapted, query_images, probs)`, where given, sees
        each episode this rank scored, j its position in the list."""
        return self._eval_chunk(
            state, self._images, self._masks, self._counts,
            list(task_indices), episodes.draw_seed(generator), lr,
            self._drop_rate(drop_rate), aug_rate, on_episode)

    def _drop_rate(self, drop_rate: Optional[float]) -> float:
        return self._default_drop_rate() if drop_rate is None else drop_rate

    def evaluate(self, state: ModelState, generator: torch.Generator,
                 lr: float, eval_all_tasks: bool = False,
                 num_tasks_to_sample: int = 1,
                 drop_rate: Optional[float] = None,
                 aug_rate: Optional[float] = 0.5,
                 rng: Optional[pyrandom.Random] = None,
                 save_fine_tuned_checkpoints: bool = False,
                 save_fine_tuned_checkpoints_dir: Optional[str] = None,
                 eval_sample_num: Optional[int] = None
                 ) -> Tuple[float, Dict[str, float]]:
        """One evaluation sample over the store: every task, or a random
        subsample of `num_tasks_to_sample` (shuffled by `rng`). Returns the
        mean IoU and {task name: IoU}. Optionally writes each task's
        fine-tuned state (the reference's reptile.py:281-285) and, when
        the SAVE_PREDICTIONS toggle is set, its overlays
        (reptile.py:495-513), both from the scored episode."""
        indices = list(range(self.store.num_tasks))
        if not eval_all_tasks:
            (rng or pyrandom).shuffle(indices)
            indices = indices[:num_tasks_to_sample]
        overlays = viz.save_predictions_enabled()
        if overlays:
            viz.pyplot()  # no matplotlib: fail before the first episode
        save_dir = (save_fine_tuned_checkpoints_dir
                    if save_fine_tuned_checkpoints else None)

        def export(j, adapted, query_images, probs):
            name = self.store.names[indices[j]]
            if save_dir is not None:
                ckpt_lib.save_fine_tuned_checkpoint(
                    os.path.join(save_dir, name), adapted,
                    step=self.config.inner_iters,
                    eval_sample_num=eval_sample_num)
            if overlays:
                viz.save_query_predictions(
                    query_images.cpu().numpy(),
                    (probs > 0.5).float().cpu().numpy(), task_name=name)

        exporting = (save_dir is not None or overlays) and \
            mesh_lib.is_writer()
        seed = episodes.draw_seed(generator)
        drop = self._drop_rate(drop_rate)
        args = (self._images, self._masks, self._counts, indices)
        ious = self._eval_chunk(state, *args, seed, lr, drop, aug_rate,
                                export if exporting else None)
        if exporting and self.mesh is not None:
            own = mesh_lib.share(len(indices), self.mesh)
            for j in range(len(indices)):
                if j not in own:   # scored on another rank: replay it
                    adapted, query_images, _, probs = \
                        self._eval_chunk.episode(state, *args, j, seed, lr,
                                                 drop, aug_rate)
                    export(j, adapted, query_images, probs)
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
                   save_fine_tuned_checkpoints: bool = False,
                   save_fine_tuned_checkpoints_dir: Optional[str] = None,
                   log_fn=print) -> Tuple[float, Dict[str, List[float]]]:
    """Repeated-sample evaluation (the reference's eval.py:18-90): per-task
    IoU lists over `num_samples` runs, logged as mean +/- 95% CI. Sample i
    writes its fine-tuned checkpoints under `<dir>/<task>/i/`."""
    mean_ious = []
    task_iou_map: Dict[str, List[float]] = {}
    for i in range(num_samples):
        mean_iou, sample_map = evaluator.evaluate(
            state, generator, lr, eval_all_tasks=serially_eval_all_tasks,
            num_tasks_to_sample=num_tasks_to_sample, drop_rate=drop_rate,
            aug_rate=aug_rate,
            save_fine_tuned_checkpoints=save_fine_tuned_checkpoints,
            save_fine_tuned_checkpoints_dir=save_fine_tuned_checkpoints_dir,
            eval_sample_num=i)
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
