"""Joint (non-meta) training baseline: N-way segmentation over all tasks.

The port of the JAX package's `joint/trainer.py`, on one device:
EfficientLab with n_classes = the number of classes (+ background channel
0), trained by SGD (or Adam) over shuffled epochs with a linear per-epoch
learning-rate anneal, periodic validation and checkpoints.

  - Labels are integer class maps. The loss is `F.cross_entropy` on the
    NCHW logits the resize returns, so no one-hot and no NHWC copy of a
    1001-channel tensor is ever made, and the train step asks the model
    for no probabilities.
  - At 1001 channels, 224^2 and batch 64 the full-resolution logits have
    3.2e9 elements: past 2^31, which some of PyTorch's CUDA kernels on
    that path cannot index (the launch fails). The train step therefore
    takes the model's logits at the decoder's resolution and resizes and
    takes the CE a batch chunk at a time (`resized_cross_entropy`), and
    the val step runs its forward a chunk at a time (eval-mode batch norm
    makes the chunks independent). Each chunk holds under 2^31 elements;
    the chunks change no result.
  - Each step gathers its batch from the device-resident uint8 store as
    float32 and, with `augment`, runs one `fused_light_augment` launch on
    per-sample seeds (prob_original 0). `use_pallas_augment=False` takes
    the kernel's plain version instead.
  - The JAX package's `lax.scan` over a launch of steps is a Python loop
    here; `steps_per_launch` only groups the host's draws (the batches'
    seeds). Randomness comes from one explicit `torch.Generator` on the
    training device.
The data-parallel trainer (`mesh=`, sync-BN) is not ported (ROADMAP.md).
"""
import dataclasses
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta.inner_loop import (ModelState, OptimizerConfig,
                                             OptState, apply_optimizer_,
                                             load_state, snapshot)
from mliis_tpu_torch.ops import augment_kernels
from mliis_tpu_torch.ops.losses import l2_term
from mliis_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw
from mliis_tpu_torch.utils import checkpoint as ckpt_lib
from mliis_tpu_torch.utils.logging import MetricsWriter

_SEED_HIGH = 2 ** 31 - 1   # per-sample seeds in [0, int32 max)


@dataclasses.dataclass
class JointDataset:
    """Flat example store with integer class masks (0 = background)."""
    images: np.ndarray        # [N, H, W, 3] uint8
    labels: np.ndarray        # [N, H, W] int32 class ids
    class_names: List[str]    # index c-1 -> name (0 is background)

    @property
    def num_examples(self) -> int:
        return self.images.shape[0]

    @property
    def num_classes(self) -> int:
        return len(self.class_names)


def joint_dataset_from_task_store(store: TaskStore,
                                  class_names: Optional[List[str]] = None
                                  ) -> JointDataset:
    """Flatten a per-task store into a joint dataset; class id = 1 + the
    index of the task's name in the sorted global class list."""
    if class_names is None:
        class_names = sorted(store.names)
    name_to_id = {n: i + 1 for i, n in enumerate(class_names)}
    images, labels = [], []
    for t in range(store.num_tasks):
        n = int(store.counts[t])
        images.append(store.images[t, :n])
        fg = store.masks[t, :n] > 127
        labels.append(fg.astype(np.int32) * name_to_id[store.names[t]])
    return JointDataset(np.concatenate(images), np.concatenate(labels),
                        class_names)


_MAX_ELEMENTS = 2 ** 31 - 1


def sparse_segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing: float = 0.0,
                             reduction: str = "mean") -> torch.Tensor:
    """Mean CE over pixels of NHWC logits against integer labels [N, H, W],
    smoothed as (1-eps) CE(label) + eps/C sum_c CE(c). The logits go to
    `F.cross_entropy` channels-second: for the model's logits that is the
    NCHW tensor they view, not a copy."""
    return F.cross_entropy(logits.permute(0, 3, 1, 2), labels.long(),
                           label_smoothing=label_smoothing,
                           reduction=reduction)


def _chunk(n: int, c: int, h: int, w: int) -> int:
    """Images per chunk: the most whose [k, c, h, w] stays under 2^31."""
    return max(1, min(n, _MAX_ELEMENTS // (c * h * w)))


def resized_cross_entropy(low_logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """`sparse_segmentation_loss` of NCHW logits at the decoder's
    resolution, resized (align corners) to the labels' [N, H, W], one
    batch chunk of under 2^31 logits at a time."""
    n, c = low_logits.shape[:2]
    h, w = labels.shape[1:]
    k = _chunk(n, c, h, w)
    total = 0.0
    for i in range(0, n, k):
        logits = resize_bilinear_align_corners_nchw(low_logits[i:i + k], h,
                                                    w)
        total = total + F.cross_entropy(
            logits, labels[i:i + k].long(), label_smoothing=label_smoothing,
            reduction="sum")
    return total / (n * h * w)


@dataclasses.dataclass
class JointTrainConfig:
    batch_size: int = 8
    epochs: int = 200
    steps_per_epoch: Optional[int] = None
    learning_rate: float = 0.005
    final_learning_rate: float = 5e-7
    label_smoothing: float = 0.0
    augment: bool = True
    l2: bool = True
    eval_interval: int = 2
    val_batches: int = 20
    save_checkpoint_every_n_epochs: int = 2
    steps_per_launch: int = 8   # steps whose seeds are drawn together
    # None or True: the `fused_light_augment` wrapper (the kernel on CUDA
    # tensors, its plain version on CPU ones); False: the plain version.
    use_pallas_augment: Optional[bool] = None


class JointTrainer:
    """Single-device joint trainer; the model trains in place."""

    def __init__(self, model: torch.nn.Module, dataset: JointDataset,
                 val_dataset: JointDataset, config: JointTrainConfig,
                 opt_config: OptimizerConfig = OptimizerConfig("sgd"),
                 device=None, log_fn: Callable = print):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.opt_config = opt_config
        self.dataset = dataset
        self.val_dataset = val_dataset
        self._params = list(model.parameters())
        self._named_params = dict(model.named_parameters())
        as_dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa
        self._images, self._labels = as_dev(dataset.images), as_dev(
            dataset.labels)
        self._val_images, self._val_labels = as_dev(val_dataset.images), \
            as_dev(val_dataset.labels)
        if config.use_pallas_augment is False:
            self._augment = augment_kernels.fused_light_augment_reference
            route = "the plain version of fused_light_augment (off)"
        else:
            self._augment = augment_kernels.fused_light_augment
            route = ("the fused_light_augment kernel"
                     if self.device.type == "cuda" else
                     "fused_light_augment, which takes its plain version "
                     "for tensors on the cpu")
        if config.augment:
            log_fn("augmentation: {}, {}".format(route, self.device))

    def train_step(self, opt: OptState, idx: torch.Tensor,
                   seeds: Optional[torch.Tensor], lr: float,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[OptState, torch.Tensor]:
        """One SGD step on the examples `idx`, augmented with `seeds` ([B]
        int32) when the config augments. Returns the new OptState and the
        loss (a device tensor: nothing here waits for the device)."""
        cfg = self.config
        images = self._images[idx].float()
        labels = self._labels[idx]
        if cfg.augment:
            images, masks = self._augment(seeds, images, labels.float(),
                                          prob_original=0.0)
            labels = masks
        low_logits, _ = self.model(images, train=True, generator=generator,
                                   upsample=False)
        loss = resized_cross_entropy(low_logits, labels, cfg.label_smoothing)
        del low_logits
        if cfg.l2:
            loss = loss + l2_term(self._named_params)
        grads = torch.autograd.grad(loss, self._params)
        opt = apply_optimizer_(self._params, grads, opt, lr, self.opt_config)
        return opt, loss.detach()

    @torch.no_grad()
    def val_step(self, idx: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(IoU, loss) of an eval-mode forward on validation examples, a
        batch chunk of under 2^31 logits at a time."""
        n, h, w = idx.shape[0], self._val_labels.shape[1], \
            self._val_labels.shape[2]
        k = _chunk(n, self.model.final_layer_weights.kernel.shape[0], h, w)
        loss, inter = 0.0, []
        for i in range(0, n, k):
            images = self._val_images[idx[i:i + k]].float()
            labels = self._val_labels[idx[i:i + k]].long()
            logits, probs = self.model(images, train=False)
            loss = loss + sparse_segmentation_loss(logits, labels,
                                                   reduction="sum")
            del logits
            # The JAX package's joint "IoU", kept as it is: it intersects
            # the full one-hot maps, which reduces to pixel accuracy as
            # acc/(2-acc).
            inter.append((probs.argmax(-1) == labels).sum((1, 2)).float())
            del probs
        inter = torch.cat(inter)
        union = 2 * h * w - inter
        return ((inter + 1e-7) / (union + 1e-7)).mean(), loss / (n * h * w)

    def lr_fn(self, epoch: int) -> float:
        frac_done = epoch / self.config.epochs
        return (frac_done * self.config.final_learning_rate
                + (1 - frac_done) * self.config.learning_rate)

    def _mark(self):
        """A point on the device's timeline (the host's on the CPU)."""
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def _seconds(a, b) -> float:
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3

    def train(self, state: ModelState, save_dir: str,
              generator: torch.Generator,
              time_deadline: Optional[float] = None,
              log_fn: Callable = print) -> ModelState:
        """Train from `state` for the config's epochs; returns the final
        state. Logs iters/s and the seconds of every step (from the device's
        timeline on CUDA) to `<save_dir>/joint_train_metrics.jsonl`."""
        cfg = self.config
        dev = self.device
        os.makedirs(save_dir, exist_ok=True)
        writer = MetricsWriter(save_dir, "joint_train")
        load_state(self.model, state)
        opt = state.opt
        steps_per_epoch = cfg.steps_per_epoch or max(
            self.dataset.num_examples // cfg.batch_size, 1)
        n = self.dataset.num_examples
        ious = []
        for epoch in range(cfg.epochs):
            start = time.time()
            lr = self.lr_fn(epoch)
            # A shuffled visit order per epoch: each example seen about once.
            total_needed = steps_per_epoch * cfg.batch_size
            reps = -(-total_needed // n)
            order = torch.cat([torch.randperm(n, generator=generator,
                                              device=dev)
                               for _ in range(reps)])
            epoch_idx = order[:total_needed].view(steps_per_epoch,
                                                  cfg.batch_size)
            marks = [self._mark()]
            done = 0
            while done < steps_per_epoch:
                launch_steps = min(cfg.steps_per_launch,
                                   steps_per_epoch - done)
                seeds = torch.randint(0, _SEED_HIGH, (launch_steps,
                                                      cfg.batch_size),
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
                for i in range(launch_steps):
                    opt, _ = self.train_step(opt, epoch_idx[done + i],
                                             seeds[i], lr, generator)
                    marks.append(self._mark())
                done += launch_steps
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            elapsed = time.time() - start
            log_fn("Epoch {}: lr {:.2e}, {} steps, {:.2f} iters/s".format(
                epoch, lr, steps_per_epoch, steps_per_epoch / elapsed))
            writer.scalar("iters_per_sec", steps_per_epoch / elapsed, epoch)
            for i in range(steps_per_epoch):
                writer.scalar("step_seconds",
                              self._seconds(marks[i], marks[i + 1]),
                              epoch * steps_per_epoch + i)

            if epoch % cfg.eval_interval == 0:
                val_ious, val_losses = [], []
                for _ in range(cfg.val_batches):
                    idx = torch.randint(0, self.val_dataset.num_examples,
                                        (cfg.batch_size,),
                                        generator=generator, device=dev)
                    iou, loss = self.val_step(idx)
                    val_ious.append(float(iou))
                    val_losses.append(float(loss))
                iou = float(np.nanmean(val_ious))
                ious.append(iou)
                log_fn("Val IoU at epoch {}: {} (loss {})".format(
                    epoch, iou, float(np.nanmean(val_losses))))
                writer.scalar("val_IoU", iou, epoch)
                writer.scalar("val_loss", float(np.nanmean(val_losses)),
                              epoch)

            if (epoch % cfg.save_checkpoint_every_n_epochs == 0
                    or epoch == cfg.epochs - 1):
                ckpt_lib.save_checkpoint(save_dir, snapshot(self.model, opt),
                                         epoch)
            if time_deadline is not None and time.time() > time_deadline:
                break
        writer.close()
        log_fn("Training complete. History: {}".format(ious))
        return snapshot(self.model, opt)
