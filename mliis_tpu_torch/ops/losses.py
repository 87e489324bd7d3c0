"""The EfficientLab training loss: softmax cross entropy with label
smoothing, the soft-dice adjustment (bce_dice) and the regularizers.

Numerics follow the JAX package's `ops/losses.py`:
  - CE over flattened pixels, labels smoothed as
    labels * (1 - s) + s / C, the mean over pixels with nonzero weight
    (TF's SUM_BY_NONZERO_WEIGHTS; every pixel when there are no weights);
  - bce_dice: loss = CE - ln(2*IoU / (IoU + 1)), IoU the (weighted) batch
    mean of the per-image soft IoU, on the foreground channel
    (`binary_iou_loss`) or over all channels;
  - l2 = 5e-4 * sum over non-batch-norm params of sum(v^2)/2 (TF l2_loss),
    l1 = 5e-4 * sum of |v| over the same params. Batch-norm params are
    recognised by the tokens of their names, which is why the port's
    parameter names keep the flax path tokens;
  - darc1 = 5e-4 * max over logit positions of the batch sum of |logits|.
Per-example `example_weights` mask padded batch slots out of every batch
term: a zero-weight example contributes nothing and does not count in a
mean. With `data_axis_name` the batch is one shard of a batch split over
that bound mesh axis, and every batch-level reduction (the CE mean, the
dice term's mean IoU, darc1's batch sum) sums across the axis (the JAX
package's `_axis_sum`), so each shard returns the whole batch's loss; an
unweighted count is the local count times the axis size, the value the
JAX package's psum of the constant gives. The l2/l1 terms of the
replicated params stay local.

With `spatial_axis_name` every image is split by rows over that bound
axis (`parallel/spatial.py`) and the loss is the whole images': the CE
sums over the axis and divides by the summed pixel count (the ranks hold
unequal row counts), each image's soft intersection and sums of the dice
term are summed over the axis before the ratio, and darc1 takes the max
over every rank's positions of its batch sums. The batch is whole on
every rank, so the means over images stay local.

`segmentation_losses` is the loss of T tasks at once (a task axis first
on the logits, labels and stacked params): each task's CE mean, dice
term, darc1 and l2/l1 on its own params, [T]. Its sum's gradient with
respect to the stacked params is each task's own gradient, as the JAX
package's `jax.vmap` of the loss and grad gives it.
"""
import math
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mliis_tpu_torch.ops.metrics import EPSILON, soft_iou_flat_per_example
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.utils import profiling

_BN_PATH_TOKENS = ("batch_normalization", "batchnorm", "bn")


def is_bn_name(name: str) -> bool:
    """True when any '/'- or '.'-separated token of `name` names batch norm."""
    return any(tok in part.lower() for part in re.split(r"[./]", name)
               for tok in _BN_PATH_TOKENS)


def _axis_sum(x: torch.Tensor, data_axis_name: Optional[str]
              ) -> torch.Tensor:
    """`x` summed over the mesh axis (itself when none is named)."""
    return x if data_axis_name is None else mesh_lib.psum(x, data_axis_name)


def _axis_count(n: int, data_axis_name: str) -> int:
    """A local count times the axis size: the whole batch's count."""
    return n * mesh_lib.axis_size(data_axis_name)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          weights: Optional[torch.Tensor] = None,
                          data_axis_name: Optional[str] = None,
                          spatial_axis_name: Optional[str] = None
                          ) -> torch.Tensor:
    """-sum(labels * log_softmax(logits)) over [M, C], smoothed labels,
    averaged over the M examples (those with nonzero `weights` [M]), over
    the whole batch split along `data_axis_name`, or the whole images
    split by rows along `spatial_axis_name`, where one is named."""
    if label_smoothing:
        labels = (labels * (1.0 - label_smoothing)
                  + label_smoothing / logits.shape[-1])
    per_example = -(labels * F.log_softmax(logits, dim=-1)).sum(-1)
    axis = data_axis_name or spatial_axis_name
    if weights is None:
        if axis is None:
            return per_example.mean()
        if spatial_axis_name is not None:
            local = per_example.sum()
            total, count = mesh_lib.psum(torch.stack([
                local, torch.full_like(local, float(per_example.shape[0]))]),
                spatial_axis_name)
            return total / count
        return (_axis_sum(per_example.sum(), data_axis_name)
                / _axis_count(per_example.shape[0], data_axis_name))
    num_nonzero = torch.clamp(
        _axis_sum((weights != 0).sum().float(), axis), min=1)
    return _axis_sum((per_example * weights).sum(), axis) / num_nonzero


def _spatial_soft_iou(true_flat: torch.Tensor, pred_flat: torch.Tensor,
                      axis_name: str) -> torch.Tensor:
    """`soft_iou_flat_per_example` of images split by rows over the axis:
    the intersection and sums of [N, D] pieces summed before the ratio."""
    intersection = (pred_flat * true_flat).sum(1)
    inter, pred, true = mesh_lib.psum(torch.stack([
        intersection, pred_flat.sum(1), true_flat.sum(1)]), axis_name)
    return (inter + EPSILON) / (pred + true - inter + EPSILON)


def soft_dice_adjustment(ce_loss: torch.Tensor,
                         iou: torch.Tensor) -> torch.Tensor:
    """bce_dice loss: CE - ln(dice) with dice = 2*IoU/(IoU+1)."""
    return ce_loss - torch.log((2.0 * iou) / (iou + 1.0))


@profiling.spanned("loss.l2")
def l2_term(params: Dict[str, torch.Tensor],
            weight_decay: float = 0.0005) -> torch.Tensor:
    """weight_decay * sum of sum(v^2)/2 over non-batch-norm params."""
    total = sum(v.square().sum() / 2.0 for k, v in params.items()
                if not is_bn_name(k))
    return weight_decay * total


def l1_term(params: Dict[str, torch.Tensor],
            weight_decay: float = 0.0005) -> torch.Tensor:
    """weight_decay * sum of |v| over non-batch-norm params."""
    total = sum(v.abs().sum() for k, v in params.items()
                if not is_bn_name(k))
    return weight_decay * total


def darc1_term(logits: torch.Tensor, weight: float = 0.0005,
               example_weights: Optional[torch.Tensor] = None,
               data_axis_name: Optional[str] = None,
               spatial_axis_name: Optional[str] = None) -> torch.Tensor:
    """weight * max_j sum_i |logits_ij|, i over the batch (first) dim,
    the batch sum taken across `data_axis_name` before the max, the max
    taken across `spatial_axis_name` (a rank with no rows holds -inf);
    `example_weights` [N] mask padded examples out of the sum."""
    flat = logits.reshape(logits.shape[0], -1).abs()
    if example_weights is not None:
        flat = flat * example_weights[:, None]
    sums = _axis_sum(flat.sum(0), data_axis_name)
    if spatial_axis_name is None:
        return weight * sums.max()
    local = torch.cat([sums, sums.new_full((1,), -math.inf)]).max()
    return weight * mesh_lib.pmax(local, spatial_axis_name)


def segmentation_loss(logits: torch.Tensor, probabilities: torch.Tensor,
                      labels: torch.Tensor,
                      params: Optional[Dict[str, torch.Tensor]] = None, *,
                      label_smoothing: float = 0.0, dice: bool = True,
                      binary_iou_loss: bool = True, l2: bool = True,
                      l1: bool = False, darc1: bool = False,
                      example_weights: Optional[torch.Tensor] = None,
                      data_axis_name: Optional[str] = None,
                      spatial_axis_name: Optional[str] = None
                      ) -> torch.Tensor:
    """logits, probabilities, labels: [N, H, W, C] (C = 2, [bg, fg]);
    example_weights: optional [N] mask for padded batch slots;
    data_axis_name: set when N is this shard's part of a batch split over
    that mesh axis (the loss is then the whole batch's);
    spatial_axis_name: set when H is this rank's rows of images split over
    that axis (the loss is then the whole images')."""
    if data_axis_name is not None and spatial_axis_name is not None:
        raise ValueError("a loss sums over one mesh axis")
    n, h, w, c = logits.shape
    pixel_weights = None
    if example_weights is not None:
        pixel_weights = torch.repeat_interleave(example_weights, h * w)
    loss = softmax_cross_entropy(logits.reshape(-1, c), labels.reshape(-1, c),
                                 label_smoothing, pixel_weights,
                                 data_axis_name, spatial_axis_name)
    if dice:
        if binary_iou_loss:
            true_flat = labels[..., 1].reshape(n, -1)
            pred_flat = probabilities[..., 1].reshape(n, -1)
        else:
            true_flat = labels.reshape(n, -1)
            pred_flat = probabilities.reshape(n, -1)
        if spatial_axis_name is None:
            per_image_iou = soft_iou_flat_per_example(true_flat, pred_flat)
        else:
            per_image_iou = _spatial_soft_iou(true_flat, pred_flat,
                                              spatial_axis_name)
        if example_weights is None and data_axis_name is None:
            iou = per_image_iou.mean()
        elif example_weights is None:
            iou = (_axis_sum(per_image_iou.sum(), data_axis_name)
                   / _axis_count(n, data_axis_name))
        else:
            iou = (_axis_sum((per_image_iou * example_weights).sum(),
                             data_axis_name)
                   / torch.clamp(_axis_sum(example_weights.sum(),
                                           data_axis_name), min=1))
        loss = soft_dice_adjustment(loss, iou)
    if darc1:
        loss = loss + darc1_term(logits, example_weights=example_weights,
                                 data_axis_name=data_axis_name,
                                 spatial_axis_name=spatial_axis_name)
    if params is not None:
        if l2:
            loss = loss + l2_term(params)
        if l1:
            loss = loss + l1_term(params)
    return loss


def _per_task_sum(v: torch.Tensor) -> torch.Tensor:
    """[T, ...] -> [T]: the sum over all but the task axis."""
    return v.reshape(v.shape[0], -1).sum(1)


def segmentation_losses(logits: torch.Tensor, probabilities: torch.Tensor,
                        labels: torch.Tensor,
                        params: Optional[Dict[str, torch.Tensor]] = None, *,
                        label_smoothing: float = 0.0, dice: bool = True,
                        binary_iou_loss: bool = True, l2: bool = True,
                        l1: bool = False, darc1: bool = False,
                        weight_decay: float = 0.0005,
                        data_axis_name: Optional[str] = None
                        ) -> torch.Tensor:
    """`segmentation_loss` of T tasks: logits, probabilities, labels [T, N,
    H, W, C]; params stacked [T, ...]. Returns the [T] losses, task t's
    computed from its own slices alone. With `data_axis_name` each task's
    N is this shard's part of its batch split over that mesh axis, and
    each task's batch-level reductions sum across the axis, as in
    `segmentation_loss`."""
    t, n, h, w, c = logits.shape
    smoothed = labels
    if label_smoothing:
        smoothed = labels * (1.0 - label_smoothing) + label_smoothing / c
    per_pixel = -(smoothed * F.log_softmax(logits, dim=-1)).sum(-1)
    if data_axis_name is None:
        loss = per_pixel.reshape(t, -1).mean(1)
    else:
        loss = (_axis_sum(per_pixel.reshape(t, -1).sum(1), data_axis_name)
                / _axis_count(n * h * w, data_axis_name))
    if dice:
        if binary_iou_loss:
            true_flat = labels[..., 1].reshape(t * n, -1)
            pred_flat = probabilities[..., 1].reshape(t * n, -1)
        else:
            true_flat = labels.reshape(t * n, -1)
            pred_flat = probabilities.reshape(t * n, -1)
        iou = soft_iou_flat_per_example(true_flat, pred_flat).reshape(t, n)
        if data_axis_name is None:
            iou = iou.mean(1)
        else:
            iou = (_axis_sum(iou.sum(1), data_axis_name)
                   / _axis_count(n, data_axis_name))
        loss = soft_dice_adjustment(loss, iou)
    if darc1:
        sums = _axis_sum(logits.reshape(t, n, -1).abs().sum(1),
                         data_axis_name)
        loss = loss + weight_decay * sums.max(1).values
    if params is not None:
        kept = [v for k, v in params.items() if not is_bn_name(k)]
        if l2:
            loss = loss + weight_decay * sum(_per_task_sum(v.square()) / 2.0
                                             for v in kept)
        if l1:
            loss = loss + weight_decay * sum(_per_task_sum(v.abs())
                                             for v in kept)
    return loss
