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
mean.
"""
import re
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from mliis_tpu_torch.ops.metrics import soft_iou_flat_per_example

_BN_PATH_TOKENS = ("batch_normalization", "batchnorm", "bn")


def is_bn_name(name: str) -> bool:
    """True when any '/'- or '.'-separated token of `name` names batch norm."""
    return any(tok in part.lower() for part in re.split(r"[./]", name)
               for tok in _BN_PATH_TOKENS)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """-sum(labels * log_softmax(logits)) over [M, C], smoothed labels,
    averaged over the M examples (those with nonzero `weights` [M])."""
    if label_smoothing:
        labels = (labels * (1.0 - label_smoothing)
                  + label_smoothing / logits.shape[-1])
    per_example = -(labels * F.log_softmax(logits, dim=-1)).sum(-1)
    if weights is None:
        return per_example.mean()
    num_nonzero = torch.clamp((weights != 0).sum(), min=1)
    return (per_example * weights).sum() / num_nonzero


def soft_dice_adjustment(ce_loss: torch.Tensor,
                         iou: torch.Tensor) -> torch.Tensor:
    """bce_dice loss: CE - ln(dice) with dice = 2*IoU/(IoU+1)."""
    return ce_loss - torch.log((2.0 * iou) / (iou + 1.0))


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
               example_weights: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """weight * max_j sum_i |logits_ij|, i over the batch (first) dim;
    `example_weights` [N] mask padded examples out of the sum."""
    flat = logits.reshape(logits.shape[0], -1).abs()
    if example_weights is not None:
        flat = flat * example_weights[:, None]
    return weight * flat.sum(0).max()


def segmentation_loss(logits: torch.Tensor, probabilities: torch.Tensor,
                      labels: torch.Tensor,
                      params: Optional[Dict[str, torch.Tensor]] = None, *,
                      label_smoothing: float = 0.0, dice: bool = True,
                      binary_iou_loss: bool = True, l2: bool = True,
                      l1: bool = False, darc1: bool = False,
                      example_weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """logits, probabilities, labels: [N, H, W, C] (C = 2, [bg, fg]);
    example_weights: optional [N] mask for padded batch slots."""
    n, h, w, c = logits.shape
    pixel_weights = None
    if example_weights is not None:
        pixel_weights = torch.repeat_interleave(example_weights, h * w)
    loss = softmax_cross_entropy(logits.reshape(-1, c), labels.reshape(-1, c),
                                 label_smoothing, pixel_weights)
    if dice:
        if binary_iou_loss:
            true_flat = labels[..., 1].reshape(n, -1)
            pred_flat = probabilities[..., 1].reshape(n, -1)
        else:
            true_flat = labels.reshape(n, -1)
            pred_flat = probabilities.reshape(n, -1)
        per_image_iou = soft_iou_flat_per_example(true_flat, pred_flat)
        if example_weights is None:
            iou = per_image_iou.mean()
        else:
            iou = ((per_image_iou * example_weights).sum()
                   / torch.clamp(example_weights.sum(), min=1))
        loss = soft_dice_adjustment(loss, iou)
    if darc1:
        loss = loss + darc1_term(logits, example_weights=example_weights)
    if params is not None:
        if l2:
            loss = loss + l2_term(params)
        if l1:
            loss = loss + l1_term(params)
    return loss
