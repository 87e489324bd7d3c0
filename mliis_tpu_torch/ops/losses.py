"""The EfficientLab training loss: softmax cross entropy, the soft-dice
adjustment (bce_dice) and the l2 term.

Numerics follow the JAX package's `ops/losses.py`:
  - CE is the mean over all flattened pixels;
  - bce_dice: loss = CE - ln(2*IoU / (IoU + 1)), IoU the batch mean of the
    per-image soft IoU on the foreground channel;
  - l2 = 5e-4 * sum over non-batch-norm params of sum(v^2)/2 (TF l2_loss).
    Batch-norm params are recognised by the tokens of their names, which
    is why the port's parameter names keep the flax path tokens.
Label smoothing, l1, darc1 and padded-batch weights are not ported yet
(ROADMAP.md).
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


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean over M of -sum(labels * log_softmax(logits)); both [M, C]."""
    return -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()


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


def segmentation_loss(logits: torch.Tensor, probabilities: torch.Tensor,
                      labels: torch.Tensor,
                      params: Optional[Dict[str, torch.Tensor]] = None, *,
                      dice: bool = True, l2: bool = True) -> torch.Tensor:
    """logits, probabilities, labels: [N, H, W, C] (C = 2, [bg, fg])."""
    n, c = logits.shape[0], logits.shape[-1]
    loss = softmax_cross_entropy(logits.reshape(-1, c), labels.reshape(-1, c))
    if dice:
        per_image_iou = soft_iou_flat_per_example(
            labels[..., 1].reshape(n, -1), probabilities[..., 1].reshape(n, -1))
        loss = soft_dice_adjustment(loss, per_image_iou.mean())
    if l2 and params is not None:
        loss = loss + l2_term(params)
    return loss
