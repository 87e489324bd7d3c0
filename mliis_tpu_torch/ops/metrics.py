"""Segmentation metrics: the evaluation (hard) IoU, the soft IoU inside the
dice loss, and the confidence interval of the evaluation's log line (the
JAX package's `ops/metrics.py`):
  - hard per-image binary IoU with rounding and eps smoothing, batched;
  - 95% CI = 1.96 sigma / sqrt(n), sigma the population std, as np.std.
"""
from typing import Optional

import numpy as np
import torch

EPSILON = 1e-7


def batched_hard_iou(predictions: torch.Tensor, labels: torch.Tensor,
                     class_channel: Optional[int] = 1) -> torch.Tensor:
    """Per-image hard IoUs for a batch: [N, H, W, C] -> [N]."""
    if class_channel is not None:
        predictions = predictions[..., class_channel]
        labels = labels[..., class_channel]
    pred_b = torch.round(predictions).bool()
    label_b = torch.round(labels).bool()
    axes = tuple(range(1, pred_b.ndim))
    intersection = (pred_b & label_b).sum(axes)
    union = (pred_b | label_b).sum(axes)
    return (intersection + EPSILON) / (union + EPSILON)


def soft_iou_flat_per_example(true_flat: torch.Tensor,
                              pred_flat: torch.Tensor,
                              epsilon: float = EPSILON) -> torch.Tensor:
    """Per-example soft IoU between [N, D] flattened probability tensors."""
    intersection = (pred_flat * true_flat).sum(1)
    denominator = pred_flat.sum(1) + true_flat.sum(1) - intersection
    return (intersection + epsilon) / (denominator + epsilon)


def ci95(a) -> float:
    """95% confidence interval half-width (population sigma, like np.std)."""
    a = np.asarray(a, dtype=np.float64)
    return float(1.96 * np.std(a) / np.sqrt(len(a)))


def nanmean(a) -> float:
    return float(np.nanmean(np.asarray(a, dtype=np.float64)))
