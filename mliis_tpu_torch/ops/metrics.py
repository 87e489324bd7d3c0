"""Segmentation metrics: the evaluation (hard) IoU, the soft IoU inside the
dice loss, and the confidence interval of the evaluation's log line (the
JAX package's `ops/metrics.py`):
  - hard per-image binary IoU with rounding and eps smoothing, one image
    or batched;
  - soft IoU of flattened probabilities, binary or over the channels;
  - Shaban et al.'s tp/tn/fp/fn counts and their IoU;
  - 95% CI = 1.96 sigma / sqrt(n), sigma the population std, as np.std.
"""
from typing import Optional

import numpy as np
import torch

EPSILON = 1e-7


def hard_iou(prediction: torch.Tensor, label: torch.Tensor,
             epsilon: float = EPSILON, class_channel: Optional[int] = 1,
             round_labels: bool = True) -> torch.Tensor:
    """Hard IoU of one image's prediction [H, W, C] against its one-hot
    label [H, W, C], on `class_channel` (None: every channel)."""
    if class_channel is not None:
        prediction = prediction[..., class_channel]
        label = label[..., class_channel]
    pred_b = torch.round(prediction).bool()
    label_b = (torch.round(label) if round_labels else label).bool()
    intersection = (pred_b & label_b).sum()
    union = (pred_b | label_b).sum()
    return (intersection + epsilon) / (union + epsilon)


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


def soft_iou_flat(true_flat: torch.Tensor, pred_flat: torch.Tensor,
                  epsilon: float = EPSILON) -> torch.Tensor:
    """Soft IoU between [N, D] flattened probability tensors; mean over N."""
    return soft_iou_flat_per_example(true_flat, pred_flat, epsilon).mean()


def soft_binary_iou(y_true: torch.Tensor, y_hat: torch.Tensor,
                    epsilon: float = EPSILON,
                    foreground_channel: int = 1) -> torch.Tensor:
    """Batched soft IoU on the foreground channel: [N, H, W, 2] inputs."""
    n = y_true.shape[0]
    return soft_iou_flat(y_true[..., foreground_channel].reshape(n, -1),
                         y_hat[..., foreground_channel].reshape(n, -1),
                         epsilon)


def soft_multiclass_iou(y_true: torch.Tensor, y_hat: torch.Tensor,
                        epsilon: float = EPSILON,
                        exclude_bg_channel: bool = False) -> torch.Tensor:
    """Batched soft IoU over all (or all but the background) channels."""
    if exclude_bg_channel:
        y_true, y_hat = y_true[..., 1:], y_hat[..., 1:]
    n = y_true.shape[0]
    return soft_iou_flat(y_true.reshape(n, -1), y_hat.reshape(n, -1),
                         epsilon)


def measure(y: torch.Tensor, pred: torch.Tensor, thresh: float = 0.5):
    """Shaban et al.'s (tp, tn, fp, fn) counts."""
    y_b, p_b = y > thresh, pred > thresh
    return ((y_b & p_b).sum(), (~y_b & ~p_b).sum(), (~y_b & p_b).sum(),
            (y_b & ~p_b).sum())


def iou_img(tp, fp, fn) -> torch.Tensor:
    """tp / max(tp + fp + fn, 1), float32."""
    tp = torch.as_tensor(tp)
    return tp / torch.clamp(tp + fp + fn, min=1).float()


def ci95(a) -> float:
    """95% confidence interval half-width (population sigma, like np.std)."""
    a = np.asarray(a, dtype=np.float64)
    return float(1.96 * np.std(a) / np.sqrt(len(a)))


def nanmean(a) -> float:
    return float(np.nanmean(np.asarray(a, dtype=np.float64)))
