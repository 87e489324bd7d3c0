"""Soft IoU, the metric inside the dice loss (the JAX package's
`ops/metrics.soft_iou_flat_per_example`)."""
import torch

EPSILON = 1e-7


def soft_iou_flat_per_example(true_flat: torch.Tensor,
                              pred_flat: torch.Tensor,
                              epsilon: float = EPSILON) -> torch.Tensor:
    """Per-example soft IoU between [N, D] flattened probability tensors."""
    intersection = (pred_flat * true_flat).sum(1)
    denominator = pred_flat.sum(1) + true_flat.sum(1) - intersection
    return (intersection + epsilon) / (denominator + epsilon)
