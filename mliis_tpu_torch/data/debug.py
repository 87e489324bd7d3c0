"""Dataset checks and mask plots.

The port of the JAX package's `data/debug.py` (the reference's
utils/debug_tf_dataset.py): check a TaskStore's shapes, dtypes, counts and
mask encoding, and the self-IoU invariant (a label scores IoU 1 against
itself) through the port's own metric; plot a mask. matplotlib is
imported only by `plot_mask`.
"""
from typing import Optional

import numpy as np
import torch

from mliis_tpu_torch.data.task_store import TaskStore
from mliis_tpu_torch.ops.metrics import batched_hard_iou


def check_task_store(store: TaskStore, log_fn=print) -> bool:
    """True when every task has examples with masks in {0, 255} and the
    first label's self-IoU is 1; each fault is logged."""
    ok = True
    if store.images.dtype != np.uint8 or store.masks.dtype != np.uint8:
        raise ValueError("a TaskStore holds uint8 images and masks")
    for t in range(store.num_tasks):
        count = int(store.counts[t])
        if count == 0:
            log_fn("Task {} has no examples".format(store.names[t]))
            ok = False
            continue
        values = np.unique(store.masks[t, :count])
        if not np.isin(values, [0, 255]).all():
            log_fn("Task {} has non-binary mask values: {}".format(
                store.names[t], values[:10]))
            ok = False
    mask = store.masks[0, 0].astype(np.float32)
    onehot = torch.from_numpy(np.stack([255.0 - mask, mask], -1) / 255.0)
    self_iou = float(batched_hard_iou(onehot[None], onehot[None])[0])
    if abs(self_iou - 1.0) > 1e-6:
        log_fn("Self-IoU of label != 1: {}".format(self_iou))
        ok = False
    log_fn("TaskStore check: {} tasks, {} examples total, ok={}".format(
        store.num_tasks, int(store.counts.sum()), ok))
    return ok


def plot_mask(mask: np.ndarray, figure_index: int = 0,
              channel_index: Optional[int] = None,
              show: bool = True, save_path: Optional[str] = None) -> int:
    """Plot one mask channel (the first nonzero channel when unspecified);
    returns its index, -1 for an [H, W] mask. With show=False the figure
    is closed after the optional save."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    if mask.ndim == 2:
        k, plane = -1, mask
    else:
        k = channel_index
        if k is None:
            k = next((c for c in range(mask.shape[2])
                      if np.sum(mask[:, :, c]) > 0), mask.shape[2] - 1)
        plane = mask[:, :, k]
    fig = plt.figure(figure_index)
    plt.imshow(plane)
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return k
