"""Episodic task store: every task stacked into aligned, padded uint8 arrays.

A copy of the `TaskStore` dataclass of the JAX package (the loaders and
shard formats are not part of this slice). The arrays are numpy;
`to_torch` puts them on the device.
"""
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mliis_tpu_torch.device import resolve_device


@dataclasses.dataclass
class TaskStore:
    """A set of binary-segmentation tasks with aligned padded storage.

    images: [T, N_max, H, W, 3] uint8
    masks:  [T, N_max, H, W] uint8 with foreground encoded as 255
    counts: [T] int32, the number of valid examples per task
    names:  task names
    """
    images: np.ndarray
    masks: np.ndarray
    counts: np.ndarray
    names: List[str]

    def __post_init__(self):
        if self.images.ndim != 5 or self.images.dtype != np.uint8:
            raise ValueError("images must be [T, N, H, W, 3] uint8")
        if self.masks.ndim != 4 or self.masks.dtype != np.uint8:
            raise ValueError("masks must be [T, N, H, W] uint8")
        if not len(self.names) == self.images.shape[0] == len(self.counts):
            raise ValueError("names, images and counts disagree on T")

    def to_torch(self, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(images, masks, counts) as tensors on `device` (default cuda)."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.images, device=dev),
                torch.as_tensor(self.masks, device=dev),
                torch.as_tensor(self.counts, device=dev))

    @staticmethod
    def from_task_arrays(tasks: Sequence[Tuple[np.ndarray, np.ndarray]],
                         names: Sequence[str]) -> "TaskStore":
        """Pad per-task (images [n,H,W,3], masks [n,H,W]) to a common N_max."""
        n_max = max(imgs.shape[0] for imgs, _ in tasks)
        h, w = tasks[0][0].shape[1:3]
        t = len(tasks)
        images = np.zeros((t, n_max, h, w, 3), np.uint8)
        masks = np.zeros((t, n_max, h, w), np.uint8)
        counts = np.zeros((t,), np.int32)
        for i, (imgs, msks) in enumerate(tasks):
            n = imgs.shape[0]
            images[i, :n] = imgs
            masks[i, :n] = msks
            counts[i] = n
        return TaskStore(images, masks, counts, list(names))
