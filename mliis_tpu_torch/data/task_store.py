"""Episodic task store: every task stacked into aligned, padded uint8 arrays.

A copy of the JAX package's `TaskStore` and its loader. The arrays are
numpy; `to_torch` puts them on the device. Shards are read through the
Python tfrecord codec (`data/tfrecord.py`) or from npz; the JAX package's
native C++ loader is not ported (ROADMAP.md).
"""
import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data import tfrecord
from mliis_tpu_torch.device import resolve_device

SHARD_SUFFIXES = (".tfrecord.gzip", ".tfrecord", ".npz")


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

    @property
    def num_tasks(self) -> int:
        return self.images.shape[0]

    @property
    def image_size(self) -> int:
        return self.images.shape[2]

    def subset(self, indices: Sequence[int]) -> "TaskStore":
        idx = np.asarray(indices, dtype=np.int64)
        return TaskStore(self.images[idx], self.masks[idx], self.counts[idx],
                         [self.names[i] for i in idx])

    def subset_by_names(self, names: Sequence[str]) -> "TaskStore":
        name_to_idx = {n: i for i, n in enumerate(self.names)}
        return self.subset([name_to_idx[n] for n in names])

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, images=self.images, masks=self.masks,
                            counts=self.counts, names=np.array(self.names))

    @staticmethod
    def load_npz(path: str) -> "TaskStore":
        with np.load(path, allow_pickle=False) as z:
            return TaskStore(z["images"], z["masks"], z["counts"],
                             [str(n) for n in z["names"]])

    def to_torch(self, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(images, masks, counts) as tensors on `device` (default cuda)."""
        dev = resolve_device(device)
        return (torch.as_tensor(self.images, device=dev),
                torch.as_tensor(self.masks, device=dev),
                torch.as_tensor(self.counts, device=dev))

    @staticmethod
    def from_task_arrays(tasks: Sequence[Tuple[np.ndarray, np.ndarray]],
                         names: Sequence[str],
                         max_examples: Optional[int] = None) -> "TaskStore":
        """Pad per-task (images [n,H,W,3], masks [n,H,W]) to a common N_max
        (`max_examples`, or the largest task), cutting longer tasks."""
        counts = np.array([imgs.shape[0] for imgs, _ in tasks], np.int32)
        n_max = int(max_examples or counts.max())
        h, w = tasks[0][0].shape[1:3]
        images = np.zeros((len(tasks), n_max, h, w, 3), np.uint8)
        masks = np.zeros((len(tasks), n_max, h, w), np.uint8)
        for i, (imgs, msks) in enumerate(tasks):
            n = min(imgs.shape[0], n_max)
            images[i, :n] = imgs[:n]
            masks[i, :n] = msks[:n]
            counts[i] = n
        return TaskStore(images, masks, counts, list(names))


def task_name_from_path(path: str) -> str:
    name = os.path.basename(path)
    for suffix in SHARD_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def find_task_shards(data_dir: str) -> List[str]:
    """All shard files in a directory (tfrecord or npz), sorted by name."""
    paths = []
    for pattern in ("*.tfrecord*", "*.npz"):
        paths.extend(glob.glob(os.path.join(data_dir, pattern)))
    return sorted(set(paths))


def load_task_store(data_dir: str, image_size: int = 224,
                    max_examples: Optional[int] = None) -> TaskStore:
    """Every per-task shard in `data_dir` as one TaskStore, tasks sorted by
    name; shards without records are skipped."""
    shard_paths = find_task_shards(data_dir)
    if not shard_paths:
        raise FileNotFoundError(
            "No task shards (*.tfrecord*, *.npz) in {}".format(data_dir))
    tasks, names = [], []
    for path in shard_paths:
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                tasks.append((z["images"], z["masks"]))
        else:
            tasks.append(tfrecord.read_segmentation_shard(path, image_size))
        names.append(task_name_from_path(path))

    empty = [n for n, t in zip(names, tasks) if t[0].shape[0] == 0]
    if empty:
        print("load_task_store: skipping {} empty shard(s): {}".format(
            len(empty), empty[:5]))
        kept = [i for i, t in enumerate(tasks) if t[0].shape[0] > 0]
        tasks = [tasks[i] for i in kept]
        names = [names[i] for i in kept]
    if not tasks:
        raise ValueError("All task shards in {} are empty".format(data_dir))
    order = np.argsort(names)
    return TaskStore.from_task_arrays([tasks[i] for i in order],
                                      [names[i] for i in order], max_examples)
