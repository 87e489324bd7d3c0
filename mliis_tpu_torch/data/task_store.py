"""Episodic task store: every task stacked into aligned, padded uint8 arrays.

A copy of the JAX package's `TaskStore`, its loader and the CLIs'
dataset checks: the FSS-1000 train/val/test split, the train/test leakage
checks (task names, and sha-256 of the images on request) and the FP-k
synonym unions. The arrays are numpy; `to_torch` puts them on the device.
tfrecord shards are read by the native C++ reader (`data/native_loader`)
where its library loads, else by the Python codec (`data/tfrecord.py`);
npz shards by numpy.
"""
import dataclasses
import glob
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mliis_tpu_torch.data import manifests, native_loader
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
                    max_examples: Optional[int] = None,
                    num_threads: int = 8) -> TaskStore:
    """Every per-task shard in `data_dir` as one TaskStore, tasks sorted by
    name; shards without records are skipped. The tfrecord shards are
    counted and read `num_threads` at a time (mliis_tpu/data/
    task_store.py:110-140); the line printed names the reader."""
    shard_paths = find_task_shards(data_dir)
    if not shard_paths:
        raise FileNotFoundError(
            "No task shards (*.tfrecord*, *.npz) in {}".format(data_dir))
    tf_paths = [p for p in shard_paths if not p.endswith(".npz")]
    tasks, names = [], []
    if tf_paths:
        probe_max = max_examples
        if probe_max is None:
            # ctypes and gzip release the GIL: the count runs in parallel.
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(num_threads) as pool:
                probe_max = max(pool.map(native_loader.count_examples,
                                         tf_paths))
        images, masks, counts = native_loader.read_shards(
            tf_paths, image_size, probe_max, num_threads=num_threads)
        print("load_task_store: read {} tfrecord shard(s) with the {} "
              "reader".format(len(tf_paths), native_loader.reader_name()))
        for i, path in enumerate(tf_paths):
            tasks.append((images[i, :counts[i]], masks[i, :counts[i]]))
            names.append(task_name_from_path(path))
    for path in shard_paths:
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                tasks.append((z["images"], z["masks"]))
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


def split_fss_1000(store: TaskStore, num_val_tasks: int = 0,
                   test_task_ids: Optional[Sequence[str]] = None
                   ) -> Tuple[TaskStore, Optional[TaskStore], TaskStore]:
    """The deterministic FSS-1000 (train, val, test) split: test tasks by
    membership in `test_task_ids` (default the 240-task manifest), then
    `num_val_tasks` val tasks popped off the sorted remainder."""
    if test_task_ids is None:
        test_task_ids = manifests.TEST_TASK_IDS
    train_names, test_names = manifests.partition_by_test_ids(
        store.names, test_task_ids)
    train_names, val_names = manifests.split_train_test_tasks(
        train_names, num_val_tasks, reproducible_splits=True)
    train = store.subset_by_names(train_names)
    val = store.subset_by_names(val_names) if val_names else None
    return train, val, store.subset_by_names(test_names)


def image_hashes(store: TaskStore) -> set:
    """sha-256 hex digests of every valid image's bytes."""
    return {hashlib.sha256(store.images[t, i].tobytes()).hexdigest()
            for t in range(store.num_tasks)
            for i in range(int(store.counts[t]))}


def assert_train_test_split(train: Optional[TaskStore], test: TaskStore,
                            check_image_hashes: bool = False) -> None:
    """No task name in both stores; with `check_image_hashes`, no image in
    both either."""
    if train is None:
        return
    overlap = set(train.names) & set(test.names)
    if overlap:
        raise AssertionError("train/test task names overlap: {}".format(
            sorted(overlap)[:5]))
    if check_image_hashes:
        leaked = image_hashes(train) & image_hashes(test)
        if leaked:
            raise AssertionError("{} identical images appear in both train "
                                 "and test".format(len(leaked)))


def validate_datasets(train: Optional[TaskStore], val: Optional[TaskStore],
                      test: TaskStore, pretrained: bool = False,
                      run_k_shot_experiment: bool = False,
                      eval_val_tasks: bool = False) -> None:
    """A training run needs training tasks; every run needs test tasks."""
    if not pretrained and not run_k_shot_experiment and (
            train is None or train.num_tasks == 0):
        raise AssertionError("Training set must have examples.")
    if test.num_tasks == 0:
        raise AssertionError("Test set must have examples.")
    if eval_val_tasks and val is not None and val.num_tasks == 0:
        raise ValueError("Val set has no tasks to evaluate")


def union_tasks_by_synonyms(store: TaskStore,
                            synonym_sets=None) -> TaskStore:
    """FP-k tasks: each synonym set's matching tasks (a synonym, spaces
    removed, contained in the task name) pooled into one task named after
    the set's first synonym in sorted order; sets that match nothing are
    left out."""
    if synonym_sets is None:
        synonym_sets = manifests.DEFAULT_K_SHOT_SET
    tasks, names = [], []
    for synonyms in synonym_sets:
        ordered = [s.replace(" ", "") for s in sorted(synonyms)]
        member_idx = sorted({j for synonym in ordered
                             for j, n in enumerate(store.names)
                             if synonym in n})
        if not member_idx:
            continue
        tasks.append((
            np.concatenate([store.images[j, :store.counts[j]]
                            for j in member_idx]),
            np.concatenate([store.masks[j, :store.counts[j]]
                            for j in member_idx])))
        names.append(ordered[0])
    return TaskStore.from_task_arrays(tasks, names)
