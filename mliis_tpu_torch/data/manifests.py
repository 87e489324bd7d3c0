"""Canonical FSS-1000 task-split manifests.

The port's own copy of the JAX package's manifests: the three task-name
lists (`fss_train_set.txt`, `fss_test_set.txt`, `fp-k_test_set.txt`) sit
beside this module and are read from here, so the port gives the same
760/240 partition and FP-k holdout without the JAX package.
"""
import os
import random
from typing import List, Optional, Sequence, Tuple

_DIRNAME = os.path.dirname(os.path.abspath(__file__))

IMAGE_DIMS = 224  # Side length of (square) FSS-1000 images.

# FP-k tasks are unions of synonym classes.
DEFAULT_K_SHOT_SET = [
    {"airliner", "aeroplane"},
    {"bus"},
    {"motorbike"},
    {"potted_plant", "potted plant"},
    {"television", "tvmonitor"},
]


def _read_manifest(name: str) -> List[str]:
    with open(os.path.join(_DIRNAME, name), "r") as f:
        return [line.rstrip("\n") for line in f]


def get_fss_test_set() -> List[str]:
    return _read_manifest("fss_test_set.txt")


def get_fss_train_set() -> List[str]:
    return _read_manifest("fss_train_set.txt")


def get_fp_k_test_set() -> List[str]:
    return _read_manifest("fp-k_test_set.txt")


TEST_TASK_IDS = get_fss_test_set()
TRAIN_TASK_IDS = get_fss_train_set()
FP_K_TEST_TASK_IDS = get_fp_k_test_set()


def assert_train_test_split(train: Sequence[str], test: Sequence[str]) -> None:
    train_set = set(train)
    leaked = [t for t in test if t in train_set]
    if leaked:
        raise AssertionError("train-test leakage: {}".format(leaked[0]))


def split_train_test_tasks(all_tasks: Sequence[str], n_test: int,
                           reproducible_splits: bool = False,
                           rng: Optional[random.Random] = None
                           ) -> Tuple[List[str], List[str]]:
    """Pop `n_test` tasks off the end of the list, after a sort
    (`reproducible_splits`) or a shuffle."""
    all_tasks = list(all_tasks)
    if reproducible_splits:
        all_tasks = sorted(all_tasks)
    else:
        (rng or random).shuffle(all_tasks)
    test_set = [all_tasks.pop() for _ in range(n_test)]
    assert_train_test_split(all_tasks, test_set)
    return all_tasks, test_set


def partition_by_test_ids(task_names: Sequence[str],
                          test_task_ids: Sequence[str]
                          ) -> Tuple[List[str], List[str]]:
    """(train, test) names by membership in `test_task_ids`, in the order
    of `task_names`."""
    test_ids = set(test_task_ids)
    train, test = [], []
    for name in task_names:
        (test if name in test_ids else train).append(name)
    return train, test
