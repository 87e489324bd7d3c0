"""The meta-training CLI's dataset helpers in the port
(`mliis_tpu_torch/data/task_store.py`) against the JAX package's: the
FSS-1000 train/val/test split, the sha-256 image hashes, the train/test
leakage checks, the dataset checks and the FP-k synonym unions, on the
same numpy stores. Names, counts and arrays must be equal, and each check
must raise exactly where the JAX one raises.
"""
import numpy as np
import pytest

from mliis_tpu.data import manifests as jmanifests
from mliis_tpu.data import task_store as jts
from mliis_tpu_torch.data import manifests as tmanifests
from mliis_tpu_torch.data import task_store as tts


def _tasks(names, seed=0, size=4):
    rng = np.random.default_rng(seed)
    tasks = []
    for i, _ in enumerate(names):
        n = 3 + i % 4
        tasks.append((rng.integers(0, 256, (n, size, size, 3)).astype(
            np.uint8), (rng.random((n, size, size)) > 0.5).astype(
                np.uint8) * 255))
    return tasks


def _stores(names, seed=0):
    tasks = _tasks(names, seed)
    return (jts.TaskStore.from_task_arrays(tasks, names),
            tts.TaskStore.from_task_arrays(tasks, names))


def _same(j, t):
    assert t.names == j.names
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.masks, j.masks)


def test_manifest_helpers_match_jax():
    assert tmanifests.DEFAULT_K_SHOT_SET == jmanifests.DEFAULT_K_SHOT_SET
    names = sorted(tmanifests.TRAIN_TASK_IDS)[:5] + \
        sorted(tmanifests.TEST_TASK_IDS)[:3]
    assert tmanifests.partition_by_test_ids(
        names, tmanifests.TEST_TASK_IDS) == jmanifests.partition_by_test_ids(
        names, jmanifests.TEST_TASK_IDS)


@pytest.mark.parametrize("num_val,fp_k", [(0, False), (2, False), (1, True)])
def test_split_fss_1000_matches_jax(num_val, fp_k):
    """Train, val and test stores equal for the canonical test manifest
    and the FP-k holdout, with and without val tasks."""
    names = (sorted(tmanifests.TRAIN_TASK_IDS)[:6]
             + sorted(tmanifests.TEST_TASK_IDS)[:3]
             + sorted(tmanifests.FP_K_TEST_TASK_IDS)[:2])
    names = sorted(set(names))
    jstore, tstore = _stores(names)
    ids = (jmanifests.FP_K_TEST_TASK_IDS, tmanifests.FP_K_TEST_TASK_IDS) \
        if fp_k else (None, None)
    jout = jts.split_fss_1000(jstore, num_val_tasks=num_val,
                              test_task_ids=ids[0])
    tout = tts.split_fss_1000(tstore, num_val_tasks=num_val,
                              test_task_ids=ids[1])
    for j, t in zip(jout, tout):
        if j is None:
            assert t is None
        else:
            _same(j, t)


def test_leakage_checks_match_jax():
    """Name overlap and (on request) a shared image raise on both sides;
    disjoint stores pass; the hash sets are equal."""
    jtrain, ttrain = _stores(["a", "b"], seed=1)
    jtest, ttest = _stores(["c", "d"], seed=2)
    assert tts.image_hashes(ttrain) == jts.image_hashes(jtrain)
    for check in (False, True):
        jts.assert_train_test_split(jtrain, jtest, check)
        tts.assert_train_test_split(ttrain, ttest, check)
    tts.assert_train_test_split(None, ttest)
    jover, tover = _stores(["b", "e"], seed=3)
    with pytest.raises(AssertionError):
        jts.assert_train_test_split(jtrain, jover)
    with pytest.raises(AssertionError, match="overlap"):
        tts.assert_train_test_split(ttrain, tover)
    leak = [(np.concatenate([ttrain.images[0, :1], ttest.images[0, 1:3]]),
             ttest.masks[0, :3])]
    jleak = jts.TaskStore.from_task_arrays(leak, ["z"])
    tleak = tts.TaskStore.from_task_arrays(leak, ["z"])
    tts.assert_train_test_split(ttrain, tleak, check_image_hashes=False)
    with pytest.raises(AssertionError):
        jts.assert_train_test_split(jtrain, jleak, check_image_hashes=True)
    with pytest.raises(AssertionError, match="identical images"):
        tts.assert_train_test_split(ttrain, tleak, check_image_hashes=True)


@pytest.mark.parametrize("case", ["ok", "no_train", "no_train_pretrained",
                                  "empty_test", "empty_val_eval"])
def test_validate_datasets_matches_jax(case):
    full = _stores(["a", "b"])
    empty = tuple(s.subset([]) for s in full)
    train, val, test = full, None, full
    kw = {}
    if case.startswith("no_train"):
        train = (None, None)
        kw = dict(pretrained=case.endswith("pretrained"))
    elif case == "empty_test":
        test = empty
    elif case == "empty_val_eval":
        val, kw = empty, dict(eval_val_tasks=True)
    outcomes = []
    for side, mod in ((0, jts), (1, tts)):
        try:
            mod.validate_datasets(train[side],
                                  None if val is None else val[side],
                                  test[side], **kw)
            outcomes.append(None)
        except (AssertionError, ValueError) as e:
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (case in ("ok", "no_train_pretrained"))


def test_union_tasks_by_synonyms_matches_jax():
    """The FP-k tasks: synonym classes pooled under the set's first sorted
    synonym, sets without a match left out."""
    names = ["aeroplane_1", "airliner", "bus", "dog", "tvmonitor_a",
             "pottedplant"]
    jstore, tstore = _stores(names, seed=4)
    _same(jts.union_tasks_by_synonyms(jstore),
          tts.union_tasks_by_synonyms(tstore))
    assert tts.union_tasks_by_synonyms(tstore).names == [
        "aeroplane", "bus", "pottedplant", "television"]
