"""The port's meta-training entry point end to end on the CPU
(`mliis_tpu_torch.cli.run_metasegnet.main(argv, device="cpu")`), the
counterpart of tests/test_e2e_drivers.py: EfficientLab-b0 rsd (2,) at 32^2
on synthetic tasks through training, the interval evaluation, the
checkpoints, the final evaluation, the grep line and
meta-test_results.json; `--pretrained` eval-only from that checkpoint; the
UHO branch with the meta-fine-tune; the k-shot branch; FSS-1000-style
tfrecord shards through `--data-dir`; and `--pallas_augment off`, which on
the CPU computes what `auto` computes.
"""
import contextlib
import io
import json
import os
import shlex

import numpy as np
import pytest
import torch

from mliis_tpu_torch.cli import run_metasegnet
from mliis_tpu_torch.data import manifests
from mliis_tpu_torch.data.tfrecord import write_segmentation_shard
from mliis_tpu_torch.utils import checkpoint as ckpt_lib

GREP_LINE = "Mean IoU over all meta-test tasks:"


def _meta_args(ckpt, extra=""):
    """The JAX package's end-to-end test arguments, with FOMAML* and
    augmentation on."""
    return shlex.split(
        "--synthetic --synthetic_tasks 6 --image_size 32 --rsd 2 --sgd "
        "--loss_name bce_dice --inner-batch 4 --train-shots 6 "
        "--inner-iters 2 --learning-rate 0.005 --meta-iters 2 "
        "--meta-batch 2 --eval-interval 2 --eval-samples 1 --shots 5 "
        "--eval-batch 4 --eval-iters 2 --transductive "
        "--serially_eval_all_test_tasks --meta-step 0.1 "
        "--task_chunk_size 2 --foml --foml-tail 2 --augment --aug_rate 0.5 "
        "--l2 --checkpoint {} {}".format(ckpt, extra))


def _grep_iou(out):
    lines = [ln for ln in out.splitlines() if ln.startswith(GREP_LINE)]
    assert len(lines) == 1, out[-2000:]
    return float(lines[0][len(GREP_LINE):])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One training run; returns (checkpoint dir, final state, stdout)."""
    ckpt = str(tmp_path_factory.mktemp("e2e") / "ckpt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = run_metasegnet.main(_meta_args(ckpt), device="cpu")
    return ckpt, state, out.getvalue()


def test_training_run_end_to_end(trained):
    """Training, the interval evaluation, rotated checkpoints, the final
    evaluation, the grep line and meta-test_results.json."""
    ckpt, state, out = trained
    assert "Meta-training..." in out
    assert "Train step 0: train=" in out
    assert "Model contains 1368242 trainable parameters." in out
    assert 0.0 <= _grep_iou(out) <= 1.0
    with open(os.path.join(ckpt, "meta-test_results.json")) as f:
        task_map = json.load(f)
    assert task_map and all(isinstance(v, list) and len(v) == 1
                            for v in task_map.values())
    names = set(os.listdir(ckpt))
    assert {"model.ckpt-0.npz", "model.ckpt-1.npz", "checkpoint",
            "phase_timings.jsonl", "train_metrics.jsonl",
            "test_metrics.jsonl"} <= names
    restored, meta = ckpt_lib.restore_checkpoint(ckpt, state)
    assert meta["step"] == 1
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    assert all(bool(v.isfinite().all()) for v in state.params.values())


def test_pretrained_eval_only(trained, capsys):
    """--pretrained restores the newest checkpoint (equal to the trained
    state), trains nothing, and evaluates."""
    ckpt, state, _ = trained
    restored = run_metasegnet.main(_meta_args(ckpt, "--pretrained"),
                                   device="cpu")
    out = capsys.readouterr().out
    assert "Restoring from checkpoint: " + ckpt in out
    assert "Meta-training..." not in out
    assert 0.0 <= _grep_iou(out) <= 1.0
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    for k, v in state.batch_stats.items():
        assert torch.equal(restored.batch_stats[k], v), k


def test_pallas_augment_off_matches_auto_on_cpu(trained, tmp_path, capsys):
    """On the CPU `auto` takes the kernels' wrappers, which take their plain
    versions, and `off` takes the plain versions: the same draws and the
    same arithmetic, so the same state and the same grep line."""
    _, state, out = trained
    off = run_metasegnet.main(_meta_args(str(tmp_path / "off"),
                                         "--pallas_augment off"),
                              device="cpu")
    assert _grep_iou(capsys.readouterr().out) == _grep_iou(out)
    for k, v in state.params.items():
        assert torch.equal(off.params[k], v), k


def test_uho_branch_with_meta_fine_tune(tmp_path, capsys):
    """UHO on 2 val tasks (2 configs, 1-3 steps, one split a config), the
    meta-fine-tune on train+val with the estimate, then the evaluation with
    the estimated lr and steps."""
    ckpt = str(tmp_path / "ckpt")
    run_metasegnet.main(_meta_args(ckpt, (
        "--optimize_update_hyperparms_on_val_set --num_val_tasks 2 "
        "--num_configs_to_sample 2 --min_steps 1 --max_steps 3 --fss_1000 "
        "--meta_fine_tune_steps_on_train_val 1")), device="cpu")
    out = capsys.readouterr().out
    assert "UHO estimated lr=" in out
    assert "Meta-fine-tuning for 1 steps" in out
    assert 0.0 <= _grep_iou(out) <= 1.0
    csv_path = os.path.join(
        ckpt, "val-set_hyper_param_search_results_5-shot.csv")
    with open(csv_path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "task_ID,best_num_steps,mIoU,lr"
    assert len(lines) == 1 + 2 * 2   # 2 configs x 2 val tasks
    assert os.path.isdir(os.path.join(
        ckpt, "fine-tuned_on_train_val_with_optimized_update_hyperparams"))


def test_k_shot_branch(trained, tmp_path, monkeypatch, capsys):
    """--run_k_shot_learning_curves_experiment from the trained checkpoint:
    k-shot-results.csv in the working directory, a row per (task, k)."""
    ckpt, _, _ = trained
    monkeypatch.chdir(str(tmp_path))
    run_metasegnet.main(_meta_args(ckpt, (
        "--pretrained --run_k_shot_learning_curves_experiment "
        "--k_shot_k_range 1 5 --eval-iters 3")), device="cpu")
    out = capsys.readouterr().out
    assert "1-shot mIoU" in out and "5-shot mIoU" in out
    with open(str(tmp_path / "k-shot-results.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "k,mIoU"
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "5"]


def test_data_dir_shards(tmp_path, capsys):
    """Per-task tfrecord shards written with the port's codec, named after
    FSS-1000 train and test classes: the manifests' split, training and
    the evaluation over the test classes."""
    rng = np.random.default_rng(0)
    shards = tmp_path / "shards"
    shards.mkdir()
    names = (sorted(manifests.TRAIN_TASK_IDS)[:3]
             + sorted(manifests.TEST_TASK_IDS)[:2])
    for name in names:
        images = rng.integers(0, 256, (10, 32, 32, 3)).astype(np.uint8)
        masks = (rng.random((10, 32, 32)) > 0.5).astype(np.uint8) * 255
        write_segmentation_shard(str(shards / (name + ".tfrecord.gzip")),
                                 images, masks)
    argv = _meta_args(str(tmp_path / "ckpt"), "--data-dir " + str(shards))
    argv.remove("--synthetic")
    run_metasegnet.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "Found 2 testing tasks." in out
    assert "Found 3 training tasks." in out
    with open(str(tmp_path / "ckpt" / "meta-test_results.json")) as f:
        assert sorted(json.load(f)) == sorted(manifests.TEST_TASK_IDS)[:2]
