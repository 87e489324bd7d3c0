"""experiments/torch_curve_v2.py, the port's learning-evidence run, at toy
size on the CPU (EfficientLab-b0 at 32^2, 2 inner steps, meta-batch 2, 4
train and 3 held-out tasks, 2 evaluation samples), held against the JAX
script it stands for (experiments/tpu_curve_v2.py) and its committed run:

- (a) the train and held-out stores against the JAX package's
  `make_synthetic_store` with the same families and seeds, byte for byte;
- (b) result.json and curve.json against experiments/curve_v2_r4's and
  curve_v2_seed1's result.json: the same keys (plus `device`) and entry
  shapes;
- (c) a run stopped after its first meta-iteration by --deadline_s 0 and
  carried on with --resume equals the uninterrupted run bit for bit;
- (d) the paired evaluation scores one state twice alike;
- (e) `task_level_ci` against `scipy.stats.t.interval` of the per-task
  means;
- (f) experiments/curve_replication_summary.py reads the port's
  result.json;
- (g) --chain_tasks --chain_eval_chunk runs through and writes the same
  files. That the strategies compute the same function is held in
  tests/test_torch_task_axis.py at 64^2: at 32^2 in bf16 rounding would
  swamp a comparison;
- and the `full_pass` launches chip_smoke.py's `curve` phase derives from
  the flags equal the augmentations of each run (the plain version's
  calls here).
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from scipy import stats as sps

import chip_smoke
from mliis_tpu.data.synthetic import make_synthetic_store as jax_store
from mliis_tpu_torch.ops import augment_kernels as ak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(ROOT, "experiments")
TOY = ["--device", "cpu", "--image_size", "32", "--inner_iters", "2",
       "--meta_batch", "2", "--train_tasks", "4", "--test_tasks", "3",
       "--eval_samples", "2", "--eval_every", "1"]
FILES = ("baseline.npy", "curve.json", "result.json", "checkpoint",
         "timings.jsonl")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXPERIMENTS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


curve = _load_script("torch_curve_v2")


def _committed(run):
    with open(os.path.join(EXPERIMENTS, run, "result.json")) as f:
        return json.load(f)


def _read(out):
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    with open(os.path.join(out, "curve.json")) as f:
        points = json.load(f)
    return result, points


def _checkpoint(out):
    with open(os.path.join(out, "checkpoint")) as f:
        name = f.readline().split('"')[1]
    with np.load(os.path.join(out, name + ".npz")) as z:
        return name, {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests read, on one intra-op thread (restored after):
    the suite runs files in parallel workers. `full_pass`'s plain version
    is counted in each run, where the card would launch the kernel."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("curve")
    out = {k: str(root / k) for k in ("whole", "cut", "chained", "still")}
    argv = {"whole": TOY + ["--meta_iters", "3"],
            "chained": TOY + ["--meta_iters", "1", "--chain_tasks",
                              "--chain_eval_chunk"],
            "still": TOY + ["--meta_iters", "0"]}
    plain = ak.full_pass_reference
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    ak.full_pass_reference = counted
    try:
        for run in ("whole", "chained", "still"):
            del calls[:]
            curve.main(argv[run] + ["--out", out[run]])
            out[run + "_augmentations"] = (len(calls), argv[run])
        curve.main(argv["whole"] + ["--deadline_s", "0", "--out",
                                    out["cut"]])
        out["cut_after_one"] = _read(out["cut"])
        curve.main(argv["whole"] + ["--resume", "--out", out["cut"]])
    finally:
        ak.full_pass_reference = plain
        torch.set_num_threads(before)
    return out


@pytest.mark.parametrize("split", ["train", "held_out"])
def test_stores_match_the_jax_script(split):
    args = curve.argument_parser().parse_args(TOY + ["--seed", "1", "--out", "unused"])
    ours = curve.make_stores(args)[split == "held_out"]
    if split == "train":
        ref = jax_store(num_tasks=4, examples_per_task=10, image_size=32,
                        seed=1000, shapes=curve.TRAIN_FAMILIES)
    else:
        ref = jax_store(num_tasks=3, examples_per_task=10, image_size=32,
                        seed=1777, shapes=curve.TEST_FAMILIES)
    assert ours.names == ref.names
    for field in ("images", "masks", "counts"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_the_families_are_the_jax_scripts():
    with open(os.path.join(EXPERIMENTS, "tpu_curve_v2.py")) as f:
        tree = ast.parse(f.read())
    assigned = {node.targets[0].id: ast.literal_eval(node.value)
                for node in ast.walk(tree) if isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_FAMILIES")}
    assert assigned == {"TRAIN_FAMILIES": curve.TRAIN_FAMILIES,
                        "TEST_FAMILIES": curve.TEST_FAMILIES}


@pytest.mark.parametrize("run", ["whole", "chained"])
def test_result_and_curve_have_the_jax_scripts_keys_and_shapes(runs, run):
    result, points = _read(runs[run])
    for committed in ("curve_v2_r4", "curve_v2_seed1"):
        ref = _committed(committed)
        # curve_v2_r4 predates the --seed flag and its `seed` key.
        assert set(result) == set(ref) | {"seed", "device"}, committed
        for key in set(ref) - {"curve"}:
            assert type(result[key]) is type(ref[key]), key
        assert len(points[0]) == len(ref["curve"][0]) == 2
        assert all(len(p) == len(ref["curve"][-1]) == 4 for p in points[1:])
    assert result["curve"] == points
    assert result["device"] == "cpu"
    assert result["n_tasks"] == 3 and result["n_pairs"] == 6
    iters = 3 if run == "whole" else 1
    assert result["meta_iters_done"] == iters
    assert [p[0] for p in points] == list(range(iters + 1))
    assert all(np.isfinite(v) for p in points for v in p)
    assert sorted(os.listdir(runs[run])) == sorted(
        FILES + ("model.ckpt-{}.npz".format(iters),
                 "model.ckpt-{}.npz.json".format(iters)))
    assert np.load(os.path.join(runs[run], "baseline.npy")).shape == (2, 3)
    with open(os.path.join(runs[run], "timings.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [e["iter"] for e in lines if "iter" in e] == list(
        range(1, iters + 1))
    assert [e["eval_at"] for e in lines if "eval_at" in e] == list(
        range(1, iters + 1))


def test_resume_equals_the_uninterrupted_run(runs):
    cut, cut_points = runs["cut_after_one"]
    assert cut["meta_iters_done"] == 1
    assert [p[0] for p in cut_points] == [0, 1]
    whole, whole_points = _read(runs["whole"])
    resumed, resumed_points = _read(runs["cut"])
    assert resumed_points == whole_points
    assert {k: v for k, v in resumed.items() if k != "wall_s"} == \
        {k: v for k, v in whole.items() if k != "wall_s"}
    np.testing.assert_array_equal(
        np.load(os.path.join(runs["cut"], "baseline.npy")),
        np.load(os.path.join(runs["whole"], "baseline.npy")))
    name_a, a = _checkpoint(runs["whole"])
    name_b, b = _checkpoint(runs["cut"])
    assert name_a == name_b == "model.ckpt-3"
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_paired_evaluation_scores_one_state_alike(runs):
    """--meta_iters 0 scores the random init twice: the baseline and the
    final evaluation, every pair equal."""
    with open(os.path.join(runs["still"], "result.json")) as f:
        result = json.load(f)
    assert result["meta_iters_done"] == 0 and len(result["curve"]) == 1
    assert result["final_mean_iou"] == result["baseline_mean_iou"]
    assert result["paired_diff_mean"] == 0.0
    assert result["paired_diff_ci95"] == 0.0
    assert result["task_level_diff_mean"] == 0.0
    # ... and the held-out episodes do not depend on the training run.
    np.testing.assert_array_equal(
        np.load(os.path.join(runs["still"], "baseline.npy")),
        np.load(os.path.join(runs["whole"], "baseline.npy")))


@pytest.mark.parametrize("run", ["whole", "chained", "still"])
def test_chip_smokes_launch_count_is_the_runs_augmentations(runs, run):
    """chip_smoke.py's `curve` phase holds the kernel's launches on the
    card to the count it derives from the flags: here, the plain
    version's calls on the CPU."""
    calls, argv = runs[run + "_augmentations"]
    expect, _ = chip_smoke._expected_curve_launches(
        curve.argument_parser().parse_args(argv + ["--out", "unused"]))
    assert calls == expect > 0


def test_task_level_ci_is_a_t_interval_of_the_task_means():
    rng = np.random.default_rng(0)
    baseline = rng.uniform(0, 0.1, (3, 6))
    mat = rng.uniform(0.2, 0.8, (3, 6))
    mat[1, 2] = np.nan           # a sample without a finite IoU
    mat[:, 4] = np.nan           # a task without one: left out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the empty task
        mean, hw, n = curve.task_level_ci(mat, baseline)
        per_task = np.nanmean(mat - baseline, axis=0)
    per_task = per_task[np.isfinite(per_task)]
    lo, hi = sps.t.interval(0.95, len(per_task) - 1, loc=per_task.mean(),
                            scale=sps.sem(per_task))
    assert n == 5
    assert mean == pytest.approx(per_task.mean(), abs=1e-15)
    assert mean == pytest.approx((lo + hi) / 2, abs=1e-12)
    assert hw == pytest.approx((hi - lo) / 2, rel=1e-12)


def test_the_replication_summary_reads_the_ports_result(runs, tmp_path):
    path = os.path.join(runs["whole"], "result.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXPERIMENTS,
                                      "curve_replication_summary.py"),
         path, "--out", str(tmp_path / "summary.json")],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads((tmp_path / "summary.json").read_text())
    result, _ = _read(runs["whole"])
    (row,) = got["per_seed"]
    assert row["seed"] == 0 and row["meta_iters"] == 3
    assert row["n_tasks"] == 3
    assert row["final_mean_iou"] == round(result["final_mean_iou"], 4)
    assert row["ci_excludes_zero"] == result["task_level_ci_excludes_zero"]


def test_the_card_is_the_default_device():
    args = curve.argument_parser().parse_args(["--out", "unused"])
    assert args.device is None and args.task_chunk_size == 8
    assert not args.chain_tasks and not args.chain_eval_chunk
    assert (args.meta_iters, args.eval_every, args.train_tasks,
            args.test_tasks, args.eval_samples, args.image_size,
            args.inner_iters, args.meta_batch, args.seed) == (
                3000, 250, 40, 12, 3, 224, 59, 5, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            curve.main(["--out", "unused"])


def test_the_band_holds_a_tpu_seed_and_refuses_a_lower_curve(tmp_path,
                                                             capsys):
    """experiments/torch_curve_band.py: a TPU seed lies in the band of the
    three seeds at every point; the same run 0.08 lower at one point (past
    the 0.07 margin of the lowest seed there) fails the bar."""
    band = _load_script("torch_curve_band")
    seed1 = os.path.join(EXPERIMENTS, "curve_v2_seed1")
    assert band.main(["--run", seed1]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["bar_met"] and len(out["points"]) == 30
    first = out["points"][0]
    assert first["iter"] == 100 and first["band"] == pytest.approx(
        [0.1757850848759214 - 0.07, 0.21779910128356683 + 0.07])
    result, points = _read(seed1)
    low = min(first["tpu_seeds"]) - 0.08
    points[1][1] = low
    for name, data in (("curve.json", points), ("result.json", result)):
        (tmp_path / name).write_text(json.dumps(data))
    assert band.main(["--run", str(tmp_path)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [r["iter"] for r in out["points"] if not r["inside"]] == [100]


def test_the_committed_port_run_lies_in_the_tpu_band(capsys):
    """experiments/torch_curve_v2_seed0, the port's run on the card: at
    least 600 meta-iterations of the 3000-iteration schedule, every point
    from 100 on in the TPU seeds' band, the baseline under 0.01 and the
    last point's task-level CI above zero."""
    run = os.path.join(EXPERIMENTS, "torch_curve_v2_seed0")
    assert _load_script("torch_curve_band").main(["--run", run]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["meta_iters_done"] >= 600
    assert [r["iter"] for r in out["points"]] == list(
        range(100, out["meta_iters_done"] + 1, 100))
    assert out["device"].startswith("NVIDIA H100")
    result, points = _read(run)
    assert result["curve"] == points and not result.get("partial")
