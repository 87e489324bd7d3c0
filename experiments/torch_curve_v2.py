"""The learning-evidence run on the port: the counterpart of
experiments/tpu_curve_v2.py, step for step.

Meta-trains EfficientLab-b0 (rsd=(2, 4), bf16 compute, final dropout 0.5)
from random init with FOMAML* (10 shots, a raw tail of 5, 59 inner SGD
steps at batch 8, bce_dice + l2, lr 5e-4, aug rate 0.5, the meta step
annealed from 0.1 to 1e-5 over --meta_iters) on synthetic tasks of five
shape families, and scores 5-shot adaptation (transductive, augmented) on
tasks of three families it never saw. The comparison is paired: the
random-init baseline and every later evaluation score the same episodes
(evaluation sample s draws from a generator seeded 9000 + s), and the
headline interval clusters the paired differences by task (per-task
means, a t-interval with ddof 1).

The stores are byte-identical to the JAX script's for the same --seed, so
--seed 0 trains and scores on the tasks of experiments/curve_v2_r4; the
init values and the random streams differ (Philox against threefry).

Strategy: with no flag the meta-batch runs on a task axis
(`learners.make_train_step`) and the evaluation in chunks of
--task_chunk_size tasks on a task axis; --chain_tasks and
--chain_eval_chunk select the JAX script's own chained strategies. The two
compute the same function of the same draws and differ only by float
rounding (tests/test_torch_task_axis.py). Every augmented inner step, in
training and in evaluation, launches the hand-written `full_pass` kernel
on the card.

Writes to --out: baseline.npy ([samples, tasks] IoUs at random init),
curve.json ([iter, mean IoU, task-level paired diff, its CI95] every
--eval_every iterations and at the last), the checkpoint of the newest
curve point (flax layout, `utils/checkpoint`), result.json (the JAX
script's keys plus `device`) and timings.jsonl (host seconds of each
meta-iteration and each evaluation point, synchronised with the device).

Usage, from the root of a checkout (on the card unless --device cpu):
  python3 experiments/torch_curve_v2.py --seed 0 --meta_iters 3000 \\
      --train_tasks 16 --eval_every 100 --out experiments/torch_curve_v2_seed0
  # in segments: add --deadline_s S, then run again with --resume
  python3 experiments/torch_curve_v2.py --device cpu --image_size 32 \\
      --inner_iters 2 --meta_batch 2 --meta_iters 2 --eval_every 1 \\
      --train_tasks 4 --test_tasks 3 --eval_samples 2 \\
      --out chiprun_out/curve_toy
Exits 3 after writing a partial result.json if a meta-iteration fails.
"""
import argparse
import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRAIN_FAMILIES = ("rect", "ellipse", "cross", "stripes", "lshape")
TEST_FAMILIES = ("triangle", "ring", "diamond")
LR = 5e-4
EXAMPLES_PER_TASK = 10


def argument_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--meta_iters", type=int, default=3000)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--train_tasks", type=int, default=40)
    p.add_argument("--test_tasks", type=int, default=12)
    p.add_argument("--eval_samples", type=int, default=3)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--deadline_s", type=float, default=4.5 * 3600,
                   help="stop after the meta-iteration that ends past this "
                        "many seconds from the script's start")
    p.add_argument("--out", type=str, required=True,
                   help="directory of the run's files")
    p.add_argument("--inner_iters", type=int, default=59)
    p.add_argument("--meta_batch", type=int, default=5)
    p.add_argument("--seed", type=int, default=0,
                   help="offsets the synthetic stores' draws (train and "
                        "held-out), the model init and the training stream")
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoint in --out; the "
                        "baseline and the curve reload from its files")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    p.add_argument("--task_chunk_size", type=int, default=8,
                   help="held-out tasks evaluated together on a task axis")
    p.add_argument("--chain_tasks", action="store_true",
                   help="run the meta-batch's tasks one after another")
    p.add_argument("--chain_eval_chunk", action="store_true",
                   help="evaluate the held-out tasks one after another")
    return p


def make_stores(args):
    """(train store, held-out store), the JAX script's families and
    seeds."""
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    store = make_synthetic_store(num_tasks=args.train_tasks,
                                 examples_per_task=EXAMPLES_PER_TASK,
                                 image_size=args.image_size,
                                 seed=1000 * args.seed,
                                 shapes=TRAIN_FAMILIES)
    test_store = make_synthetic_store(num_tasks=args.test_tasks,
                                      examples_per_task=EXAMPLES_PER_TASK,
                                      image_size=args.image_size,
                                      seed=777 + 1000 * args.seed,
                                      shapes=TEST_FAMILIES)
    return store, test_store


def task_level_ci(mat, baseline):
    """Paired task-level stats against the random-init baseline: the
    [samples, tasks] paired differences clustered to per-task means, a
    t-interval with ddof 1. Returns (mean diff, CI95 half-width, tasks)."""
    import numpy as np
    from scipy import stats as sps
    per_task = np.nanmean(mat - baseline, axis=0)
    per_task = per_task[np.isfinite(per_task)]
    n_t = len(per_task)
    hw = float(sps.t.ppf(0.975, n_t - 1)
               * np.std(per_task, ddof=1) / np.sqrt(n_t))
    return float(np.mean(per_task)), hw, n_t


def device_name(dev):
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]


def main(argv=None):
    t0 = time.time()

    def log(*a):
        print("[{:8.1f}s]".format(time.time() - t0), *a, flush=True)

    args = argument_parser().parse_args(argv)
    import numpy as np
    import torch
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import episodes
    from mliis_tpu_torch.meta.evaluate import EvalConfig, GeckoEvaluator
    from mliis_tpu_torch.meta.inner_loop import (LossConfig, OptimizerConfig,
                                                 init_model_state)
    from mliis_tpu_torch.meta.learners import (MetaTrainConfig,
                                               draw_meta_step,
                                               make_chained_train_step,
                                               make_train_step,
                                               meta_step_size_schedule)
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils import checkpoint as ckpt_lib

    dev = resolve_device(args.device)
    card = device_name(dev)
    log("device:", card)

    store, test_store = make_stores(args)
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(dev)
    loss_cfg = LossConfig(dice=True, l2=True, remat=False)
    opt_cfg = OptimizerConfig(name="sgd")
    cfg = MetaTrainConfig(num_shots=10, inner_batch_size=8,
                          inner_iters=args.inner_iters,
                          meta_batch_size=args.meta_batch, foml=True,
                          tail_shots=5, aug_rate=0.5)
    state = init_model_state(model, opt_cfg)
    init_state = copy.deepcopy(state)  # the random-init copy

    eval_cfg = EvalConfig(num_shots=5, test_shots=5, inner_batch_size=8,
                          inner_iters=args.inner_iters, transductive=True,
                          augment=True, task_chunk_size=args.task_chunk_size,
                          chain_chunk=args.chain_eval_chunk)
    evaluator = GeckoEvaluator(model, loss_cfg, opt_cfg, eval_cfg,
                               test_store, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def paired_eval(st):
        """[eval_samples, test_tasks] per-task IoUs; sample s always draws
        from a generator seeded 9000 + s, so every call scores the same
        episodes."""
        rows = []
        for s in range(args.eval_samples):
            gen = torch.Generator(device=dev).manual_seed(9000 + s)
            rows.append(evaluator.evaluate_tasks(
                st, list(range(test_store.num_tasks)), gen, LR,
                aug_rate=0.5))
        return np.stack(rows)

    os.makedirs(args.out, exist_ok=True)
    baseline_path = os.path.join(args.out, "baseline.npy")
    curve_path = os.path.join(args.out, "curve.json")
    timings_path = os.path.join(args.out, "timings.jsonl")
    start_iter = 0
    resume_path = None
    if args.resume:
        try:
            resume_path = ckpt_lib.latest_checkpoint(args.out)
        except FileNotFoundError:
            log("--resume: no checkpoint in", args.out, "- starting fresh")
    if resume_path is not None:
        state, meta = ckpt_lib.restore_checkpoint(resume_path, state)
        start_iter = int(meta.get("step", 0))
        baseline = np.load(baseline_path)
        with open(curve_path) as f:
            curve = json.load(f)
        log("resumed from iter", start_iter)
    else:
        log("evaluating random-init baseline on held-out families...")
        baseline = paired_eval(init_state)
        np.save(baseline_path, baseline)
        curve = [[0, float(np.nanmean(baseline))]]
        log("baseline mean IoU:", round(float(np.nanmean(baseline)), 4))
        if os.path.exists(timings_path):
            os.remove(timings_path)

    if args.chain_tasks:
        train_step = make_chained_train_step(model, loss_cfg, opt_cfg, cfg)
    else:
        train_step = make_train_step(model, loss_cfg, opt_cfg, cfg)
    imgs, msks, cnts = store.to_torch(dev)
    n_max = imgs.shape[1]

    # The training stream is replayable: a resumed run first draws the
    # seeds of the iterations done, so it draws what the uninterrupted run
    # would have.
    generator = torch.Generator(device=dev).manual_seed(42 + args.seed)
    for _ in range(start_iter):
        episodes.draw_seed(generator)

    t_train0 = time.time()
    done_iters = start_iter

    def timing(**entry):
        with open(timings_path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def _write_partial(error=None):
        with open(os.path.join(args.out, "result.json"), "w") as f:
            json.dump({"partial": True, "error": error,
                       "meta_iters_done": done_iters, "curve": curve,
                       "baseline_mean_iou": float(np.nanmean(baseline)),
                       "wall_s": round(time.time() - t0, 1),
                       "device": card}, f, indent=1)

    try:
        for i in range(start_iter, args.meta_iters):
            t_iter = time.time()
            ms = meta_step_size_schedule(i, args.meta_iters, 0.1, 1e-5)
            draws = draw_meta_step(episodes.draw_seed(generator), cnts, cfg,
                                   n_max)
            state = train_step(state, imgs, msks, draws, ms, LR)
            sync()
            done_iters = i + 1
            timing(iter=done_iters, s=time.time() - t_iter)
            if (done_iters % args.eval_every == 0
                    or done_iters == args.meta_iters):
                t_eval = time.time()
                test_ious = paired_eval(state)
                d_mean, d_ci, _ = task_level_ci(test_ious, baseline)
                timing(eval_at=done_iters, s=time.time() - t_eval)
                # entry: [iter, mean IoU, task-level paired diff, its CI95]
                curve.append([done_iters, float(np.nanmean(test_ious)),
                              d_mean, d_ci])
                rate = ((done_iters - start_iter)
                        / (time.time() - t_train0))
                log("iter", done_iters, "held-out IoU",
                    round(curve[-1][1], 4), "({:.3f} it/s)".format(rate))
                with open(curve_path, "w") as f:
                    json.dump(curve, f)
                ckpt_lib.save_checkpoint(args.out, state, done_iters,
                                         max_to_keep=1)
            if time.time() - t0 > args.deadline_s:
                log("deadline reached at iter", done_iters)
                break
    except Exception as exc:  # noqa: BLE001 - a fault must not lose the run
        log("FATAL at iter", done_iters, "-", repr(exc))
        _write_partial(error=repr(exc))
        raise SystemExit(3)

    log("final paired evaluation...")
    final = paired_eval(state)
    diffs = (final - baseline).ravel()
    diffs = diffs[np.isfinite(diffs)]
    mean_d = float(np.mean(diffs))
    ci = float(1.96 * np.std(diffs) / np.sqrt(len(diffs)))
    mean_t, ci_t, n_t = task_level_ci(final, baseline)
    strategy = "{} meta-step, {} evaluation".format(
        "chained" if args.chain_tasks else "task-axis",
        "chained" if args.chain_eval_chunk else
        "task-axis chunks of {}".format(args.task_chunk_size))
    out = {
        "config": ("EfficientLab-6-3 FOMAML* ({}), run.sh shapes; "
                   "train families {} x {} tasks; DISJOINT test families {} "
                   "x {} tasks; paired eval seeds".format(
                       strategy, TRAIN_FAMILIES, args.train_tasks,
                       TEST_FAMILIES, args.test_tasks)),
        "seed": args.seed,
        "meta_iters_done": done_iters,
        "baseline_mean_iou": float(np.nanmean(baseline)),
        "final_mean_iou": float(np.nanmean(final)),
        "paired_diff_mean": mean_d,
        "paired_diff_ci95": ci,
        "ci_excludes_zero": bool(mean_d - ci > 0),
        "n_pairs": int(len(diffs)),
        "task_level_diff_mean": mean_t,
        "task_level_ci95_t": ci_t,
        "task_level_ci_excludes_zero": bool(mean_t - ci_t > 0),
        "n_tasks": int(n_t),
        "curve": curve,
        "wall_s": round(time.time() - t0, 1),
        "device": card,
    }
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    log("RESULT", json.dumps(out))
    return out


if __name__ == "__main__":
    main()
