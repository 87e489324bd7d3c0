"""Does the augmentation route change the evaluation's IoU? A paired
comparison of the fused route (one `full_pass` a step) and the split route
(`cheap_pass`, the plain rotation, `cheap_pass`) on one GPU.

Runs run.sh's evaluation protocol (5 shots + 5 query, 59 SGD steps at
batch 8, 224^2, lr 5e-4, bce_dice + l2, aug rate 0.5, transductive) with
the committed experiments/curve_v2_r4 checkpoint (EfficientLab-b0
rsd=(2, 4), bf16, final dropout 0.5) on its 12 held-out tasks (seed 777),
over --samples samples. For each (sample, task) pair one
`evaluate.draw_episode` draw (the shots, the support/query split and the
batch index matrix, from a generator seeded 9000 + sample) is made once
and injected into both routes, and each route's episode starts from a
generator seeded alike, so the two episodes share their support and query
images, their batches and the first step's gate, permutation and prefix
lengths; the later augmentation and dropout draws differ because the
routes consume different numbers of them. The routes run in turns, fused
then split, task by task.

Prints, per route, the mean IoU with its task-level 95% CI, then the paired
difference (fused - split): per-task means over the samples, their mean and
a t-interval over the tasks (ddof 1, as experiments/tpu_curve_v2.py takes
it), and the pair-level mean; then one JSON line with every pair's IoUs,
then the card's name and power limit (nvidia-smi).

Usage, from the root of a checkout on a machine with the card
(about 7 minutes at 3 samples on an H100):
  python3 experiments/torch_route_iou.py [--samples 3]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASKS, STEPS, LR, AUG_RATE = 12, 59, 5e-4, 0.5


def task_level(per_task):
    """(mean, 95% t-interval half-width) over tasks, ddof 1."""
    from scipy import stats
    per_task = np.asarray(per_task, np.float64)
    n = len(per_task)
    hw = stats.t.ppf(0.975, n - 1) * np.std(per_task, ddof=1) / np.sqrt(n)
    return float(per_task.mean()), float(hw)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--samples", type=int, default=3)
    args = parser.parse_args()

    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import evaluate as ev
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment as taug
    from mliis_tpu_torch.ops import augment_kernels as ak
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz

    dev = resolve_device()
    with open(os.path.join(ROOT, "experiments", "curve_v2_r4",
                           "result.json")) as f:
        jax_iou = json.load(f)["final_mean_iou"]
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.load_state_dict(load_jax_npz(os.path.join(
        ROOT, "experiments", "curve_v2_r4", "model.ckpt-3000.npz")))
    model.to(dev)
    store = make_synthetic_store(num_tasks=TASKS, examples_per_task=10,
                                 image_size=224, seed=777,
                                 shapes=("triangle", "ring", "diamond"))
    images, masks, counts = store.to_torch(dev)
    opt_cfg = il.OptimizerConfig("sgd")
    cfg = ev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=8,
                        inner_iters=STEPS, transductive=True, augment=True)
    eval_task = ev.make_eval_task_fn(model, il.LossConfig(), opt_cfg, cfg)
    state = il.init_model_state(model, opt_cfg)
    routes = (("fused", True), ("split", False))
    ious = {r: np.zeros((args.samples, TASKS)) for r, _ in routes}
    launches = {}
    t0 = time.time()
    try:
        for s in range(args.samples):
            draw_gen = torch.Generator(device=dev).manual_seed(9000 + s)
            for t in range(TASKS):
                draws = ev.draw_episode(draw_gen, counts[t], cfg,
                                        images.shape[1])
                for route, fused in routes:
                    taug.PALLAS_FUSED_SINGLE_LAUNCH = fused
                    ak.full_pass.launches = ak.cheap_pass.launches = 0
                    gen = torch.Generator(device=dev).manual_seed(
                        100000 * (s + 1) + t)
                    per_image = eval_task(state, images[t], masks[t], draws,
                                          gen, LR, 0.5, AUG_RATE)
                    ious[route][s, t] = np.nanmean(per_image.cpu().numpy())
                    launches[route] = {"full_pass": ak.full_pass.launches,
                                       "cheap_pass": ak.cheap_pass.launches}
            print("sample {}: fused {:.4f} split {:.4f} ({:.1f} s so far)"
                  .format(s, ious["fused"][s].mean(), ious["split"][s].mean(),
                          time.time() - t0), flush=True)
    finally:
        taug.PALLAS_FUSED_SINGLE_LAUNCH = True
    expect = {"fused": {"full_pass": STEPS, "cheap_pass": 0},
              "split": {"full_pass": 0, "cheap_pass": 2 * STEPS}}
    if launches != expect:
        raise AssertionError("launches a task {} (expect {})".format(
            launches, expect))
    for route, _ in routes:
        mean, hw = task_level(ious[route].mean(0))
        print("{}: mean IoU {:.4f} +/- {:.4f} (task-level 95% t-CI over {} "
              "tasks x {} samples; the JAX package's {:.4f})".format(
                  route, mean, hw, TASKS, args.samples, jax_iou))
    diff = ious["fused"] - ious["split"]
    d_mean, d_hw = task_level(diff.mean(0))
    verdict = ("within the CI" if abs(d_mean) <= d_hw
               else "outside the CI")
    print("paired fused - split: task-level {:.4f} +/- {:.4f} (95% t-CI, "
          "{}); pair-level mean {:.4f} over {} pairs; per task {}".format(
              d_mean, d_hw, verdict, float(diff.mean()), diff.size,
              ["{:.3f}".format(v) for v in diff.mean(0)]))
    print("wall {:.1f} s for {} episodes".format(time.time() - t0,
                                                  2 * diff.size))
    print(json.dumps({"fused": ious["fused"].tolist(),
                      "split": ious["split"].tolist(),
                      "diff_task_mean": d_mean, "diff_task_ci95_t": d_hw,
                      "diff_pair_mean": float(diff.mean()),
                      "launches_a_task": launches}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
