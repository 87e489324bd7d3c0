"""How far the evaluation's mean IoU moves between two strategies, and
between two runs of one strategy, on one GPU.

Evaluates the committed experiments/curve_v2_r4 checkpoint
(EfficientLab-b0 rsd=(2, 4), bf16, final dropout 0.5) on its 12 held-out
synthetic tasks (seed 777) with run.sh's protocol (5 shots + 5 query, 59
SGD steps at batch 8, 224^2, lr 5e-4, bce_dice + l2, aug rate 0.5,
transductive, one sample), on the fused route, in turns: chained, batched
(chunks of 2 on a task axis), batched, chained, every run from the same
evaluation seed, so every run draws the same episodes. Prints one JSON
line: each run's mean IoU, task IoUs and wall, the run-to-run gap of each
strategy (the same code twice) and the strategy gap (the mean of each
strategy's runs), and the card's name and power limit (nvidia-smi).
With `--cudnn-deterministic`, cuDNN takes deterministic algorithms
(`torch.backends.cudnn.deterministic`); with `--deterministic`, PyTorch's
ops do too (`torch.use_deterministic_algorithms`, as chip_smoke.py's
`eval` and `batched` phases run), so each strategy's two runs show
whether the evaluation repeats bit for bit.

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_batched_eval_iou.py [--cudnn-deterministic |
      --deterministic]
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TASKS, SEED = 12, 9000


def main():
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import evaluate as ev
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz

    mode = ("all" if "--deterministic" in sys.argv[1:] else "cudnn"
            if "--cudnn-deterministic" in sys.argv[1:] else "none")
    if mode == "all":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = resolve_device()
    torch.backends.cudnn.deterministic = mode != "none"
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.load_state_dict(load_jax_npz(os.path.join(
        ROOT, "experiments", "curve_v2_r4", "model.ckpt-3000.npz")))
    store = make_synthetic_store(num_tasks=TASKS, examples_per_task=10,
                                 image_size=224, seed=777,
                                 shapes=("triangle", "ring", "diamond"))
    opt = il.OptimizerConfig("sgd")
    base = ev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=8,
                         inner_iters=59, transductive=True, augment=True,
                         task_chunk_size=2)
    evaluators = {
        name: ev.GeckoEvaluator(
            model, il.LossConfig(dice=True, l2=True), opt,
            dataclasses.replace(base, chain_chunk=name == "chained"), store,
            device=dev)
        for name in ("chained", "batched")}
    state = il.init_model_state(model, opt)
    runs = []
    for name in ("chained", "batched", "batched", "chained"):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.time()
        mean_iou, task_map = ev.evaluate_gecko(
            evaluators[name], state, gen, 5e-4, num_samples=1,
            serially_eval_all_tasks=True, aug_rate=0.5,
            log_fn=lambda line: None)
        torch.cuda.synchronize()
        runs.append({"strategy": name, "mean_iou": mean_iou,
                     "wall_s": time.time() - t0,
                     "task_ious": [v[0] for v in task_map.values()]})
    by = {name: [r["mean_iou"] for r in runs if r["strategy"] == name]
          for name in ("chained", "batched")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "deterministic": mode, "runs": runs,
        "run_to_run_gap": {k: abs(v[0] - v[1]) for k, v in by.items()},
        "strategy_gap": (sum(by["batched"]) - sum(by["chained"])) / 2}))


if __name__ == "__main__":
    main()
