"""How far UHO's early-stopping traces move between the two strategies
(chunks on a task axis against one task after another), and between two
runs of one strategy, on one GPU, at the benchmark's learning rate and at
the one the CLI's GP search sampled first.

The float32 `EarlyStoppingEvaluator` (EfficientLab-b0 rsd=(2, 4), final
dropout 0.5, the committed experiments/curve_v2_r4 weights; 5 shots + 5
val, batch 8, 224^2, bce_dice + l2, aug rate 0.5) traces the CLI's 4
synthetic val tasks (`--synthetic --synthetic_tasks 8 --num_val_tasks 4
--seed 0`) for 80 steps, with PyTorch's and cuDNN's deterministic
algorithms, in turns: chained, batched (chunks of 4), batched, chained,
every run from the same seed, so every run draws the same episodes; once
at lr 5e-4 and once at 0.009394926330749748. Prints one JSON line: for
each lr, each run's best steps and best IoUs (the patience walk of
`walk_trace` at the CLI's patience 50), the largest trace gap of each
strategy's repeat, and the strategy gap by step (the largest over the
tasks at steps 10, 20, 40 and 80), with the card's name and power limit
(nvidia-smi).

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_traces_divergence.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS, CHUNK, SEED = 80, 4, 9000
LRS = (5e-4, 0.009394926330749748)


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import uho_eval
    from mliis_tpu_torch.meta.early_stopping import walk_trace
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = resolve_device()
    torch.backends.cudnn.deterministic = True
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5)
    model.load_state_dict(load_jax_npz(os.path.join(
        ROOT, "experiments", "curve_v2_r4", "model.ckpt-3000.npz")))
    store = make_synthetic_store(num_tasks=8, examples_per_task=10,
                                 image_size=224, seed=0)
    val = store.subset(range(2, 6))   # the CLI's 4 val tasks
    opt = il.OptimizerConfig("sgd")
    state = il.init_model_state(model.to(dev), opt)
    evaluators = {chain: uho_eval.EarlyStoppingEvaluator(
        model, il.LossConfig(dice=True, l2=True), opt, val, device=dev,
        task_chunk_size=CHUNK, chain_chunk=chain) for chain in (True, False)}

    def run(chain, lr):
        ev = evaluators[chain]
        traces = []
        real = ev._trace_tasks

        def recorded(*args):
            out = real(*args)
            traces.append(out)
            return out
        ev._trace_tasks = recorded
        torch.cuda.synchronize()
        t0 = time.time()
        ev.evaluate_with_early_stopping(
            state, torch.Generator(device=dev).manual_seed(SEED),
            min_steps=0, max_steps=STEPS, inner_batch_size=8, lr=lr,
            aug_rate=0.5, eval_all_tasks=True)
        torch.cuda.synchronize()
        ev._trace_tasks = real
        trace = np.concatenate(traces)
        walked = [walk_trace(t, patience=50) for t in trace]
        return trace, {"strategy": "chained" if chain else "batched",
                       "wall": time.time() - t0,
                       "best_steps": [int(w[0]) for w in walked],
                       "best_ious": [float(w[1]) for w in walked]}

    result = {}
    for lr in LRS:
        runs = [run(chain, lr) for chain in (True, False, False, True)]
        chained = (runs[0][0], runs[3][0])
        batched = (runs[1][0], runs[2][0])
        gap = np.abs((batched[0] + batched[1]) / 2
                     - (chained[0] + chained[1]) / 2).max(0)
        result[str(lr)] = {
            "runs": [r[1] for r in runs],
            "repeat_gap": {"chained": float(np.abs(
                chained[0] - chained[1]).max()), "batched": float(np.abs(
                    batched[0] - batched[1]).max())},
            "strategy_gap_at_step": {str(s): float(gap[s - 1])
                                     for s in (10, 20, 40, 80)},
            "mean_best_iou": {
                "chained": float(np.mean(runs[0][1]["best_ious"])),
                "batched": float(np.mean(runs[1][1]["best_ious"]))}}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "steps": STEPS, "chunk": CHUNK,
                      "by_lr": result}))


if __name__ == "__main__":
    main()
