"""Where one evaluation task of the PyTorch/CUDA port spends its time, on
one GPU, on the fused and on the split augmentation route.

Runs run.sh's evaluation protocol (5 shots + 5 query, 59 SGD steps at batch
8, 224^2, lr 5e-4, bce_dice + l2, aug rate 0.5, transductive) with the
committed experiments/curve_v2_r4 checkpoint (EfficientLab-b0 rsd=(2, 4),
bf16, final dropout 0.5) on its held-out tasks (seed 777):
  - one warm-up task on each route (cuDNN autotuning, kernel builds);
  - the wall seconds of one task (task 0), timed in turns fused, split,
    split, fused, so that the two routes are compared within one call;
  - one task on each route under torch.profiler (CPU + CUDA activities):
    the summed device kernel time, the device's idle share against the
    timed wall, the augmentation kernels' share and launches, and device
    time by kernel name (top 15).
Prints one JSON line, then the top kernels of each route, then the card's
name and power limit (nvidia-smi).

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_eval_profile.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import evaluate as ev
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment as taug
    from mliis_tpu_torch.ops import kernel_library
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz

    dev = resolve_device()
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.load_state_dict(load_jax_npz(os.path.join(
        ROOT, "experiments", "curve_v2_r4", "model.ckpt-3000.npz")))
    store = make_synthetic_store(num_tasks=3, examples_per_task=10,
                                 image_size=224, seed=777,
                                 shapes=("triangle", "ring", "diamond"))
    opt_cfg = il.OptimizerConfig("sgd")
    evaluator = ev.GeckoEvaluator(model, il.LossConfig(), opt_cfg,
                                  ev.EvalConfig(transductive=True), store,
                                  device=dev)
    state = il.init_model_state(model, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    def task(fused):
        taug.PALLAS_FUSED_SINGLE_LAUNCH = fused
        torch.cuda.synchronize()
        t0 = time.time()
        evaluator.evaluate_tasks(state, [0], gen, 5e-4, aug_rate=0.5)
        torch.cuda.synchronize()
        return time.time() - t0

    try:
        task(True)
        task(False)
        walls = {"fused": [], "split": []}
        for fused in (True, False, False, True):
            walls["fused" if fused else "split"].append(task(fused))
        out, tops = {}, {}
        for route, fused in (("fused", True), ("split", False)):
            taug.PALLAS_FUSED_SINGLE_LAUNCH = fused
            kernel_library.launches.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                task(fused)
            by_name = {}
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[evt.name] = by_name.get(evt.name, 0.0) + \
                        evt.time_range.elapsed_us() / 1e3
            device_ms = sum(by_name.values())
            aug_ms = sum(v for k, v in by_name.items()
                         if "full_pass" in k or "cheap_pass" in k)
            wall = sum(walls[route]) / len(walls[route])
            out[route] = {
                "task_wall_s": walls[route],
                "device_kernel_ms": device_ms,
                "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
                "augment_kernel_ms": aug_ms,
                "augment_kernel_share_of_device": aug_ms / device_ms,
                "launches": {k: kernel_library.launches[k]
                             for k in ("full_pass", "cheap_pass")}}
            tops[route] = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    finally:
        taug.PALLAS_FUSED_SINGLE_LAUNCH = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(out, card=smi)))
    for route, top in tops.items():
        print(route)
        for name, ms in top:
            print("{:10.2f} ms  {}".format(ms, name[:110]))
    print(smi)


if __name__ == "__main__":
    main()
