"""Where one meta-step of the PyTorch/CUDA port spends its time, on one GPU.

Runs the slice at bench.py's configuration (FOMAML*, meta-batch 5 x 59
inner steps at batch 8, 224^2, EfficientLab-b0 rsd=(2, 4) in bf16,
bce_dice + l2, aug rate 0.5): one warm-up meta-step and one timed
meta-step; then, since the profiler's bookkeeping over a whole meta-step
(some 400k events) takes minutes, a one-task meta-step (the same 59 inner
steps) timed alone and then run under torch.profiler (CPU + CUDA
activities). Prints one JSON line and then the top kernels:
  - the wall seconds of the 5-task meta-step and of the one-task step, the
    summed device kernel time of the profiled one-task step, and from them
    the device's idle share;
  - device time by kernel name (top 25), and the share of `full_pass`;
  - full_pass launches in the profiled step;
  - the card's name and power limit (nvidia-smi).

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_meta_step_profile.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment_kernels as ak

    dev = resolve_device()
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    imgs, msks, counts = make_synthetic_store(
        num_tasks=8, examples_per_task=10, image_size=224,
        seed=0).to_torch(dev)
    opt_cfg = il.OptimizerConfig("sgd")
    cfg = lr.MetaTrainConfig(num_shots=10, inner_batch_size=8,
                             inner_iters=59, meta_batch_size=5, foml=True,
                             tail_shots=5, aug_rate=0.5)
    step = lr.make_chained_train_step(model, il.LossConfig(), opt_cfg, cfg)
    state = il.init_model_state(model, opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(1)

    one_cfg = dataclasses.replace(cfg, meta_batch_size=1)
    one_step = lr.make_chained_train_step(model, il.LossConfig(), opt_cfg,
                                          one_cfg)

    def meta_step(state, cfg=cfg, step=step):
        draws = lr.draw_meta_step(gen, counts, cfg, n_max=10)
        return step(state, imgs, msks, draws, gen, 0.1, 5e-4)

    def timed(fn, state):
        torch.cuda.synchronize()
        t0 = time.time()
        state = fn(state)
        torch.cuda.synchronize()
        return state, time.time() - t0

    state = meta_step(state)          # warm-up (cuDNN autotune, build)
    state, wall_meta = timed(meta_step, state)
    one = lambda st: meta_step(st, one_cfg, one_step)  # noqa: E731
    state, wall = timed(one, state)
    ak.full_pass.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = one(state)
        torch.cuda.synchronize()
    launches = ak.full_pass.launches

    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    full_pass_ms = sum(v for k, v in by_name.items() if "full_pass" in k)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "meta_step_s": wall_meta, "one_task_step_s": wall,
        "device_kernel_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
        "full_pass_ms": full_pass_ms,
        "full_pass_share_of_device": full_pass_ms / device_ms,
        "full_pass_launches": launches}))
    for name, ms in top:
        print("{:10.2f} ms  {}".format(ms, name[:110]))


if __name__ == "__main__":
    main()
