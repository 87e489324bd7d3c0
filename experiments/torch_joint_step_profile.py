"""Where one joint training step of the PyTorch/CUDA port spends its time,
on one GPU.

Runs the joint baseline's step at full width (EfficientLab-b0 rsd=(2,) in
float32 with a 1001-channel head, 224^2, batch 64, SGD + l2, one
`fused_light_augment` launch a step) on random data: 640 training images
with class ids in 0..1000 (the step's time does not depend on what the
images show, so the synthetic store's minute of host work is skipped).
Three warm-up steps, ten timed steps, then five steps under torch.profiler
(CPU + CUDA activities), and one timed val step. Prints one JSON line and
then the top kernels:
  - the wall seconds a step (the mean of the ten), the summed device
    kernel time a profiled step, and from them the device's idle share;
  - the device time of the 1001-channel head's kernels (the resize, the
    softmax family and the NLL loss, forward and backward) and of
    `fused_light_augment`, each as a share of the device time;
  - the peak memory, the val step's seconds, and the card's name and power
    limit (nvidia-smi).

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_joint_step_profile.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HEAD_KERNELS = ("upsample", "softmax", "nll_loss")


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mliis_tpu_torch.device import resolve_device
    from mliis_tpu_torch.joint.trainer import (JointDataset,
                                               JointTrainConfig,
                                               JointTrainer)
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment_kernels as ak

    dev = resolve_device()
    rng = np.random.default_rng(0)
    n, size, classes = 640, 224, 1000
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = np.zeros((n, size, size), np.int32)
    labels[:, 60:160, 50:170] = rng.integers(1, classes + 1, (n, 1, 1))
    names = ["class_{:04d}".format(i) for i in range(classes)]
    train = JointDataset(images, labels, names)
    val = JointDataset(images[:64], labels[:64], names)

    model = EfficientLab(n_classes=classes, rsd=(2,),
                         final_layer_dropout_rate=0.0)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt_cfg = il.OptimizerConfig("sgd")
    trainer = JointTrainer(model, train, val, JointTrainConfig(
        batch_size=64, augment=True, l2=True), opt_cfg, device=dev)
    opt = il.init_model_state(model, opt_cfg).opt
    gen = torch.Generator(device=dev).manual_seed(1)

    def steps(opt, k):
        for _ in range(k):
            idx = torch.randint(0, n, (64,), generator=gen, device=dev)
            seeds = torch.randint(0, 2 ** 31 - 1, (64,), generator=gen,
                                  device=dev, dtype=torch.int32)
            opt, _ = trainer.train_step(opt, idx, seeds, 0.005, gen)
        return opt

    opt = steps(opt, 3)                       # warm-up (cuDNN autotune)
    torch.cuda.synchronize()
    t0 = time.time()
    opt = steps(opt, 10)
    torch.cuda.synchronize()
    wall = (time.time() - t0) / 10
    ak.fused_light_augment.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt = steps(opt, 5)
        torch.cuda.synchronize()
    launches = ak.fused_light_augment.launches
    torch.cuda.synchronize()
    t0 = time.time()
    trainer.val_step(torch.arange(64, device=dev))
    torch.cuda.synchronize()
    val_s = time.time() - t0

    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values()) / 5
    head_ms = sum(v for k, v in by_name.items()
                  if any(h in k.lower() for h in HEAD_KERNELS)) / 5
    light_ms = sum(v for k, v in by_name.items()
                   if "light_augment" in k) / 5
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": smi, "step_s": wall, "steps_per_s": 1.0 / wall,
        "device_kernel_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
        "head_ms_per_step": head_ms,
        "head_share_of_device": head_ms / device_ms,
        "light_augment_ms_per_step": light_ms,
        "light_augment_share_of_device": light_ms / device_ms,
        "light_augment_launches": launches,
        "val_step_s": val_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}))
    for name, ms in top:
        print("{:10.2f} ms  {}".format(ms / 5, name[:110]))


if __name__ == "__main__":
    main()
