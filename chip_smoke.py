#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, from the root of a
checkout: `python3 chip_smoke.py`.

It prints the card's name and power limit (nvidia-smi) first, then runs
its phases, one line each (or a few):
  1. build: compile every mliis_tpu_torch/csrc/*.cu kernel for sm_90a, one
     `nvcc` per source, all started together.
  2. kernel: `full_pass` against `full_pass_reference` on the card at the
     meta path's shapes (B=8, 5 x 224^2): fixed rows that run every op and
     every rotation mode, then rows drawn as the meta path draws them.
     Tolerances: 1e-3 abs on samples without rotation; on rotated samples
     1e-2 abs on the image planes (0..255) and at most 1e-4 of the mask
     pixels flipped (fg/bg ties within float32 DFT rounding). Times both
     and computes the kernel's bound.
  3. kernel[light_augment]: `fused_light_augment` against
     `fused_light_augment_reference` at the joint path's shapes (B=64,
     224^2, prob_original 0, labels in 0..1000), with seeds that cover
     every op, prefix length and translate mode (the coverage is printed):
     labels exact, images 1e-3 abs on 0..255; prob_original 1 must be the
     identity. Times both and computes the bound.
  4. agree: EfficientLab-b0's train-mode loss and gradients at a small
     input (4 x 64^2, float32, no dropout) on the card and on the CPU must
     agree: loss 1e-4 rel, each param's gradient within 1e-3 of the whole
     gradient's norm.
     agree[joint]: one augmented joint SGD step of EfficientLab-b0 with
     1001 channels (4 x 32^2, float32) on the card, through the
     `fused_light_augment` kernel, against the CPU's, through its plain
     version: loss 1e-4 rel, each param's update within 1e-3 of the whole
     update's norm.
  5. slice: two chained FOMAML* meta-steps at bench.py's configuration
     (EfficientLab-b0 rsd=(2, 4), bf16, final dropout 0.5; synthetic store
     8 tasks x 10 images at 224^2; meta-batch 5 x 59 inner steps at batch
     8, 10 shots, tail 5; bce_dice + l2; SGD lr 5e-4; meta step 0.1; aug
     rate 0.5). `full_pass` must be launched exactly 2 x 5 x 58 = 580 times
     and the params must be finite and changed.
  6. joint: the joint CLI, `mliis_tpu_torch.cli.joint_train.main`, at full
     width: 1000 synthetic classes (1001 output channels, 750 train tasks
     x 10 images on the card), EfficientLab-b0 rsd=(2,) in float32, 224^2,
     batch 64, SGD + l2 + augmentation, 12 steps and 2 val batches.
     `fused_light_augment` must be launched exactly 12 times and
     `full_pass` not at all, the params must be finite and changed, and
     the checkpoint must be in flax layout and read back through
     `restore_checkpoint`. Prints the store's build seconds, steps/s over
     the last 6 steps and the peak memory.
Then the `kernels` JSON line, the card's name and power limit again, and
the result line. Any failed phase exits non-zero, as does a run without a
card or away from the checkout.
"""
import json
import math
import os
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_build():
    from mliis_tpu_torch.ops import augment_kernels as ak
    t0 = time.time()
    built = ak.build_library(verbose=True)
    for name, (path, seconds, out) in built.items():
        usage = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("build[{}]: {:.2f} s -> {} | {}".format(name, seconds, path,
                                                    " ; ".join(usage)))
    log("build: {} sources in parallel, {:.2f} s".format(len(built),
                                                         time.time() - t0))


def _planar_batch(dev, b=8, size=224):
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta.episodes import onehot_mask
    from mliis_tpu_torch.ops.augment import to_planar
    store = make_synthetic_store(num_tasks=1, examples_per_task=b,
                                 image_size=size, seed=3)
    images = torch.as_tensor(store.images[0], device=dev).float()
    masks = onehot_mask(torch.as_tensor(store.masks[0], device=dev))
    return to_planar(images, masks)


def _compare(name, out, ref, rotated, c_img=3):
    err_plain = (out[~rotated] - ref[~rotated]).abs()
    err_img = (out[rotated, :c_img] - ref[rotated, :c_img]).abs()
    flips = (out[rotated, c_img:] != ref[rotated, c_img:]).float()
    e0 = float(err_plain.max()) if err_plain.numel() else 0.0
    e1 = float(err_img.max()) if err_img.numel() else 0.0
    flip = float(flips.mean()) if flips.numel() else 0.0
    log("kernel[{}]: rotated {}/{} | max abs unrotated {:.3g} (<= 1e-3) | "
        "max abs rotated image {:.3g} (<= 1e-2) | mask flips {:.3g} "
        "(<= 1e-4)".format(name, int(rotated.sum()), rotated.numel(), e0,
                           e1, flip))
    if not (e0 <= 1e-3 and e1 <= 1e-2 and flip <= 1e-4
            and bool(out.isfinite().all())):
        raise AssertionError("full_pass disagrees with its plain version")
    return max(e0, e1)


def phase_kernel(dev):
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    b, c_tot, size = 8, 5, 224
    x = _planar_batch(dev, b, size)
    i32 = dict(dtype=torch.int32, device=dev)
    ident = [5, 0, 1, 2, 3, 4]
    perm = torch.tensor([[0, 1, 2, 3, 4, 5], ident, ident, ident, ident,
                         ident, [0, 1, 5, 2, 3, 4], [4, 3, 2, 1, 0, 5]],
                        **i32)
    num = torch.tensor([5, 1, 1, 1, 1, 1, 6, 6], **i32)
    rot = torch.tensor([[0, 0, 0, 0], [30, 0, 0, 0], [-44, 1, 0, 77],
                        [17, 1, 1, 0], [-12, 2, 0, 0], [40, 3, 0, 0],
                        [25, 1, 1, 0], [-33, 1, 0, 200]], **i32)
    seeds = torch.arange(101, 101 + b, **i32)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rotated_of(perm, num):
        pos = torch.arange(6, device=dev)[None] < num[:, None]
        return ((perm == ak.ROTATE_OP) & pos).any(1)

    err = _compare("fixed", ak.full_pass(seeds, x, perm, num, rot),
                   ak.full_pass_reference(seeds, x, perm, num, rot),
                   rotated_of(perm, num))
    # Rows drawn as ops/augment.augment_batch draws them.
    perm = torch.argsort(torch.rand(b, 6, generator=gen, device=dev),
                         1).to(torch.int32).contiguous()
    num = torch.randint(1, 7, (b,), generator=gen, **i32)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen, **i32)
    rot = torch.stack([torch.randint(lo, hi, (b,), generator=gen, **i32)
                       for lo, hi in ((-45, 45), (0, 4), (0, 2), (0, 256))],
                      1).contiguous()
    rotated = rotated_of(perm, num)
    err = max(err, _compare("drawn", ak.full_pass(seeds, x, perm, num, rot),
                            ak.full_pass_reference(seeds, x, perm, num, rot),
                            rotated))
    ak.full_pass.launches = 0
    kernel_ms = cuda_ms(lambda: ak.full_pass(seeds, x, perm, num, rot), 20)
    plain_ms = cuda_ms(lambda: ak.full_pass_reference(seeds, x, perm, num,
                                                      rot), 3)
    n_rot = int(rotated.sum())
    bytes_moved = 2 * x.numel() * 4 + 4 * (b + 6 * b + b + 4 * b)
    flops = n_rot * 3 * 4 * 2 * c_tot * size * size * size
    bound_ms = 1e3 * max(bytes_moved / H100_BYTES_PER_S,
                         flops / H100_FP32_FLOP_PER_S)
    bound_by = "bytes" if bytes_moved / H100_BYTES_PER_S >= \
        flops / H100_FP32_FLOP_PER_S else "operations"
    log("kernel: kernel_ms {:.4f} plain_ms {:.4f} bound_ms {:.5f} ({}, {} "
        "of {} samples rotated)".format(kernel_ms, plain_ms, bound_ms,
                                        bound_by, n_rot, b))
    return {"name": "full_pass", "route": "cuda",
            "source": "mliis_tpu_torch/csrc/full_pass.cu",
            "replaces": "mliis_tpu/ops/pallas_augment.py:610",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# Operations of one noise value (a pixel and channel) of `fused_light_augment`:
# Philox4x32-10 (10 rounds of 4 multiplies, 4 xors, 2 adds), two uniforms
# (3 each), Box-Muller (7), the scale, add and clip (4).
LIGHT_NOISE_OPS = 100 + 6 + 7 + 4


def phase_light_kernel(dev):
    """`fused_light_augment` against its plain version at the joint path's
    shapes (B=64, 224^2, prob_original 0, labels in 0..1000)."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    b, size = 64, 224
    gen = torch.Generator(device=dev).manual_seed(11)
    images = torch.randint(0, 256, (b, size, size, 3), generator=gen,
                           device=dev).float()
    masks = torch.randint(0, 1001, (b, size, size), generator=gen,
                          device=dev).float()
    seeds = torch.arange(1000, 1000 + b, dtype=torch.int32, device=dev)
    p = ak.draw_light_params(seeds)
    stage = torch.arange(4, device=dev)[None]
    applied = [((p["ops"] == op) & (stage < p["num"][:, None])).any(1)
               for op in range(4)]
    tr = applied[ak.TRANSLATE]
    coverage = {
        "samples_per_op": {name: int(a.sum()) for name, a in zip(
            ak.LIGHT_OPS, applied)},
        "prefix_lengths": {n: int((p["num"] == n).sum()) for n in range(
            1, 5)},
        "translate": {"roll": int((tr & p["do_roll"]).sum()),
                      "stripe": int((tr & ~p["do_roll"]).sum()),
                      "vertical": int((tr & p["vert"]).sum()),
                      "horizontal": int((tr & ~p["vert"]).sum())},
    }
    log("kernel[light_augment]: coverage " + json.dumps(coverage))
    counts = [v for d in coverage.values() for v in d.values()]
    if min(counts) == 0:
        raise AssertionError("the seeds do not cover every op and mode")

    out_i, out_m = ak.fused_light_augment(seeds, images, masks)
    ref_i, ref_m = ak.fused_light_augment_reference(seeds, images, masks)
    err = float((out_i - ref_i).abs().max())
    labels_exact = bool(torch.equal(out_m, ref_m))
    id_i, id_m = ak.fused_light_augment(seeds, images, masks,
                                        prob_original=1.0)
    identity = bool(torch.equal(id_i, images) and torch.equal(id_m, masks))
    changed = float((out_i != images).any(-1).float().mean())
    log("kernel[light_augment]: B={} {}^2 | max abs image {:.3g} (<= 1e-3) "
        "| labels exact {} | prob_original=1 identity {} | pixels changed "
        "{:.3f}".format(b, size, err, labels_exact, identity, changed))
    if not (err <= 1e-3 and labels_exact and identity
            and bool(out_i.isfinite().all())):
        raise AssertionError("fused_light_augment disagrees with its plain "
                             "version")
    kernel_ms = cuda_ms(lambda: ak.fused_light_augment(seeds, images, masks),
                        20)
    plain_ms = cuda_ms(lambda: ak.fused_light_augment_reference(
        seeds, images, masks), 3)
    noisy = int(applied[ak.NOISE].sum())
    bytes_moved = 2 * (images.numel() + masks.numel()) * 4 + 4 * b
    ops = noisy * size * size * 3 * LIGHT_NOISE_OPS
    t_bytes, t_ops = bytes_moved / H100_BYTES_PER_S, ops / H100_FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log("kernel[light_augment]: kernel_ms {:.4f} plain_ms {:.4f} bound_ms "
        "{:.5f} ({}; {} of {} samples noised)".format(
            kernel_ms, plain_ms, bound_ms, bound_by, noisy, b))
    return {"name": "fused_light_augment", "route": "cuda",
            "source": "mliis_tpu_torch/csrc/light_augment.cu",
            "replaces": "mliis_tpu/ops/pallas_augment.py:188",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _loss_and_grads(dev, init_state, images, masks):
    """Loss and gradients of one train-mode forward of EfficientLab-b0 in
    float32, without drop-connect or dropout."""
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.0)
    getattr(model, model.backbone_name).drop_connect_rate = 0.0
    model.load_state_dict(init_state)
    model.to(dev)
    loss, grads = il.make_loss_and_grad(model, il.LossConfig())(
        images.to(dev), masks.to(dev), None, None)
    return float(loss), [g.cpu() for g in grads]


def phase_agree(dev):
    """The model's loss and gradients on the card against the CPU's at a
    small input (4 x 64^2, float32). Gradients are compared against the
    whole gradient's norm: the biases of batch norms that feed a linear
    layer and another batch norm have a zero gradient, whose float32 noise
    has no relative scale of its own."""
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta.episodes import onehot_mask
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    init = EfficientLab(rsd=(2, 4))
    init.reset_parameters(torch.Generator().manual_seed(0))
    store = make_synthetic_store(num_tasks=1, examples_per_task=4,
                                 image_size=64, seed=1)
    images = torch.as_tensor(store.images[0]).float()
    masks = onehot_mask(torch.as_tensor(store.masks[0]))
    loss_card, g_card = _loss_and_grads(dev, init.state_dict(), images, masks)
    loss_cpu, g_cpu = _loss_and_grads(torch.device("cpu"), init.state_dict(),
                                      images, masks)
    norm = float(torch.sqrt(sum(g.square().sum() for g in g_cpu)))
    worst = max(float((a - b).norm()) for a, b in zip(g_card, g_cpu)) / norm
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log("agree: card vs cpu, 4 x 64^2 float32 | loss {:.6f} vs {:.6f} "
        "(rel {:.3g} <= 1e-4) | max_k |dg_k| / |g| {:.3g} (<= 1e-3)".format(
            loss_card, loss_cpu, loss_err, worst))
    if not (loss_err <= 1e-4 and worst <= 1e-3):
        raise AssertionError("the card's gradients disagree with the CPU's")


def phase_agree_joint(dev):
    """One augmented joint SGD step of EfficientLab-b0 with 1001 channels
    (batch 4 at 32^2, float32, label smoothing 0.1, no drop-connect) on the
    card, with the `fused_light_augment` kernel, against the same step on
    the CPU, with its plain version: loss 1e-4 rel, each param's update
    within 1e-3 of the whole update's norm."""
    import numpy as np
    import torch
    from mliis_tpu_torch.joint.trainer import (JointDataset,
                                               JointTrainConfig,
                                               JointTrainer)
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    rng = np.random.default_rng(5)
    labels = np.zeros((8, 32, 32), np.int32)
    labels[:, 8:24, 6:22] = rng.integers(1, 1001, (8, 1, 1))
    ds = JointDataset(rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                      labels, ["c{:04d}".format(i) for i in range(1000)])
    init = EfficientLab(n_classes=1000, rsd=(2,),
                        final_layer_dropout_rate=0.0)
    init.reset_parameters(torch.Generator().manual_seed(0))
    start = {k: v.detach().clone() for k, v in init.named_parameters()}
    out = []
    for d in (dev, torch.device("cpu")):
        model = EfficientLab(n_classes=1000, rsd=(2,),
                             final_layer_dropout_rate=0.0)
        getattr(model, model.backbone_name).drop_connect_rate = 0.0
        model.load_state_dict(init.state_dict())
        trainer = JointTrainer(model, ds, ds, JointTrainConfig(
            batch_size=4, label_smoothing=0.1), device=d,
            log_fn=lambda *a: None)
        opt = il.init_model_state(model, il.OptimizerConfig("sgd")).opt
        _, loss = trainer.train_step(
            opt, torch.tensor([0, 2, 5, 7], device=d),
            torch.tensor([11, 12, 13, 14], dtype=torch.int32, device=d),
            0.005)
        out.append((float(loss), {k: v.detach().cpu() - start[k]
                                  for k, v in model.named_parameters()}))
    (loss_card, upd_card), (loss_cpu, upd_cpu) = out
    norm = float(torch.sqrt(sum(u.square().sum() for u in upd_cpu.values())))
    worst = max(float((upd_card[k] - upd_cpu[k]).norm())
                for k in upd_cpu) / norm
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log("agree[joint]: card (kernel) vs cpu (plain version), 1001 channels, "
        "4 x 32^2 | loss {:.6f} vs {:.6f} (rel {:.3g} <= 1e-4) | max_k "
        "|du_k| / |u| {:.3g} (<= 1e-3)".format(loss_card, loss_cpu,
                                               loss_err, worst))
    if not (loss_err <= 1e-4 and worst <= 1e-3):
        raise AssertionError("the card's joint step disagrees with the CPU's")


def phase_slice(dev):
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment_kernels as ak
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    store = make_synthetic_store(num_tasks=8, examples_per_task=10,
                                 image_size=224, seed=0)
    imgs, msks, counts = store.to_torch(dev)
    opt_cfg = il.OptimizerConfig("sgd")
    cfg = lr.MetaTrainConfig(num_shots=10, inner_batch_size=8,
                             inner_iters=59, meta_batch_size=5, foml=True,
                             tail_shots=5, aug_rate=0.5)
    step = lr.make_chained_train_step(model, il.LossConfig(dice=True,
                                                           l2=True),
                                      opt_cfg, cfg)
    state = il.init_model_state(model, opt_cfg)
    start = {k: v.clone() for k, v in state.params.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    ak.full_pass.launches = 0
    ak.fused_light_augment.launches = 0
    seconds = []
    for _ in range(2):
        t0 = time.time()
        draws = lr.draw_meta_step(gen, counts, cfg, n_max=10)
        state = step(state, imgs, msks, draws, gen, 0.1, 5e-4)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = ak.full_pass.launches
    light = ak.fused_light_augment.launches
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    moved = sum(float((state.params[k] - start[k]).abs().sum())
                for k in start)
    log("slice: meta-step seconds {} | full_pass launches {} (expect 580) "
        "| fused_light_augment launches {} (expect 0) | params finite {} | "
        "sum |d params| {:.4g} | peak memory {:.2f} GB".format(
            ["{:.3f}".format(s) for s in seconds], launches, light, finite,
            moved, torch.cuda.max_memory_allocated(dev) / 1e9))
    if launches != 2 * 5 * 58 or light != 0 or not finite or not moved > 0:
        raise AssertionError("the slice did not run as expected")
    return launches


JOINT_ARGV = ["--synthetic", "--synthetic_tasks", "1000", "--image_size",
              "224", "--rsd", "2", "--sgd", "--l2", "--augment",
              "--batch_size", "64", "--epochs", "1", "--steps_per_epoch",
              "12", "--eval_interval", "1", "--val_batches", "2", "--seed",
              "0"]
JOINT_STEPS = 12


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_joint(dev):
    """The joint CLI at full width: 1000 synthetic classes (1001 output
    channels), EfficientLab-b0 rsd=(2,), 224^2, batch 64, SGD + l2 +
    augmentation, 12 steps and 2 val batches."""
    import contextlib
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mliis_tpu_torch.cli import joint_train
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment_kernels as ak
    from mliis_tpu_torch.utils import checkpoint as ckpt
    workdir = tempfile.mkdtemp(prefix="joint_smoke_")
    try:
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ak.full_pass.launches = 0
        ak.fused_light_augment.launches = 0
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            state = joint_train.main(JOINT_ARGV + ["--checkpoint", workdir],
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = ak.fused_light_augment.launches
        meta_launches = ak.full_pass.launches
        peak = torch.cuda.max_memory_allocated(dev)
        out = "".join(tee.parts)
        store_s = float(re.search(r"built in ([0-9.]+) s", out).group(1))

        with open(os.path.join(workdir, "joint_train_metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        step_s = [r["value"] for r in records if r["tag"] == "step_seconds"]
        last6 = 6 / sum(step_s[-6:])
        init = EfficientLab(n_classes=1000, rsd=(2,),
                            final_layer_dropout_rate=0.0)
        init.reset_parameters(torch.Generator().manual_seed(0))
        start = dict(init.named_parameters())
        finite = all(bool(v.isfinite().all()) for v in state.params.values())
        moved = sum(float((v.cpu() - start[k].detach()).abs().sum())
                    for k, v in state.params.items())

        path = ckpt.latest_checkpoint(workdir)
        with np.load(path) as z:
            keys = list(z.files)
            head = z["params/final_layer_weights/kernel"].shape
        layout = all(k == "opt_step" or k.split("/")[0] in (
            "params", "batch_stats", "opt_v") for k in keys) \
            and head == (1, 1, 112, 1001)
        restored, _ = ckpt.restore_checkpoint(workdir, state)
        readable = all(torch.equal(restored.params[k], v)
                       for k, v in state.params.items()) and all(
            torch.equal(restored.batch_stats[k], v)
            for k, v in state.batch_stats.items())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("joint: 1001 channels, b0 rsd=(2,), 224^2, batch 64 | store and "
        "datasets built in {:.2f} s | wall {:.2f} s | step seconds {} | "
        "steps/s over the last 6 steps {:.3f} | fused_light_augment launches "
        "{} (expect {}) | full_pass launches {} (expect 0) | params finite "
        "{} | sum |d params| {:.4g} | checkpoint {} keys, flax layout {}, "
        "reads back {} | peak memory {:.2f} GB".format(
            store_s, wall, ["{:.4f}".format(s) for s in step_s], last6,
            launches, JOINT_STEPS, meta_launches, finite, moved, len(keys),
            layout, readable, peak / 1e9))
    if not (launches == JOINT_STEPS and meta_launches == 0 and finite
            and moved > 0 and layout and readable):
        raise AssertionError("the joint path did not run as expected")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "mliis_tpu_torch", "csrc",
                                       "full_pass.cu")):
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from mliis_tpu_torch.device import resolve_device
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60
                          ).stdout.strip().splitlines()[0]
    log("card: " + card)
    phase_build()
    entry = phase_kernel(dev)
    light = phase_light_kernel(dev)
    phase_agree(dev)
    phase_agree_joint(dev)
    entry["launches"] = phase_slice(dev)
    light["launches"] = phase_joint(dev)
    for e in (entry, light):
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(e[key]):
                raise AssertionError("{} of {} is not finite".format(
                    key, e["name"]))
    log(json.dumps({"kernels": [entry, light]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
