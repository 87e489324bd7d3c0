#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, from the root of a
checkout: `python3 chip_smoke.py`.

It prints the card's name and power limit (nvidia-smi) first, then runs
its phases, one line each:
  1. build: compile mliis_tpu_torch/csrc/full_pass.cu for sm_90a.
  2. kernel: `full_pass` against `full_pass_reference` on the card at the
     main path's shapes (B=8, 5 x 224^2): fixed rows that run every op and
     every rotation mode, then rows drawn as the main path draws them.
     Tolerances: 1e-3 abs on samples without rotation; on rotated samples
     1e-2 abs on the image planes (0..255) and at most 1e-4 of the mask
     pixels flipped (fg/bg ties within float32 DFT rounding). Times both
     and computes the kernel's bound.
  3. agree: EfficientLab-b0's train-mode loss and gradients at a small
     input (4 x 64^2, float32, no dropout) on the card and on the CPU must
     agree: loss 1e-4 rel, each param's gradient within 1e-3 of the whole
     gradient's norm.
  4. slice: two chained FOMAML* meta-steps at bench.py's configuration
     (EfficientLab-b0 rsd=(2, 4), bf16, final dropout 0.5; synthetic store
     8 tasks x 10 images at 224^2; meta-batch 5 x 59 inner steps at batch
     8, 10 shots, tail 5; bce_dice + l2; SGD lr 5e-4; meta step 0.1; aug
     rate 0.5). The kernel must be launched exactly 2 x 5 x 58 = 580 times
     and the params must be finite and changed.
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
    path, seconds, out = ak.build_library(verbose=True)
    usage = [ln.strip() for ln in out.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build: {:.2f} s -> {} | {}".format(seconds, path, " ; ".join(usage)))


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
    seconds = []
    for _ in range(2):
        t0 = time.time()
        draws = lr.draw_meta_step(gen, counts, cfg, n_max=10)
        state = step(state, imgs, msks, draws, gen, 0.1, 5e-4)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = ak.full_pass.launches
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    moved = sum(float((state.params[k] - start[k]).abs().sum())
                for k in start)
    log("slice: meta-step seconds {} | full_pass launches {} (expect 580) "
        "| params finite {} | sum |d params| {:.4g} | peak memory {:.2f} GB"
        .format(["{:.3f}".format(s) for s in seconds], launches, finite,
                moved, torch.cuda.max_memory_allocated(dev) / 1e9))
    if launches != 2 * 5 * 58 or not finite or not moved > 0:
        raise AssertionError("the slice did not run as expected")
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
    phase_agree(dev)
    entry["launches"] = phase_slice(dev)
    for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
        if not math.isfinite(entry[key]):
            raise AssertionError("{} is not finite".format(key))
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
