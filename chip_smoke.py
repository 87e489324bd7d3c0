#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, from the root of a
checkout: `python3 chip_smoke.py`.

It prints the card's name and power limit (nvidia-smi) first, then runs
its phases, one line each (or a few):
  1. build: compile every mliis_tpu_torch/csrc/*.cu kernel for sm_90a, one
     `nvcc` per source, all started together.
  2. kernel: `full_pass` against `full_pass_reference` on the card at
     B=8: the meta path's 5 x 224^2, the JAX CLI's default 5 x 320^2, an
     odd 5 x 225^2 (padded lines and bins) and the largest plane the
     wrapper takes, 5 x 512^2: fixed rows that run every op and every
     rotation mode, then (but at 512^2) rows drawn as the meta path draws
     them. Tolerances: 1e-3 abs on samples without rotation; on rotated
     samples 1e-2 abs on the image planes (0..255) and at most 1e-4 of the
     mask pixels flipped (fg/bg ties within float32 DFT rounding). Times
     each size, computes the bounds and prints each size's cluster size
     and shared memory beside the kernel's registers and spills.
  3. kernel[cheap_pass]: `cheap_pass` against `cheap_pass_reference` at
     B=8, 5 x 224^2, a non-square 5 x 160 x 224, 5 x 320^2 and an odd
     5 x 161 x 225 (4-byte copies, scalar stores): fixed rows covering
     every op, both translate modes in both directions, an empty window, a
     rotation-only stage and the two windows around a rotation, then rows
     drawn as the split route draws them (both windows). Image planes
     1e-3 abs on 0..255, mask planes exact. Times each size and computes
     the bound; then rows too wide for shared memory (5 x 3 x 5000, the
     direct mode) are checked alone.
  4. kernel[light_augment]: `fused_light_augment` against
     `fused_light_augment_reference` at the joint path's shapes (B=64,
     224^2, prob_original 0, labels in 0..1000), with seeds that cover
     every op, prefix length and translate mode (the coverage is printed),
     and at an odd B=8, 225^2: labels exact, images 1e-3 abs on 0..255;
     prob_original 1 must be the identity. Times both sizes and computes
     the bound; then B=2, 4 x 6000 (the direct mode) is checked alone.
  A kernel's time is the device time of a launch, from a CUDA graph of
  many launches: `cold_ms` with a cold L2 (the launches rotate through
  copies of the input, at least 2 x 50 MB apart, and keep every output),
  `ms` with a warm one (the same input each launch; its eager, event-timed
  loop is printed beside it). The bound's share is taken from `cold_ms`;
  the row kernels' plan (grid, ring stages, copy mode, shared memory) is
  printed beside their registers and spills.
  5. agree: EfficientLab-b0's train-mode loss and gradients at a small
     input (4 x 64^2, float32, no dropout) on the card and on the CPU must
     agree: loss 1e-4 rel, each param's gradient within 1e-3 of the whole
     gradient's norm.
     agree[joint]: one augmented joint SGD step of EfficientLab-b0 with
     1001 channels (4 x 32^2, float32) on the card, through the
     `fused_light_augment` kernel, against the CPU's, through its plain
     version: loss 1e-4 rel, each param's update within 1e-3 of the whole
     update's norm.
  6. slice: two chained FOMAML* meta-steps at bench.py's configuration
     (EfficientLab-b0 rsd=(2, 4), bf16, final dropout 0.5; synthetic store
     8 tasks x 10 images at 224^2; meta-batch 5 x 59 inner steps at batch
     8, 10 shots, tail 5; bce_dice + l2; SGD lr 5e-4; meta step 0.1; aug
     rate 0.5). `full_pass` must be launched exactly 2 x 5 x 58 = 580 times
     and no other kernel, and the params must be finite and changed.
  7. eval: run.sh's evaluation protocol (`meta.evaluate.evaluate_gecko`)
     on the committed experiments/curve_v2_r4 checkpoint over its 12
     held-out synthetic tasks at 224^2, on the fused route and on the split
     route (`PALLAS_FUSED_SINGLE_LAUNCH = False`): exactly 12 x 59 = 708
     `full_pass` launches and no `cheap_pass` on the first, 2 x 708 = 1416
     `cheap_pass` launches and no `full_pass` on the second, and on each a
     mean IoU within 0.15 of the JAX package's (result.json), printed with
     its 95% CI and the wall seconds a task.
  8. joint: the joint CLI, `mliis_tpu_torch.cli.joint_train.main`, at full
     width: 1000 synthetic classes (1001 output channels, 750 train tasks
     x 10 images on the card), EfficientLab-b0 rsd=(2,) in float32, 224^2,
     batch 64, SGD + l2 + augmentation, 12 steps and 2 val batches.
     `fused_light_augment` must be launched exactly 12 times and no other
     kernel, the params must be finite and changed, and the checkpoint
     must be in flax layout and read back through `restore_checkpoint`.
     Prints the store's build seconds, steps/s over the last 6 steps and
     the peak memory.
  9. train: the meta-training CLI, `mliis_tpu_torch.cli.run_metasegnet.main`,
     with run.sh's flags (EfficientLab-b0 rsd=(2, 4) in float32, final
     dropout 0.5, 224^2, FOMAML* with 10 shots and a tail of 5, 59 inner
     steps at batch 8, bce_dice + l2, SGD lr 5e-4, aug rate 0.5,
     transductive, meta step 0.1 annealed to 1e-5) on 8 synthetic tasks
     (6 train, 2 test), 2 meta-iters, an interval evaluation at step 0
     and 1 eval sample: exactly 2 x 5 x 58 + 1 x (6 + 2) x 59 +
     1 x (1 + 2) x 59 = 1,229 `full_pass` launches (derived from the flags
     and printed) and no other kernel, finite and changed params, the grep
     line, meta-test_results.json, an ETA line a meta-step, and the newest
     checkpoint read back equal; then `--pretrained` eval-only from it
     (3 x 59 = 177 launches, the restored params equal the saved), the
     UHO branch (2 configs of 5 trace steps on 2 val tasks, then the
     evaluation at the estimated steps; its CSV) and the k-shot branch
     (k 1 and 5 at 5 steps on the 2 test tasks; k-shot-results.csv), each
     with its derived launch count. Prints each run's wall seconds and
     peak memory, the seconds a meta-step and phase_timings.jsonl.
  10. decoders: the `train` phase's synthetic store written as tfrecord
     shards and read back by `load_task_store` (prints whether
     native/libtfrecord_loader.so loaded and which reader ran); then the
     `train` run with `--spatial_pyramid_pooling --skip_decoding` cut to 1
     meta-iter: exactly 1 x 5 x 58 + 1 x (6 + 2) x 59 + 1 x (1 + 2) x 59
     = 939 `full_pass` launches and no other kernel, finite and changed
     params, the newest checkpoint holding the ASPP and skip-decoder keys
     and reading back equal, and the skip decoder's running stats
     unchanged by an eval-mode forward; then `--pretrained` eval-only
     (177 launches) writing the fine-tuned checkpoints of the train and
     the test evaluation (one a (task, sample), each read back and
     different from the meta-learned state) and the serving artifact
     (loaded with `torch.export.load`, the module's eval probabilities
     within 1e-5 at batch 1 and 5); then a run under `--profile_dir` on 2
     tasks (1 meta-iter of 1 task, 3 inner and 3 eval steps: 14
     launches) whose gzipped Chrome trace must parse and hold one
     `full_pass` kernel event a launch and the `meta_step`, `eval_train`
     and `eval_test` ranges. Prints each run's wall seconds, seconds a
     meta-step, peak memory and the trace's size.
Then the `kernels` JSON line (each kernel's launches on the path it
carries, and on every path; `ms`, `cold_ms` and `bound_share` at the main
path's size, every size's beside them), the card's name and power limit
again, and the result line. Any failed phase exits non-zero, as does a run without a
card or away from the checkout.
"""
import json
import math
import os
import re
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


KERNELS = ("full_pass", "cheap_pass", "fused_light_augment")


def reset_launches():
    """Every kernel wrapper's launch count set to 0."""
    from mliis_tpu_torch.ops import augment_kernels as ak
    for name in KERNELS:
        getattr(ak, name).launches = 0


def read_launches():
    """{kernel: launches since the last reset}."""
    from mliis_tpu_torch.ops import augment_kernels as ak
    return {name: getattr(ak, name).launches for name in KERNELS}


def graph_ms(fn, reps):
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph
    and its replay timed with events, so the host's cost of a launch (the
    wrapper's checks, ctypes) is left out."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: full_pass's cudaFuncSetAttribute is not a stream operation.
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return _replay_ms(graph, reps)


def _replay_ms(graph, reps):
    import torch
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


L2_BYTES = 50e6  # the H100's L2


def cold_graph_ms(fn, inputs, bytes_moved, reps=20):
    """Device ms per call of fn(*inputs) with a cold L2: as `graph_ms`, but
    the calls rotate through copies of the `inputs` tensors, enough that at
    least 2 x 50 MB (`bytes_moved` a call) pass between two uses of one
    copy, and every call's output is kept, so that each launch reads its
    input from device memory and writes fresh lines. Returns (ms, copies).
    """
    import torch
    copies = 1 + math.ceil(2 * L2_BYTES / bytes_moved)
    sets = [tuple(t.clone() for t in inputs) for _ in range(copies)]
    fn(*sets[0])
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            outs.append(fn(*sets[i % copies]))
    ms = _replay_ms(graph, reps)
    del graph, outs, sets
    torch.cuda.empty_cache()
    return ms, copies


def kernel_times(fn, inputs, bytes_moved, warm_reps):
    """{"ms": warm, "eager_ms", "cold_ms", "cold_copies"} of fn(*inputs)."""
    warm = lambda: fn(*inputs)  # noqa: E731
    cold, copies = cold_graph_ms(fn, inputs, bytes_moved)
    return {"ms": graph_ms(warm, warm_reps), "eager_ms": cuda_ms(warm, 20),
            "cold_ms": cold, "cold_copies": copies}


BUILD_USAGE = {}  # kernel source -> ptxas's registers and spills


def phase_build():
    from mliis_tpu_torch.ops import augment_kernels as ak
    t0 = time.time()
    built = ak.build_library(verbose=True)
    for name, (path, seconds, out) in built.items():
        usage = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        text = " ".join(usage)
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", text)
        BUILD_USAGE[name] = {
            "registers": max(map(int, regs)) if regs else None,
            "spill_bytes": max((int(a) + int(b) for a, b in spills),
                               default=None)}
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


def _times_text(t, bound_ms):
    return ("cold_ms {:.4f} ({} input copies; {:.1%} of the bound) warm_ms "
            "{:.4f} (eager {:.4f}) bound_ms {:.5f}".format(
                t["cold_ms"], t["cold_copies"], bound_ms / t["cold_ms"],
                t["ms"], t["eager_ms"], bound_ms))


def _bound(bytes_moved, ops, ops_per_s):
    """(bound ms, what binds) for the bytes at HBM3's rate and the
    operations at `ops_per_s`."""
    t_bytes, t_ops = bytes_moved / H100_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Operations of one noise value (a pixel and channel) of the augmentation
# kernels: Philox4x32-10 (10 rounds of 4 multiplies, 4 xors, 2 adds), two
# uniforms (3 each), Box-Muller (7), the scale, add and clip (4).
NOISE_OPS = 100 + 6 + 7 + 4
NOISE_OP = 3  # the noise op's index in the meta kernels' permutations


def _shear_line_ops(n):
    """Operations of one shear of one length-n line, the least the Fourier
    shift needs: a real-input FFT (2.5 n log2 n, half a complex one's
    5 n log2 n), the phase product on the n/2 + 1 bins of the half
    spectrum (6 each) and the inverse real FFT (2.5 n log2 n)."""
    return 5 * n * math.log2(n) + 6 * (n // 2 + 1)


def _full_pass_at(dev, size, b=8, c_tot=5, drawn=True):
    """`full_pass` against its plain version at B=8, 5 x size^2: fixed rows
    that run every op and every rotation mode, then (if `drawn`) rows
    drawn as the meta path draws them; the times and the bound of the
    last rows checked."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
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

    tag = "{0}x{0}".format(size)
    rotated = rotated_of(perm, num)
    err = _compare("fixed " + tag, ak.full_pass(seeds, x, perm, num, rot),
                   ak.full_pass_reference(seeds, x, perm, num, rot), rotated)
    if drawn:   # rows drawn as ops/augment.augment_batch draws them
        perm = torch.argsort(torch.rand(b, 6, generator=gen, device=dev),
                             1).to(torch.int32).contiguous()
        num = torch.randint(1, 7, (b,), generator=gen, **i32)
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen, **i32)
        rot = torch.stack([torch.randint(lo, hi, (b,), generator=gen, **i32)
                           for lo, hi in ((-45, 45), (0, 4), (0, 2),
                                          (0, 256))], 1).contiguous()
        rotated = rotated_of(perm, num)
        err = max(err, _compare(
            "drawn " + tag, ak.full_pass(seeds, x, perm, num, rot),
            ak.full_pass_reference(seeds, x, perm, num, rot), rotated))
    bytes_moved = 2 * x.numel() * 4 + 4 * (b + 6 * b + b + 4 * b)
    t = kernel_times(lambda xx: ak.full_pass(seeds, xx, perm, num, rot),
                     (x,), bytes_moved, 20)
    plain_ms = cuda_ms(lambda: ak.full_pass_reference(seeds, x, perm, num,
                                                      rot), 3)
    n_rot = int(rotated.sum())
    pos = torch.arange(6, device=dev)[None] < num[:, None]
    noised = int(((perm == NOISE_OP) & pos).any(1).sum())
    # Three shears of every line of every plane of a rotated sample, plus
    # the noise of the noised samples' image planes.
    ops = n_rot * 3 * c_tot * size * _shear_line_ops(size) \
        + noised * size * size * 3 * NOISE_OPS
    bound_ms, bound_by = _bound(bytes_moved, ops, H100_FP32_FLOP_PER_S)
    cs, group, smem = ak.full_pass_plan(size)
    usage = BUILD_USAGE.get("full_pass", {})
    log("kernel {}: {} plain_ms {:.4f} ({}; {} of {} samples rotated, {} "
        "noised; {:.4g} GFLOP as FFT shears and noise) | cluster {} blocks, "
        "{} lines a group, {} B shared memory a block, {} registers, {} B "
        "spilled".format(tag, _times_text(t, bound_ms), plain_ms, bound_by,
                         n_rot, b, noised, ops / 1e9, cs, group, smem,
                         usage.get("registers"), usage.get("spill_bytes")))
    return dict(t, max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / t["cold_ms"],
                cluster=cs, group=group, smem_bytes=smem)


FULL_PASS_SIZES = ((224, True), (320, True), (225, True), (512, False))


def phase_kernel(dev):
    """`full_pass` at the meta path's shape (B=8, 5 x 224^2), at the JAX
    CLI's default image size (5 x 320^2), at an odd 5 x 225^2 and at the
    largest plane the wrapper takes (5 x 512^2, fixed rows only), all held
    to the same bars; the entry's times are the meta path's, every size's
    beside them."""
    sizes = {"{0}x{0}".format(n): _full_pass_at(dev, n, drawn=drawn)
             for n, drawn in FULL_PASS_SIZES}
    entry = dict(sizes["224x224"])
    entry["max_abs_err"] = max(s["max_abs_err"] for s in sizes.values())
    return dict({"name": "full_pass", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/full_pass.cu",
                 "replaces": "mliis_tpu/ops/pallas_augment.py:610",
                 "library_ms": None, "sizes": sizes,
                 **BUILD_USAGE.get("full_pass", {})}, **entry)


def _seeds_by_translate_mode(dev):
    """{(vertical, roll): seed} for the four translate modes: seeds whose
    `cheap_pass` draws cover vertical and horizontal rolls and stripe
    fills (the draws that decide them do not depend on the plane size)."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    cand = torch.arange(1, 200, dtype=torch.int64, device=dev)[:, None]
    p = ak._draw_cheap_params(cand, ak.philox_words, 5, 224, 224, 23, 5.1,
                              12.75, 0.02, 0.1, 0.3, 1 / 0.3)
    found = {}
    for i in range(cand.shape[0]):
        mode = (bool(p["vert"][i]), bool(p["do_roll"][i]))
        found.setdefault(mode, int(cand[i, 0]))
    if len(found) < 4:
        raise AssertionError("no seeds cover every translate mode")
    return found


def _cheap_rows(dev, b):
    """Fixed `cheap_pass` rows: every op, both translate modes in both
    directions, an empty window, a rotation-only stage, and the two
    windows around a rotation."""
    import torch
    modes = _seeds_by_translate_mode(dev)
    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.tensor([[0, 1, 2, 3, 4, 5], [1, 0, 2, 3, 4, 5],
                         [1, 4, 3, 2, 0, 5], [4, 3, 2, 1, 0, 5],
                         [0, 1, 2, 3, 4, 5], [5, 0, 1, 2, 3, 4],
                         [2, 5, 3, 0, 1, 4], [2, 5, 3, 0, 1, 4]], **i32)
    num = torch.tensor([6, 1, 6, 5, 6, 1, 6, 6], **i32)
    window = torch.tensor([[0, 6], [0, 6], [0, 6], [0, 6], [3, 3], [0, 6],
                           [0, 1], [2, 6]], **i32)
    seeds = torch.tensor([modes[(True, True)], modes[(True, False)],
                          modes[(False, True)], modes[(False, False)],
                          11, 12, 13, 13], **i32)
    identity = torch.tensor([False] * 4 + [True, True, False, False],
                            device=dev)
    return seeds[:b], perm[:b], num[:b], window[:b], identity[:b]


def _random_planar(dev, b, h, w):
    """Random images (0..255) and a random one-hot mask, planar."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    img = torch.randint(0, 256, (b, 3, h, w), generator=gen,
                        device=dev).float()
    fg = (torch.rand(b, 1, h, w, generator=gen, device=dev) > 0.5).float()
    return torch.cat([img, 1.0 - fg, fg], 1).contiguous()


ROW_MODES = {0: "direct", 1: "cp.async", 2: "bulk"}


def _plan_text(plan):
    return ("{} blocks, {} stages, {} copies, {} B shared memory a "
            "block".format(plan.grid, plan.stages, ROW_MODES[plan.mode],
                           plan.smem))


def _sms(dev):
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _cheap_pass_at(dev, h, w, b=8, x=None):
    """`cheap_pass` against its plain version at B=8, 5 x h x w: the fixed
    rows, then rows drawn as the split route draws them (both windows);
    image planes 1e-3 abs on 0..255, mask planes exact. Returns the max
    error, the drawn rows, the batch and the launch's plan."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    if x is None:
        x = _planar_batch(dev, b, max(h, w))[:, :, :h, :w].contiguous()
    seeds, perm, num, window, identity = _cheap_rows(dev, b)
    checks = [(seeds, perm, num, window)]
    gen = torch.Generator(device=dev).manual_seed(17)
    i32 = dict(dtype=torch.int32, device=dev)
    perm_d = torch.argsort(torch.rand(b, 6, generator=gen, device=dev),
                           1).to(torch.int32).contiguous()
    num_d = torch.where(torch.rand(b, generator=gen, device=dev) <= 0.5, 0,
                        torch.randint(1, 7, (b,), generator=gen, **i32))
    seeds_d = torch.randint(0, 2 ** 31 - 1, (2, b), generator=gen, **i32)
    rot_pos = torch.argmax((perm_d == ak.ROTATE_OP).int(), 1).int()
    windows = (torch.stack([0 * rot_pos, rot_pos], 1),
               torch.stack([rot_pos + 1, 0 * rot_pos + 6], 1))
    checks += [(seeds_d[k], perm_d, num_d, windows[k]) for k in range(2)]
    err, exact = 0.0, True
    for i, args in enumerate(checks):
        out = ak.cheap_pass(args[0], x, *args[1:])
        ref = ak.cheap_pass_reference(args[0], x, *args[1:])
        err = max(err, float((out[:, :3] - ref[:, :3]).abs().max()))
        exact &= bool(torch.equal(out[:, 3:], ref[:, 3:]))
        exact &= bool(out.isfinite().all())
        if i == 0:
            exact &= bool(torch.equal(out[identity], x[identity]))
            changed = int((out != x).flatten(1).any(1).sum())
    plan = ak.cheap_pass_plan(b, x.shape[1], h, w, _sms(dev))
    log("kernel[cheap_pass] {}x{}: max abs image {:.3g} (<= 1e-3) | masks "
        "exact, identity rows unchanged {} | fixed rows changed {} of {} "
        "(expect 6) | {}".format(h, w, err, exact, changed, b,
                                 _plan_text(plan)))
    if not (err <= 1e-3 and exact and changed == 6):
        raise AssertionError("cheap_pass disagrees with its plain version")
    return err, (seeds_d[0], perm_d, num_d, windows[0]), x, plan


# The split route's 224^2, a non-square 160x224, the JAX CLI's 320^2 and an
# odd 161x225 (4-byte copies, scalar stores).
CHEAP_SIZES = ((224, 224), (160, 224), (320, 320), (161, 225))


def phase_cheap_kernel(dev):
    """`cheap_pass` at B=8 and 5 x CHEAP_SIZES; times the drawn rows' first
    pass at each size (cold and warm L2) and computes the bound; then rows
    too wide for shared memory (5 x 3 x 5000, no ring), checked only."""
    from mliis_tpu_torch.ops import augment_kernels as ak
    sizes = {}
    usage = BUILD_USAGE.get("cheap_pass", {})
    for h, w in CHEAP_SIZES:
        e, args, x, plan = _cheap_pass_at(dev, h, w)
        b = x.shape[0]
        applied = ak.cheap_applied(*args[1:])
        noised = int((applied & (args[1] == NOISE_OP)).any(1).sum())
        bytes_moved = 2 * x.numel() * 4 + 4 * (b + 6 * b + b + 2 * b)
        ops = noised * h * w * 3 * NOISE_OPS
        bound_ms, bound_by = _bound(bytes_moved, ops, H100_FP32_FLOP_PER_S)
        t = kernel_times(lambda xx: ak.cheap_pass(args[0], xx, *args[1:]),
                         (x,), bytes_moved, 50)
        plain_ms = cuda_ms(lambda: ak.cheap_pass_reference(
            args[0], x, *args[1:]), 3)
        log("kernel[cheap_pass] {}x{}: {} plain_ms {:.4f} ({}; {} of {} "
            "samples noised) | {} registers, {} B spilled".format(
                h, w, _times_text(t, bound_ms), plain_ms, bound_by, noised,
                b, usage.get("registers"), usage.get("spill_bytes")))
        sizes["{}x{}".format(h, w)] = dict(
            t, max_abs_err=e, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / t["cold_ms"],
            plan=plan._asdict())
    e, _, _, plan = _cheap_pass_at(dev, 3, 5000,
                                   x=_random_planar(dev, 8, 3, 5000))
    if plan.mode != ak.ROW_DIRECT:
        raise AssertionError("5 x 3 x 5000 should take the direct mode")
    entry = dict(sizes["224x224"])
    entry["max_abs_err"] = max([e] + [s["max_abs_err"]
                                      for s in sizes.values()])
    return dict({"name": "cheap_pass", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/cheap_pass.cu",
                 "replaces": "mliis_tpu/ops/pallas_augment.py:389",
                 "library_ms": None, "sizes": sizes, **usage}, **entry)


def _light_at(dev, b, h, w, cover):
    """`fused_light_augment` against its plain version at B x h x w
    (prob_original 0, labels in 0..1000; with `cover`, seeds that cover
    every op, prefix length and translate mode): labels exact, images 1e-3
    abs on 0..255, prob_original 1 the identity. Returns the max error,
    the inputs, the noised samples and the launch's plan."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    gen = torch.Generator(device=dev).manual_seed(11)
    images = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                           device=dev).float()
    masks = torch.randint(0, 1001, (b, h, w), generator=gen,
                          device=dev).float()
    seeds = torch.arange(1000, 1000 + b, dtype=torch.int32, device=dev)
    p = ak.draw_light_params(seeds)
    stage = torch.arange(4, device=dev)[None]
    applied = [((p["ops"] == op) & (stage < p["num"][:, None])).any(1)
               for op in range(4)]
    if cover:
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
    plan = ak.light_plan(b, h, w, _sms(dev))
    log("kernel[light_augment]: B={} {}x{} | max abs image {:.3g} (<= 1e-3) "
        "| labels exact {} | prob_original=1 identity {} | pixels changed "
        "{:.3f} | {}".format(b, h, w, err, labels_exact, identity, changed,
                             _plan_text(plan)))
    if not (err <= 1e-3 and labels_exact and identity
            and bool(out_i.isfinite().all())):
        raise AssertionError("fused_light_augment disagrees with its plain "
                             "version")
    return err, (seeds, images, masks), int(applied[ak.NOISE].sum()), plan


# The joint path's B=64 at 224^2, and an odd 225^2 at B=8 (4-byte copies,
# scalar stores).
LIGHT_SIZES = ((64, 224, True), (8, 225, False))


def phase_light_kernel(dev):
    """`fused_light_augment` at LIGHT_SIZES, timed (cold and warm L2)
    against the bound; then rows too wide for shared memory (B=2, 4 x 6000,
    no ring), checked only."""
    from mliis_tpu_torch.ops import augment_kernels as ak
    sizes = {}
    usage = BUILD_USAGE.get("light_augment", {})
    for b, size, cover in LIGHT_SIZES:
        err, (seeds, images, masks), noisy, plan = _light_at(
            dev, b, size, size, cover)
        bytes_moved = 2 * (images.numel() + masks.numel()) * 4 + 4 * b
        ops = noisy * size * size * 3 * NOISE_OPS
        bound_ms, bound_by = _bound(bytes_moved, ops, H100_FP32_FLOP_PER_S)
        t = kernel_times(lambda i, m: ak.fused_light_augment(seeds, i, m),
                         (images, masks), bytes_moved, 20)
        plain_ms = cuda_ms(lambda: ak.fused_light_augment_reference(
            seeds, images, masks), 3)
        log("kernel[light_augment] B={} {}^2: {} plain_ms {:.4f} ({}; {} of "
            "{} samples noised) | {} registers, {} B spilled".format(
                b, size, _times_text(t, bound_ms), plain_ms, bound_by, noisy,
                b, usage.get("registers"), usage.get("spill_bytes")))
        sizes["B{} {}x{}".format(b, size, size)] = dict(
            t, max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / t["cold_ms"],
            plan=plan._asdict())
    err, _, _, plan = _light_at(dev, 2, 4, 6000, False)
    if plan.mode != ak.ROW_DIRECT:
        raise AssertionError("B=2, 4 x 6000 should take the direct mode")
    entry = dict(sizes["B64 224x224"])
    entry["max_abs_err"] = max([err] + [s["max_abs_err"]
                                        for s in sizes.values()])
    return dict({"name": "fused_light_augment", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/light_augment.cu",
                 "replaces": "mliis_tpu/ops/pallas_augment.py:188",
                 "library_ms": None, "sizes": sizes, **usage}, **entry)


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
    reset_launches()
    seconds = []
    for _ in range(2):
        t0 = time.time()
        draws = lr.draw_meta_step(gen, counts, cfg, n_max=10)
        state = step(state, imgs, msks, draws, gen, 0.1, 5e-4)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = read_launches()
    expect = {"full_pass": 2 * 5 * 58, "cheap_pass": 0,
              "fused_light_augment": 0}
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    moved = sum(float((state.params[k] - start[k]).abs().sum())
                for k in start)
    log("slice: meta-step seconds {} | launches {} (expect {}) | params "
        "finite {} | sum |d params| {:.4g} | peak memory {:.2f} GB".format(
            ["{:.3f}".format(s) for s in seconds], launches, expect, finite,
            moved, torch.cuda.max_memory_allocated(dev) / 1e9))
    if launches != expect or not finite or not moved > 0:
        raise AssertionError("the slice did not run as expected")
    return launches


EVAL_CHECKPOINT = os.path.join("experiments", "curve_v2_r4",
                               "model.ckpt-3000.npz")
EVAL_TASKS, EVAL_STEPS = 12, 59
EVAL_IOU_BAR = 0.15


def phase_eval(dev):
    """run.sh's evaluation protocol on the committed checkpoint of
    experiments/curve_v2_r4 (EfficientLab-b0 rsd=(2, 4), bf16, final
    dropout 0.5, meta-trained 3000 steps at 224^2) over its 12 held-out
    tasks (triangle, ring, diamond; seed 777): 5 shots + 5 query, 59 SGD
    steps at batch 8, lr 5e-4, bce_dice + l2, aug rate 0.5, transductive,
    one sample; once on the fused route and once on the split route. Each
    route's mean IoU must lie within 0.15 of the JAX package's, and the
    kernels must be launched exactly once (fused) or twice (split) a step.
    Returns {"eval_fused": launches, "eval_split": launches}."""
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta import evaluate as ev
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment as taug
    from mliis_tpu_torch.ops.metrics import ci95
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "experiments", "curve_v2_r4",
                           "result.json")) as f:
        jax_iou = json.load(f)["final_mean_iou"]
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.load_state_dict(load_jax_npz(os.path.join(root, EVAL_CHECKPOINT)))
    t0 = time.time()
    store = make_synthetic_store(num_tasks=EVAL_TASKS, examples_per_task=10,
                                 image_size=224, seed=777,
                                 shapes=("triangle", "ring", "diamond"))
    store_s = time.time() - t0
    opt_cfg = il.OptimizerConfig("sgd")
    cfg = ev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=8,
                        inner_iters=EVAL_STEPS, transductive=True,
                        augment=True)
    evaluator = ev.GeckoEvaluator(model, il.LossConfig(dice=True, l2=True),
                                  opt_cfg, cfg, store, device=dev)
    state = il.init_model_state(model, opt_cfg)
    counts, failed = {}, []
    try:
        for route, fused in (("fused", True), ("split", False)):
            taug.PALLAS_FUSED_SINGLE_LAUNCH = fused
            gen = torch.Generator(device=dev).manual_seed(9000)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            mean_iou, task_map = ev.evaluate_gecko(
                evaluator, state, gen, 5e-4, num_samples=1,
                serially_eval_all_tasks=True, aug_rate=0.5,
                log_fn=lambda line: log("eval[{}]: {}".format(route, line)))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read_launches()
            counts["eval_" + route] = launches
            ious = [v[0] for v in task_map.values()]
            steps = EVAL_TASKS * EVAL_STEPS
            expect = {"full_pass": steps if fused else 0,
                      "cheap_pass": 0 if fused else 2 * steps,
                      "fused_light_augment": 0}
            log("eval[{}]: {} tasks | mean IoU {:.4f} +/- {:.4f} (95% CI; "
                "the JAX package's {:.4f}, bar {}) | wall {:.2f} s, {:.3f} s "
                "a task | launches {} (expect {}) | task IoUs {}".format(
                    route, len(ious), mean_iou, ci95(ious), jax_iou,
                    EVAL_IOU_BAR, wall, wall / EVAL_TASKS, launches, expect,
                    ["{:.3f}".format(v) for v in ious]))
            if launches != expect or not abs(mean_iou - jax_iou) \
                    <= EVAL_IOU_BAR:
                failed.append(route)
    finally:
        taug.PALLAS_FUSED_SINGLE_LAUNCH = True
    log("eval: held-out store built in {:.2f} s".format(store_s))
    if failed:
        raise AssertionError("the evaluation did not run as expected on "
                             "the {} route".format(" and ".join(failed)))
    return counts


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
    from mliis_tpu_torch.utils import checkpoint as ckpt
    workdir = tempfile.mkdtemp(prefix="joint_smoke_")
    try:
        tee = _Tee(sys.stdout)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            state = joint_train.main(JOINT_ARGV + ["--checkpoint", workdir],
                                     device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
        expect = {"full_pass": 0, "cheap_pass": 0,
                  "fused_light_augment": JOINT_STEPS}
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
        "steps/s over the last 6 steps {:.3f} | launches {} (expect {}) | "
        "params finite {} | sum |d params| {:.4g} | checkpoint {} keys, flax "
        "layout {}, reads back {} | peak memory {:.2f} GB".format(
            store_s, wall, ["{:.4f}".format(s) for s in step_s], last6,
            launches, expect, finite, moved, len(keys), layout, readable,
            peak / 1e9))
    if not (launches == expect and finite and moved > 0 and layout
            and readable):
        raise AssertionError("the joint path did not run as expected")
    return launches


# run.sh's flags (run.sh:9-21) without --fss_1000, --pretrained and
# --data-dir, cut to 8 synthetic tasks, 2 meta-iters and 1 eval sample.
TRAIN_ARGV = (
    "--image_size 224 --rsd 2 4 --l2 --foml --foml-tail 5 "
    "--final_layer_dropout_rate 0.5 --augment --aug_rate 0.5 --sgd "
    "--loss_name bce_dice --inner-batch 8 --learning-rate 0.0005 "
    "--train-shots 10 --inner-iters 59 --learning_rate_scheduler fixed "
    "--meta-batch 5 --serially_eval_all_test_tasks --shots 5 --eval-batch 8 "
    "--eval-iters 59 --transductive --model_name efficientlab "
    "--meta-step 0.1 --meta-step-final 0.00001 --chain_tasks "
    "--chain_eval_chunk --task_chunk_size 8 --synthetic --synthetic_tasks 8 "
    "--meta-iters 2 --eval-interval 2 --eval-samples 1 --seed 0").split()
UHO_ARGV = ("--pretrained --optimize_update_hyperparms_on_val_set "
            "--num_val_tasks 2 --num_configs_to_sample 2 --min_steps 1 "
            "--max_steps 5 --fss_1000").split()
KSHOT_ARGV = ("--pretrained --run_k_shot_learning_curves_experiment "
              "--k_shot_k_range 1 5 --eval-iters 5").split()


def _expected_train_launches(args, n_train, n_test):
    """`full_pass` launches of a training run of the CLI, from its flags:
    each meta-step task adapts inner_iters - 1 augmented steps (FOMAML*'s
    last step is the raw tail); an interval evaluation adapts every
    sampled train and test task (up to the loop's 100) for eval_iters
    steps; the final evaluation 1 train task and every test task, each
    eval_samples times. Returns (total, its terms as text)."""
    meta = args.meta_iters * args.meta_batch * (args.inner_iters - 1)
    intervals = len(range(0, args.meta_iters, args.eval_interval))
    interval = intervals * (min(100, n_train) + min(100, n_test)) \
        * args.eval_iters
    final = args.eval_samples * (1 + n_test) * args.eval_iters
    return meta + interval + final, (
        "{} x {} x {} + {} x ({} + {}) x {} + {} x (1 + {}) x {}".format(
            args.meta_iters, args.meta_batch, args.inner_iters - 1,
            intervals, min(100, n_train), min(100, n_test), args.eval_iters,
            args.eval_samples, n_test, args.eval_iters))


def _run_cli(argv, dev, cwd=None):
    """run_metasegnet.main on the card with the counts at 0 just before;
    returns (state, stdout, launches, wall seconds, peak bytes)."""
    import contextlib
    import torch
    from mliis_tpu_torch.cli import run_metasegnet
    tee = _Tee(sys.stdout)
    here = os.getcwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.time()
    try:
        if cwd is not None:
            os.chdir(cwd)
        with contextlib.redirect_stdout(tee):
            state = run_metasegnet.main(argv, device="cuda")
        torch.cuda.synchronize()
    finally:
        os.chdir(here)
    return (state, "".join(tee.parts), read_launches(), time.time() - t0,
            torch.cuda.max_memory_allocated(dev))


def phase_train(dev):
    """The meta-training CLI, `mliis_tpu_torch.cli.run_metasegnet.main`, at
    full width with run.sh's flags on 8 synthetic tasks (6 train, 2 test):
    2 meta-steps, an interval evaluation at step 0, checkpoints at steps 0
    and 1, the final evaluation; then --pretrained eval-only from its
    checkpoint, the UHO branch and the k-shot branch at a smaller depth.
    Each run's `full_pass` launches must equal the count derived from its
    flags (and, for UHO, the steps it printed); no other kernel runs.
    Returns {run: launches}."""
    import shutil
    import tempfile
    import torch
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils import checkpoint as ckpt
    workdir = tempfile.mkdtemp(prefix="train_smoke_")
    ckpt_dir = os.path.join(workdir, "ckpt")
    argv = TRAIN_ARGV + ["--checkpoint", ckpt_dir]
    args = args_lib.argument_parser().parse_args(argv)
    n_test = max(args.synthetic_tasks // 4, 1)
    counts, failed = {}, []

    def check(run, launches, full_pass, ok, text):
        expect = {"full_pass": full_pass, "cheap_pass": 0,
                  "fused_light_augment": 0}
        counts[run] = launches
        log("{}: {} | launches {} (expect {})".format(run, text, launches,
                                                      expect))
        if launches != expect or not ok:
            failed.append(run)

    try:
        state, out, launches, wall, peak = _run_cli(argv, dev)
        expect, terms = _expected_train_launches(
            args, args.synthetic_tasks - n_test, n_test)
        with open(os.path.join(ckpt_dir, "phase_timings.jsonl")) as f:
            timings = json.loads(f.readline())
        init = EfficientLab(**args_lib.model_kwargs(args))
        init.reset_parameters(torch.Generator().manual_seed(args.seed))
        start = dict(init.named_parameters())
        finite = all(bool(v.isfinite().all()) for v in state.params.values())
        moved = sum(float((v.cpu() - start[k].detach()).abs().sum())
                    for k, v in state.params.items())
        restored, meta = ckpt.restore_checkpoint(ckpt_dir, state)
        readable = meta.get("step") == args.meta_iters - 1 and all(
            torch.equal(restored.params[k], v)
            for k, v in state.params.items()) and all(
            torch.equal(restored.batch_stats[k], v)
            for k, v in state.batch_stats.items())
        grep = [ln for ln in out.splitlines()
                if ln.startswith("Mean IoU over all meta-test tasks:")]
        results = os.path.exists(os.path.join(ckpt_dir,
                                              "meta-test_results.json"))
        eta = out.count("Estimated training hours remaining:")
        log("train: phase_timings.jsonl {}".format(json.dumps(timings)))
        check("train", launches, expect,
              finite and moved > 0 and readable and len(grep) == 1
              and results and eta == args.meta_iters,
              "b0 rsd={} float32, {}^2, {} train + {} test tasks | wall "
              "{:.2f} s | {:.3f} s a meta-step (mean of {}) | interval "
              "evaluation {:.2f} s | {} | params finite {} | sum |d params| "
              "{:.4g} | newest checkpoint (step {}) reads back {} | "
              "results json {} | ETA lines {} | peak memory {:.2f} GB | "
              "expected launches {} = {}".format(
                  tuple(args.rsd), args.image_size,
                  args.synthetic_tasks - n_test, n_test,
                  wall, timings["meta_step"]["mean_s"],
                  timings["meta_step"]["count"],
                  timings["eval_train"]["total_s"]
                  + timings["eval_test"]["total_s"],
                  grep[0] if grep else "no grep line", finite, moved,
                  meta.get("step"), readable, results, eta, peak / 1e9,
                  expect, terms))

        restored, out, launches, wall, peak = _run_cli(
            argv + ["--pretrained"], dev)
        equal = all(torch.equal(restored.params[k], v)
                    for k, v in state.params.items())
        expect = args.eval_samples * (1 + n_test) * args.eval_iters
        check("train[eval-only]", launches, expect,
              equal and "Mean IoU over all meta-test tasks:" in out,
              "--pretrained | wall {:.2f} s | restored params equal the "
              "saved {} | peak memory {:.2f} GB".format(wall, equal,
                                                        peak / 1e9))

        uho_args = args_lib.argument_parser().parse_args(argv + UHO_ARGV)
        _, out, launches, wall, peak = _run_cli(argv + UHO_ARGV, dev)
        steps = int(re.search(r"UHO estimated lr=\S+ steps=(\d+)",
                              out).group(1))
        csv_path = os.path.join(
            ckpt_dir, "val-set_hyper_param_search_results_5-shot.csv")
        with open(csv_path) as f:
            rows = f.read().splitlines()
        n_val = uho_args.num_val_tasks
        splits = 1 if uho_args.fss_1000 else 4
        expect = (uho_args.num_configs_to_sample * splits * n_val
                  * uho_args.max_steps
                  + args.eval_samples * (1 + n_test) * steps)
        check("train[uho]", launches, expect,
              len(rows) == 1 + uho_args.num_configs_to_sample * splits
              * n_val,
              "wall {:.2f} s | estimated steps {} | {} CSV rows | expected "
              "{} x {} x {} x {} trace steps + {} x (1 + {}) x {} | peak "
              "memory {:.2f} GB".format(
                  wall, steps, len(rows) - 1, uho_args.num_configs_to_sample,
                  splits, n_val, uho_args.max_steps, args.eval_samples,
                  n_test, steps, peak / 1e9))

        kshot_args = args_lib.argument_parser().parse_args(argv + KSHOT_ARGV)
        _, out, launches, wall, peak = _run_cli(argv + KSHOT_ARGV, dev,
                                                cwd=workdir)
        # meta/kshot.py's k_eff for a synthetic task of 10 examples: 9
        # query images leave k_eff = 1, below early stopping's 10, so each
        # (task, k) adapts eval_iters steps.
        count = 10
        query = min(20, max(count - 1, 1))
        per_k = [min(k, max(count - query, 1))
                 for k in kshot_args.k_shot_k_range]
        expect = (args.eval_samples * n_test * len(per_k)
                  * kshot_args.eval_iters)
        with open(os.path.join(workdir, "k-shot-results.csv")) as f:
            rows = f.read().splitlines()
        check("train[k-shot]", launches, expect,
              all(k < 10 for k in per_k) and "early stopping" not in out
              and len(rows) == 1 + n_test * len(per_k),
              "wall {:.2f} s | k_eff {} | {} CSV rows | peak memory {:.2f} "
              "GB".format(wall, per_k, len(rows) - 1, peak / 1e9))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        raise AssertionError("the training CLI did not run as expected: "
                             "{}".format(", ".join(failed)))
    return counts


# The `train` phase's run with EfficientLab's ASPP and skip decoding, cut to
# 1 meta-iter; then a short run under the profiler on 2 tasks.
DECODER_ARGV = ["--spatial_pyramid_pooling", "--skip_decoding",
                "--meta-iters", "1"]
PROFILE_ARGV = ("--synthetic_tasks 2 --meta-iters 1 --meta-batch 1 "
                "--inner-iters 3 --eval-iters 3 --eval-samples 1").split()
DECODER_KEYS = ("params/spatial_pyramid_pooling/branch_0/kernel",
                "params/spatial_pyramid_pooling/fuse/kernel",
                "params/decode_skip_proj/kernel",
                "params/sep_conv_0/depthwise_conv/kernel",
                "params/sep_conv_1/pointwise_conv/kernel",
                "batch_stats/decode_skip_batch_normalization/mean",
                "batch_stats/sep_conv_1/batch_normalization_1/var")


def _tfrecord_reader(workdir, args):
    """The synthetic store written as tfrecord shards and read back by
    `load_task_store` (which prints the reader it used): whether the
    native library loaded, whether the arrays match, the store's names."""
    import numpy as np
    from mliis_tpu_torch.data import native_loader
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.data.task_store import load_task_store
    store = make_synthetic_store(num_tasks=args.synthetic_tasks,
                                 examples_per_task=10,
                                 image_size=args.image_size, seed=args.seed)
    shard_dir = os.path.join(workdir, "shards")
    os.makedirs(shard_dir)
    for i, name in enumerate(store.names):
        c = int(store.counts[i])
        native_loader.write_shard(
            os.path.join(shard_dir, name + ".tfrecord.gzip"),
            store.images[i, :c], store.masks[i, :c])
    loaded = load_task_store(shard_dir, image_size=args.image_size)
    order = [store.names.index(n) for n in loaded.names]
    same = (np.array_equal(loaded.images, store.images[order])
            and np.array_equal(loaded.masks, store.masks[order]))
    return native_loader.native_loader_available(), same, store.names


def phase_decoders(dev):
    """The meta-training CLI with `--spatial_pyramid_pooling
    --skip_decoding` at the `train` phase's width (run.sh's flags, 8
    synthetic tasks) cut to 1 meta-iter; then `--pretrained` eval-only from
    its checkpoint, writing the fine-tuned checkpoints of the train and
    the test evaluation and the serving artifact; then a short run under
    `--profile_dir`. Each run's `full_pass` launches must equal the count
    derived from its flags, with no other kernel; the checkpoints must
    hold the decoders' keys and read back; the skip decoder's running
    stats must not move in an eval-mode forward; the artifact must give
    the module's probabilities at batch 1 and 5; the trace must hold a
    `full_pass` kernel event per launch and the phases' ranges. Returns
    {run: launches}."""
    import glob
    import gzip
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.meta.inner_loop import load_state
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils import checkpoint as ckpt
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="decoders_smoke_")
    ckpt_dir = os.path.join(workdir, "ckpt")
    argv = TRAIN_ARGV + DECODER_ARGV + ["--checkpoint", ckpt_dir]
    args = args_lib.argument_parser().parse_args(argv)
    n_test = max(args.synthetic_tasks // 4, 1)
    counts, failed = {}, []

    def check(run, launches, full_pass, ok, text):
        expect = {"full_pass": full_pass, "cheap_pass": 0,
                  "fused_light_augment": 0}
        counts[run] = launches
        log("{}: {} | launches {} (expect {})".format(run, text, launches,
                                                      expect))
        if launches != expect or not ok:
            failed.append(run)

    try:
        native, same, names = _tfrecord_reader(workdir, args)
        log("decoders[data]: native/libtfrecord_loader.so loaded {} | "
            "load_task_store read the tfrecord shards with the {} reader | "
            "arrays equal the written store {}".format(
                native, "native" if native else "Python", same))
        if not same:
            failed.append("decoders[data]")

        state, out, launches, wall, peak = _run_cli(argv, dev)
        expect, terms = _expected_train_launches(
            args, args.synthetic_tasks - n_test, n_test)
        with open(os.path.join(ckpt_dir, "phase_timings.jsonl")) as f:
            timings = json.loads(f.readline())
        model = EfficientLab(**args_lib.model_kwargs(args))
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        finite = all(bool(v.isfinite().all()) for v in state.params.values())
        moved = sum(float((v.cpu() - start[k]).abs().sum())
                    for k, v in state.params.items())
        newest = ckpt.latest_checkpoint(ckpt_dir)
        with np.load(newest) as z:
            keys = all(k in z.files for k in DECODER_KEYS)
        restored, _ = ckpt.restore_checkpoint(newest, state)
        readable = all(torch.equal(restored.params[k], v)
                       for k, v in state.params.items()) and all(
            torch.equal(restored.batch_stats[k], v)
            for k, v in state.batch_stats.items())
        model.to(dev)
        load_state(model, state)
        before = {k: b.clone() for k, b in model.named_buffers()}
        x = torch.rand((4, args.image_size, args.image_size, 3),
                       generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev) * 255
        with torch.no_grad():
            model(x, train=False)
        still = all(torch.equal(b, before[k])
                    for k, b in model.named_buffers())
        check("decoders", launches, expect,
              finite and moved > 0 and keys and readable and still
              and "Mean IoU over all meta-test tasks:" in out,
              "b0 rsd={} ASPP + skip decoding float32, {}^2, {} params | "
              "wall {:.2f} s | {:.3f} s a meta-step | interval evaluation "
              "{:.2f} s ({} tasks) | params finite {} | sum |d params| "
              "{:.4g} | checkpoint holds the decoders' keys {} and reads "
              "back {} | skip-decoder stats unchanged by an eval forward "
              "{} | peak memory {:.2f} GB | expected launches {} = {}".format(
                  tuple(args.rsd), args.image_size,
                  sum(v.numel() for v in state.params.values()), wall,
                  timings["meta_step"]["mean_s"],
                  timings["eval_train"]["total_s"]
                  + timings["eval_test"]["total_s"], args.synthetic_tasks,
                  finite, moved, keys, readable, still, peak / 1e9, expect,
                  terms))

        ft_dir = os.path.join(workdir, "fine_tuned")
        artifact = os.path.join(workdir, "serving.pt2")
        _, out, launches, wall, peak = _run_cli(
            argv + ["--pretrained", "--save_fine_tuned_checkpoints",
                    "--save_fine_tuned_checkpoints_train",
                    "--save_fine_tuned_checkpoints_dir", ft_dir,
                    "--export_serving_artifact", artifact], dev)
        expect = args.eval_samples * (1 + n_test) * args.eval_iters
        found = sorted(glob.glob(os.path.join(
            ft_dir, "*", "*", "model.ckpt-{}.npz".format(args.eval_iters))))
        tasks = {os.path.basename(os.path.dirname(os.path.dirname(p)))
                 for p in found}
        fine_tuned = (len(found) == args.eval_samples * (1 + n_test)
                      and set(names[:n_test]) <= tasks)
        for path in found:
            tuned, meta = ckpt.restore_checkpoint(path, state)
            fine_tuned &= (meta.get("step") == args.eval_iters and any(
                not torch.equal(tuned.params[k], v)
                for k, v in state.params.items()))
        program = torch.export.load(artifact).module()
        served = {}
        for b in (1, 5):
            images = torch.rand(
                (b, args.image_size, args.image_size, 3),
                generator=torch.Generator(device=dev).manual_seed(b),
                device=dev) * 255
            with torch.no_grad():
                served[b] = float((program(images) - model(
                    images, train=False)[1]).abs().max())
        check("decoders[eval-only]", launches, expect,
              fine_tuned and max(served.values()) <= 1e-5,
              "--pretrained, fine-tuned checkpoints and the serving "
              "artifact | wall {:.2f} s | {} fine-tuned checkpoints for "
              "tasks {} read back and differ from the meta-learned state "
              "{} | artifact {:.1f} MB, max |probs - module's| at batch 1 "
              "{:.3g}, at batch 5 {:.3g} (1e-5) | peak memory {:.2f} "
              "GB".format(wall, len(found), sorted(tasks), fine_tuned,
                          os.path.getsize(artifact) / 1e6, served[1],
                          served[5], peak / 1e9))

        prof_dir = os.path.join(workdir, "profile")
        pargv = argv + PROFILE_ARGV + [
            "--checkpoint", os.path.join(workdir, "ckpt_profile"),
            "--profile_dir", prof_dir]
        pargs = args_lib.argument_parser().parse_args(pargv)
        p_test = max(pargs.synthetic_tasks // 4, 1)
        _, out, launches, wall, peak = _run_cli(pargv, dev)
        expect, terms = _expected_train_launches(
            pargs, pargs.synthetic_tasks - p_test, p_test)
        (trace,) = glob.glob(os.path.join(prof_dir, "*.pt.trace.json.gz"))
        with gzip.open(trace) as f:
            raw = f.read()
        events = json.loads(raw)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel"
                      and "full_pass_kernel" in e.get("name", ""))
        ranges = {e["name"] for e in events
                  if e.get("cat") == "user_annotation"}
        phases = {"meta_step", "eval_train", "eval_test"}
        check("decoders[profile]", launches, expect,
              kernels == launches["full_pass"] and phases <= ranges,
              "--profile_dir | wall {:.2f} s | trace {:.1f} MB gzipped "
              "({:.1f} MB of JSON), {} events, {} full_pass kernel events, "
              "ranges {} | peak memory {:.2f} GB | expected launches {} = "
              "{}".format(
                  wall, os.path.getsize(trace) / 1e6, len(raw) / 1e6,
                  len(events), kernels,
                  sorted(ranges & phases), peak / 1e9, expect, terms))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("decoders: the phase's wall {:.2f} s".format(time.time() - t0))
    if failed:
        raise AssertionError("the decoders' CLI runs did not run as "
                             "expected: {}".format(", ".join(failed)))
    return counts


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
    entries = [phase_kernel(dev), phase_cheap_kernel(dev),
               phase_light_kernel(dev)]
    phase_agree(dev)
    phase_agree_joint(dev)
    by_path = {"slice": phase_slice(dev)}
    by_path.update(phase_eval(dev))
    by_path["joint"] = phase_joint(dev)
    by_path.update(phase_train(dev))
    by_path.update(phase_decoders(dev))
    # Each kernel's `launches` is read from the path it carries: the
    # meta-step for full_pass, the split-route evaluation for cheap_pass,
    # the joint run for fused_light_augment; every path's counts beside.
    main_path = {"full_pass": "slice", "cheap_pass": "eval_split",
                 "fused_light_augment": "joint"}
    for e in entries:
        e["launches"] = by_path[main_path[e["name"]]][e["name"]]
        e["launches_by_path"] = {p: c[e["name"]] for p, c in by_path.items()}
        for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(e[key]):
                raise AssertionError("{} of {} is not finite".format(
                    key, e["name"]))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
