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
     them; then the batched meta-step's B=40 (5 tasks x 8) and the
     learning-evidence run's evaluation chunks' B=32 and 64 (4 and 8
     tasks x 8) at 224^2, the fixed rows repeated. Tolerances: 1e-3 abs
     on samples without rotation; on rotated samples 1e-2 abs on the
     image planes (0..255) and at most 1e-4 of the mask pixels flipped
     (fg/bg ties within float32 DFT rounding). Times
     each size, computes the bounds and prints each size's cluster size
     and shared memory beside the kernel's registers and spills.
  3. kernel[cheap_pass]: `cheap_pass` against `cheap_pass_reference` at
     B=8, 5 x 224^2, a non-square 5 x 160 x 224, 5 x 320^2 and an odd
     5 x 161 x 225 (4-byte copies, scalar stores): fixed rows covering
     every op, both translate modes in both directions, an empty window, a
     rotation-only stage and the two windows around a rotation, then rows
     drawn as the split route draws them (both windows); then a batched
     evaluation chunk's B=16 (2 tasks x 8) at 224^2. Image planes
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
  4b. kernel[resized_ce]: the joint loss head's forward and backward
     kernels against their plain version at the joint path's shape
     ([64, 1001, 56, 56] NCHW logits to 224^2) and at an odd 6 x 1001 x
     29 x 41 in channels-last to 113 x 167, label smoothing 0 and 0.1:
     loss 1e-6 rel, gradient within 1e-5 of its norm and in the logits'
     memory format, two runs bit-identical, exactly 2 launches a forward
     and backward. Times both launches together (cold and warm L2) and
     each alone, beside the bound (bytes at 3.35 TB/s, exponentials at
     H100_EXP2_PER_S), the plain version and `library_ms`, the
     F.interpolate + F.cross_entropy composition the kernels replaced.
  4c. kernel[batch_norm_act]: the model's batch norm and swish kernels
     (two launches each way) against float64 and against the composition
     they replaced (the layer's own, under autograd) at b3's largest and
     deepest batch-norm inputs, [64, 144, 150, 150] and [64, 816, 19, 19],
     and b0's largest, [64, 96, 112, 112], in NCHW and channels-last, with
     the swish after, before and beside none: y, dx, d_scale, d_bias and
     the running stats within BN_Y_BAR / BN_GRAD_BAR of float64, two runs
     bit-identical, exactly 4 launches a forward and backward. Then every
     batch norm's input of the b3 and b0 joint cells' training forward
     (shape, layout, swish) is timed, forward and backward, the kernels
     with a cold L2 and the composition eager, and summed over the layers
     as a step runs them, beside the bound (8 float32 passes over each
     input at 3.35 TB/s).
  4d. kernel[depthwise_conv]: the model's depthwise conv kernels (one
     launch each way, the SAME padding read in place) against the plain
     version in float64 on the card and against the library route they
     replaced (`F.pad` + `F.conv2d`, TF32 off) at every depthwise input of
     the b3 and b0 joint cells' models (b3: [64, 40 and 24, 150, 150] k 3,
     [64, 144, 150, 150] k 3 stride 2, ..., [64, 816, 19, 19] k 5) and at
     two small maps whose channels are no multiple of 8 and of 4: y, dx and
     dw within DW_Y_BAR / DW_DX_BAR / DW_W_BAR of float64, y and dx
     channels-last, two runs bit-identical, one launch each way. Then
     every depthwise input of both models is timed, forward and backward
     apart, with a cold L2, beside the bound (x read and y written; x and
     dy read and dx written) and the library's eager time, summed over the
     layers as a step runs them; then the host's microseconds a forward
     and backward of a small depthwise `Conv2d` on each route.
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
     update's norm; on the card exactly 1 `fused_light_augment` and 2
     `resized_ce` launches.
  6. slice: two chained FOMAML* meta-steps at bench.py's configuration
     (EfficientLab-b0 rsd=(2, 4), bf16, final dropout 0.5; synthetic store
     8 tasks x 10 images at 224^2; meta-batch 5 x 59 inner steps at batch
     8, 10 shots, tail 5; bce_dice + l2; SGD lr 5e-4; meta step 0.1; aug
     rate 0.5). `full_pass` must be launched exactly 2 x 5 x 58 = 580 times
     and no other kernel, and the params must be finite and changed.
  7. eval: run.sh's evaluation protocol (`meta.evaluate.evaluate_gecko`)
     on the committed experiments/curve_v2_r4 checkpoint over its 12
     held-out synthetic tasks at 224^2, on the fused route and on the split
     route (`PALLAS_FUSED_SINGLE_LAUNCH = False`), the tasks one after
     another (`chain_chunk`): exactly 12 x 59 = 708
     `full_pass` launches and no `cheap_pass` on the first, 2 x 708 = 1416
     `cheap_pass` launches and no `full_pass` on the second, and on each a
     mean IoU within 0.15 of the JAX package's (result.json), printed with
     its 95% CI and the wall seconds a task.
  8. joint: the joint CLI, `mliis_tpu_torch.cli.joint_train.main`, at full
     width: 1000 synthetic classes (1001 output channels, 750 train tasks
     x 10 images on the card), EfficientLab-b0 rsd=(2,) in float32, 224^2,
     batch 64, SGD + l2 + augmentation, 12 steps and 2 val batches.
     `fused_light_augment` must be launched exactly 12 times, `resized_ce`
     24 (a forward and a backward a step), `batch_norm_act` 4 a batch norm
     a step, `depthwise_conv` 11 a step and a validation forward and
     `depthwise_conv_grad` 11 a step, and no other kernel, the params
     must be finite and changed, and the checkpoint
     must be in flax layout and read back through `restore_checkpoint`.
     Prints the store's build seconds, steps/s over the last 6 steps and
     the peak memory.
  9. train: the meta-training CLI, `mliis_tpu_torch.cli.run_metasegnet.main`,
     with run.sh's flags (EfficientLab-b0 rsd=(2, 4) in float32, final
     dropout 0.5, 224^2, FOMAML* with 10 shots and a tail of 5, 59 inner
     steps at batch 8, bce_dice + l2, SGD lr 5e-4, aug rate 0.5,
     transductive, meta step 0.1 annealed to 1e-5) on 8 synthetic tasks
     (6 train, 2 test), 2 meta-iters, an interval evaluation at step 0,
     1 eval sample and 10 evaluation steps a task (run.sh: 59): exactly
     2 x 5 x 58 + 1 x (6 + 2) x 10 + 1 x (1 + 2) x 10 = 690 `full_pass`
     launches (derived from the flags and printed) and no other kernel,
     finite and changed params, the grep line, meta-test_results.json, an
     ETA line a meta-step, and the newest checkpoint read back equal; then
     `--pretrained` eval-only from it (3 x 10 = 30 launches, the restored
     params equal the saved), the
     UHO branch (2 configs of 5 trace steps on 2 val tasks, then the
     evaluation at the estimated steps; its CSV) and the k-shot branch
     (k 1 and 5 at 5 steps on the 2 test tasks; k-shot-results.csv), each
     with its derived launch count. Prints each run's wall seconds and
     peak memory, the seconds a meta-step and phase_timings.jsonl.
  10. decoders: the `train` phase's synthetic store written as tfrecord
     shards and read back by `load_task_store` (prints whether
     native/libtfrecord_loader.so loaded and which reader ran); then the
     `train` run with `--spatial_pyramid_pooling --skip_decoding` cut to 1
     meta-iter: exactly 1 x 5 x 58 + 1 x (6 + 2) x 10 + 1 x (1 + 2) x 10
     = 400 `full_pass` launches and no other kernel, finite and changed
     params, the newest checkpoint holding the ASPP and skip-decoder keys
     and reading back equal, and the skip decoder's running stats
     unchanged by an eval-mode forward; then `--pretrained` eval-only
     (30 launches) writing the fine-tuned checkpoints of the train and
     the test evaluation (one a (task, sample), each read back and
     different from the meta-learned state) and the serving artifact
     (loaded with `torch.export.load`, the module's eval probabilities
     within 1e-5 at batch 1 and 5 on the batch norms' composition, the
     route a trace takes, and within SPATIAL_PROB_BAR of the module's
     kernels); then a run under `--profile_dir` on 2
     tasks (1 meta-iter of 1 task, 3 inner and 3 eval steps: 14
     launches) whose gzipped Chrome trace must parse and hold one
     `full_pass` kernel event a launch and the `meta_step`, `eval_train`
     and `eval_test` ranges. Prints each run's wall seconds, seconds a
     meta-step, peak memory and the trace's size.
  11. mesh: the sharded strategies (mliis_tpu_torch/parallel/mesh.py) at
     the `train` phase's width. A world of 1 on NCCL: the meta-training
     CLI with `--mesh_tasks 1` (the `train` run cut to 1 meta-iter and 10
     evaluation steps a task: 1 x 5 x 58 + 1 x (6 + 2) x 10 + 1 x (1 + 2)
     x 10 = 400 `full_pass` launches), then one library FOMAML* meta-step
     of 10 inner steps a task unsharded and one through
     `make_sharded_train_step` (its slots chained) on a task mesh of 1
     from the same state and draw seed (dropout and drop-connect 0),
     then 2 unsharded joint steps at 1001 channels and batch 64 (the store
     cut to 1 image a class). A world of 2 on the one card over gloo
     (`python -m torch.distributed.run --standalone --nproc_per_node 2
     chip_smoke.py --mesh-rank DIR`): the CLI with `--mesh_tasks 2`, a
     1x2 (task, data) meta-step with the sync-BN model and 2 data-parallel
     joint steps at 32 a rank; the 1x2 step runs twice, its rank's 5
     slots on a task axis beside the data axis (the default) and chained
     (`chain_local`). Every sharded state is held against its
     unsharded one (largest gap within MESH_*_BAR of the largest change),
     the 1x2 step on the task axis against the chained one within
     MESH_BATCHED_BAR of the chained step's largest change,
     the CLIs' mean IoUs within MESH_IOU_BAR, the backends must be NCCL
     and gloo, and the launches are exact, summed over the ranks: 400 for
     either CLI, 9 a rank on the 1x2 step on the task axis and 5 x 9 =
     45 chained, 1
     `fused_light_augment` and 2 `resized_ce` a rank a joint step. Prints each run's seconds (a
     meta-step, a joint step), each rank's peak memory and the gaps.
  12. spatial: the image H axis split over ranks
     (mliis_tpu_torch/parallel/spatial.py) at full width: EfficientLab-b0
     rsd=(2, 4) in float32 (dropout 0.5, drop-connect 0.2), 8 synthetic
     images at 1024^2, weights from seed 0. A world of 1 (no mesh): the
     eval forward, one loss-and-grad SGD step (bce_dice + l2, lr 5e-4),
     and the eval forward of the same model with ASPP and skip decoding
     (and once more on the batch reversed, to show how far the order of
     float32 sums alone moves the skip decoder's batch moments). Each
     run is timed after an untimed warm-up run.
     A world of 2 on the one card over gloo (`python -m
     torch.distributed.run --standalone --nproc_per_node 2 chip_smoke.py
     --spatial-rank DIR`): the same three runs on H shards
     (`make_spatial_forward`; `make_loss_and_grad` under `spatial.bound`),
     the probabilities gathered. Held: probabilities within
     SPATIAL_PROB_BAR abs; the step's params and running stats within
     SPATIAL_STATE_BAR of the step's largest change, its loss within
     SPATIAL_STATE_BAR relative; no kernel launched. Prints each run's
     wall, each rank's peak memory beside the unsharded peak, the
     all-reduces of each run (count, bytes, host seconds inside them) and
     the gaps.
  13. batched (between `train` and `decoders`): the task axis, each run
     beside its chained run in this call. The `slice` phase's two bf16
     meta-steps again through `learners.make_train_step` from the same
     state and draw seeds (2 x 58 = 116 `full_pass` launches at B=40; the
     states within 0.1 of the largest change of the slice's); one float32
     meta-step cut to 6 inner steps, chained and batched from one state
     and draw (within 1e-5, the CPU test's bound); the `eval` phase's
     evaluation in chunks of 2 on both routes from the same seed (354
     `full_pass` launches at B=16, or 708 `cheap_pass`; the mean IoU
     within 0.02 of the chained run's, where bf16 amplifies the two
     strategies' rounding, and 0.15 of the JAX package's); the same
     checkpoint in float32 cut to 10 steps, evaluated chained and batched
     on both routes (the mean IoUs within 0.005); and the `train` run's
     CLI with no strategy flag, 1 meta-iter (118
     launches, derived from the flags). Prints the seconds and peak
     memory of each beside the chained run's.
  14. traces (between `batched` and `decoders`): the early-stopping
     traces on a task axis (`early_stopping.
     make_batched_early_stopping_trace_fn`), each run beside its chained
     run. (a) UHO through the CLI at full width (the `train` run's model
     and adaptation flags in float32, from the committed checkpoint's
     weights; 4 synthetic val tasks, 1 GP config, the CLI's --max_steps 80
     and --min_steps 0), with no strategy flag and --task_chunk_size 4,
     then with --chain_eval_chunk: exact launches, derived from the flags
     and the steps chosen, the seconds a traced task, the median best
     step, the mean best IoU and the peak memory. (b)
     `EarlyStoppingEvaluator` in float32 on the `eval` phase's 12
     held-out tasks, 10 steps, in chunks of 4 and chained, with
     deterministic algorithms: every trace entry within TRACES_BAR. (c)
     the UHO and k-shot branches with --mesh_tasks 2 in a world of 2 on
     the one card over gloo (`python -m torch.distributed.run --standalone
     --nproc_per_node 2 chip_smoke.py --traces-rank DIR`), 2 val tasks of
     5 steps: both ranks' (steps, IoU) lists and k-shot mIoUs equal,
     launches exact summed over the ranks.
  15. curve (after `traces`): experiments/torch_curve_v2.py, the
     learning-evidence run, in a process of its own (`chip_smoke.py
     --curve-run DIR`) at full width (EfficientLab-b0 rsd=(2, 4) in bf16,
     224^2, 59 inner steps, meta-batch 5, the meta-step on a task axis,
     the evaluation in chunks of 8) on 16 train tasks, cut to 2
     meta-iterations, an evaluation point after each, 1 evaluation sample
     and 4 held-out tasks: exactly 2 x 1 x 58 + 4 x 1 x 1 x 59 = 352
     `full_pass` launches (derived from the flags) and no other kernel;
     result.json with the JAX script's keys plus `device`, curve.json's
     entries [0, mean] then [iter, mean, diff, ci]; a baseline mean IoU
     below CURVE_BASELINE_BAR; the checkpoint's params finite and changed.
     Prints the seconds a meta-iteration and an evaluation point take.
Every float32 path on the card runs the model's batch norms through
`batch_norm_act` where they take the batch's moments: each training step
4 launches a layer, an eval-mode forward 2 a layer of the skip decoder's
(which normalize by the batch in every mode), nothing where the running
moments are taken, in bf16, under sync-BN or a spatial context. Every
phase's launch counts include them, derived the same way. Every float32
path runs a depthwise conv whose input is a channels-last map through
`depthwise_conv` (the backbone's, wherever its input is NHWC in memory,
as the joint path's and the evaluations' are; an augmented meta step's
images are planar, so its backbone runs NCHW on cuDNN): `read_launches`
holds its forward and backward launches, in every phase, to one a
depthwise conv of each backbone and skip-decoder unit that ran on that
route and one more of each that kept its graph, counted as the model runs;
the `joint` phase derives them from its flags besides (11 forward
launches a step and a validation chunk, 11 backward a step); none in
bf16 or under a spatial context.
Then the `kernels` JSON line (each kernel's launches on the path it
carries, and on every path; `ms`, `cold_ms` and `bound_share` at the main
path's size, every size's beside them), the card's name and power limit
again, and the result line. Any failed phase exits non-zero, as does a run without a
card or away from the checkout. After each phase, whatever process it left
below the script (the script is their subreaper, so orphans count) is
named on a `processes:` line and stopped, so that none outlives the run.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12  # FP32 outside the tensor cores
# ex2.approx results a second: 16 a clock on each of the 132 SMs at the
# H100 SXM's 1.98 GHz boost clock.
H100_EXP2_PER_S = 16 * 132 * 1.98e9


def log(*args):
    print(*args, flush=True)


# Processes below the script before its first phase (a `tee` of a shell's
# process substitution is one): `stop_descendants` leaves them be.
_KEPT = set()


def _become_subreaper():
    """Linux's PR_SET_CHILD_SUBREAPER: a process that a child of ours
    leaves behind (an orphan of torch.distributed.run's workers, which run
    in sessions of their own, or of the `curve` run) becomes our child
    instead of init's, so that `stop_descendants` finds it. What is below
    the script already is kept out of the sweeps."""
    import ctypes
    _KEPT.update(pid for pid, _, _ in _descendants())
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (AttributeError, OSError):
        pass


def _descendants():
    """[(pid, state, command line)] of every process below this one, read
    from /proc, but those in _KEPT and below them."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open("/proc/{}/stat".format(entry)) as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open("/proc/{}/cmdline".format(entry), "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        children.setdefault(int(fields[1]), []).append(
            (int(entry), fields[0], cmd.strip()[:200]))
    out, todo = [], [os.getpid()]
    while todo:
        for proc in children.get(todo.pop(), ()):
            if proc[0] not in _KEPT:
                out.append(proc)
                todo.append(proc[0])
    return out


def _reap():
    """Collects the exit status of every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_descendants(where, grace=10.0):
    """Stops every process below this one that is still there after
    `where`: names each, sends SIGTERM, SIGKILL to those left after `grace`
    seconds, and reaps them. Returns how many there were."""
    import signal
    left = _descendants()
    for pid, state, cmd in left:
        log("processes: after {} pid {} ({}) was left: {}".format(
            where, pid, state, cmd))
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.time() + grace
    while left and time.time() < deadline:
        _reap()
        if not [p for p in _descendants() if p[1] != "Z"]:
            break
        time.sleep(0.1)
    for pid, _, _ in _descendants():
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    _reap()
    while [p for p in _descendants() if p[1] != "Z"]:
        time.sleep(0.1)
        _reap()
    _reap()
    return len(left)


@contextlib.contextmanager
def deterministic_algorithms(record):
    """PyTorch's and cuDNN's deterministic algorithms for the block, so
    that an evaluation repeats bit for bit (cuBLAS's take
    CUBLAS_WORKSPACE_CONFIG, which `main` sets). Without them two runs of
    the `eval` phase's evaluation differ by up to 0.0038 in mean IoU
    (experiments/torch_batched_eval_iou.py, PERF.md), so the `batched`
    phase's gaps between its strategies would move from call to call. An
    op that has no deterministic form warns; its warning is appended to
    `record`."""
    import torch
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        record.extend(sorted({str(w.message)[:160] for w in caught}))
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]


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


# The kernel wrappers' names in `kernel_library.launches`, every one
# counted and checked.
KERNELS = ("full_pass", "cheap_pass", "fused_light_augment", "resized_ce",
           "batch_norm_act")
# The depthwise conv's forward and backward launches, held by
# `read_launches` to the depthwise convs the model ran (`_DW_SEEN`).
DW_KERNELS = ("depthwise_conv", "depthwise_conv_grad")
# Depthwise convs since the last reset, counted as the model runs them
# (`_watch_depthwise`): "forward", of every backbone (its MBConv blocks')
# and skip-decoder unit (`_SepConv`, one) whose input is a float32
# channels-last map on the card, with no spatial context and not traced;
# "backward", of those that keep the autograd graph.
_DW_SEEN = {"forward": 0, "backward": 0}


def _watch_depthwise():
    """`EfficientNetFeatures.forward` and `_SepConv.forward` wrapped once
    to count into _DW_SEEN the depthwise convs that `layers.Conv2d` sends
    to `depthwise_conv` (a float32 channels-last CUDA map, which the
    backbone's convs and batch norms keep from its input on)."""
    import functools
    import torch
    from mliis_tpu_torch.models.efficientlab import _SepConv
    from mliis_tpu_torch.models.efficientnet import EfficientNetFeatures
    from mliis_tpu_torch.ops import kernel_library
    from mliis_tpu_torch.parallel import spatial

    def watch(owner, convs):
        forward = owner.forward
        if getattr(forward, "watched", False):
            return

        @functools.wraps(forward)
        def watched(self, x, *args, **kwargs):
            if (x.is_cuda and x.dtype == torch.float32
                    and kernel_library.channels_last(x)
                    and spatial.current() is None
                    and not torch.compiler.is_compiling()):
                n = convs(self)
                _DW_SEEN["forward"] += n
                if torch.is_grad_enabled():
                    _DW_SEEN["backward"] += n
            return forward(self, x, *args, **kwargs)

        watched.watched = True
        owner.forward = watched

    watch(EfficientNetFeatures, dw_layers)
    watch(_SepConv, lambda m: 1)


def reset_launches():
    """Every kernel wrapper's launch count and _DW_SEEN set to 0."""
    from mliis_tpu_torch.ops import kernel_library
    _watch_depthwise()
    kernel_library.launches.clear()
    _DW_SEEN.update(forward=0, backward=0)


def read_dw_launches():
    """{depthwise_conv, depthwise_conv_grad: launches since the last
    reset}."""
    from mliis_tpu_torch.ops import kernel_library
    return {name: kernel_library.launches[name] for name in DW_KERNELS}


def read_launches():
    """{kernel: launches since the last reset}, for every one of KERNELS;
    a launch counted under another name raises, and so do depthwise conv
    launches other than one a depthwise conv of each backbone and skip
    decoder unit that ran on the route (`_DW_SEEN`), and one more a conv
    of each of those that kept its graph (its backward)."""
    from mliis_tpu_torch.ops import kernel_library
    unknown = set(kernel_library.launches) - set(KERNELS) - set(DW_KERNELS)
    if unknown:
        raise AssertionError("launches of kernels not in KERNELS: {}".format(
            sorted(unknown)))
    dw = read_dw_launches()
    seen = {"depthwise_conv": _DW_SEEN["forward"],
            "depthwise_conv_grad": _DW_SEEN["backward"]}
    if dw != seen:
        raise AssertionError("depthwise conv launches {} against the "
                             "depthwise convs run {}".format(dw, seen))
    return {name: kernel_library.launches[name] for name in KERNELS}


def expected(**counts):
    """{kernel: launches}: `counts`, and 0 for every other kernel."""
    return dict({name: 0 for name in KERNELS}, **counts)


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
    from mliis_tpu_torch.ops import kernel_library
    t0 = time.time()
    built = kernel_library.build(verbose=True)
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


def _tile_rows(b, *rows):
    """Each of `rows` (8 fixed rows, batch dim first) repeated to b rows."""
    return [r.repeat((-(-b // r.shape[0]),) + (1,) * (r.ndim - 1))[:b]
            .contiguous() for r in rows]


def _size_tag(b, h, w):
    """'224x224' at B=8, the paths' one-task batch; 'B40 224x224' else."""
    tag = "{}x{}".format(h, w)
    return tag if b == 8 else "B{} {}".format(b, tag)


def _full_pass_at(dev, size, b=8, c_tot=5, drawn=True):
    """`full_pass` against its plain version at B x 5 x size^2: fixed rows
    that run every op and every rotation mode (8 of them, repeated to B),
    then (if `drawn`) rows drawn as the meta path draws them; the times
    and the bound of the last rows checked."""
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
    perm, num, rot = _tile_rows(b, perm, num, rot)
    seeds = torch.arange(101, 101 + b, **i32)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rotated_of(perm, num):
        pos = torch.arange(6, device=dev)[None] < num[:, None]
        return ((perm == ak.ROTATE_OP) & pos).any(1)

    tag = _size_tag(b, size, size)
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


# (size, drawn rows, B): the chained paths' B=8 at 224^2, the JAX CLI's
# 320^2, an odd 225^2, the largest plane (512^2), the task axis's B=40
# (5 tasks x 8) at 224^2, and the learning-evidence run's evaluation
# chunks, B=32 and 64 (4 and 8 held-out tasks x 8).
FULL_PASS_SIZES = ((224, True, 8), (320, True, 8), (225, True, 8),
                   (512, False, 8), (224, True, 40), (224, True, 32),
                   (224, True, 64))


def phase_kernel(dev):
    """`full_pass` at the chained meta path's shape (B=8, 5 x 224^2), at
    the JAX CLI's default image size (5 x 320^2), at an odd 5 x 225^2, at
    the largest plane the wrapper takes (5 x 512^2, fixed rows only), at
    the batched meta-step's B=40 and at the learning-evidence run's
    evaluation chunks' B=32 and 64, all held to the same bars; the
    entry's times are the chained meta path's, every size's beside
    them."""
    sizes = {_size_tag(b, n, n): _full_pass_at(dev, n, b=b, drawn=drawn)
             for n, drawn, b in FULL_PASS_SIZES}
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
    return _tile_rows(b, seeds, perm, num, window, identity)


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


def _cheap_pass_at(dev, h, w, b=8, x=None):
    """`cheap_pass` against its plain version at B x 5 x h x w: the fixed
    rows (8, repeated to B), then rows drawn as the split route draws them
    (both windows); image planes 1e-3 abs on 0..255, mask planes exact.
    Returns the max error, the drawn rows, the batch and the launch's
    plan."""
    import torch
    from mliis_tpu_torch.ops import augment_kernels as ak
    from mliis_tpu_torch.ops import kernel_library
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
    plan = ak.cheap_pass_plan(b, x.shape[1], h, w,
                              kernel_library.sm_count(x.device.index))
    moving = int((~identity).sum())
    log("kernel[cheap_pass] {}: max abs image {:.3g} (<= 1e-3) | masks "
        "exact, identity rows unchanged {} | fixed rows changed {} of {} "
        "(expect {}) | {}".format(_size_tag(b, h, w), err, exact, changed, b,
                                  moving, _plan_text(plan)))
    if not (err <= 1e-3 and exact and changed == moving):
        raise AssertionError("cheap_pass disagrees with its plain version")
    return err, (seeds_d[0], perm_d, num_d, windows[0]), x, plan


# (H, W, B): the split route's 224^2, a non-square 160x224, the JAX CLI's
# 320^2 and an odd 161x225 (4-byte copies, scalar stores) at B=8, and a
# batched evaluation chunk's B=16 (2 tasks x 8) at 224^2.
CHEAP_SIZES = ((224, 224, 8), (160, 224, 8), (320, 320, 8), (161, 225, 8),
               (224, 224, 16))


def phase_cheap_kernel(dev):
    """`cheap_pass` at 5 x CHEAP_SIZES; times the drawn rows' first pass at
    each size (cold and warm L2) and computes the bound; then rows too
    wide for shared memory (5 x 3 x 5000, no ring), checked only."""
    from mliis_tpu_torch.ops import augment_kernels as ak
    sizes = {}
    usage = BUILD_USAGE.get("cheap_pass", {})
    for h, w, b in CHEAP_SIZES:
        e, args, x, plan = _cheap_pass_at(dev, h, w, b)
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
        log("kernel[cheap_pass] {}: {} plain_ms {:.4f} ({}; {} of {} "
            "samples noised) | {} registers, {} B spilled".format(
                _size_tag(b, h, w), _times_text(t, bound_ms), plain_ms,
                bound_by, noised, b, usage.get("registers"),
                usage.get("spill_bytes")))
        sizes[_size_tag(b, h, w)] = dict(
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
    from mliis_tpu_torch.ops import kernel_library
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
    plan = ak.light_plan(b, h, w,
                         kernel_library.sm_count(images.device.index))
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


# The joint path's loss head at the cell's shape ([64, 1001, 56, 56] to
# 224^2, NCHW as the model hands it over), and at an odd shape in
# channels-last.
HEAD_SIZES = ((64, 1001, 56, 56, 224, 224, False),
              (6, 1001, 29, 41, 113, 167, True))


def _head_composition(low, labels, eps, chunk):
    """The head `resized_ce` replaced: F.interpolate and F.cross_entropy a
    batch chunk at a time (the yardstick `library_ms` times)."""
    import torch.nn.functional as F
    n, (out_h, out_w) = low.shape[0], labels.shape[1:]
    total = 0.0
    for i in range(0, n, chunk):
        logits = F.interpolate(low[i:i + chunk], size=(out_h, out_w),
                               mode="bilinear", align_corners=True)
        total = total + F.cross_entropy(logits, labels[i:i + chunk].long(),
                                        label_smoothing=eps, reduction="sum")
    return total / (n * out_h * out_w)


def _head_at(dev, n, c, h, w, out_h, out_w, channels_last):
    """`resized_ce`'s kernels against its plain version at one shape, label
    smoothing 0 and 0.1: loss within 1e-6 rel, gradient within 1e-5 of its
    norm and in the logits' memory format, two runs bit-identical, exactly
    2 launches a forward and backward. Returns (the worst gradient gap
    relative to its norm, the largest absolute gradient error, the inputs,
    the chunk of the plain version)."""
    import torch
    from mliis_tpu_torch.joint.trainer import _chunk
    from mliis_tpu_torch.ops import resized_ce as rce
    gen = torch.Generator(device=dev).manual_seed(21)
    low = torch.randn(n, c, h, w, generator=gen, device=dev) * 3
    if channels_last:
        low = low.contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, c, (n, out_h, out_w), generator=gen,
                           device=dev).float()
    chunk = _chunk(n, c, out_h, out_w)
    one = torch.ones((), device=dev)
    worst = worst_abs = 0.0
    for eps in (0.0, 0.1):
        runs = []
        for _ in range(2):
            reset_launches()
            x = low.detach().requires_grad_(True)
            loss = rce.resized_ce(x, labels, eps)
            (grad,) = torch.autograd.grad(loss, x)
            torch.cuda.synchronize()
            runs.append((loss.detach(), grad, read_launches()["resized_ce"]))
        ref_loss, lse = rce.resized_ce_forward_reference(low, labels, eps,
                                                         chunk)
        ref_grad = rce.resized_ce_backward_reference(low, labels, lse, one,
                                                     eps, chunk)
        loss_gap = abs(float(runs[0][0]) - float(ref_loss)) \
            / abs(float(ref_loss))
        grad_gap = float((runs[0][1] - ref_grad).norm() / ref_grad.norm())
        same = all(torch.equal(a, b) for a, b in zip(runs[0][:2],
                                                      runs[1][:2]))
        layout = runs[0][1].stride() == low.stride()
        launches = [r[2] for r in runs]
        finite = bool(runs[0][1].isfinite().all())
        log("kernel[resized_ce]: {} x {} x {}x{} -> {}x{} {}, eps {} | loss "
            "{:.7f} vs plain {:.7f} (rel {:.3g} <= 1e-6) | |dg| / |g| {:.3g} "
            "(<= 1e-5) | two runs bit-identical {} | gradient in the input's "
            "layout {} | launches {} (expect [2, 2])".format(
                n, c, h, w, out_h, out_w,
                "channels-last" if channels_last else "NCHW", eps,
                float(runs[0][0]), float(ref_loss), loss_gap, grad_gap, same,
                layout, launches))
        if not (loss_gap <= 1e-6 and grad_gap <= 1e-5 and same and layout
                and launches == [2, 2] and finite):
            raise AssertionError("resized_ce disagrees with its plain "
                                 "version")
        worst = max(worst, grad_gap)
        worst_abs = max(worst_abs, float((runs[0][1] - ref_grad).abs().max()))
        del runs, ref_grad, lse
        torch.cuda.empty_cache()
    return worst, worst_abs, (low, labels), chunk


def _head_guards(dev):
    """`resized_ce`'s kernels at a small shape: a label outside [0, C)
    (C or -1, float or integer) makes the loss and the gradient NaN; forwards
    on two streams at once each give the plain version's loss (each launch
    counts its own finished blocks)."""
    import torch
    from mliis_tpu_torch.ops import resized_ce as rce
    gen = torch.Generator(device=dev).manual_seed(5)
    n, c, out_h, out_w = 3, 1001, 30, 33
    low = torch.randn(n, c, 7, 9, generator=gen, device=dev) * 3
    labels = torch.randint(0, c, (n, out_h, out_w), generator=gen,
                           device=dev)
    poisoned = []
    for bad in (c, -1):
        for dtype in (torch.float32, torch.int32):
            lab = labels.to(dtype)
            lab[1, 4, 5] = bad
            x = low.detach().requires_grad_(True)
            loss = rce.resized_ce(x, lab, 0.1)
            (grad,) = torch.autograd.grad(loss, x)
            poisoned.append(bool(loss.isnan()) and bool(grad[1].isnan().any())
                            and bool(grad[0].isfinite().all()))
    ref = [float(rce.resized_ce_forward_reference(low[i:], labels[i:])[0])
           for i in range(2)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize(dev)
    losses = []
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                losses.append((i, rce.resized_ce(low[i:], labels[i:])))
    torch.cuda.synchronize(dev)
    gap = max(abs(float(l) - ref[i]) / abs(ref[i]) for i, l in losses)
    log("kernel[resized_ce] guards: a label out of range gives a NaN loss "
        "and NaN gradient on its image alone {} (expect 4 x True) | 40 "
        "forwards on two streams at once, largest rel gap to plain {:.3g} "
        "(<= 1e-6)".format(poisoned, gap))
    if not (all(poisoned) and gap <= 1e-6):
        raise AssertionError("resized_ce's guards failed")


def phase_head_kernel(dev):
    """`resized_ce` at HEAD_SIZES against its plain version; the forward
    and backward timed together (cold and warm L2) and alone (warm), beside
    the bound (its bytes at HBM3's rate, its exponentials at the SFUs'),
    the plain version and the composition it replaced (`library_ms`); then
    `_head_guards`."""
    import torch
    from mliis_tpu_torch.ops import resized_ce as rce
    _head_guards(dev)
    sizes = {}
    usage = BUILD_USAGE.get("resized_ce", {})
    one = torch.ones((), device=dev)
    for n, c, h, w, out_h, out_w, channels_last in HEAD_SIZES:
        rel, err, (low, labels), chunk = _head_at(dev, n, c, h, w, out_h,
                                                  out_w, channels_last)
        pixels = n * out_h * out_w
        # The logits read by each launch, their gradient written, the labels
        # read, the statistics written and read back.
        bytes_moved = 3 * low.numel() * 4 + pixels * (4 + 2 * 8)
        exps = 2 * pixels * c
        t_bytes = 1e3 * bytes_moved / H100_BYTES_PER_S
        t_exps = 1e3 * exps / H100_EXP2_PER_S
        bound_ms = max(t_bytes, t_exps)

        def both(x, lab):
            _, stats = rce._forward_kernel(x, lab, 0.0)
            return rce._backward_kernel(x, stats, one, 0.0)

        t = kernel_times(both, (low, labels), bytes_moved, 10)
        fwd_ms = cuda_ms(lambda: rce._forward_kernel(low, labels, 0.0), 10)
        _, stats = rce._forward_kernel(low, labels, 0.0)
        bwd_ms = cuda_ms(lambda: rce._backward_kernel(low, stats, one, 0.0),
                         10)

        def plain():
            _, lse = rce.resized_ce_forward_reference(low, labels, 0.0,
                                                      chunk)
            return rce.resized_ce_backward_reference(low, labels, lse, one,
                                                     0.0, chunk)

        def library():
            x = low.detach().requires_grad_(True)
            return torch.autograd.grad(
                _head_composition(x, labels, 0.0, chunk), x)

        plain_ms = cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        library_ms = cuda_ms(library, 2)
        torch.cuda.empty_cache()
        tag = _size_tag(n, out_h, out_w)
        log("kernel[resized_ce] {} x {} x {}x{} -> {}x{}: {} | forward {:.4f} "
            "ms, backward {:.4f} ms (warm, eager) | bound: bytes {:.4f} ms "
            "({:.4g} GB at 3.35 TB/s), exponentials {:.4f} ms ({:.4g} at "
            "{:.4g}/s) | plain_ms {:.2f} | library_ms {:.2f} (F.interpolate + "
            "F.cross_entropy, chunks of {}) | {} registers, {} B "
            "spilled".format(n, c, h, w, out_h, out_w,
                             _times_text(t, bound_ms), fwd_ms, bwd_ms,
                             t_bytes, bytes_moved / 1e9, t_exps, float(exps),
                             H100_EXP2_PER_S, plain_ms,
                             library_ms, chunk, usage.get("registers"),
                             usage.get("spill_bytes")))
        sizes[tag] = dict(t, max_abs_err=err, max_rel_grad_err=rel,
                          fwd_ms=fwd_ms,
                          bwd_ms=bwd_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_bytes_ms=t_bytes, bound_exp_ms=t_exps,
                          bound_share=bound_ms / t["cold_ms"])
        del low, labels, stats
        torch.cuda.empty_cache()
    n, _, _, _, out_h, out_w, _ = HEAD_SIZES[0]
    entry = dict(sizes[_size_tag(n, out_h, out_w)])
    entry["max_abs_err"] = max(s["max_abs_err"] for s in sizes.values())
    return dict({"name": "resized_ce", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/resized_ce.cu",
                 "replaces": None, "sizes": sizes, **usage}, **entry)


# The `bn_kernel` phase's checks: b3's largest batch-norm input (the
# joint cell's first block at 150^2), b3's deepest (block 17 at 19^2) and
# b0's largest, each in both layouts and with the swish after, before and
# beside none.
BN_CHECK_SHAPES = ((64, 144, 150, 150), (64, 816, 19, 19),
                   (64, 96, 112, 112))
BN_SWISHES = ("after", "before", None)
BN_Y_BAR, BN_GRAD_BAR = 1e-6, 2e-6  # shares of the float64 value's largest
# The joint cells' models, whose every batch-norm input the phase times:
# (tag, backbone, image size), batch 64.
BN_MODELS = (("b3", "efficientnet-b3", 300), ("b0", "efficientnet-b0", 224))


def bn_layers(model, always_batch_stats=False) -> int:
    """The model's batch norms (those that normalize by the batch's
    moments in every mode, the skip decoder's, with
    `always_batch_stats`)."""
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    return sum(isinstance(m, FusedBatchNorm)
               and (m.always_batch_stats or not always_batch_stats)
               for m in model.modules())


def dw_layers(model) -> int:
    """The model's backbone depthwise convs, one an MBConv block."""
    from mliis_tpu_torch.models.efficientnet import MBConvBlock
    return sum(isinstance(m, MBConvBlock) for m in model.modules())


def bn_launches(model, steps, eval_forwards=0):
    """`batch_norm_act` launches of a float32 run on the card: each
    training step runs every batch norm forward and backward (4 launches a
    layer, whatever the tasks on a task axis); each eval-mode forward runs
    those that normalize by the batch in every mode (2 a layer); the
    predictions of an evaluation take the running moments."""
    return (4 * bn_layers(model) * steps
            + 2 * bn_layers(model, True) * eval_forwards)


def _tail_steps(args, chained=True):
    """FOMAML*'s raw tail steps of a training run of the CLI, which launch
    no `full_pass`: one a meta-iteration for each task chained, or each
    task group on a task axis."""
    groups = (args.meta_batch if chained else
              -(-args.meta_batch // args.task_group_size)
              if args.task_group_size else 1)
    return args.meta_iters * groups


def _predictions(args, n_train, n_test):
    """The evaluated tasks' prediction forwards of a training run of the
    CLI, one a task chained: the interval evaluations' and the final."""
    intervals = len(range(0, args.meta_iters, args.eval_interval))
    return (intervals * (min(100, n_train) + min(100, n_test))
            + args.eval_samples * (1 + n_test))


def _bn_library(bn, x, g, swish):
    """(y, dx, d_scale, d_bias) of the composition the kernels replaced,
    the layer's own, under autograd."""
    import torch
    import torch.nn.functional as F
    xr = x.detach().requires_grad_(True)
    y = bn._composition(F.silu(xr) if swish == "before" else xr, True)
    if swish == "after":
        y = F.silu(y)
    return (y.detach(),) + torch.autograd.grad(y, (xr, bn.scale, bn.bias), g)


def _bn_check(dev, shape, channels_last, swish):
    """The kernels (through `batch_norm_act`) against float64 and the
    composition against float64, at one shape; the kernels twice, bit for
    bit. Returns the kernels' worst gap and the composition's."""
    import torch
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    from mliis_tpu_torch.ops import batch_norm_act as bn_act
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    x = (1.5 * torch.randn(shape, generator=gen, device=dev) + 0.7
         ).contiguous(memory_format=fmt)
    g = torch.randn(shape, generator=gen, device=dev).contiguous(
        memory_format=fmt)
    c = shape[1]
    bn = FusedBatchNorm(c).to(dev)
    with torch.no_grad():
        bn.scale.copy_(1.0 + 0.3 * torch.randn(c, generator=gen, device=dev))
        bn.bias.copy_(0.2 * torch.randn(c, generator=gen, device=dev))
        bn.var.fill_(1.5)
    start = (bn.mean.clone(), bn.var.clone())
    runs = []
    for _ in range(2):
        bn.mean.copy_(start[0])
        bn.var.copy_(start[1])
        reset_launches()
        xr = x.clone().requires_grad_(True)
        y = bn(xr, True, swish=swish)
        grads = torch.autograd.grad(y, (xr, bn.scale, bn.bias), g)
        launches = read_launches()["batch_norm_act"]
        runs.append((y.detach(),) + grads + (bn.mean.clone(),
                                             bn.var.clone()))
        del xr, y, grads
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    in_format = all(t.is_contiguous(memory_format=fmt) for t in runs[0][:2])
    y64, stats = bn_act.batch_norm_act_forward_reference(
        x.double(), bn.scale.detach().double(), bn.bias.detach().double(),
        bn.epsilon, swish)
    truth = (y64,) + bn_act.batch_norm_act_backward_reference(
        x.double(), g.double(), stats, swish) + (
        0.99 * start[0].double() + 0.01 * stats[0],
        0.99 * start[1].double() + 0.01 * stats[1])
    del y64, stats
    bn.mean.copy_(start[0])
    bn.var.copy_(start[1])
    library = _bn_library(bn, x, g, swish) + (bn.mean, bn.var)

    def gaps(got):
        return [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(got, truth)]
    k_gaps, l_gaps = gaps(runs[0]), gaps(library)
    bars = (BN_Y_BAR,) + (BN_GRAD_BAR,) * 3 + (BN_Y_BAR,) * 2
    ok = (same and in_format and launches == 4
          and all(a <= b for a, b in zip(k_gaps, bars)))
    log("bn_kernel[check] {} {} swish {}: gaps to float64 (y, dx, d_scale, "
        "d_bias, mean, var) kernels {} | composition {} | bars {} / {} | "
        "bit-identical twice {} | in x's layout {} | launches {} (expect "
        "4)".format(list(shape), "channels-last" if channels_last else
                    "NCHW", swish, ["{:.3g}".format(v) for v in k_gaps],
                    ["{:.3g}".format(v) for v in l_gaps], BN_Y_BAR,
                    BN_GRAD_BAR, same, in_format, launches))
    if not ok:
        raise AssertionError("batch_norm_act disagrees at {} {} swish "
                             "{}".format(shape, channels_last, swish))
    return max(k_gaps), max(l_gaps)


@contextlib.contextmanager
def _composition_route():
    """Every batch norm on the composition of PyTorch ops for the block,
    the route a traced forward takes."""
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    route = FusedBatchNorm._kernel_route
    FusedBatchNorm._kernel_route = lambda self, x, train: False
    try:
        yield
    finally:
        FusedBatchNorm._kernel_route = route


def bn_inputs(dev, backbone, size, batch=64):
    """[(shape, channels-last, swish)] of every batch norm of the joint
    cell's model (EfficientLab on `backbone`, rsd (2,), 1001 channels) in a
    training forward at `batch` x size^2, in the order they run."""
    import torch
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    from mliis_tpu_torch.ops import kernel_library
    model = EfficientLab(n_classes=1000, feature_extractor_name=backbone,
                         rsd=(2,), final_layer_dropout_rate=0.0).to(dev)
    seen = []

    def hook(module, args, kwargs):
        x = args[0]
        seen.append((tuple(x.shape), kernel_library.channels_last(x),
                     kwargs.get("swish")))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, FusedBatchNorm)]
    images = 255.0 * torch.rand(batch, size, size, 3, device=dev)
    with torch.no_grad():
        model(images, train=True, upsample=False)
    for h in handles:
        h.remove()
    del model, images
    torch.cuda.empty_cache()
    return seen


def _bn_times(dev, shape, channels_last, swish):
    """(kernels' cold ms, composition's ms) of a forward and backward at
    one batch-norm input."""
    import torch
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    from mliis_tpu_torch.ops import batch_norm_act as bn_act
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn(shape, device=dev) + 0.5).contiguous(memory_format=fmt)
    g = torch.randn(shape, device=dev).contiguous(memory_format=fmt)
    bn = FusedBatchNorm(shape[1]).to(dev)
    scale, bias = bn.scale.detach(), bn.bias.detach()

    def both(x, g):
        _, stats = bn_act._forward_kernel(x, scale, bias, bn.mean, bn.var,
                                          0.99, 1e-3, swish)
        return bn_act._backward_kernel(x, g, stats, swish, True)

    values = x.numel()
    reps = max(3, min(20, int(4e9 / (4 * values))))
    cold, _ = cold_graph_ms(both, (x, g), 8 * 4 * values, reps)
    library = cuda_ms(lambda: _bn_library(bn, x, g, swish), 3)
    del x, g
    torch.cuda.empty_cache()
    return cold, library


def phase_bn_kernel(dev):
    """`batch_norm_act` against float64 and the composition it replaced at
    BN_CHECK_SHAPES, both layouts, every swish (`_bn_check`); then, for
    each of BN_MODELS, every batch norm's input of a training forward (its
    shape, layout and swish) timed, forward and backward: the kernels with
    a cold L2 and the composition eager, summed over the model's layers as
    a step runs them, beside the bound, 8 float32 passes over each input
    (x read twice and y written forward; x and the gradient read twice and
    dx written backward) at 3.35 TB/s."""
    import torch
    usage = BUILD_USAGE.get("batch_norm_act", {})
    worst_k, worst_l = 0.0, 0.0
    for shape in BN_CHECK_SHAPES:
        for channels_last in (False, True):
            for swish in BN_SWISHES:
                k, lib = _bn_check(dev, shape, channels_last, swish)
                worst_k, worst_l = max(worst_k, k), max(worst_l, lib)
                torch.cuda.empty_cache()
    steps = {}
    for tag, backbone, size in BN_MODELS:
        inputs = bn_inputs(dev, backbone, size)
        timed = {}
        for key in inputs:
            if key not in timed:
                timed[key] = _bn_times(dev, *key)
        kernel_ms = sum(timed[k][0] for k in inputs)
        library_ms = sum(timed[k][1] for k in inputs)
        values = sum(math.prod(k[0]) for k in inputs)
        bound_ms = 1e3 * 8 * 4 * values / H100_BYTES_PER_S
        layouts = sum(k[1] for k in inputs)
        for key, (cold, lib) in sorted(timed.items(), key=lambda kv:
                                       -math.prod(kv[0][0])):
            n = inputs.count(key)
            one = 1e3 * 8 * 4 * math.prod(key[0]) / H100_BYTES_PER_S
            log("bn_kernel[{}] {} {} swish {} x{}: cold_ms {:.4f} ({:.1%} of "
                "the bound {:.4f}) | composition {:.4f} ms".format(
                    tag, list(key[0]), "channels-last" if key[1] else "NCHW",
                    key[2], n, cold, one / cold, one, lib))
        log("bn_kernel[{}]: {} batch norms ({} channels-last, {} NCHW), "
            "{:.4g} GB of inputs a step | kernels {:.3f} ms a step ({:.1%} "
            "of the bound {:.3f} ms) | composition {:.3f} ms a step | {} "
            "registers, {} B spilled".format(
                tag, len(inputs), layouts, len(inputs) - layouts,
                4 * values / 1e9, kernel_ms, bound_ms / kernel_ms, bound_ms,
                library_ms, usage.get("registers"), usage.get("spill_bytes")))
        steps[tag] = dict(layers=len(inputs), channels_last=layouts,
                          kernel_ms=kernel_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_share=bound_ms / kernel_ms)
    b3 = steps["b3"]
    return dict({"name": "batch_norm_act", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/batch_norm_act.cu",
                 "replaces": None, "steps": steps, **usage},
                ms=b3["kernel_ms"], cold_ms=b3["kernel_ms"],
                plain_ms=b3["library_ms"], bound_ms=b3["bound_ms"],
                bound_share=b3["bound_share"], max_abs_err=worst_k,
                library_max_err=worst_l)


# The `dw_kernel` phase's bars, shares of the float64 value's largest
# magnitude: y and dx sum 9 or 25 float32 products a value; dw sums N Ho Wo
# products a tap (float32 within a block, double across blocks).
DW_Y_BAR, DW_DX_BAR, DW_W_BAR = 2e-6, 2e-6, 2e-5
# Maps the joint cells do not have: channels that are no multiple of 8
# (a last slice partly masked) and no multiple of 4 (4-byte copies), odd
# planes.
DW_ODD_SHAPES = (((4, 20, 17, 17), 5, 2), ((4, 6, 9, 10), 3, 1))


def dw_inputs(dev, backbone, size, batch=64):
    """[(shape, k, stride)] of every depthwise conv's input of the joint
    cell's model (EfficientLab on `backbone`, rsd (2,), 1001 channels) in a
    training forward at `batch` x size^2, in the order they run."""
    import torch
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.models.layers import Conv2d
    model = EfficientLab(n_classes=1000, feature_extractor_name=backbone,
                         rsd=(2,), final_layer_dropout_rate=0.0).to(dev)
    seen = []

    def hook(module, args):
        if module.groups > 1:
            seen.append((tuple(args[0].shape), module.kernel_size,
                         module.stride))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d)]
    images = 255.0 * torch.rand(batch, size, size, 3, device=dev)
    with torch.no_grad():
        model(images, train=True, upsample=False)
    for h in handles:
        h.remove()
    del model, images
    torch.cuda.empty_cache()
    return seen


def _dw_maps(dev, shape, k, stride):
    """x (channels-last, off zero as a swish's output), weight, dy and the
    SAME padding at one input shape."""
    import torch
    from mliis_tpu_torch.models.layers import same_padding
    n, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + 10 * k
                                                  + stride)
    x = (torch.randn(shape, generator=gen, device=dev) + 0.3).contiguous(
        memory_format=torch.channels_last)
    weight = torch.randn(c, 1, k, k, generator=gen, device=dev) / k
    g = torch.randn(n, c, -(-h // stride), -(-w // stride), generator=gen,
                    device=dev).contiguous(memory_format=torch.channels_last)
    padding = (same_padding(h, k, stride), same_padding(w, k, stride))
    return x, weight, g, padding


def _dw_library(x, weight, g, stride, padding):
    """(y, dx, dw) of the route the kernels replaced, `F.pad` + `F.conv2d`
    under autograd, float32 with TF32 off."""
    import torch
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = padding
    xr = x.detach().requires_grad_(True)
    wr = weight.detach().requires_grad_(True)
    y = F.conv2d(F.pad(xr, (pl, pr, pt, pb)), wr, stride=stride,
                 groups=x.shape[1])
    return (y.detach(),) + torch.autograd.grad(y, (xr, wr), g)


@contextlib.contextmanager
def _tf32_off():
    import torch
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _dw_check(dev, shape, k, stride):
    """The kernels (through `depthwise_conv`) against the plain version in
    float64 on the card, and the library against it too, at one shape; the
    kernels twice, bit for bit, one launch each way. Returns the kernels'
    worst gap and the library's."""
    import torch
    from mliis_tpu_torch.ops import depthwise_conv as dw
    x, weight, g, padding = _dw_maps(dev, shape, k, stride)
    runs = []
    for _ in range(2):
        reset_launches()
        xr = x.clone().requires_grad_(True)
        wr = weight.clone().requires_grad_(True)
        y = dw.depthwise_conv(xr, wr, stride, padding)
        grads = torch.autograd.grad(y, (xr, wr), g)
        launches = read_dw_launches()
        runs.append((y.detach(),) + grads)
        del xr, wr, y, grads
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    in_format = all(t.is_contiguous(memory_format=torch.channels_last)
                    for t in runs[0][:2])
    x64, w64, g64 = x.double(), weight.double(), g.double()
    truth = (dw.depthwise_conv_reference(x64, w64, stride, padding),) + \
        dw.depthwise_conv_backward_reference(x64, w64, g64, stride, padding)
    del x64, w64, g64
    with _tf32_off():
        library = _dw_library(x, weight, g, stride, padding)

    def gaps(got):
        return [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(got, truth)]
    k_gaps, l_gaps = gaps(runs[0]), gaps(library)
    bars = (DW_Y_BAR, DW_DX_BAR, DW_W_BAR)
    ok = (same and in_format
          and launches == {"depthwise_conv": 1, "depthwise_conv_grad": 1}
          and all(a <= b for a, b in zip(k_gaps, bars)))
    log("dw_kernel[check] {} k {} stride {} padding {}: gaps to float64 (y, "
        "dx, dw) kernels {} | library {} | bars {} | bit-identical twice "
        "{} | channels-last {} | launches {}".format(
            list(shape), k, stride, padding,
            ["{:.3g}".format(v) for v in k_gaps],
            ["{:.3g}".format(v) for v in l_gaps], bars, same, in_format,
            launches))
    if not ok:
        raise AssertionError("depthwise_conv disagrees at {} k {} stride "
                             "{}".format(shape, k, stride))
    del truth, library, runs
    torch.cuda.empty_cache()
    return max(k_gaps), max(l_gaps)


def _dw_times(dev, shape, k, stride):
    """(forward's cold ms, backward's cold ms, library's ms) at one input:
    the kernels from CUDA graphs with a cold L2, the library's forward and
    backward eager (TF32 off)."""
    import torch
    from mliis_tpu_torch.ops import depthwise_conv as dw
    x, weight, g, padding = _dw_maps(dev, shape, k, stride)
    xv, yv = x.numel(), g.numel()
    reps = max(3, min(20, int(4e9 / (4 * xv))))
    fwd, _ = cold_graph_ms(
        lambda a, b: dw._forward_kernel(a, b, stride, padding), (x, weight),
        4 * (xv + yv), reps)
    bwd, _ = cold_graph_ms(
        lambda a, b, c: dw._backward_kernel(a, b, c, stride, padding, True),
        (x, weight, g), 4 * (2 * xv + yv), reps)
    with _tf32_off():
        library = cuda_ms(lambda: _dw_library(x, weight, g, stride,
                                              padding), 3)
    del x, weight, g
    torch.cuda.empty_cache()
    return fwd, bwd, library


def _dw_host_us(dev, reps=200):
    """Host microseconds a forward and backward of one small depthwise
    `Conv2d` ([4, 16, 8, 8] channels-last, k 3) on the kernels' route and
    on `F.pad` + `F.conv2d`, from the wall of `reps` calls ended by one
    sync: at this size the card waits on the host."""
    import torch
    from mliis_tpu_torch.models import layers
    conv = layers.Conv2d(16, 16, 3, groups=16, use_bias=False,
                         depthwise_init=True).to(dev)
    x = torch.randn(4, 16, 8, 8, device=dev).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    g = torch.randn(4, 16, 8, 8, device=dev).contiguous(
        memory_format=torch.channels_last)

    def call():
        torch.autograd.grad(conv(x), (x, conv.kernel), g)

    out = {}
    route = layers.Conv2d._kernel_route
    for name in ("kernels", "library", "kernels_again", "library_again"):
        if name.startswith("library"):
            layers.Conv2d._kernel_route = lambda self, x, k, g: False
        try:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
            out[name] = 1e6 * (time.perf_counter() - t0) / reps
        finally:
            layers.Conv2d._kernel_route = route
    return out


def phase_dw_kernel(dev):
    """`depthwise_conv` against float64 and the library route it replaced
    (`F.pad` + `F.conv2d`) at every depthwise input of the b3 and b0 joint
    cells' models and at DW_ODD_SHAPES (`_dw_check`); then every depthwise
    input of each model timed, forward and backward, the kernels with a
    cold L2 and the library eager, summed over the model's layers as a
    step runs them, beside the bound (x read and y written forward; x and
    dy read and dx written backward, at 3.35 TB/s); then the host's cost
    of a small call on each route."""
    import torch
    from mliis_tpu_torch.models.layers import same_padding
    from mliis_tpu_torch.ops import depthwise_conv as dw
    from mliis_tpu_torch.ops import kernel_library
    usage = BUILD_USAGE.get("depthwise_conv", {})
    sms = kernel_library.sm_count(dev.index)
    worst_k, worst_l = 0.0, 0.0
    models = {tag: dw_inputs(dev, backbone, size)
              for tag, backbone, size in BN_MODELS}
    shapes = sorted({key for inputs in models.values() for key in inputs},
                    key=lambda key: -math.prod(key[0]))
    for shape, k, stride in shapes + list(DW_ODD_SHAPES):
        a, b = _dw_check(dev, shape, k, stride)
        worst_k, worst_l = max(worst_k, a), max(worst_l, b)
    steps = {}
    for tag, inputs in models.items():
        timed = {key: _dw_times(dev, *key) for key in set(inputs)}
        fwd_ms = sum(timed[key][0] for key in inputs)
        bwd_ms = sum(timed[key][1] for key in inputs)
        library_ms = sum(timed[key][2] for key in inputs)

        def bound(key):
            (n, c, h, w), _, s = key
            out = n * c * -(-h // s) * -(-w // s)
            return (1e3 * 4 * (n * c * h * w + out) / H100_BYTES_PER_S,
                    1e3 * 4 * (2 * n * c * h * w + out) / H100_BYTES_PER_S)

        bound_ms = sum(sum(bound(key)) for key in inputs)
        for key in sorted(timed, key=lambda kk: -math.prod(kk[0])):
            f, bw, lib = timed[key]
            bf, bb = bound(key)
            (n, c, h, w), k, s = key
            pad = (same_padding(h, k, s)[0], same_padding(w, k, s)[0])
            plans = [dw.launch_plan(key[0], k, s, *pad, b, sms)
                     for b in (False, True)]
            log("dw_kernel[{}] {} k {} stride {} x{}: cold_ms forward "
                "{:.4f} ({:.1%} of its bound {:.4f}), backward {:.4f} "
                "({:.1%} of {:.4f}) | library {:.4f} ms | plans (slice, "
                "tile) {}".format(
                    tag, list(key[0]), k, s, inputs.count(key), f, bf / f,
                    bf, bw, bb / bw, bb, lib,
                    [(p.cs, p.tile_h, p.tile_w) for p in plans]))
        kernel_ms = fwd_ms + bwd_ms
        log("dw_kernel[{}]: {} depthwise convs | kernels {:.3f} ms a step "
            "(forward {:.3f}, backward {:.3f}; {:.1%} of the bound {:.3f} "
            "ms) | library {:.3f} ms a step | {} registers, {} B "
            "spilled".format(tag, len(inputs), kernel_ms, fwd_ms, bwd_ms,
                             bound_ms / kernel_ms, bound_ms, library_ms,
                             usage.get("registers"),
                             usage.get("spill_bytes")))
        steps[tag] = dict(layers=len(inputs), kernel_ms=kernel_ms,
                          forward_ms=fwd_ms, backward_ms=bwd_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_share=bound_ms / kernel_ms)
    host = _dw_host_us(dev)
    log("dw_kernel[host]: us a forward and backward of a [4, 16, 8, 8] "
        "depthwise Conv2d, in turns: {}".format(
            {k: round(v, 1) for k, v in host.items()}))
    b3 = steps["b3"]
    return dict({"name": "depthwise_conv", "route": "cuda",
                 "source": "mliis_tpu_torch/csrc/depthwise_conv.cu",
                 "replaces": None, "steps": steps, "host_us": host,
                 **usage},
                ms=b3["kernel_ms"], cold_ms=b3["kernel_ms"],
                plain_ms=b3["library_ms"], bound_ms=b3["bound_ms"],
                bound_share=b3["bound_share"], max_abs_err=worst_k,
                library_max_err=worst_l)


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
    reset_launches()
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
    launches = read_launches()
    expect = expected(fused_light_augment=1, resized_ce=2,
                      batch_norm_act=4 * bn_layers(init))
    norm = float(torch.sqrt(sum(u.square().sum() for u in upd_cpu.values())))
    worst = max(float((upd_card[k] - upd_cpu[k]).norm())
                for k in upd_cpu) / norm
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log("agree[joint]: card (kernels) vs cpu (plain versions), 1001 "
        "channels, 4 x 32^2 | loss {:.6f} vs {:.6f} (rel {:.3g} <= 1e-4) | "
        "max_k |du_k| / |u| {:.3g} (<= 1e-3) | launches {} (expect "
        "{})".format(loss_card, loss_cpu, loss_err, worst, launches, expect))
    if not (loss_err <= 1e-4 and worst <= 1e-3 and launches == expect):
        raise AssertionError("the card's joint step disagrees with the CPU's")


# The `slice` phase's model, store, configs, initial state, draw seeds,
# states after each meta-step and seconds, which the `batched` phase runs
# again on a task axis.
SLICE = {}


def phase_slice(dev):
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.meta.episodes import draw_seed
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    store = make_synthetic_store(num_tasks=8, examples_per_task=10,
                                 image_size=224, seed=0)
    imgs, msks, counts = store.to_torch(dev)
    opt_cfg = il.OptimizerConfig("sgd")
    loss_cfg = il.LossConfig(dice=True, l2=True)
    cfg = lr.MetaTrainConfig(num_shots=10, inner_batch_size=8,
                             inner_iters=59, meta_batch_size=5, foml=True,
                             tail_shots=5, aug_rate=0.5)
    step = lr.make_chained_train_step(model, loss_cfg, opt_cfg, cfg)
    state = il.init_model_state(model, opt_cfg)
    SLICE.update(model=model, store=(imgs, msks, counts), cfg=cfg,
                 opt_cfg=opt_cfg, loss_cfg=loss_cfg, start=state, seeds=[],
                 states=[], seconds=[])
    start = {k: v.clone() for k, v in state.params.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    seconds = SLICE["seconds"]
    for _ in range(2):
        t0 = time.time()
        seed = draw_seed(gen)
        draws = lr.draw_meta_step(seed, counts, cfg, n_max=10)
        state = step(state, imgs, msks, draws, 0.1, 5e-4)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        SLICE["seeds"].append(seed)
        SLICE["states"].append(state)
    launches = read_launches()
    SLICE["peak"] = torch.cuda.max_memory_allocated(dev)
    expect = expected(full_pass=2 * 5 * 58)
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    moved = sum(float((state.params[k] - start[k]).abs().sum())
                for k in start)
    log("slice: meta-step seconds {} | launches {} (expect {}) | params "
        "finite {} | sum |d params| {:.4g} | peak memory {:.2f} GB".format(
            ["{:.3f}".format(s) for s in seconds], launches, expect, finite,
            moved, SLICE["peak"] / 1e9))
    if launches != expect or not finite or not moved > 0:
        raise AssertionError("the slice did not run as expected")
    return launches


EVAL_CHECKPOINT = os.path.join("experiments", "curve_v2_r4",
                               "model.ckpt-3000.npz")
EVAL_TASKS, EVAL_STEPS = 12, 59
EVAL_IOU_BAR = 0.15
EVAL_SEED = 9000   # the evaluation generator's seed on both strategies
# The `eval` phase's model, store, config, the JAX package's IoU and, per
# route, the chained evaluation's mean IoU and wall, for the `batched`
# phase.
EVAL = {}


def phase_eval(dev):
    """run.sh's evaluation protocol on the committed checkpoint of
    experiments/curve_v2_r4 (EfficientLab-b0 rsd=(2, 4), bf16, final
    dropout 0.5, meta-trained 3000 steps at 224^2) over its 12 held-out
    tasks (triangle, ring, diamond; seed 777): 5 shots + 5 query, 59 SGD
    steps at batch 8, lr 5e-4, bce_dice + l2, aug rate 0.5, transductive,
    one sample, the tasks one after another (`chain_chunk`; the `batched`
    phase runs them on a task axis), with deterministic algorithms
    (`deterministic_algorithms`); once on the fused route and once on
    the split route. Each
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
                        augment=True, chain_chunk=True)
    evaluator = ev.GeckoEvaluator(model, il.LossConfig(dice=True, l2=True),
                                  opt_cfg, cfg, store, device=dev)
    EVAL.update(model=model, store=store, cfg=cfg, jax_iou=jax_iou)
    state = il.init_model_state(model, opt_cfg)
    EVAL["state"] = state
    counts, failed, nondeterministic = {}, [], []
    try:
        for route, fused in (("fused", True), ("split", False)):
            taug.PALLAS_FUSED_SINGLE_LAUNCH = fused
            gen = torch.Generator(device=dev).manual_seed(EVAL_SEED)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            with deterministic_algorithms(nondeterministic):
                mean_iou, task_map = ev.evaluate_gecko(
                    evaluator, state, gen, 5e-4, num_samples=1,
                    serially_eval_all_tasks=True, aug_rate=0.5,
                    log_fn=lambda line: log("eval[{}]: {}".format(route,
                                                                  line)))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read_launches()
            counts["eval_" + route] = launches
            ious = [v[0] for v in task_map.values()]
            steps = EVAL_TASKS * EVAL_STEPS
            expect = expected(full_pass=steps if fused else 0,
                              cheap_pass=0 if fused else 2 * steps)
            EVAL[route] = {"iou": mean_iou, "wall": wall,
                           "task_ious": ["{:.3f}".format(v) for v in ious]}
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
    log("eval: held-out store built in {:.2f} s | deterministic algorithms,"
        " ops without one: {}".format(store_s, nondeterministic or "none"))
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
JOINT_VAL_BATCHES = 2


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
    from mliis_tpu_torch.joint import trainer as jt
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
        # The validation batches normalize by the running moments: no
        # batch_norm_act launch. Every step and every validation chunk's
        # forward (under 2^31 logits a chunk) launches the depthwise conv
        # once a backbone depthwise conv, every step's backward once more.
        init = EfficientLab(n_classes=1000, rsd=(2,),
                            final_layer_dropout_rate=0.0)
        expect = expected(fused_light_augment=JOINT_STEPS,
                          resized_ce=2 * JOINT_STEPS,
                          batch_norm_act=4 * bn_layers(init) * JOINT_STEPS)
        val_forwards = JOINT_VAL_BATCHES * -(-64 // jt._chunk(
            64, init.n_output_channels, 224, 224))
        launches.update(read_dw_launches())
        expect.update(
            depthwise_conv=dw_layers(init) * (JOINT_STEPS + val_forwards),
            depthwise_conv_grad=dw_layers(init) * JOINT_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        out = "".join(tee.parts)
        store_s = float(re.search(r"built in ([0-9.]+) s", out).group(1))

        with open(os.path.join(workdir, "joint_train_metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        step_s = [r["value"] for r in records if r["tag"] == "step_seconds"]
        last6 = 6 / sum(step_s[-6:])
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
# --data-dir, cut to 8 synthetic tasks, 2 meta-iters, 1 eval sample and 10
# evaluation steps a task (run.sh: 59; the `eval` phase runs 59).
TRAIN_ARGV = (
    "--image_size 224 --rsd 2 4 --l2 --foml --foml-tail 5 "
    "--final_layer_dropout_rate 0.5 --augment --aug_rate 0.5 --sgd "
    "--loss_name bce_dice --inner-batch 8 --learning-rate 0.0005 "
    "--train-shots 10 --inner-iters 59 --learning_rate_scheduler fixed "
    "--meta-batch 5 --serially_eval_all_test_tasks --shots 5 --eval-batch 8 "
    "--eval-iters 10 --transductive --model_name efficientlab "
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


# The `train` run's phase timings, wall and peak (chained), for the
# `batched` phase's CLI run.
TRAIN = {}


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
    init = EfficientLab(**args_lib.model_kwargs(args))

    def check(run, launches, full_pass, ok, text, tails=0):
        # Every step a full_pass launch augments, and the raw tails, run
        # the batch norms forward and backward.
        expect = expected(full_pass=full_pass,
                          batch_norm_act=bn_launches(init, full_pass + tails))
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
        TRAIN.update(timings=timings, wall=wall, peak=peak)
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
                  expect, terms), tails=_tail_steps(args))

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


# The `batched` phase: the meta-batch and the evaluation chunks on a task
# axis (`learners.make_train_step`, `evaluate.make_eval_chunk_fn` without
# `chain_chunk`), against the chained runs of the `slice`, `eval` and
# `train` phases in the same call.
BATCHED_CHUNK = 2          # evaluation tasks on the task axis at a time
BATCHED_F32_STEPS = 6      # the float32 meta-step's depth (run.sh: 59)
BATCHED_F32_EVAL_STEPS = 10  # the float32 evaluations' depth (run.sh: 59)
# Bars. The float32 meta-step: the CPU test's bound
# (tests/test_torch_task_axis.py
# `test_task_axis_steps_equal_chained_step_with_every_draw_on`: 1e-5 abs;
# measured 2.8e-7 there). bf16 rounds a grouped conv's sums differently
# from a plain one's, and 59 dependent bf16 steps amplify that: the bf16
# meta-steps are held loosely, on the largest gap as a share of the
# largest change; the bf16 evaluations' mean IoU within 0.02 of the
# chained one's (measured with deterministic algorithms, each reproducible
# bit for bit: +0.0027 fused, +0.0072 split; per task up to 0.055; the
# chained evaluation alone moves 0.0038 between two runs without them,
# experiments/torch_batched_eval_iou.py). The float32 evaluations, chained
# and batched, agree within 0.005 in mean IoU.
BATCHED_F32_BAR, BATCHED_BF16_BAR = 1e-5, 0.1
BATCHED_BF16_IOU_BAR, BATCHED_IOU_BAR = 0.02, 0.005


def _expected_batched_launches(args, n_train, n_test):
    """`full_pass` launches of a training run of the CLI on a task axis:
    one an inner step for the meta-batch (for each task group with
    --task_group_size), and one an evaluation step for each chunk of
    --task_chunk_size tasks. Returns (total, its terms as text)."""
    groups = (-(-args.meta_batch // args.task_group_size)
              if args.task_group_size else 1)
    c = args.task_chunk_size

    def chunks(n):
        return -(-n // c)
    meta = args.meta_iters * groups * (args.inner_iters - 1)
    intervals = len(range(0, args.meta_iters, args.eval_interval))
    interval = intervals * (chunks(min(100, n_train))
                            + chunks(min(100, n_test))) * args.eval_iters
    final = args.eval_samples * (chunks(1) + chunks(n_test)) \
        * args.eval_iters
    return meta + interval + final, (
        "{} x {} x {} + {} x ({} + {}) x {} + {} x ({} + {}) x {}".format(
            args.meta_iters, groups, args.inner_iters - 1, intervals,
            chunks(min(100, n_train)), chunks(min(100, n_test)),
            args.eval_iters, args.eval_samples, chunks(1), chunks(n_test),
            args.eval_iters))


def phase_batched(dev):
    """The task axis on the card, each run beside its chained counterpart
    from this call:
    1. the `slice` phase's two bf16 FOMAML* meta-steps again through
       `learners.make_train_step` from the same state and draw seeds: one
       `full_pass` launch at B = 5 x 8 = 40 an inner step, 2 x 58 = 116 in
       all, against the slice's 580; the states after each step held to
       the slice's within BATCHED_BF16_BAR of the largest change;
    2. the same model in float32 cut to BATCHED_F32_STEPS inner steps
       (5 tasks at batch 8, 224^2), one meta-step chained and one batched
       from the same state and draws: every param and running stat within
       BATCHED_F32_BAR;
    3. the `eval` phase's evaluation (12 held-out tasks of the committed
       checkpoint, 59 steps) in chunks of 2 on the fused and the split
       route, from the same evaluation seed: 12 / 2 x 59 = 354 `full_pass`
       launches at B=16, or 2 x 354 = 708 `cheap_pass` launches; the mean
       IoU within BATCHED_BF16_IOU_BAR of the chained evaluation's and
       within EVAL_IOU_BAR of the JAX package's; then the checkpoint in
       float32 cut to BATCHED_F32_EVAL_STEPS steps, evaluated chained and
       batched on both routes: the mean IoUs within BATCHED_IOU_BAR; every
       evaluation with deterministic algorithms;
    4. the `train` run's CLI with no strategy flag (the meta-batch and the
       evaluation chunks of --task_chunk_size 2 on a task axis), cut to 1
       meta-iter: exact launches, derived from the flags.
    Prints each run's seconds and peak memory beside the chained run's.
    Returns {path: launches}."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.meta import evaluate as ev
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.ops import augment as taug
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz
    t_phase = time.time()
    counts, failed = {}, []

    def check(path, launches, full_pass, ok, text, cheap=0, bn=0):
        expect = expected(full_pass=full_pass, cheap_pass=cheap,
                          batch_norm_act=bn)
        counts[path] = launches
        log("batched[{}]: {} | launches {} (expect {})".format(
            path, text, launches, expect))
        if launches != expect or not ok:
            failed.append(path)

    model, (imgs, msks, mcounts) = SLICE["model"], SLICE["store"]
    cfg, opt_cfg, loss_cfg = SLICE["cfg"], SLICE["opt_cfg"], SLICE["loss_cfg"]
    start = _cpu_state(SLICE["start"])
    step = lr.make_train_step(model, loss_cfg, opt_cfg, cfg)
    state, seconds, gaps = SLICE["start"], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    for i, seed in enumerate(SLICE["seeds"]):
        t0 = time.time()
        draws = lr.draw_meta_step(seed, mcounts, cfg, n_max=10)
        state = step(state, imgs, msks, draws, 0.1, 5e-4)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        gaps.append(_state_gap(_cpu_state(state),
                               _cpu_state(SLICE["states"][i]), start))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    check("batched_step", launches, 2 * 58,
          finite and max(g[1] for g in gaps) <= BATCHED_BF16_BAR,
          "2 bf16 FOMAML* meta-steps on a task axis (5 tasks x 59 steps at "
          "batch 8, 224^2) | seconds {} (chained, slice: {}) | peak memory "
          "{:.2f} GB (chained: {:.2f}) | largest gap to the chained states "
          "{} ({} of the largest change; bar {}) | params finite {}".format(
              ["{:.3f}".format(v) for v in seconds],
              ["{:.3f}".format(v) for v in SLICE["seconds"]], peak / 1e9,
              SLICE["peak"] / 1e9, ["{:.3g}".format(g[0]) for g in gaps],
              ["{:.3g}".format(g[1]) for g in gaps], BATCHED_BF16_BAR,
              finite))
    del state

    f32 = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5)
    f32.load_state_dict(model.state_dict())
    f32.to(dev)
    cfg_f32 = dataclasses.replace(cfg, inner_iters=BATCHED_F32_STEPS)
    state0 = il.init_model_state(f32, opt_cfg)
    f32_start, outs, walls = _cpu_state(state0), {}, {}
    for name, make in (("chained", lr.make_chained_train_step),
                       ("batched", lr.make_train_step)):
        draws = lr.draw_meta_step(SLICE["seeds"][0], mcounts, cfg_f32, 10)
        run = make(f32, loss_cfg, opt_cfg, cfg_f32)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        outs[name] = _cpu_state(run(state0, imgs, msks, draws, 0.1, 5e-4))
        torch.cuda.synchronize()
        walls[name] = time.time() - t0
        counts["batched_f32_" + name] = read_launches()
    gap = _state_gap(outs["batched"], outs["chained"], f32_start)
    per_step = BATCHED_F32_STEPS - 1
    chained_expect = expected(full_pass=5 * per_step, batch_norm_act=5
                              * bn_launches(f32, BATCHED_F32_STEPS))
    check("batched_f32", counts["batched_f32_batched"], per_step,
          gap[0] <= BATCHED_F32_BAR
          and counts["batched_f32_chained"] == chained_expect,
          "float32 FOMAML* meta-step of {} inner steps, batched against "
          "chained from the same state and draws | seconds {:.3f} (chained "
          "{:.3f}, {} launches) | largest gap {:.3g} (bar {}; {:.3g} of the "
          "largest change)".format(BATCHED_F32_STEPS, walls["batched"],
                                   walls["chained"],
                                   counts["batched_f32_chained"]["full_pass"],
                                   gap[0], BATCHED_F32_BAR, gap[1]),
          bn=bn_launches(f32, BATCHED_F32_STEPS))
    del f32, outs

    def evaluate(evaluator, state, route):
        """(mean IoU, task IoUs, wall) of one deterministic evaluation of
        the held-out tasks on `route`, from the `eval` phase's seed."""
        taug.PALLAS_FUSED_SINGLE_LAUNCH = route == "fused"
        gen = torch.Generator(device=dev).manual_seed(EVAL_SEED)
        torch.cuda.synchronize()
        t0 = time.time()
        with deterministic_algorithms(nondeterministic):
            mean_iou, task_map = ev.evaluate_gecko(
                evaluator, state, gen, 5e-4, num_samples=1,
                serially_eval_all_tasks=True, aug_rate=0.5,
                log_fn=lambda line: None)
        torch.cuda.synchronize()
        return (mean_iou, ["{:.3f}".format(v[0]) for v in task_map.values()],
                time.time() - t0)

    loss_eval = il.LossConfig(dice=True, l2=True)
    ecfg = dataclasses.replace(EVAL["cfg"], chain_chunk=False,
                               task_chunk_size=BATCHED_CHUNK)
    evaluator = ev.GeckoEvaluator(EVAL["model"], loss_eval, opt_cfg, ecfg,
                                  EVAL["store"], device=dev)
    chunks = -(-EVAL_TASKS // BATCHED_CHUNK)
    nondeterministic = []
    try:
        for route in ("fused", "split"):
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            mean_iou, task_ious, wall = evaluate(evaluator, EVAL["state"],
                                                 route)
            chained = EVAL[route]
            steps = chunks * EVAL_STEPS
            check("batched_eval_" + route, read_launches(),
                  steps if route == "fused" else 0,
                  abs(mean_iou - chained["iou"]) <= BATCHED_BF16_IOU_BAR
                  and abs(mean_iou - EVAL["jax_iou"]) <= EVAL_IOU_BAR,
                  "bf16, {} tasks in chunks of {} on the {} route | mean "
                  "IoU {:.4f} (chained: {:.4f}, gap {:+.4f}, bar {}; the "
                  "JAX package's {:.4f}, bar {}) | wall {:.2f} s, {:.3f} s "
                  "a task (chained: {:.3f}) | peak memory {:.2f} GB | task "
                  "IoUs {} (chained: {})".format(
                      EVAL_TASKS, BATCHED_CHUNK, route, mean_iou,
                      chained["iou"], mean_iou - chained["iou"],
                      BATCHED_BF16_IOU_BAR, EVAL["jax_iou"], EVAL_IOU_BAR,
                      wall, wall / EVAL_TASKS, chained["wall"] / EVAL_TASKS,
                      torch.cuda.max_memory_allocated(dev) / 1e9, task_ious,
                      chained["task_ious"]),
                  cheap=0 if route == "fused" else 2 * steps)
        del evaluator

        f32 = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5)
        f32.load_state_dict(load_jax_npz(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), EVAL_CHECKPOINT)))
        f32_state = il.init_model_state(f32, opt_cfg)
        fcfg = dataclasses.replace(ecfg, inner_iters=BATCHED_F32_EVAL_STEPS)
        evaluators = {chain: ev.GeckoEvaluator(
            f32, loss_eval, opt_cfg,
            dataclasses.replace(fcfg, chain_chunk=chain), EVAL["store"],
            device=dev) for chain in (True, False)}
        for route in ("fused", "split"):
            runs = {}
            for chain in (True, False):
                reset_launches()
                runs[chain] = evaluate(evaluators[chain], f32_state,
                                       route) + (read_launches(),)
            steps = chunks * BATCHED_F32_EVAL_STEPS
            counts["batched_eval_f32_chained_" + route] = runs[True][3]
            gap = runs[False][0] - runs[True][0]
            chained_steps = EVAL_TASKS * BATCHED_F32_EVAL_STEPS
            ok = runs[True][3] == expected(
                full_pass=chained_steps if route == "fused" else 0,
                cheap_pass=0 if route == "fused" else 2 * chained_steps,
                batch_norm_act=bn_launches(f32, chained_steps))
            check("batched_eval_f32_" + route, runs[False][3],
                  steps if route == "fused" else 0,
                  ok and abs(gap) <= BATCHED_IOU_BAR,
                  "float32, {} steps, {} tasks in chunks of {} on the {} "
                  "route against the chained evaluation | mean IoU {:.4f} "
                  "(chained: {:.4f}, gap {:+.5f}, bar {}) | wall {:.2f} s "
                  "(chained: {:.2f}; {} launches) | task IoUs {} (chained: "
                  "{})".format(
                      BATCHED_F32_EVAL_STEPS, EVAL_TASKS, BATCHED_CHUNK,
                      route, runs[False][0], runs[True][0], gap,
                      BATCHED_IOU_BAR, runs[False][2], runs[True][2],
                      runs[True][3], runs[False][1], runs[True][1]),
                  cheap=0 if route == "fused" else 2 * steps,
                  bn=bn_launches(f32, steps))
        del f32, evaluators
    finally:
        taug.PALLAS_FUSED_SINGLE_LAUNCH = True
    log("batched: the evaluations ran with deterministic algorithms; ops "
        "without one: {}".format(nondeterministic or "none"))

    workdir = tempfile.mkdtemp(prefix="batched_smoke_")
    try:
        argv = [a for a in TRAIN_ARGV
                if a not in ("--chain_tasks", "--chain_eval_chunk")]
        cut = argv.index("--task_chunk_size")
        argv = argv[:cut] + argv[cut + 2:] + [
            "--meta-iters", "1", "--checkpoint", workdir]
        args = args_lib.argument_parser().parse_args(argv)
        n_test = max(args.synthetic_tasks // 4, 1)
        expect, terms = _expected_batched_launches(
            args, args.synthetic_tasks - n_test, n_test)
        state, out, launches, wall, peak = _run_cli(argv, dev)
        with open(os.path.join(workdir, "phase_timings.jsonl")) as f:
            timings = json.loads(f.readline())
        finite = all(bool(v.isfinite().all()) for v in state.params.values())
        iou = _mean_iou(out)
        chained = TRAIN["timings"]
        model = EfficientLab(**args_lib.model_kwargs(args))
        check("batched_cli", launches, expect,
              finite and math.isfinite(iou),
              "run_metasegnet with no strategy flag (task axis; evaluation "
              "chunks of {}), 1 meta-iter | wall {:.2f} s | {:.3f} s a "
              "meta-step (chained, `train`: {:.3f}) | interval evaluation "
              "{:.2f} s (chained: {:.2f}) | mean IoU {:.4f} | peak memory "
              "{:.2f} GB (chained: {:.2f}) | expected launches {} = "
              "{}".format(
                  args.task_chunk_size, wall,
                  timings["meta_step"]["mean_s"],
                  chained["meta_step"]["mean_s"],
                  timings["eval_train"]["total_s"]
                  + timings["eval_test"]["total_s"],
                  chained["eval_train"]["total_s"]
                  + chained["eval_test"]["total_s"],
                  iou, peak / 1e9, TRAIN["peak"] / 1e9, expect, terms),
              bn=bn_launches(model, expect + _tail_steps(args, False)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("batched: the phase's wall {:.2f} s".format(time.time() - t_phase))
    if failed:
        raise AssertionError("the task axis did not run as expected: "
                             "{}".format(", ".join(failed)))
    return counts


# The `traces` phase: the early-stopping traces of UHO (and of the k-shot
# curves) on a task axis, `task_chunk_size` tasks a `full_pass` launch a
# step, against the chained traces in the same call.
TRACES_CUT = ["--pretrained", "--optimize_update_hyperparms_on_val_set",
              "--num_val_tasks", "4", "--num_configs_to_sample", "1",
              "--fss_1000"]
TRACES_CHUNK = 4           # (a): the val tasks on the task axis at a time
TRACES_F32_STEPS = 10      # (b): the library evaluator's depth (CLI: 80)
# (b)'s bar: every trace entry (a val mIoU after a step), batched against
# chained, in float32 with TF32 off and deterministic algorithms.
TRACES_BAR = 0.005
# (c): the mesh branches in a world of 2 (`--mesh_tasks 2`), cut to 2 val
# tasks of 5 steps.
TRACES_MESH_ARGV = ["--num_val_tasks", "2", "--max_steps", "5",
                    "--mesh_tasks", "2"]


def _chunk_count(n, chunk, ranks=1):
    """Launches a step for n tasks shared over `ranks` task ranks (each its
    contiguous ceil(n / ranks)), in chunks of ceil(chunk / ranks) a rank,
    summed over the ranks (`mesh.share`); chunk 1 chains them."""
    k = -(-n // ranks)
    c = -(-chunk // ranks)
    return sum(-(-max(0, min(n, (r + 1) * k) - min(n, r * k)) // c)
               for r in range(ranks))


@contextlib.contextmanager
def _recording(owner, name, record):
    """`owner.name` wrapped: each call's result appended to `record`, with
    its wall seconds and the kernels it launched."""
    import torch
    real = getattr(owner, name)

    def recorded(*args, **kwargs):
        torch.cuda.synchronize()
        before = read_launches()
        t0 = time.time()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        after = read_launches()
        record.append({"out": out, "wall": time.time() - t0,
                       "launches": {k: after[k] - before[k]
                                    for k in KERNELS}})
        return out

    setattr(owner, name, recorded)
    try:
        yield record
    finally:
        setattr(owner, name, real)


def _traces_argv(ckpt_dir, chained, uho=True):
    """The full-width UHO run: run.sh's model and adaptation flags from the
    checkpoint in `ckpt_dir`, with no strategy flag and --task_chunk_size
    4, or with --chain_eval_chunk; without `uho`, its flags but UHO's."""
    argv = [a for a in TRAIN_ARGV
            if a not in ("--chain_tasks", "--chain_eval_chunk")]
    cut = argv.index("--task_chunk_size")
    argv = argv[:cut] + argv[cut + 2:] + (
        TRACES_CUT if uho else ["--pretrained"]) + [
        "--task_chunk_size", str(TRACES_CHUNK), "--checkpoint", ckpt_dir]
    return argv + ["--chain_eval_chunk"] if chained else argv


def _expected_uho_launches(args, steps, ranks=1):
    """`full_pass` launches of a UHO run of the CLI, from its flags and the
    steps it chose: every (config, split) traces the val tasks for
    max_steps steps; then the final evaluation adapts 1 train task and the
    test tasks for the chosen steps, eval_samples times. Each in chunks of
    --task_chunk_size on a task axis, or one task a launch with
    --chain_eval_chunk (dropped under a mesh). Returns (total, its terms)."""
    chunk = 1 if args.chain_eval_chunk and not args.mesh_tasks \
        else args.task_chunk_size
    n_test = max(args.synthetic_tasks // 4, 1)
    splits = 1 if args.fss_1000 else 4
    val = _chunk_count(args.num_val_tasks, chunk, ranks)
    final = _chunk_count(1, chunk, ranks) + _chunk_count(n_test, chunk,
                                                         ranks)
    total = (args.num_configs_to_sample * splits * val * args.max_steps
             + args.eval_samples * final * steps)
    return total, "{} x {} x {} x {} + {} x {} x {}".format(
        args.num_configs_to_sample, splits, val, args.max_steps,
        args.eval_samples, final, steps)


def _save_pretrained_checkpoint(ckpt_dir, args):
    """The committed experiments/curve_v2_r4 weights in the CLI's model,
    saved as the checkpoint --pretrained restores."""
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils import checkpoint as ckpt
    model = EfficientLab(**args_lib.model_kwargs(args))
    model.load_state_dict(ckpt.load_jax_npz(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), EVAL_CHECKPOINT)))
    ckpt.save_checkpoint(ckpt_dir, il.init_model_state(
        model, il.OptimizerConfig("sgd")), 0)


def traces_rank(outdir):
    """One rank of the `traces` phase's world of 2 on the one card (run
    under `torch.distributed.run`): the UHO and the k-shot branches of the
    CLI with `--mesh_tasks 2` from the checkpoint in `outdir`; each rank
    writes the (names, steps, IoUs) its early-stopping evaluations
    returned, the k-shot (ks, mIoUs), its launches, walls and peaks.
    Both branches run with deterministic algorithms: each rank computes
    the k-shot curves of every task itself, and without them cuDNN's
    backward sums in another order from process to process (a k-shot
    mIoU once differed by 1.2e-6 between the ranks)."""
    import torch
    import torch.distributed as dist
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.cli import run_metasegnet
    from mliis_tpu_torch.meta import uho_eval
    from mliis_tpu_torch.parallel import mesh as mesh_lib
    dev = mesh_lib.init_world(MESH_RANKS, "cuda", log_fn=log)
    rank = dist.get_rank()
    result = {"rank": rank, "backend": dist.get_backend()}
    ckpt_dir = os.path.join(outdir, "ckpt")
    argv = _traces_argv(ckpt_dir, False) + TRACES_MESH_ARGV
    es, kshot, nondeterministic = [], [], []
    with deterministic_algorithms(nondeterministic), _recording(
            uho_eval.EarlyStoppingEvaluator, "evaluate_with_early_stopping",
            es):
        _, out, launches, wall, peak = _run_cli(argv, dev)
    steps = re.search(r"UHO estimated lr=\S+ steps=(\d+)", out)
    result["uho"] = {"es": [list(r["out"]) for r in es],
                     "es_launches": [r["launches"] for r in es],
                     "launches": launches, "wall": wall, "peak": peak,
                     "steps": int(steps.group(1)) if steps else None}
    workdir = os.path.join(outdir, "kshot{}".format(rank))
    os.makedirs(workdir)
    kshot_argv = _traces_argv(ckpt_dir, False, uho=False) + KSHOT_ARGV \
        + TRACES_MESH_ARGV
    with deterministic_algorithms(nondeterministic), _recording(
            run_metasegnet, "run_k_shot_learning_curves_experiment", kshot):
        _, out, launches, wall, peak = _run_cli(kshot_argv, dev,
                                                cwd=workdir)
    result["nondeterministic"] = nondeterministic
    args = args_lib.argument_parser().parse_args(kshot_argv)
    result["kshot"] = {"ks_mious": [list(map(list, r["out"]))
                                    for r in kshot],
                       "launches": launches, "wall": wall, "peak": peak,
                       "k_range": args.k_shot_k_range,
                       "eval_iters": args.eval_iters,
                       "csv": os.path.exists(os.path.join(
                           workdir, "k-shot-results.csv"))}
    with open(os.path.join(outdir, "rank{}.json".format(rank)), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def phase_traces(dev):
    """The early-stopping traces on a task axis, each run beside its
    chained run from this call:
    (a) the full-width UHO path through the CLI (`run_metasegnet.main`
        with the `train` phase's model and adaptation flags, float32, from
        the committed checkpoint's weights): 4 synthetic val tasks, 1 GP
        config, the CLI's --max_steps 80 and --min_steps 0, then the final
        evaluation at the chosen steps; once with no strategy flag and
        --task_chunk_size 4 (the 4 traces on a task axis: one `full_pass`
        launch at B = 4 x 8 a step) and once with --chain_eval_chunk.
        Exact launches, derived from the flags and the chosen steps;
        prints the seconds a traced task, the median best step, the mean
        best IoU and the peak memory of each;
    (b) `EarlyStoppingEvaluator` in float32 (TF32 off) on the `eval`
        phase's 12 held-out tasks with the committed checkpoint's weights,
        cut to TRACES_F32_STEPS steps, in chunks of 4 on a task axis and
        chained, from the same seed, with deterministic algorithms: every
        trace entry within TRACES_BAR;
    (c) the UHO and the k-shot branches of the CLI with --mesh_tasks 2 in a
        world of 2 on the one card over gloo (`torch.distributed.run`,
        `traces_rank`), cut to 2 val tasks of 5 steps: both ranks return
        the same (steps, IoU) lists and k-shot mIoUs, exact launches summed
        over the ranks.
    Returns {path: launches}."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import uho_eval
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils.checkpoint import load_jax_npz
    t_phase = time.time()
    workdir = tempfile.mkdtemp(prefix="traces_smoke_")
    counts, failed = {}, []

    def check(path, launches, full_pass, ok, text):
        # Each augmented step a forward and backward of the batch norms;
        # the traces and evaluations predict with the running moments.
        expect = expected(full_pass=full_pass,
                          batch_norm_act=bn_launches(model, full_pass))
        counts[path] = launches
        log("traces[{}]: {} | launches {} (expect {})".format(
            path, text, launches, expect))
        if launches != expect or not ok:
            failed.append(path)

    try:
        ckpt_dir = os.path.join(workdir, "ckpt")
        args = args_lib.argument_parser().parse_args(
            _traces_argv(ckpt_dir, False))
        model = EfficientLab(**args_lib.model_kwargs(args))
        _save_pretrained_checkpoint(ckpt_dir, args)
        runs = {}
        for name, chained in (("batched", False), ("chained", True)):
            argv = _traces_argv(ckpt_dir, chained)
            args = args_lib.argument_parser().parse_args(argv)
            es = []
            with _recording(uho_eval.EarlyStoppingEvaluator,
                            "evaluate_with_early_stopping", es):
                _, out, launches, wall, peak = _run_cli(argv, dev)
            steps = int(re.search(r"UHO estimated lr=\S+ steps=(\d+)",
                                  out).group(1))
            expect, terms = _expected_uho_launches(args, steps)
            traced = sum(len(r["out"][0]) for r in es)
            es_wall = sum(r["wall"] for r in es)
            best = [s for r in es for s in r["out"][1]]
            ious = [v for r in es for v in r["out"][2]]
            runs[name] = dict(best=best, ious=ious, wall=es_wall / traced)
            check("traces_cli_" + name, launches, expect,
                  traced == args.num_val_tasks
                  and all(math.isfinite(v) for v in ious),
                  "run_metasegnet UHO ({}), b0 rsd={} float32 {}^2, {} val "
                  "tasks x {} steps, 1 config | wall {:.2f} s | traces "
                  "{:.2f} s, {:.3f} s a traced task | median best step {} "
                  "| mean best IoU {:.4f} | chosen steps {} | peak memory "
                  "{:.2f} GB | expected launches {} = {}".format(
                      "chained, --chain_eval_chunk" if chained else
                      "task axis, --task_chunk_size {}".format(
                          args.task_chunk_size), tuple(args.rsd),
                      args.image_size, args.num_val_tasks, args.max_steps,
                      wall, es_wall, es_wall / traced,
                      int(np.median(best)), float(np.mean(ious)), steps,
                      peak / 1e9, expect, terms))
        log("traces: the CLI's strategies | best steps {} (chained {}) | "
            "best IoUs {} (chained {}) | {:.3f} s a traced task against "
            "{:.3f} ({:.2f}x)".format(
                runs["batched"]["best"], runs["chained"]["best"],
                ["{:.4f}".format(v) for v in runs["batched"]["ious"]],
                ["{:.4f}".format(v) for v in runs["chained"]["ious"]],
                runs["batched"]["wall"], runs["chained"]["wall"],
                runs["chained"]["wall"] / runs["batched"]["wall"]))

        f32 = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5)
        f32.load_state_dict(load_jax_npz(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), EVAL_CHECKPOINT)))
        f32.to(dev)
        opt_cfg = il.OptimizerConfig("sgd")
        state = il.init_model_state(f32, opt_cfg)
        traces, walls, runs_f32, nondeterministic = {}, {}, {}, []
        for chain in (False, True):
            evaluator = uho_eval.EarlyStoppingEvaluator(
                f32, il.LossConfig(dice=True, l2=True), opt_cfg,
                EVAL["store"], device=dev, task_chunk_size=TRACES_CHUNK,
                chain_chunk=chain)
            recorded = []
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            with _recording(evaluator, "_trace_tasks", recorded), \
                    deterministic_algorithms(nondeterministic):
                runs_f32[chain] = evaluator.evaluate_with_early_stopping(
                    state, torch.Generator(device=dev).manual_seed(EVAL_SEED),
                    min_steps=0, max_steps=TRACES_F32_STEPS,
                    inner_batch_size=8, lr=5e-4, aug_rate=0.5,
                    eval_all_tasks=True)
            torch.cuda.synchronize()
            walls[chain] = time.time() - t0
            counts["traces_f32_" + ("chained" if chain else "batched")] = \
                read_launches()
            traces[chain] = np.concatenate([r["out"] for r in recorded])
        gap = float(np.abs(traces[False] - traces[True]).max())
        chunks = _chunk_count(EVAL_TASKS, TRACES_CHUNK)
        chained_steps = EVAL_TASKS * TRACES_F32_STEPS
        check("traces_f32", counts["traces_f32_batched"],
              chunks * TRACES_F32_STEPS,
              gap <= TRACES_BAR and counts["traces_f32_chained"] == expected(
                  full_pass=chained_steps,
                  batch_norm_act=bn_launches(f32, chained_steps)),
              "EarlyStoppingEvaluator float32, {} tasks x {} steps, chunks "
              "of {} against chained (deterministic; ops without a "
              "deterministic form: {}) | largest trace gap {:.5f} (bar {}) "
              "| best steps {} (chained {}) | wall {:.2f} s (chained {:.2f}, "
              "{} launches)".format(
                  EVAL_TASKS, TRACES_F32_STEPS, TRACES_CHUNK,
                  nondeterministic or "none", gap, TRACES_BAR,
                  runs_f32[False][1], runs_f32[True][1], walls[False],
                  walls[True], counts["traces_f32_chained"]["full_pass"]))
        del f32, state

        outdir = os.path.join(workdir, "w2")
        os.makedirs(outdir)
        args = args_lib.argument_parser().parse_args(
            _traces_argv(os.path.join(outdir, "ckpt"), False)
            + TRACES_MESH_ARGV)
        _save_pretrained_checkpoint(os.path.join(outdir, "ckpt"), args)
        t0 = time.time()
        code = _launch_ranks(outdir, timeout=600, entry="--traces-rank")
        log("traces: the world of 2 ran {:.2f} s, exit code {}".format(
            time.time() - t0, code))
        if code != 0:
            raise AssertionError("the world of 2 failed")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, "rank{}.json".format(r))) as f:
                ranks.append(json.load(f))

        def summed(part):
            return {k: sum(r[part]["launches"][k] for r in ranks)
                    for k in KERNELS}

        uho = [r["uho"] for r in ranks]
        expect, terms = _expected_uho_launches(args, uho[0]["steps"],
                                               MESH_RANKS)
        check("traces_mesh_uho", summed("uho"), expect,
              {r["backend"] for r in ranks} == {"gloo"}
              and uho[0]["es"] == uho[1]["es"],
              "run_metasegnet UHO --mesh_tasks 2 on gloo, {} val tasks x {} "
              "steps | (names, best steps, IoUs) per rank {} | walls {} s | "
              "peak memory per rank {} GB | expected launches {} = "
              "{}".format(
                  args.num_val_tasks, args.max_steps,
                  [r["es"] for r in uho],
                  ["{:.2f}".format(r["wall"]) for r in uho],
                  ["{:.2f}".format(r["peak"] / 1e9) for r in uho], expect,
                  terms))
        kshot = [r["kshot"] for r in ranks]
        n_test = max(args.synthetic_tasks // 4, 1)
        per_rank = (args.eval_samples * n_test * len(kshot[0]["k_range"])
                    * kshot[0]["eval_iters"])
        check("traces_mesh_kshot", summed("kshot"), MESH_RANKS * per_rank,
              kshot[0]["ks_mious"] == kshot[1]["ks_mious"]
              and kshot[0]["csv"] and not kshot[1]["csv"],
              "run_metasegnet k-shot --mesh_tasks 2 on gloo, k {} at {} "
              "steps on {} test tasks (each rank all of them) | (ks, "
              "mIoUs) per rank {} | CSV written by rank 0 alone {} | walls "
              "{} s | deterministic; ops without a deterministic form: "
              "{}".format(
                  kshot[0]["k_range"], kshot[0]["eval_iters"], n_test,
                  [r["ks_mious"] for r in kshot],
                  kshot[0]["csv"] and not kshot[1]["csv"],
                  ["{:.2f}".format(r["wall"]) for r in kshot],
                  sorted({m for r in ranks for m in r["nondeterministic"]})
                  or "none"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("traces: the phase's wall {:.2f} s".format(time.time() - t_phase))
    if failed:
        raise AssertionError("the early-stopping traces did not run as "
                             "expected: {}".format(", ".join(failed)))
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
    `full_pass` kernel event per launch and the phases' ranges (the
    artifact, a trace, against the module on the batch norms' composition
    within 1e-5, and against the module's kernels within
    SPATIAL_PROB_BAR). Returns {run: launches}."""
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
    # The skip decoder's batch norms normalize by the batch in every mode:
    # each prediction forward launches them too.
    decoders = EfficientLab(**args_lib.model_kwargs(args))
    n_test = max(args.synthetic_tasks // 4, 1)
    counts, failed = {}, []

    def check(run, launches, full_pass, ok, text, steps, predictions):
        expect = expected(full_pass=full_pass, batch_norm_act=bn_launches(
            decoders, steps, predictions))
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
                  terms), expect + _tail_steps(args),
              _predictions(args, args.synthetic_tasks - n_test, n_test))

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
        # The artifact is a trace, which takes the batch norms'
        # composition: it is held to the module's forward on that route;
        # the module's own forward on the card runs the skip decoder's
        # norms through `batch_norm_act`, whose exact moments move the
        # probabilities as a reordered sum does (SPATIAL_PROB_BAR).
        program = torch.export.load(artifact).module()
        served, kernels = {}, {}
        for b in (1, 5):
            images = torch.rand(
                (b, args.image_size, args.image_size, 3),
                generator=torch.Generator(device=dev).manual_seed(b),
                device=dev) * 255
            with torch.no_grad():
                probs = program(images)
                with _composition_route():
                    served[b] = float((probs - model(
                        images, train=False)[1]).abs().max())
                kernels[b] = float((probs - model(
                    images, train=False)[1]).abs().max())
        check("decoders[eval-only]", launches, expect,
              fine_tuned and max(served.values()) <= 1e-5
              and max(kernels.values()) <= SPATIAL_PROB_BAR,
              "--pretrained, fine-tuned checkpoints and the serving "
              "artifact | wall {:.2f} s | {} fine-tuned checkpoints for "
              "tasks {} read back and differ from the meta-learned state "
              "{} | artifact {:.1f} MB, max |probs - module's| (the "
              "composition's route) at batch 1 {:.3g}, at batch 5 {:.3g} "
              "(1e-5); against the module's kernels {:.3g}, {:.3g} ({}) | "
              "peak memory {:.2f} GB".format(
                  wall, len(found), sorted(tasks), fine_tuned,
                  os.path.getsize(artifact) / 1e6, served[1], served[5],
                  kernels[1], kernels[5], SPATIAL_PROB_BAR, peak / 1e9),
              expect, args.eval_samples * (1 + n_test))

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
                  sorted(ranges & phases), peak / 1e9, expect, terms),
              expect + _tail_steps(pargs),
              _predictions(pargs, pargs.synthetic_tasks - p_test, p_test))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("decoders: the phase's wall {:.2f} s".format(time.time() - t0))
    if failed:
        raise AssertionError("the decoders' CLI runs did not run as "
                             "expected: {}".format(", ".join(failed)))
    return counts


# The `mesh` phase: the sharded strategies on the one card. The `train`
# phase's run cut to 1 meta-iter (the meta-step keeps its full depth of
# 5 x 59 steps).
MESH_CUT = ["--meta-iters", "1"]
MESH_STEP_SEED = 1234      # the library meta-steps' draw seed
# The library meta-steps' depth: 10 inner steps a task (run.sh: 59), cut
# to keep chip_smoke.py within 900 s.
MESH_STEP_ITERS = 10
MESH_JOINT_STEPS, MESH_JOINT_BATCH = 2, 64
MESH_RANKS = 2
# Bars on the largest difference of a state from the unsharded one, as a
# share of the largest change the unsharded step made: the order of the
# sums differs, and cuDNN's backward is not bitwise repeatable. Measured on
# an H100 80GB HBM3 at 700 W: 6.0e-7 (task axis), 3.5e-7 (1x2), 2.7e-6
# (joint); the bars leave a factor of 16 to 37. The CLIs' mean IoUs were
# equal.
MESH_TASK_BAR, MESH_DATA_BAR, MESH_JOINT_BAR = 1e-5, 1e-5, 1e-4
MESH_IOU_BAR = 1e-3
# The 1x2 step with the rank's slots on a task axis against the same step
# chained (`chain_local`), as a share of the chained step's largest change:
# a grouped conv sums in another order than a plain one.
MESH_BATCHED_BAR = 1e-4


def _mesh_meta_setup(dev, bn_axis_name=None):
    """The `train` phase's width for a library meta-step: EfficientLab-b0
    rsd=(2, 4) in float32 with dropout and drop-connect at 0 (their streams
    differ by rank on the data axis), weights from seed 0; its store, the
    FOMAML* config, the step's draws and the initial state."""
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.0,
                         bn_axis_name=bn_axis_name)
    getattr(model, model.backbone_name).drop_connect_rate = 0.0
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    imgs, msks, counts = make_synthetic_store(
        num_tasks=8, examples_per_task=10, image_size=224,
        seed=0).to_torch(dev)
    cfg = lr.MetaTrainConfig(num_shots=10, inner_batch_size=8,
                             inner_iters=MESH_STEP_ITERS, meta_batch_size=5,
                             foml=True, tail_shots=5, aug_rate=0.5)
    state = il.init_model_state(model, il.OptimizerConfig("sgd"))
    return model, (imgs, msks, counts), cfg, state


def _mesh_joint_setup(dev, bn_axis_name=None):
    """The joint path at its published width: 1000 classes (1001
    channels), b0 rsd=(2,) float32, 224^2, batch 64, SGD + l2 +
    augmentation; the store cut to 1 image a class (1000 examples); dropout
    and drop-connect at 0; weights from seed 0; the steps' batches and
    seeds from seed 5."""
    import numpy as np
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.joint import trainer as jt
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    ds = jt.joint_dataset_from_task_store(make_synthetic_store(
        num_tasks=1000, examples_per_task=1, image_size=224, seed=0))
    model = EfficientLab(n_classes=ds.num_classes, rsd=(2,),
                         final_layer_dropout_rate=0.0,
                         bn_axis_name=bn_axis_name)
    getattr(model, model.backbone_name).drop_connect_rate = 0.0
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    rng = np.random.default_rng(5)
    batches = [(torch.as_tensor(rng.integers(0, ds.num_examples,
                                             MESH_JOINT_BATCH), device=dev),
                torch.as_tensor(rng.integers(0, 2 ** 31 - 1,
                                             MESH_JOINT_BATCH)
                                .astype(np.int32), device=dev))
               for _ in range(MESH_JOINT_STEPS)]
    cfg = jt.JointTrainConfig(batch_size=MESH_JOINT_BATCH, augment=True,
                              l2=True)
    return model, ds, cfg, batches, il.init_model_state(
        model, il.OptimizerConfig("sgd"))


def _run_joint(model, ds, cfg, batches, state, dev, mesh=None):
    """The joint steps from `state`; returns (state on the CPU, seconds a
    step, launches, peak bytes)."""
    import torch
    from mliis_tpu_torch.joint import trainer as jt
    from mliis_tpu_torch.meta import inner_loop as il
    trainer = jt.JointTrainer(model, ds, ds, cfg, il.OptimizerConfig("sgd"),
                              device=dev, log_fn=lambda *a: None, mesh=mesh)
    il.load_state(model, state)
    opt = state.opt
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    seconds = []
    for idx, seeds in batches:
        t0 = time.time()
        opt, _ = trainer.train_step(opt, idx, seeds, 0.005, gen)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = read_launches()
    return (_cpu_state(il.snapshot(model, opt)), seconds, launches,
            torch.cuda.max_memory_allocated(dev))


def _cpu_state(state):
    """{"params/..", "batch_stats/..", "opt_v/.."}: tensors on the CPU."""
    out = {"params/" + k: v.detach().cpu() for k, v in state.params.items()}
    out.update({"batch_stats/" + k: v.detach().cpu()
                for k, v in state.batch_stats.items()})
    out.update({"opt_v/" + k: v.detach().cpu()
                for k, v in state.opt.v.items()})
    return out


def _state_gap(a, b, start):
    """(largest |a - b| over every tensor, the same as a share of the
    largest |b - start|)."""
    gap = max(float((a[k] - b[k]).abs().max()) for k in b)
    moved = max(float((b[k] - start[k]).abs().max()) for k in b)
    return gap, gap / moved if moved else math.inf


def _mean_iou(out):
    line = [ln for ln in out.splitlines()
            if ln.startswith("Mean IoU over all meta-test tasks:")]
    return float(line[0].split(":")[1]) if line else math.nan


def _mesh_cli_argv(workdir, ranks):
    return TRAIN_ARGV + MESH_CUT + ["--mesh_tasks", str(ranks),
                                    "--checkpoint", workdir]


def mesh_rank(outdir):
    """One rank of the `mesh` phase's world of 2 on the one card (run under
    `torch.distributed.run`): the meta-training CLI with `--mesh_tasks 2`,
    a 1x2 (task, data) library meta-step with the sync-BN model and the
    data-parallel joint steps. Each part's kernel counts are set to 0
    before it and summed over the ranks after it; each rank writes what it
    measured to `outdir`, rank 0 its states too."""
    import torch
    import torch.distributed as dist
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.meta.inner_loop import LossConfig, OptimizerConfig
    from mliis_tpu_torch.parallel import mesh as mesh_lib
    dev = mesh_lib.init_world(MESH_RANKS, "cuda", log_fn=log)
    rank = dist.get_rank()
    result = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    states = {}

    def summed(launches):
        t = torch.tensor([float(launches[k]) for k in KERNELS], device=dev)
        dist.all_reduce(t)
        return {k: int(v) for k, v in zip(KERNELS, t.tolist())}

    ckpt_dir = os.path.join(outdir, "cli_w2")
    state, out, launches, wall, peak = _run_cli(
        _mesh_cli_argv(ckpt_dir, MESH_RANKS), dev)
    result["cli"] = {"launches": summed(launches), "rank_launches": launches,
                     "wall": wall, "peak": peak, "iou": _mean_iou(out)}
    if rank == 0:
        with open(os.path.join(ckpt_dir, "phase_timings.jsonl")) as f:
            result["cli"]["timings"] = json.loads(f.readline())
        states["cli"] = _cpu_state(state)
    del state

    mesh = mesh_lib.make_task_data_mesh(1, MESH_RANKS, dev)
    model, (imgs, msks, counts), cfg, state = _mesh_meta_setup(
        dev, mesh_lib.DATA_AXIS)
    # The rank's slots on a task axis beside the data axis (the default),
    # then one after another (`chain_local`), from the same draws.
    for name, chain_local in (("step_1x2", False),
                              ("step_1x2_chained", True)):
        step = mesh_lib.make_sharded_train_step(
            model, LossConfig(), OptimizerConfig("sgd"), cfg, mesh,
            chain_local=chain_local)
        draws = lr.draw_meta_step(MESH_STEP_SEED, counts, cfg, 10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.time()
        out_state = step(state, imgs, msks, draws, 0.1, 5e-4)
        torch.cuda.synchronize()
        launches = read_launches()
        result[name] = {"launches": summed(launches),
                        "rank_launches": launches,
                        "wall": time.time() - t0,
                        "peak": torch.cuda.max_memory_allocated(dev)}
        if rank == 0:
            states[name] = _cpu_state(out_state)
        del out_state, step, draws
        torch.cuda.empty_cache()
    del model, state, imgs, msks
    torch.cuda.empty_cache()

    jmesh = mesh_lib.make_data_mesh(MESH_RANKS, dev)
    model, ds, jcfg, batches, state = _mesh_joint_setup(dev,
                                                        mesh_lib.DATA_AXIS)
    jstate, seconds, launches, peak = _run_joint(model, ds, jcfg, batches,
                                                 state, dev, jmesh)
    result["joint"] = {"launches": summed(launches),
                       "rank_launches": launches, "seconds": seconds,
                       "peak": peak}
    if rank == 0:
        states["joint"] = jstate
        torch.save(states, os.path.join(outdir, "states.pt"))
    with open(os.path.join(outdir, "rank{}.json".format(rank)), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def _launch_ranks(outdir, timeout, entry="--mesh-rank"):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2
    chip_smoke.py <entry> outdir`, its whole process group killed if it
    outlives `timeout`; returns the exit code."""
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(MESH_RANKS), os.path.abspath(__file__),
         entry, outdir], start_new_session=True)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise


def phase_mesh(dev):
    """The sharded strategies (parallel/mesh.py) on the one card.

    1. A world of 1 on NCCL: the meta-training CLI with `--mesh_tasks 1`
       (the `train` phase's flags and store, 1 meta-iter, 10 evaluation
       steps a task); then one library meta-step unsharded and one through
       `make_sharded_train_step` on a task mesh of 1, from the same state
       and draw seed (dropout and drop-connect 0), and 2 unsharded joint
       steps at batch 64 (the references of part 2).
    2. A world of 2 on the card over gloo (`torch.distributed.run`): the
       CLI with `--mesh_tasks 2`, a 1x2 (task, data) meta-step with the
       sync-BN model and 2 data-parallel joint steps (32 a rank).
    Each sharded state is held against its unsharded one (`_state_gap`),
    the CLIs' mean IoUs against each other, and each run's launches are
    exact: `full_pass` summed over the ranks equals the unsharded count on
    the task axis and twice it on the data axis (each rank augments its
    half of every batch); `fused_light_augment` is 1 a rank a step.
    Returns {path: launches}."""
    import shutil
    import tempfile
    import torch
    from mliis_tpu_torch.cli import args as args_lib
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.meta.inner_loop import (LossConfig, OptimizerConfig,
                                                 init_model_state)
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.parallel import mesh as mesh_lib
    t_phase = time.time()
    workdir = tempfile.mkdtemp(prefix="mesh_smoke_")
    counts, failed = {}, []

    def check(path, launches, expect, ok, text):
        counts[path] = launches
        log("mesh[{}]: {} | launches {} (expect {})".format(
            path, text, launches, expect))
        if launches != expect or not ok:
            failed.append(path)

    try:
        argv = _mesh_cli_argv(os.path.join(workdir, "cli_w1"), 1)
        args = args_lib.argument_parser().parse_args(argv)
        n_test = max(args.synthetic_tasks // 4, 1)
        cli_expect, terms = _expected_train_launches(
            args, args.synthetic_tasks - n_test, n_test)
        init = EfficientLab(**args_lib.model_kwargs(args))
        cli_expect = expected(full_pass=cli_expect, batch_norm_act=bn_launches(
            init, cli_expect + _tail_steps(args)))
        init.reset_parameters(torch.Generator().manual_seed(args.seed))
        cli_start = _cpu_state(init_model_state(init,
                                                OptimizerConfig("sgd")))
        state_w1, out, launches, wall, peak = _run_cli(argv, dev)
        with open(os.path.join(workdir, "cli_w1",
                               "phase_timings.jsonl")) as f:
            t_w1 = json.loads(f.readline())
        iou_w1 = _mean_iou(out)
        cli_w1 = _cpu_state(state_w1)
        del state_w1
        backend_w1 = re.search(r"torch.distributed: a world of 1 on (\w+)",
                               out)
        check("mesh_cli_w1", launches, cli_expect,
              backend_w1 is not None and backend_w1.group(1) == "nccl"
              and math.isfinite(iou_w1),
              "run_metasegnet --mesh_tasks 1 | backend {} | wall {:.2f} s | "
              "{:.3f} s a meta-step | mean IoU {:.4f} | peak memory {:.2f} GB"
              " | expected launches {}".format(
                  backend_w1.group(1) if backend_w1 else None, wall,
                  t_w1["meta_step"]["mean_s"], iou_w1, peak / 1e9, terms))

        model, (imgs, msks, mcounts), cfg, state = _mesh_meta_setup(dev)
        # Chained: every task's steps, its raw tail too, run the batch
        # norms forward and backward.
        step_expect = expected(full_pass=5 * (MESH_STEP_ITERS - 1),
                               batch_norm_act=bn_launches(
                                   model, 5 * MESH_STEP_ITERS))
        start = _cpu_state(state)
        walls, refs = {}, {}

        def library_step(name, step, what):
            draws = lr.draw_meta_step(MESH_STEP_SEED, mcounts, cfg, 10)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.time()
            refs[name] = _cpu_state(step(state, imgs, msks, draws, 0.1,
                                         5e-4))
            torch.cuda.synchronize()
            walls[name] = time.time() - t0
            launches = read_launches()
            gap = _state_gap(refs[name], refs["unsharded"], start)
            check("mesh_step_" + name, launches, step_expect,
                  gap[1] <= MESH_TASK_BAR,
                  "library meta-step ({}) | wall {:.3f} s | largest gap to "
                  "the unsharded step {:.3g} ({:.3g} of its largest change; "
                  "bar {})".format(what, walls[name], gap[0], gap[1],
                                   MESH_TASK_BAR))

        library_step("unsharded", lr.make_chained_train_step(
            model, LossConfig(), OptimizerConfig("sgd"), cfg),
            "chained, no mesh")
        with mesh_lib.world(1, dev, workdir, log_fn=log):
            library_step("w1", mesh_lib.make_sharded_train_step(
                model, LossConfig(), OptimizerConfig("sgd"), cfg,
                mesh_lib.make_task_mesh(1, dev), chain_local=True),
                "make_sharded_train_step, task mesh of 1 on NCCL")
        del model, state, imgs, msks
        torch.cuda.empty_cache()

        model, ds, jcfg, batches, state = _mesh_joint_setup(dev)
        jstart = _cpu_state(state)
        joint_ref, j_seconds, launches, j_peak = _run_joint(
            model, ds, jcfg, batches, state, dev)
        check("mesh_joint_unsharded", launches,
              expected(fused_light_augment=MESH_JOINT_STEPS,
                       resized_ce=2 * MESH_JOINT_STEPS,
                       batch_norm_act=bn_launches(model, MESH_JOINT_STEPS)),
              True,
              "joint steps at batch 64, 1001 channels, unsharded | seconds "
              "a step {} | peak memory {:.2f} GB".format(
                  ["{:.4f}".format(s) for s in j_seconds], j_peak / 1e9))
        del model, ds, batches, state
        torch.cuda.empty_cache()

        outdir = os.path.join(workdir, "w2")
        os.makedirs(outdir)
        t0 = time.time()
        code = _launch_ranks(outdir, timeout=600)
        log("mesh: the world of 2 ran {:.2f} s, exit code {}".format(
            time.time() - t0, code))
        if code != 0:
            raise AssertionError("the world of 2 failed")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, "rank{}.json".format(r))) as f:
                ranks.append(json.load(f))
        states = torch.load(os.path.join(outdir, "states.pt"))
        backends = {r["backend"] for r in ranks}
        log("mesh: world of 2 | backend {} | devices {}".format(
            sorted(backends), [r["device"] for r in ranks]))
        if backends != {"gloo"}:
            failed.append("mesh_backend_w2")

        cli = ranks[0]["cli"]
        gap = _state_gap(states["cli"], cli_w1, cli_start)
        check("mesh_cli_w2", cli["launches"], cli_expect,
              abs(cli["iou"] - iou_w1) <= MESH_IOU_BAR
              and gap[1] <= MESH_TASK_BAR,
              "run_metasegnet --mesh_tasks 2 | wall {:.2f} s | {:.3f} s a "
              "meta-step (world of 1: {:.3f}) | mean IoU {:.4f} (world of "
              "1: {:.4f}; bar {}) | largest gap to the world of 1's state "
              "{:.3g} ({:.3g} of its largest change; bar {}) | per-rank "
              "full_pass launches {} | peak memory per rank {} GB".format(
                  cli["wall"], cli["timings"]["meta_step"]["mean_s"],
                  t_w1["meta_step"]["mean_s"], cli["iou"], iou_w1,
                  MESH_IOU_BAR, gap[0], gap[1], MESH_TASK_BAR,
                  [r["cli"]["rank_launches"]["full_pass"] for r in ranks],
                  ["{:.2f}".format(r["cli"]["peak"] / 1e9) for r in ranks]))

        # A rank's 5 slots on a task axis: one launch an augmented step;
        # chained, one a slot and step.
        chained_gap = _state_gap(states["step_1x2"],
                                 states["step_1x2_chained"], start)
        for name, per_rank, what in (
                ("step_1x2", MESH_STEP_ITERS - 1, "slots on a task axis"),
                ("step_1x2_chained", 5 * (MESH_STEP_ITERS - 1),
                 "slots chained, chain_local")):
            gap = _state_gap(states[name], refs["unsharded"], start)
            ok = gap[1] <= MESH_DATA_BAR and all(
                r[name]["rank_launches"]["full_pass"] == per_rank
                for r in ranks)
            if name == "step_1x2":
                ok = ok and chained_gap[1] <= MESH_BATCHED_BAR
            check("mesh_" + name, ranks[0][name]["launches"],
                  expected(full_pass=MESH_RANKS * per_rank), ok,
                  "1x2 (task, data) meta-step, sync-BN, {} | wall {} s "
                  "(unsharded {:.3f}, task mesh of 1 {:.3f}) | largest gap "
                  "to the unsharded step {:.3g} ({:.3g} of its largest "
                  "change; bar {}) | peak memory per rank {} GB | per-rank "
                  "full_pass launches {}".format(
                      what, ["{:.3f}".format(r[name]["wall"]) for r in ranks],
                      walls["unsharded"], walls["w1"], gap[0], gap[1],
                      MESH_DATA_BAR, ["{:.2f}".format(r[name]["peak"] / 1e9)
                                      for r in ranks],
                      [r[name]["rank_launches"]["full_pass"]
                       for r in ranks]))
        log("mesh: the 1x2 step on a task axis against chain_local | "
            "largest gap {:.3g} ({:.3g} of the chained step's largest "
            "change; bar {}) | s a step per rank {} against {}".format(
                chained_gap[0], chained_gap[1], MESH_BATCHED_BAR,
                ["{:.3f}".format(r["step_1x2"]["wall"]) for r in ranks],
                ["{:.3f}".format(r["step_1x2_chained"]["wall"])
                 for r in ranks]))

        js = ranks[0]["joint"]
        gap = _state_gap(states["joint"], joint_ref, jstart)
        check("mesh_joint_w2", js["launches"],
              expected(fused_light_augment=MESH_RANKS * MESH_JOINT_STEPS,
                       resized_ce=2 * MESH_RANKS * MESH_JOINT_STEPS),
              gap[1] <= MESH_JOINT_BAR and all(
                  r["joint"]["rank_launches"]["fused_light_augment"]
                  == MESH_JOINT_STEPS for r in ranks),
              "data-parallel joint steps, 32 a rank | seconds a step per "
              "rank {} (unsharded {}) | largest gap to the unsharded steps "
              "{:.3g} ({:.3g} of their largest change; bar {}) | peak "
              "memory per rank {} GB (unsharded {:.2f})".format(
                  [["{:.4f}".format(s) for s in r["joint"]["seconds"]]
                   for r in ranks], ["{:.4f}".format(s) for s in j_seconds],
                  gap[0], gap[1], MESH_JOINT_BAR,
                  ["{:.2f}".format(r["joint"]["peak"] / 1e9)
                   for r in ranks], j_peak / 1e9))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("mesh: the phase's wall {:.2f} s".format(time.time() - t_phase))
    if failed:
        raise AssertionError("the sharded strategies did not run as "
                             "expected: {}".format(", ".join(failed)))
    return counts


# The `spatial` phase: the image H axis split over the ranks of a world of
# 2 on the one card, at a resolution far above the 224^2 benchmark.
SPATIAL_SIZE, SPATIAL_BATCH, SPATIAL_LR = 1024, 8, 5e-4
# Bars: probabilities within 1e-4 abs; the step's state within 1e-4 of its
# largest change (the skip decoder's float32 batch moments move by a few
# 1e-5 with the order of the sums alone, PERF.md).
SPATIAL_PROB_BAR, SPATIAL_STATE_BAR = 1e-4, 1e-4
SPATIAL_RUNS = ("forward", "step", "decoders")


def _spatial_model(dev, decoders):
    """EfficientLab-b0 rsd=(2, 4) in float32 with run.sh's dropout 0.5 and
    the default drop-connect 0.2 (with ASPP and skip decoding when
    `decoders`), weights from seed 0."""
    import torch
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    model = EfficientLab(rsd=(2, 4), spatial_pyramid_pooling=decoders,
                         skip_decoding=decoders, final_layer_dropout_rate=0.5)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(dev)


class _AllReduceCount:
    """`torch.distributed.all_reduce` counted while the block runs: calls,
    bytes and the host seconds spent inside them."""

    def __init__(self):
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def __enter__(self):
        import torch.distributed as dist
        self.inner = dist.all_reduce

        def counted(tensor, *args, **kwargs):
            self.calls += 1
            self.bytes += tensor.numel() * tensor.element_size()
            t0 = time.time()
            try:
                return self.inner(tensor, *args, **kwargs)
            finally:
                self.seconds += time.time() - t0

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_reduce = self.inner


def _spatial_runs(dev, mesh=None, runs=SPATIAL_RUNS):
    """The phase's `runs`, whole (no mesh) or on this rank's rows of
    `mesh`: the eval forward, one loss-and-grad SGD step and the decoders'
    eval forward. Returns ({run: wall, peak, launches, all-reduces},
    {"probs", "state", "decoders": tensors on the CPU, gathered})."""
    import contextlib
    import torch
    from mliis_tpu_torch.data.synthetic import make_synthetic_store
    from mliis_tpu_torch.meta import inner_loop as il
    from mliis_tpu_torch.parallel import spatial
    store = make_synthetic_store(num_tasks=1,
                                 examples_per_task=SPATIAL_BATCH,
                                 image_size=SPATIAL_SIZE, seed=0)
    images = torch.as_tensor(store.images[0]).float().to(dev)
    fg = torch.as_tensor(store.masks[0]).float().to(dev) / 255.0
    masks = torch.stack([1.0 - fg, fg], -1)
    height, width = images.shape[1:3]
    if mesh is not None:
        images = spatial.shard_spatial(images, mesh).contiguous()
        masks = spatial.shard_spatial(masks, mesh).contiguous()
    results, arrays = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.time()
        with _AllReduceCount() as count:
            out = fn()
            torch.cuda.synchronize()
        results[name] = {"wall": time.time() - t0,
                         "peak": torch.cuda.max_memory_allocated(dev),
                         "launches": read_launches(),
                         "all_reduces": count.calls,
                         "all_reduce_bytes": count.bytes,
                         "all_reduce_s": count.seconds}
        return out

    def whole(probs):
        if mesh is not None:
            probs = spatial.gather_spatial(probs, mesh, height)
        return probs.cpu()

    def forward_of(model):
        if mesh is not None:
            return spatial.make_spatial_forward(model, mesh)

        def forward(x):
            with torch.no_grad():
                return model(x, train=False)[1]
        return forward

    model = _spatial_model(dev, False)
    forward = forward_of(model)
    if "forward" in runs:
        forward(images)  # warm-up: cuDNN's first calls pick algorithms
        arrays["probs"] = whole(timed("forward", lambda: forward(images)))
    sgd = il.OptimizerConfig("sgd")
    start = il.init_model_state(model, sgd)
    loss_and_grad = il.make_loss_and_grad(model, il.LossConfig())

    def step(apply=True):
        gen = torch.Generator(device=dev).manual_seed(3)
        bound = (spatial.bound(mesh, height, width) if mesh is not None
                 else contextlib.nullcontext())
        with bound:
            loss, grads = loss_and_grad(images, masks, gen, None)
        if not apply:
            return None
        return loss, il.apply_optimizer_(list(model.parameters()), grads,
                                         start.opt, SPATIAL_LR, sgd)

    if "step" in runs:
        step(apply=False)  # warm-up, then the weights and stats put back
        il.load_state(model, start)
        loss, opt = timed("step", step)
        results["step"]["loss"] = float(loss)
        arrays["state"] = _cpu_state(il.snapshot(model, opt))
    del model, forward, start, loss_and_grad
    torch.cuda.empty_cache()
    if "decoders" not in runs:
        return results, arrays
    model = _spatial_model(dev, True)
    forward = forward_of(model)
    forward(images)
    arrays["decoders"] = whole(timed("decoders", lambda: forward(images)))
    if mesh is None:
        # The same forward on the batch in reverse order: how far the order
        # of float32 sums alone moves the skip decoder's batch moments.
        arrays["decoders_reordered"] = forward(images.flip(0)).flip(0).cpu()
    del model, forward
    torch.cuda.empty_cache()
    return results, arrays


def spatial_rank(outdir):
    """One rank of the `spatial` phase's world of 2 on the one card (run
    under `torch.distributed.run`): the three runs on this rank's rows.
    Each rank writes what it measured to `outdir`, rank 0 the gathered
    probabilities and the new state too; the kernel counts are summed
    over the ranks."""
    import torch
    import torch.distributed as dist
    from mliis_tpu_torch.parallel import spatial
    mesh = spatial.make_spatial_mesh(MESH_RANKS, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    results, arrays = _spatial_runs(dev, mesh)
    for run in SPATIAL_RUNS:
        launches = results[run]["launches"]
        t = torch.tensor([float(launches[k]) for k in KERNELS], device=dev)
        dist.all_reduce(t)
        results[run]["launches"] = {k: int(v)
                                    for k, v in zip(KERNELS, t.tolist())}
    rank = dist.get_rank()
    results["backend"] = dist.get_backend()
    results["device"] = str(dev)
    if rank == 0:
        torch.save(arrays, os.path.join(outdir, "arrays.pt"))
    with open(os.path.join(outdir, "rank{}.json".format(rank)), "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()
    return 0


def phase_spatial(dev):
    """The spatial partitioning (parallel/spatial.py) on the one card.

    1. A world of 1 (no mesh): the eval forward of EfficientLab-b0 rsd=(2,
       4) on 8 images at 1024^2, one loss-and-grad SGD step from the same
       weights, and the eval forward with ASPP and skip decoding.
    2. A world of 2 on the card over gloo (`torch.distributed.run`): the
       same runs on H shards, the probabilities gathered.
    Each sharded result is held against the world of 1's: probabilities
    within SPATIAL_PROB_BAR abs, the step's state (params, running stats)
    within SPATIAL_STATE_BAR of its largest change and the loss within
    SPATIAL_STATE_BAR relative. No kernel is launched on the world of 2's
    runs (a batch norm under a spatial context takes the composition); the
    world of 1's step runs every batch norm forward and backward through
    `batch_norm_act`, and its decoders' eval forward the skip decoder's.
    Returns {path: launches}."""
    import shutil
    import tempfile
    import torch
    from mliis_tpu_torch.meta.inner_loop import (OptimizerConfig,
                                                 init_model_state)
    t_phase = time.time()
    workdir = tempfile.mkdtemp(prefix="spatial_smoke_")
    counts, failed = {}, []
    none = {k: 0 for k in KERNELS}
    w1_expect = {
        "forward": none,
        "step": expected(batch_norm_act=bn_launches(
            _spatial_model("cpu", False), 1)),
        "decoders": expected(batch_norm_act=bn_launches(
            _spatial_model("cpu", True), 0, 1))}
    try:
        start = _cpu_state(init_model_state(_spatial_model("cpu", False),
                                            OptimizerConfig("sgd")))
        w1, a1 = _spatial_runs(dev)
        for run in SPATIAL_RUNS:
            counts["spatial_w1_" + run] = w1[run]["launches"]
            log("spatial[w1_{}]: world of 1 | wall {:.3f} s | peak memory "
                "{:.2f} GB | launches {} (expect {})".format(
                    run, w1[run]["wall"], w1[run]["peak"] / 1e9,
                    w1[run]["launches"], w1_expect[run]))
            if w1[run]["launches"] != w1_expect[run]:
                failed.append("spatial_w1_" + run)
        torch.cuda.empty_cache()

        outdir = os.path.join(workdir, "w2")
        os.makedirs(outdir)
        t0 = time.time()
        code = _launch_ranks(outdir, timeout=600, entry="--spatial-rank")
        log("spatial: the world of 2 ran {:.2f} s, exit code {}".format(
            time.time() - t0, code))
        if code != 0:
            raise AssertionError("the spatial world of 2 failed")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(outdir, "rank{}.json".format(r))) as f:
                ranks.append(json.load(f))
        a2 = torch.load(os.path.join(outdir, "arrays.pt"))
        backends = {r["backend"] for r in ranks}
        log("spatial: world of 2 | backend {} | devices {}".format(
            sorted(backends), [r["device"] for r in ranks]))
        if backends != {"gloo"}:
            failed.append("spatial_backend_w2")

        gaps = {"forward": float((a2["probs"] - a1["probs"]).abs().max()),
                "decoders": float((a2["decoders"]
                                   - a1["decoders"]).abs().max())}
        reordered = float((a1["decoders_reordered"]
                           - a1["decoders"]).abs().max())
        state_gap = _state_gap(a2["state"], a1["state"], start)
        moved = max(float((a1["state"][k] - start[k]).abs().max())
                    for k in start)
        loss_gap = abs(ranks[0]["step"]["loss"] - w1["step"]["loss"])
        gaps["step"] = state_gap[1]
        for run in SPATIAL_RUNS:
            path = "spatial_w2_" + run
            counts[path] = ranks[0][run]["launches"]
            if run == "step":
                ok = (state_gap[1] <= SPATIAL_STATE_BAR
                      and loss_gap <= SPATIAL_STATE_BAR * abs(
                          w1["step"]["loss"]))
                gap_text = ("largest state gap {:.3g} ({:.3g} of the "
                            "largest change {:.3g}; bar {}) | loss {:.6f} "
                            "(world of 1: {:.6f}; relative gap {:.3g})"
                            .format(state_gap[0], state_gap[1], moved,
                                    SPATIAL_STATE_BAR,
                                    ranks[0]["step"]["loss"],
                                    w1["step"]["loss"],
                                    loss_gap / abs(w1["step"]["loss"])))
            else:
                ok = gaps[run] <= SPATIAL_PROB_BAR
                gap_text = "largest probability gap {:.3g} (bar {})".format(
                    gaps[run], SPATIAL_PROB_BAR)
                if run == "decoders":
                    gap_text += (" | the world of 1 on the batch reversed: "
                                 "{:.3g}".format(reordered))
            log("spatial[w2_{}]: world of 2 | wall per rank {} s (world of "
                "1: {:.3f}) | peak memory per rank {} GB (world of 1: {:.2f})"
                " | all-reduces per rank {} ({} MB, {} s inside them) | {} | "
                "launches {} (expect {})".format(
                    run, ["{:.3f}".format(r[run]["wall"]) for r in ranks],
                    w1[run]["wall"],
                    ["{:.2f}".format(r[run]["peak"] / 1e9) for r in ranks],
                    w1[run]["peak"] / 1e9,
                    [r[run]["all_reduces"] for r in ranks],
                    ["{:.1f}".format(r[run]["all_reduce_bytes"] / 1e6)
                     for r in ranks],
                    ["{:.3f}".format(r[run]["all_reduce_s"]) for r in ranks],
                    gap_text, counts[path], none))
            if not ok or counts[path] != none:
                failed.append(path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("spatial: the phase's wall {:.2f} s".format(time.time() - t_phase))
    if failed:
        raise AssertionError("the spatial partitioning did not run as "
                             "expected: {}".format(", ".join(failed)))
    return counts


# The `curve` phase: experiments/torch_curve_v2.py, the learning-evidence
# run, at full width (b0 rsd=(2, 4) bf16, 224^2, 59 inner steps,
# meta-batch 5, the meta-step on a task axis, the evaluation in chunks of
# 8), cut from 3000 meta-iterations, 40 train tasks, 12 held-out tasks and
# 3 evaluation samples.
CURVE_ARGV = ["--meta_iters", "2", "--eval_every", "1", "--eval_samples",
              "1", "--test_tasks", "4", "--train_tasks", "16"]
CURVE_BASELINE_BAR = 0.01  # random init scores ~0 (the TPU's: 3.6e-11)


def _curve_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_curve_v2", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "experiments", "torch_curve_v2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def curve_run(outdir):
    """The `curve` phase's process: the script's `main` with CURVE_ARGV
    into outdir/run, the counts at 0 just before and written to
    outdir/launches.json just after."""
    script = _curve_script()
    reset_launches()
    script.main(CURVE_ARGV + ["--out", os.path.join(outdir, "run")])
    with open(os.path.join(outdir, "launches.json"), "w") as f:
        json.dump(read_launches(), f)
    return 0


def _expected_curve_launches(args):
    """`full_pass` launches of a run of the script, from its flags: each
    meta-iteration one launch an augmented inner step for the meta-batch
    (FOMAML*'s last step is the raw tail; the chained step one a task);
    each evaluation (the baseline, every curve point, the final one) one
    an inner step for each chunk of held-out tasks (one a task chained),
    eval_samples times. Returns (total, its terms as text)."""
    points = sum(1 for i in range(1, args.meta_iters + 1)
                 if i % args.eval_every == 0 or i == args.meta_iters)
    tasks = args.meta_batch if args.chain_tasks else 1
    chunks = args.test_tasks if args.chain_eval_chunk else \
        -(-args.test_tasks // args.task_chunk_size)
    evals = 2 + points
    total = (args.meta_iters * tasks * (args.inner_iters - 1)
             + evals * args.eval_samples * chunks * args.inner_iters)
    return total, "{} x {} x {} + {} x {} x {} x {}".format(
        args.meta_iters, tasks, args.inner_iters - 1, evals,
        args.eval_samples, chunks, args.inner_iters)


def phase_curve(dev):
    """experiments/torch_curve_v2.py at full width in a process of its own
    (`chip_smoke.py --curve-run DIR`), cut to CURVE_ARGV: its `full_pass`
    launches exact (derived from the flags) and no other kernel;
    result.json with the JAX script's keys (those of the committed
    experiments/curve_v2_seed1 run) plus `device`, and curve.json with its
    entry shapes; a baseline mean IoU below CURVE_BASELINE_BAR; the
    checkpoint's params finite and changed from the random init. Prints
    the seconds a meta-iteration and an evaluation point take. Returns
    {"curve": launches}."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mliis_tpu_torch.meta.inner_loop import (OptimizerConfig,
                                                 init_model_state)
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    from mliis_tpu_torch.utils import checkpoint as ckpt
    args = _curve_script().argument_parser().parse_args(
        CURVE_ARGV + ["--out", "unused"])
    total, terms = _expected_curve_launches(args)
    expect = expected(full_pass=total)
    with open(os.path.join("experiments", "curve_v2_seed1",
                           "result.json")) as f:
        keys = set(json.load(f)) | {"device"}
    workdir = tempfile.mkdtemp(prefix="curve_smoke_")
    run = os.path.join(workdir, "run")
    try:
        t0 = time.time()
        code = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--curve-run", workdir], timeout=600
                              ).returncode
        wall = time.time() - t0
        if code != 0:
            raise AssertionError("the curve run exited {}".format(code))
        with open(os.path.join(workdir, "launches.json")) as f:
            launches = json.load(f)
        with open(os.path.join(run, "result.json")) as f:
            result = json.load(f)
        with open(os.path.join(run, "curve.json")) as f:
            points = json.load(f)
        with open(os.path.join(run, "timings.jsonl")) as f:
            timings = [json.loads(line) for line in f]
        baseline = np.load(os.path.join(run, "baseline.npy"))
        model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                             compute_dtype=torch.bfloat16)
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
        init = init_model_state(model, OptimizerConfig("sgd"))
        state, meta = ckpt.restore_checkpoint(run, init)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    shapes = [len(p) for p in points]
    shapes_ok = (points == result["curve"]
                 and [p[0] for p in points] == list(range(args.meta_iters
                                                          + 1))
                 and shapes == [2] + [4] * args.meta_iters
                 and all(math.isfinite(v) for p in points for v in p))
    finite = all(bool(v.isfinite().all()) for v in state.params.values())
    moved = sum(float((state.params[k] - v).abs().sum())
                for k, v in init.params.items())
    iter_s = [e["s"] for e in timings if "iter" in e]
    eval_s = [e["s"] for e in timings if "eval_at" in e]
    ok = (launches == expect and set(result) == keys and shapes_ok
          and baseline.shape == (args.eval_samples, args.test_tasks)
          and result["baseline_mean_iou"] < CURVE_BASELINE_BAR
          and result["meta_iters_done"] == args.meta_iters
          and meta.get("step") == args.meta_iters and finite and moved > 0)
    log("curve: experiments/torch_curve_v2.py {} | wall {:.2f} s | s a "
        "meta-iteration {} | s an evaluation point {} | baseline mean IoU "
        "{:.3g} (bar < {}) | curve {} | final {:.4f}, task-level diff "
        "{:.4f} +/- {:.4f} | result keys {} | curve shapes {} | params "
        "finite {} | sum |d params| {:.4g} | device {} | launches {} "
        "(expect {} = {})".format(
            " ".join(CURVE_ARGV), wall,
            ["{:.3f}".format(s) for s in iter_s],
            ["{:.3f}".format(s) for s in eval_s],
            result["baseline_mean_iou"], CURVE_BASELINE_BAR,
            [[round(v, 4) for v in p] for p in points],
            result["final_mean_iou"], result["task_level_diff_mean"],
            result["task_level_ci95_t"], "match" if set(result) == keys
            else sorted(set(result) ^ keys), shapes, finite, moved,
            result["device"], launches, expect, terms))
    if not ok:
        raise AssertionError("the curve run did not run as expected")
    return {"curve": launches}


def _drive(dev):
    """Every phase in turn, each followed by `stop_descendants`. Returns
    ({path: launches}, the kernels' entries)."""
    def run(phase, *args):
        try:
            return phase(*args)
        finally:
            stop_descendants(phase.__name__)

    run(phase_build)
    entries = [run(phase_kernel, dev), run(phase_cheap_kernel, dev),
               run(phase_light_kernel, dev), run(phase_head_kernel, dev),
               run(phase_bn_kernel, dev), run(phase_dw_kernel, dev)]
    run(phase_agree, dev)
    run(phase_agree_joint, dev)
    by_path = {"slice": run(phase_slice, dev)}
    by_path.update(run(phase_eval, dev))
    by_path["joint"] = run(phase_joint, dev)
    for phase in (phase_train, phase_batched, phase_traces, phase_curve,
                  phase_decoders, phase_mesh, phase_spatial):
        by_path.update(run(phase, dev))
    return by_path, entries


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
    # cuBLAS's deterministic workspace, for `deterministic_algorithms`; set
    # before the first product makes its handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    _become_subreaper()
    by_path, entries = _drive(dev)
    # Each kernel's `launches` is read from the path it carries: the
    # meta-step for full_pass, the split-route evaluation for cheap_pass,
    # the joint run for fused_light_augment; every path's counts beside.
    main_path = {"full_pass": "slice", "cheap_pass": "eval_split",
                 "fused_light_augment": "joint", "resized_ce": "joint",
                 "batch_norm_act": "joint", "depthwise_conv": "joint"}
    for e in entries:
        e["launches"] = by_path[main_path[e["name"]]][e["name"]]
        e["launches_by_path"] = {p: c.get(e["name"])
                                 for p, c in by_path.items()}
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
    RANK_ENTRIES = {"--mesh-rank": mesh_rank, "--spatial-rank": spatial_rank,
                    "--traces-rank": traces_rank, "--curve-run": curve_run}
    if sys.argv[1:2] and sys.argv[1] in RANK_ENTRIES:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(RANK_ENTRIES[sys.argv[1]](sys.argv[2]))
    sys.exit(main())
