"""The joint loss head's kernels (`csrc/resized_ce.cu`, forward and
backward, matched by name in the trace) against their roofline in the
EfficientLab-b3 cell: 100 * the least time of one step's head over the
two kernels' device time a step in the slice.

The least time is the larger of two bounds, at the configuration's
channels (1001) and batch (the slice's, 64), the logits at the decoder's
plane (the labels' size over 4, rounded up: 75^2 at 300^2) resized to the
labels' (300^2):
  - the exponentials, two an output logit (the forward's log-sum-exp and
    the backward's softmax), at the SFUs' rate of 16 a clock on each of
    132 SMs at 1.98 GHz (4.18e12/s; 1.153e10 at b3, 2.76 ms);
  - the bytes at HBM3's 3.35 TB/s: the float32 logits read by each launch
    and their gradient written, an int32 label a pixel read, and each
    pixel's statistics (8 bytes) written and read back (4.44 GB at b3,
    1.33 ms).
The same counts as chip_smoke.py's bound for the head (PERF.md)."""
from portbench import common, counts

KERNELS = ("resized_ce_forward_kernel", "resized_ce_backward_kernel")
CONFIG = "efficientlab-b3-joint1000"
EXP_PER_S = 16 * 132 * 1.98e9


def decoder_plane(size: int) -> int:
    """The RSD decoder's plane at stride 4 (two halvings, SAME)."""
    half = -(-size // 2)
    return -(-half // 2)


def head_exps(batch: int, channels: int, size: int) -> int:
    """Two exponentials an output logit."""
    return 2 * batch * channels * size * size


def head_bytes(batch: int, channels: int, size: int) -> int:
    """The low logits read twice and their gradient written, the labels
    read, the per-pixel statistics written and read."""
    low = decoder_plane(size)
    return 3 * batch * channels * low * low * 4 + batch * size * size * (
        4 + 2 * 8)


def least_s(batch: int, channels: int, size: int) -> float:
    return max(head_exps(batch, channels, size) / EXP_PER_S,
               head_bytes(batch, channels, size)
               / counts.PEAKS["hbm_bytes_per_s"])


def read(trace):
    times = [e - s for n, s, e in trace.kernels
             if any(k in n for k in KERNELS)]
    if not times or trace.inner_steps <= 0:
        return None
    per_step_s = sum(times) / trace.inner_steps / 1e6
    channels = common.load_json("configs", CONFIG + ".json")["model"][
        "n_classes"] + 1
    return 100.0 * least_s(trace.augment_batch, channels,
                           trace.image_size) / per_step_s
