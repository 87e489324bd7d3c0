"""The joint step's loss head: logits at the decoder's resolution resized
(align corners, bilinear) to the labels' and their mean cross entropy, in
one hand-written kernel each way (csrc/resized_ce.cu), with its plain
PyTorch version.

`resized_ce(low, labels, label_smoothing)` is the mean over the N x H x W
output pixels of (1 - eps) CE(label) + eps / C sum_c CE(c) of
`F.interpolate(low, (H, W), mode="bilinear", align_corners=True)`: what
`F.cross_entropy` takes of those logits, as one `torch.autograd.Function`.

  - A CUDA tensor launches the kernels: the forward writes each output
    pixel's log-sum-exp and label (8 bytes a pixel) and the loss, the
    backward the gradient of `low` in `low`'s memory format (NCHW or
    channels-last, each taken as it is; another layout is copied to NCHW
    first). Neither writes an H x W logit, probability or gradient, so the
    whole batch goes in one launch each way. Both count under "resized_ce"
    in `kernel_library.launches`. Their tables (the taps, the units, the
    tiles) are built on the host once a shape (`resized_ce_plan`) and kept
    on the card.
  - A CPU tensor takes the plain version: explicit PyTorch for the same
    forward (the interpolation, the log-sum-exp, the label's logit and the
    logits' sum) and the hand-derived backward (softmax - target, then the
    transpose of the interpolation, `upsample_bilinear2d_backward`), a batch
    chunk of `chunk` images at a time, so that each chunk's H x W logits
    stay under the 2^31 elements some CUDA kernels index. Any other device
    raises.

Labels are class ids, float (as `fused_light_augment` returns them) or
integer, in [0, C); a float label is truncated, as `.long()` does. A label
outside [0, C) makes the plain version raise and the kernels' loss and
gradient NaN.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops.kernel_library import F32, I32, PTR, channels_last

# csrc/resized_ce.cu's constants.
THREADS = 256        # kThreads: a block's threads, one an output column
MAX_ROWS = 8         # kMaxRows: output rows of a forward unit
FWD_CHUNK = 32       # kFwdChunk: channels the forward stages at a time
BWD_CHUNK = 16       # kBwdChunk: channels of a backward block
BAND = 16            # kBand: input rows of a backward block
MAX_SMEM = 48 * 1024  # kMaxSmem: a block's shared memory


def axis_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """PyTorch's float32 align-corners taps along one axis: (lo [n_out],
    frac [n_out], start [n_in + 1]). Output point d reads input points lo
    and lo + (lo < n_in - 1) with weights 1 - frac and frac, where src =
    float32((n_in - 1) / (n_out - 1)) * d in float32, lo = trunc(src), frac
    = src - lo; start[i] is the first output point whose lo is at least
    i."""
    scale = (np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1
             else np.float32(0.0))
    src = scale * np.arange(n_out, dtype=np.float32)
    lo = np.minimum(src.astype(np.int64), n_in - 1)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    start = np.searchsorted(lo, np.arange(n_in + 1), side="left")
    return lo, frac, start


def forward_smem(span: int) -> int:
    """Bytes of a forward block: two buffers of FWD_CHUNK channels of two
    input rows of `span` columns."""
    return 4 * 2 * FWD_CHUNK * (2 * span | 1)


def backward_smem(span: int, x_count: int, n_cols: int) -> int:
    """Bytes of a backward block: a ring of three input rows of BWD_CHUNK
    channels, two rows of y-sums and the two x weights of its output
    columns, a finished input row and the table of its input columns'
    first output columns."""
    return 4 * (3 * BWD_CHUNK * (span | 1) + (2 * BWD_CHUNK + 2)
                * (x_count | 1) + BWD_CHUNK * (n_cols | 1) + n_cols + 2)


def forward_tiles(xlo: np.ndarray, w: int) -> list:
    """The forward's column tiles: runs of at most THREADS output columns
    whose taps' input columns fit MAX_SMEM, as (x_begin, x_count, j_lo,
    span, 0, 0, 0, 0)."""
    tiles, x, n_out = [], 0, len(xlo)
    while x < n_out:
        end = x + 1
        while (end < n_out and end - x < THREADS and forward_smem(
                min(xlo[end] + 1, w - 1) - xlo[x] + 1) <= MAX_SMEM):
            end += 1
        span = min(xlo[end - 1] + 1, w - 1) - xlo[x] + 1
        tiles.append((x, end - x, int(xlo[x]), int(span), 0, 0, 0, 0))
        x = end
    return tiles


def backward_tiles(xstart: np.ndarray, w: int) -> list:
    """The backward's column tiles: runs of input columns [j_begin, j_end)
    whose gathered output columns (those with a tap in the run) number at
    most THREADS and fit MAX_SMEM, as (x_begin, x_count, j_lo, span,
    j_begin, j_end, smem, 0)."""
    def tile(jb, je):
        j_lo = max(jb - 1, 0)
        xb, xe = int(xstart[j_lo]), int(xstart[je])
        span = min(je, w - 1) - j_lo + 1
        smem = backward_smem(span, xe - xb, je - jb)
        if xe - xb > THREADS or smem > MAX_SMEM:
            return None
        return (xb, xe - xb, j_lo, span, jb, je, smem, 0)

    tiles, jb = [], 0
    while jb < w:
        best = tile(jb, jb + 1)
        if best is None:
            raise ValueError("resized_ce's kernel takes at most {} output "
                             "columns on two input columns".format(THREADS))
        je = jb + 2
        while je <= w and tile(jb, je) is not None:
            best, je = tile(jb, je), je + 1
        tiles.append(best)
        jb = best[5]
    return tiles


def row_units(ystart: np.ndarray) -> list:
    """The forward's row units: each cell row's output rows, at most
    MAX_ROWS at a time, as (cell row, first output row, rows, 0)."""
    return [(i, y, min(MAX_ROWS, int(ystart[i + 1]) - y), 0)
            for i in range(len(ystart) - 1)
            for y in range(int(ystart[i]), int(ystart[i + 1]), MAX_ROWS)]


class Plan(NamedTuple):
    """The kernels' tables for one (h, w) -> (H, W), on a device."""
    yfrac: torch.Tensor     # float32 [H]
    ystart: torch.Tensor    # int32 [h + 1]
    xlo: torch.Tensor       # int32 [W]
    xfrac: torch.Tensor     # float32 [W]
    xstart: torch.Tensor    # int32 [w + 1]
    units: torch.Tensor     # int32 [units, 4]
    fwd_tiles: torch.Tensor  # int32 [tiles, 8]
    bwd_tiles: torch.Tensor  # int32 [tiles, 8]
    fwd_smem: int
    bwd_smem: int


@functools.lru_cache(maxsize=16)
def resized_ce_plan(h: int, w: int, out_h: int, out_w: int,
                    device: torch.device) -> Plan:
    """The tables of csrc/resized_ce.cu for (h, w) -> (out_h, out_w), on
    `device` (copied there once)."""
    _, yfrac, ystart = axis_taps(h, out_h)
    xlo, xfrac, xstart = axis_taps(w, out_w)
    ftiles = forward_tiles(xlo, w)
    btiles = backward_tiles(xstart, w)
    as_int = lambda v: torch.tensor(np.asarray(v, np.int64),  # noqa: E731
                                    dtype=torch.int32, device=device)
    return Plan(
        yfrac=torch.from_numpy(yfrac).to(device), ystart=as_int(ystart),
        xlo=as_int(xlo), xfrac=torch.from_numpy(xfrac).to(device),
        xstart=as_int(xstart), units=as_int(row_units(ystart)),
        fwd_tiles=as_int(ftiles), bwd_tiles=as_int(btiles),
        fwd_smem=max(forward_smem(t[3]) for t in ftiles),
        bwd_smem=max(t[6] for t in btiles))


# --------------------------------------------------------------------------
# The plain version.
# --------------------------------------------------------------------------

def _resized(low: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The resized logits, in float32 (float64 for float64 logits)."""
    dtype = torch.promote_types(low.dtype, torch.float32)
    return F.interpolate(low.to(dtype), size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resized_ce_forward_reference(low: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 chunk: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse): the mean smoothed CE of the resized logits and each
    output pixel's log-sum-exp [N, H, W], `chunk` images at a time (default:
    the whole batch)."""
    n, c = low.shape[:2]
    out_h, out_w = labels.shape[1:]
    eps = float(label_smoothing)
    k = chunk or n
    dtype = torch.promote_types(low.dtype, torch.float32)
    lse = torch.empty(n, out_h, out_w, dtype=dtype, device=low.device)
    total = torch.zeros((), dtype=torch.float64, device=low.device)
    for i in range(0, n, k):
        z = _resized(low[i:i + k], out_h, out_w)
        lse[i:i + k] = torch.logsumexp(z, 1)
        picked = z.gather(1, labels[i:i + k, None].long())[:, 0]
        per_pixel = lse[i:i + k] - (1.0 - eps) * picked
        if eps:
            per_pixel = per_pixel - (eps / c) * z.sum(1)
        total = total + per_pixel.sum(dtype=torch.float64)
    return (total / (n * out_h * out_w)).to(dtype), lse


def resized_ce_backward_reference(low: torch.Tensor, labels: torch.Tensor,
                                  lse: torch.Tensor, grad: torch.Tensor,
                                  label_smoothing: float = 0.0,
                                  chunk: Optional[int] = None
                                  ) -> torch.Tensor:
    """The gradient of `low` (in its memory format): softmax - target of the
    resized logits, from the forward's `lse`, scaled by `grad` / (N H W) and
    taken back through the interpolation's transpose, `chunk` images at a
    time."""
    n, c, h, w = low.shape
    out_h, out_w = labels.shape[1:]
    eps = float(label_smoothing)
    k = chunk or n
    dtype = torch.promote_types(low.dtype, torch.float32)
    scale = grad.to(low.device, dtype) / (n * out_h * out_w)
    out = torch.empty_like(low, dtype=dtype)
    for i in range(0, n, k):
        z = _resized(low[i:i + k], out_h, out_w)
        d = torch.exp(z - lse[i:i + k, None])
        if eps:
            d = d - eps / c
        d.scatter_add_(1, labels[i:i + k, None].long(),
                       torch.full_like(z[:, :1], eps - 1.0))
        out[i:i + k] = torch.ops.aten.upsample_bilinear2d_backward(
            d * scale, [out_h, out_w], list(z.shape[:2]) + [h, w], True)
    return out


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

# The C entry points' arguments before the stream (`kernel_library.bind`).
_FORWARD_ARGS = [PTR, I32] * 4 + [PTR] * 7 + [I32] * 6 + [F32, I32]
_BACKWARD_ARGS = [PTR, I32] + [PTR] * 4 + [I32] + [PTR] * 5 + [I32] * 6 \
    + [F32, I32]


def _forward_kernel(low: torch.Tensor, labels: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, stats): one launch; stats [N, H, W, 2] holds each output
    pixel's log-sum-exp times log2 e and its label's bits."""
    n, c, h, w = low.shape
    out_h, out_w = labels.shape[1:]
    plan = resized_ce_plan(h, w, out_h, out_w, low.device)
    if labels.dtype not in (torch.float32, torch.int32):
        labels = labels.to(torch.int32)
    labels = labels.contiguous()
    stats = torch.empty(n, out_h, out_w, 2, device=low.device)
    partials = torch.empty(len(plan.fwd_tiles) * len(plan.units) * n,
                           dtype=torch.float64, device=low.device)
    # The count of finished blocks: this call's own, zeroed by the launch.
    done = torch.empty(1, dtype=torch.int32, device=low.device)
    loss = torch.empty((), device=low.device)
    fn = kernel_library.bind("resized_ce", "resized_ce_forward",
                             _FORWARD_ARGS)
    kernel_library.launch(
        "resized_ce", fn, low.device, low.data_ptr(),
        int(channels_last(low)), labels.data_ptr(),
        int(labels.dtype == torch.float32), plan.units.data_ptr(),
        len(plan.units), plan.fwd_tiles.data_ptr(), len(plan.fwd_tiles),
        plan.yfrac.data_ptr(), plan.xlo.data_ptr(), plan.xfrac.data_ptr(),
        stats.data_ptr(), partials.data_ptr(), done.data_ptr(),
        loss.data_ptr(), n, c, h, w, out_h, out_w, kernel_library.f32(eps),
        plan.fwd_smem)
    return loss, stats


def _backward_kernel(low: torch.Tensor, stats: torch.Tensor,
                     grad: torch.Tensor, eps: float) -> torch.Tensor:
    """The gradient of `low`, in its memory format: one launch."""
    n, c, h, w = low.shape
    out_h, out_w = stats.shape[1:3]
    plan = resized_ce_plan(h, w, out_h, out_w, low.device)
    grad = grad.to(low.device, torch.float32).contiguous()
    out = torch.empty_like(low)
    fn = kernel_library.bind("resized_ce", "resized_ce_backward",
                             _BACKWARD_ARGS)
    kernel_library.launch(
        "resized_ce", fn, low.device, low.data_ptr(),
        int(channels_last(low)), stats.data_ptr(), grad.data_ptr(),
        out.data_ptr(), plan.bwd_tiles.data_ptr(), len(plan.bwd_tiles),
        plan.ystart.data_ptr(), plan.yfrac.data_ptr(), plan.xlo.data_ptr(),
        plan.xstart.data_ptr(), plan.xfrac.data_ptr(), n, c, h, w, out_h,
        out_w, kernel_library.f32(eps), plan.bwd_smem)
    return out


class ResizedCrossEntropy(torch.autograd.Function):
    """`resized_ce` with its backward: the kernels on CUDA tensors, the plain
    version on CPU ones."""

    @staticmethod
    def forward(ctx, low, labels, label_smoothing, chunk):
        ctx.label_smoothing, ctx.chunk = label_smoothing, chunk
        if low.device.type == "cuda":
            loss, stats = _forward_kernel(low, labels, label_smoothing)
            ctx.save_for_backward(low, stats)
        else:
            loss, lse = resized_ce_forward_reference(low, labels,
                                                     label_smoothing, chunk)
            ctx.save_for_backward(low, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, grad):
        if ctx.saved_tensors[0].device.type == "cuda":
            low, stats = ctx.saved_tensors
            out = _backward_kernel(low, stats, grad, ctx.label_smoothing)
        else:
            low, labels, lse = ctx.saved_tensors
            out = resized_ce_backward_reference(low, labels, lse, grad,
                                                ctx.label_smoothing,
                                                ctx.chunk)
        return out, None, None, None


def resized_ce(low: torch.Tensor, labels: torch.Tensor,
               label_smoothing: float = 0.0,
               chunk: Optional[int] = None) -> torch.Tensor:
    """The mean smoothed cross entropy of `low` [N, C, h, w] float32 resized
    to `labels` [N, H, W] (module doc). `chunk`: images a chunk of the plain
    version (default: the whole batch); the kernels take the batch at once.
    """
    if low.dtype != torch.float32 or low.ndim != 4:
        raise ValueError("low must be a float32 [N, C, h, w]")
    if labels.ndim != 3 or labels.shape[0] != low.shape[0] \
            or labels.device != low.device:
        raise ValueError("labels must be [N, H, W] on {}".format(low.device))
    if low.device.type == "cuda":
        if not (low.is_contiguous() or channels_last(low)):
            low = low.contiguous()
    elif low.device.type != "cpu":
        raise ValueError("resized_ce runs on cuda or cpu tensors")
    return ResizedCrossEntropy.apply(low, labels, float(label_smoothing),
                                     chunk)
