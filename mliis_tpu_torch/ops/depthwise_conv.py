"""The model's depthwise convolution with flax's SAME padding
(`models/layers.Conv2d` with groups == in == out channels) in one
hand-written kernel launch each way (csrc/depthwise_conv.cu), with its
plain PyTorch version.

`depthwise_conv(x, weight, stride, padding)` computes, for x [N, C, H, W]
and weight [C, 1, k, k], the grouped conv of each channel by its own k x k
taps at `stride`, x padded with zeros by `padding` ((top, bottom), (left,
right)), as one `torch.autograd.Function`:
    y[n, c, oh, ow] = sum_{i, j} xpad[n, c, oh s + i, ow s + j] w[c, 0, i, j].
Its backward is the exact gradient: dx gathers, for each input, the
outputs that read it; dw sums x * dy over the batch and the outputs.

  - A CUDA tensor launches the kernels: one launch forward, counted under
    "depthwise_conv", and one backward (dx and dw together), counted under
    "depthwise_conv_grad" in `kernel_library.launches`. They take float32
    channels-last maps, k 3 or 5, stride 1 or 2 and the SAME padding that
    gives ceil(H / s) x ceil(W / s) outputs (`layers.same_padding`'s), read
    in place as zeros: no padded map is written. y and dx are channels-last.
  - A CPU tensor takes the plain version: the same forward as a sum of k^2
    shifted slices of the padded map, and the hand-derived backward. Any
    other device raises.

The backward's dw is summed across blocks through double partials and a
ticket a channel slice (`batch_norm_act.tickets`, shared with that
kernel), so it repeats bit for bit.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops.batch_norm_act import tickets
from mliis_tpu_torch.ops.kernel_library import I32, PTR, channels_last

KERNEL_SIZES = (3, 5)
STRIDES = (1, 2)
# csrc/depthwise_conv.cu's constants.
THREADS = 256                # kThreads
WARPS = THREADS // 32
UNIT = {1: 4, 2: 2}          # a thread's unit: UNIT x UNIT outputs
CHANNEL_SLICES = (8, 16, 32)  # channels a block (the kernels' CS)
SMEM_BUDGET = 110 * 1024     # dynamic shared memory a block: two an SM
BLOCKS_PER_SM = 2
MAX_UNITS_A_THREAD = 4       # units of a tile a thread computes, at most
# The plan's cost model: a loaded channel-position's weight by the slice's
# width (narrow slices read device memory in short pieces), and a tile's
# fixed cost (its barriers and waits), in channel-positions. Fitted to the
# kernels' times on an H100 at every depthwise input of the b3 and b0
# joint cells with each slice forced: the plans it picks take 0.7% (b3)
# and 1.2% (b0) longer a step than the fastest slice at each input.
LOAD_WEIGHT = {8: 1.25, 16: 1.1, 32: 0.9}
TILE_COST = 2048

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


# --------------------------------------------------------------------------
# The plain version.
# --------------------------------------------------------------------------

def _taps(xp: torch.Tensor, k: int, stride: int, ho: int, wo: int):
    """(i, j, the [N, C, ho, wo] slice of the padded map that tap (i, j)
    reads)."""
    span_h, span_w = stride * (ho - 1) + 1, stride * (wo - 1) + 1
    for i in range(k):
        for j in range(k):
            yield i, j, xp[:, :, i:i + span_h:stride, j:j + span_w:stride]


def _out_size(x: torch.Tensor, k: int, stride: int, padding: Padding):
    (pt, pb), (pl, pr) = padding
    return ((x.shape[2] + pt + pb - k) // stride + 1,
            (x.shape[3] + pl + pr - k) // stride + 1)


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t in x's memory format (channels-last or contiguous)."""
    fmt = torch.channels_last if channels_last(x) else \
        torch.contiguous_format
    return t.contiguous(memory_format=fmt)


def depthwise_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                             stride: int, padding: Padding) -> torch.Tensor:
    """y as the module doc says, a sum of k^2 shifted slices."""
    (pt, pb), (pl, pr) = padding
    k = weight.shape[-1]
    ho, wo = _out_size(x, k, stride, padding)
    xp = F.pad(x, (pl, pr, pt, pb))
    y = sum(sl * weight[:, 0, i, j][:, None, None]
            for i, j, sl in _taps(xp, k, stride, ho, wo))
    return _like(y, x)


def depthwise_conv_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                      grad: torch.Tensor, stride: int,
                                      padding: Padding
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw), the hand-derived gradient of the forward: each tap adds
    grad w[c, 0, i, j] into the padded map's slice it read (dx is that
    map's interior), and grad x-slice summed over the batch and outputs to
    dw[c, 0, i, j]."""
    (pt, pb), (pl, pr) = padding
    n, c, h, w = x.shape
    k = weight.shape[-1]
    ho, wo = grad.shape[2:]
    xp = F.pad(x, (pl, pr, pt, pb))
    dxp = torch.zeros_like(xp)
    dw = torch.empty_like(weight)
    span_h, span_w = stride * (ho - 1) + 1, stride * (wo - 1) + 1
    for i, j, sl in _taps(xp, k, stride, ho, wo):
        dw[:, 0, i, j] = (grad * sl).sum((0, 2, 3))
        dxp[:, :, i:i + span_h:stride, j:j + span_w:stride] += \
            grad * weight[:, 0, i, j][:, None, None]
    dx = dxp[:, :, pt:pt + h, pl:pl + w]
    return _like(dx, x), dw


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

class Plan(NamedTuple):
    """The kernels' grid for one shape (`launch_plan`)."""
    cs: int               # channels of a block's slice
    tile_h: int           # outputs of a tile
    tile_w: int
    tiles: int            # tiles of the batch
    tiles_per_block: int
    blocks: int           # blocks along the tiles (grid y)
    slices: int           # channel slices (grid x)
    smem: int             # dynamic shared memory a block, bytes


def smem_bytes(k: int, stride: int, backward: bool, cs: int, tile_h: int,
               tile_w: int) -> int:
    """A block's dynamic shared memory: two stages of the x tile (and the
    dy tile, backward), one column of padding every unit; backward at
    least the dw reduction's [WARPS][cs][k k] floats."""
    unit = UNIT[stride]
    x_rows, x_cols = (tile_h - 1) * stride + k, (tile_w - 1) * stride + k
    stage = x_rows * (x_cols + (x_cols - 1) // (unit * stride)) * cs
    if backward:
        halo = (k - 1) // stride
        d_rows, d_cols = tile_h + halo, tile_w + halo
        stage += d_rows * (d_cols + (d_cols - 1) // unit) * cs
    smem = 2 * stage * 4
    return max(smem, WARPS * cs * k * k * 4) if backward else smem


def output_grid(shape, k: int, stride: int, pad_top: int, pad_left: int,
                backward: bool) -> Tuple[int, int]:
    """The rows and columns of outputs the tiles cover: Ho x Wo, backward
    at stride 2 ceil((H + pad_top) / 2) x ceil((W + pad_left) / 2), so that
    every input row and column has an owner of its dx."""
    h, w = shape[2:]
    if backward and stride == 2:
        return -(-(h + pad_top) // 2), -(-(w + pad_left) // 2)
    return -(-h // stride), -(-w // stride)


def _plan_at(shape, k: int, stride: int, pad_top: int, pad_left: int,
            backward: bool, sms: int, cs: int) -> Tuple[float, Plan]:
    """(cost, plan) of the kernels' grid for x of `shape` [N, C, H, W] at
    slices of `cs` channels: the tile (a whole number of units, at most
    MAX_UNITS_A_THREAD a thread, within SMEM_BUDGET) that costs least over
    the batch, a tile costing its channel-positions loaded (weighted by
    LOAD_WEIGHT[cs]) and computed (every unit slot of its passes) and
    TILE_COST; then the tiles a block that finish soonest, counting whole
    waves of BLOCKS_PER_SM blocks an SM and one tile's load a block."""
    n, c = shape[:2]
    a_pass = THREADS // cs
    unit = UNIT[stride]
    grid_h, grid_w = output_grid(shape, k, stride, pad_top, pad_left,
                                 backward)
    halo = (k - 1) // stride if backward else None
    best = None
    for uh in range(1, -(-grid_h // unit) + 1):
        for uw in range(1, -(-grid_w // unit) + 1):
            units = uh * uw
            th, tw = uh * unit, uw * unit
            if (units > MAX_UNITS_A_THREAD * a_pass
                    or smem_bytes(k, stride, backward, cs, th, tw)
                    > SMEM_BUDGET):
                break
            tiles = -(-grid_h // th) * -(-grid_w // tw)
            loads = ((th - 1) * stride + k) * ((tw - 1) * stride + k)
            if backward:
                loads += (th + halo) * (tw + halo)
            slots = -(-units // a_pass) * a_pass * unit * unit
            cost = tiles * (cs * (LOAD_WEIGHT[cs] * loads + slots)
                            + TILE_COST)
            if best is None or cost < best[0]:
                best = (cost, th, tw, tiles)
    if best is None:
        raise ValueError("no tile fits the shared memory at {}".format(
            shape))
    cost, th, tw, per_image = best
    tiles = n * per_image
    slices = -(-c // cs)
    resident = BLOCKS_PER_SM * sms
    per_block = min(range(1, tiles + 1), key=lambda t: (
        -(-(-(-tiles // t) * slices) // resident) * (t + 1), -t))
    return n * slices * cost, Plan(
        cs, th, tw, tiles, per_block, -(-tiles // per_block), slices,
        smem_bytes(k, stride, backward, cs, th, tw))


@functools.lru_cache(maxsize=1024)
def launch_plan(shape, k: int, stride: int, pad_top: int, pad_left: int,
                backward: bool, sms: int) -> Plan:
    """The cheapest of `_plan_at`'s plans over the slices that divide C
    (slices of 8, the last one partly masked, where none does: slices of
    4 read device memory in 16-byte pieces and ran at half the speed)."""
    c = shape[1]
    options = [cs for cs in CHANNEL_SLICES if c % cs == 0] or [8]
    return min((_plan_at(shape, k, stride, pad_top, pad_left, backward, sms,
                         cs) for cs in options), key=lambda cp: cp[0])[1]


# The C entry point's arguments before the stream (`kernel_library.bind`).
_ARGS = [I32] + [PTR] * 7 + [I32] * 14


def _launch(x: torch.Tensor, weight: torch.Tensor, stride: int,
            padding: Padding, g: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None,
            dw: Optional[torch.Tensor] = None):
    backward = g is not None
    n, c, h, w = x.shape
    k = weight.shape[-1]
    pad_top, pad_left = padding[0][0], padding[1][0]
    plan = launch_plan(tuple(x.shape), k, stride, pad_top, pad_left,
                       backward, kernel_library.sm_count(x.device.index))
    vec = 4 if c % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, g) if t is not None) else 1
    partials = held = None
    if backward:
        partials = torch.empty(plan.blocks * c * k * k, dtype=torch.float64,
                               device=x.device)
        held = tickets(x.device, kernel_library.stream(x.device),
                       plan.slices)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    name = "depthwise_conv_grad" if backward else "depthwise_conv"
    fn = kernel_library.bind("depthwise_conv", "depthwise_conv", _ARGS)
    kernel_library.launch(
        name, fn, x.device, int(backward), ptr(x), ptr(weight), ptr(g),
        ptr(out), ptr(dw), ptr(partials), ptr(held), n, c, h, w, k, stride,
        pad_top, pad_left, plan.cs, vec, plan.tile_h, plan.tile_w,
        plan.tiles_per_block, plan.smem)


def _forward_kernel(x, weight, stride, padding) -> torch.Tensor:
    """y: one launch."""
    n, c, h, w = x.shape
    y = torch.empty((n, c, -(-h // stride), -(-w // stride)),
                    device=x.device, memory_format=torch.channels_last)
    _launch(x, weight, stride, padding, out=y)
    return y


def _backward_kernel(x, weight, grad, stride, padding, need_dx
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(dx or None, dw): one launch."""
    grad = grad.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(weight)
    _launch(x, weight, stride, padding, g=grad, out=dx, dw=dw)
    return dx, dw


class DepthwiseConv(torch.autograd.Function):
    """`depthwise_conv` with its backward: the kernels on CUDA tensors, the
    plain version on CPU ones."""

    @staticmethod
    def forward(ctx, x, weight, stride, padding):
        if x.device.type == "cuda":
            y = _forward_kernel(x, weight, stride, padding)
        else:
            y = depthwise_conv_reference(x, weight, stride, padding)
        ctx.stride, ctx.padding = stride, padding
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dw = _backward_kernel(x, weight, grad, ctx.stride,
                                      ctx.padding, ctx.needs_input_grad[0])
        else:
            dx, dw = depthwise_conv_backward_reference(x, weight, grad,
                                                       ctx.stride,
                                                       ctx.padding)
        return dx, dw, None, None


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
                   padding: Padding) -> torch.Tensor:
    """The depthwise conv of x [N, C, H, W] by weight [C, 1, k, k] at
    `stride` over x padded by `padding` ((top, bottom), (left, right)) with
    zeros (module doc). On CUDA: float32, channels-last, k 3 or 5, stride 1
    or 2 and the SAME padding; on the CPU any float dtype and padding."""
    if x.ndim != 4 or weight.ndim != 4:
        raise ValueError("x must be [N, C, H, W] and weight [C, 1, k, k]")
    c, k = x.shape[1], weight.shape[-1]
    if tuple(weight.shape) != (c, 1, k, k) or weight.dtype != x.dtype \
            or weight.device != x.device:
        raise ValueError("weight must be [{}, 1, k, k] {} on {}".format(
            c, x.dtype, x.device))
    padding = (tuple(int(p) for p in padding[0]),
               tuple(int(p) for p in padding[1]))
    stride = int(stride)
    if x.device.type == "cuda":
        same = _out_size(x, k, stride, padding) == (
            -(-x.shape[2] // stride), -(-x.shape[3] // stride))
        if (x.dtype != torch.float32 or not channels_last(x)
                or k not in KERNEL_SIZES or stride not in STRIDES or not same
                or max(padding[0][0], padding[1][0]) >= k
                or (stride == 1 and padding != ((k // 2,) * 2,) * 2)):
            raise ValueError("the kernels take float32 channels-last maps, "
                             "k in {}, stride in {} and SAME padding".format(
                                 KERNEL_SIZES, STRIDES))
        weight = weight.contiguous()
    elif x.device.type != "cpu":
        raise ValueError("depthwise_conv runs on cuda or cpu tensors")
    return DepthwiseConv.apply(x, weight, stride, padding)
