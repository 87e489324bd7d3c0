"""The model's batch norm by the batch's moments with the swish beside it
(`models/layers.FusedBatchNorm`), in two hand-written kernel launches each
way (csrc/batch_norm_act.cu), with its plain PyTorch version.

`batch_norm_act(x, scale, bias, running_mean, running_var, momentum, eps,
swish)` computes, per channel of x [N, C, H, W] over its N H W values of u
(u = x, or swish(x) with `swish="before"`):
    m = mean u, v = mean u^2 - m^2, inv = rsqrt(v + eps) scale,
    z = u inv + (bias - m inv), y = swish(z) (`swish="after"`) or z,
as one `torch.autograd.Function`, and, given the running stats, updates
them in place as flax does: new = momentum old + (1 - momentum) batch, for
m and the biased v. Its backward is the exact gradient of that formula
(csrc/batch_norm_act.cu's header has it).

  - A CUDA tensor launches the kernels: the moments, then y, forward; the
    gradient's two sums, then dx, backward (no dx launch where x needs no
    gradient). Each counts under "batch_norm_act" in
    `kernel_library.launches`. x is taken in its
    memory format, NCHW or channels-last (another layout is copied to NCHW
    first), and y and dx are written in it. The forward saves x and five
    [C] vectors, not z, y or the squares.
  - A CPU tensor takes the plain version: the same forward in explicit
    PyTorch, the hand-derived backward, and the same running-stat update.
    Any other device raises.

The kernels keep a ticket counter a channel tile on each (device, stream),
zeroed here once and left at zero by every launch (`tickets`).
"""
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops.kernel_library import (F32, I32, I64, PTR,
                                                channels_last)

# csrc/batch_norm_act.cu's constants.
THREADS = 256        # kThreads
MAX_TILE_VECS = 32   # channel vectors of a channels-last tile, at most
BLOCKS_PER_SM = 8    # the grid's target: this many blocks an SM
MIN_ROWS = 16        # rows a thread walks, at least (channels-last)
SWISH = {None: 0, "after": 1, "before": 2}
STATS, APPLY, REDUCE, GRAD = range(4)
MEAN, VAR, RSTD, INV, ADD = range(5)   # the rows of the saved stats


# --------------------------------------------------------------------------
# The plain version.
# --------------------------------------------------------------------------

def swish_grad(t: torch.Tensor) -> torch.Tensor:
    """d swish(t) / dt = s (1 + t (1 - s)), s = sigmoid(t)."""
    s = torch.sigmoid(t)
    return s * (1.0 + t * (1.0 - s))


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def batch_norm_act_forward_reference(x: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor, eps: float = 1e-3,
                                     swish: Optional[str] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): y as the module doc says, in x's dtype, and stats [5, C]
    = (m, v, rstd, inv, a), what the backward and the running-stat update
    read."""
    u = F.silu(x) if swish == "before" else x
    dims = (0, 2, 3)
    m = u.mean(dims)
    v = u.square().mean(dims) - m.square()
    rstd = torch.rsqrt(v + eps)
    inv = rstd * scale
    add = bias - m * inv
    z = u * _per_channel(inv) + _per_channel(add)
    y = F.silu(z) if swish == "after" else z
    return y, torch.stack([m, v, rstd, inv, add])


def batch_norm_act_backward_reference(x: torch.Tensor, grad: torch.Tensor,
                                      stats: torch.Tensor,
                                      swish: Optional[str] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(dx, d_scale, d_bias), the hand-derived gradient of the forward
    (csrc/batch_norm_act.cu's header), from its stats."""
    m, _, rstd, inv, add = stats
    count = x.numel() // x.shape[1]
    dims = (0, 2, 3)
    u = F.silu(x) if swish == "before" else x
    gz = grad
    if swish == "after":
        gz = grad * swish_grad(u * _per_channel(inv) + _per_channel(add))
    centred = u - _per_channel(m)
    s1 = gz.sum(dims)
    s2 = (gz * centred).sum(dims)
    d_v = -0.5 * s2 * inv * rstd.square()
    k0 = -inv * s1 / count
    k1 = 2.0 * d_v / count
    dx = gz * _per_channel(inv) + _per_channel(k0) + _per_channel(k1) \
        * centred
    if swish == "before":
        dx = dx * swish_grad(x)
    return dx, s2 * rstd, s1


def update_running_stats_(running_mean: torch.Tensor,
                          running_var: torch.Tensor, stats: torch.Tensor,
                          momentum: float):
    """running = momentum running + (1 - momentum) batch, in place, for the
    batch's m and v (stats' first two rows)."""
    with torch.no_grad():
        running_mean.mul_(momentum).add_((1.0 - momentum) * stats[MEAN])
        running_var.mul_(momentum).add_((1.0 - momentum) * stats[VAR])


# --------------------------------------------------------------------------
# The kernels.
# --------------------------------------------------------------------------

class Plan(NamedTuple):
    """The kernels' grid for one shape and layout (`launch_plan`)."""
    rows: int        # channels-last: N H W rows (0 on NCHW)
    tiles: int       # channels-last: channel tiles (0 on NCHW)
    tile_vecs: int   # channels-last: channel vectors of a tile
    groups: int      # channels-last: row groups of a block
    split_len: int   # rows (channels-last) or planes (NCHW) of a split
    splits: int
    tickets: int     # ticket counters a reducing launch uses


@functools.lru_cache(maxsize=512)
def launch_plan(shape, channels_last: bool, vec: int, sms: int) -> Plan:
    """The kernels' grid for x of `shape` [N, C, H, W]: channels-last, tiles
    of `tile_vecs` vectors of `vec` channels (at most MAX_TILE_VECS,
    balanced), `groups` row groups a block and `splits` splits of the N H W
    rows; NCHW, a block a (split of the N planes, channel). About
    BLOCKS_PER_SM blocks an SM in all, and on channels-last at least
    MIN_ROWS rows a thread."""
    n, c, h, w = shape
    target = BLOCKS_PER_SM * sms
    if channels_last:
        vecs = c // vec
        tiles = -(-vecs // MAX_TILE_VECS)
        tile_vecs = -(-vecs // tiles)
        groups = THREADS // tile_vecs
        rows = n * h * w
        splits = max(1, min(-(-target // tiles),
                            -(-rows // (groups * MIN_ROWS))))
        split_len = -(-rows // splits)
        return Plan(rows, tiles, tile_vecs, groups, split_len,
                    -(-rows // split_len), tiles)
    splits = max(1, min(-(-target // c), n))
    split_len = -(-n // splits)
    return Plan(0, 0, 0, 0, split_len, -(-n // split_len), c)


_TICKETS = {}   # (device index, stream) -> uint32 zeros, as int32


def tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """The stream's ticket counters, at least `count`, all 0 between
    launches (the kernels leave them so). Shared by every kernel that
    takes tickets: launches on one stream run one after another."""
    key = (device.index, stream)
    held = _TICKETS.get(key)
    if held is None or held.numel() < count:
        held = torch.zeros(max(count, 1024), dtype=torch.int32,
                           device=device)
        _TICKETS[key] = held
    return held


class _Call(NamedTuple):
    """What every launch of one direction shares."""
    x: torch.Tensor
    channels_last: bool
    vec: int
    plan: Plan
    stream: int
    swish: int


def _call(x: torch.Tensor, swish: Optional[str], *others) -> _Call:
    """The launches' layout, vector width (4 where every tensor's
    contiguous axis, C channels-last or H W on NCHW, holds whole 16-byte
    vectors at 16-byte aligned addresses, else 1), plan and stream."""
    n, c, h, w = x.shape
    cl = channels_last(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    vec = 4 if (c if cl else h * w) % 4 == 0 and aligned else 1
    plan = launch_plan(tuple(x.shape), cl, vec,
                       kernel_library.sm_count(x.device.index))
    return _Call(x, cl, vec, plan, kernel_library.stream(x.device),
                 SWISH[swish])


# The C entry point's arguments before the stream (`kernel_library.bind`).
_ARGS = [I32] * 4 + [PTR] * 13 + [I64] + [I32] * 5 + [I64] + [I32] * 2 \
    + [F32] * 3


def _launch(call: _Call, pass_: int, *, g=None, out=None, scale=None,
            bias=None, running=(None, None), stats=None, coef=None,
            d_scale=None, d_bias=None, momentum=0.0, eps=0.0):
    x, plan = call.x, call.plan
    n, c, h, w = x.shape
    partials = held = None
    if pass_ in (STATS, REDUCE):
        partials = torch.empty(plan.splits * 2 * c, dtype=torch.float64,
                               device=x.device)
        held = tickets(x.device, call.stream, plan.tickets)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = kernel_library.bind("batch_norm_act", "batch_norm_act", _ARGS)
    kernel_library.launch(
        "batch_norm_act", fn, x.device, pass_, call.swish,
        int(call.channels_last), call.vec, ptr(x), ptr(g), ptr(out),
        ptr(scale), ptr(bias), ptr(running[0]), ptr(running[1]), ptr(stats),
        ptr(coef), ptr(d_scale), ptr(d_bias), ptr(partials), ptr(held),
        plan.rows, n, h * w, c, plan.tile_vecs, plan.groups, plan.split_len,
        plan.splits, plan.tiles, momentum, 1.0 - momentum, eps)


def _forward_kernel(x, scale, bias, running_mean, running_var, momentum,
                    eps, swish) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats): two launches."""
    y = torch.empty_like(x)
    stats = torch.empty(5, x.shape[1], device=x.device)
    call = _call(x, swish, y)
    _launch(call, STATS, scale=scale, bias=bias,
            running=(running_mean, running_var), stats=stats,
            momentum=momentum, eps=eps)
    _launch(call, APPLY, out=y, stats=stats)
    return y, stats


def _backward_kernel(x, grad, stats, swish, need_dx
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                torch.Tensor]:
    """(dx or None, d_scale, d_bias): one launch, two with dx."""
    c = x.shape[1]
    fmt = torch.channels_last if channels_last(x) else \
        torch.contiguous_format
    grad = grad.contiguous(memory_format=fmt)
    d_scale = torch.empty(c, device=x.device)
    d_bias = torch.empty(c, device=x.device)
    coef = torch.empty(2, c, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    call = _call(x, swish, grad, *((dx,) if need_dx else ()))
    _launch(call, REDUCE, g=grad, stats=stats, coef=coef, d_scale=d_scale,
            d_bias=d_bias)
    if need_dx:
        _launch(call, GRAD, g=grad, out=dx, stats=stats, coef=coef)
    return dx, d_scale, d_bias


class BatchNormAct(torch.autograd.Function):
    """`batch_norm_act` with its backward: the kernels on CUDA tensors, the
    plain version on CPU ones."""

    @staticmethod
    def forward(ctx, x, scale, bias, running_mean, running_var, momentum,
                eps, swish):
        if x.device.type == "cuda":
            y, stats = _forward_kernel(x, scale, bias, running_mean,
                                       running_var, momentum, eps, swish)
            for held in (running_mean, running_var):
                if held is not None and not held.is_inference():
                    # written through its pointer, as an in-place op would
                    torch.autograd.graph.increment_version(held)
        else:
            y, stats = batch_norm_act_forward_reference(x, scale, bias, eps,
                                                        swish)
            if running_mean is not None:
                update_running_stats_(running_mean, running_var, stats,
                                      momentum)
        ctx.swish = swish
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, stats = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, d_scale, d_bias = _backward_kernel(
                x, grad, stats, ctx.swish, ctx.needs_input_grad[0])
        else:
            dx, d_scale, d_bias = batch_norm_act_backward_reference(
                x, grad, stats, ctx.swish)
        return dx, d_scale, d_bias, None, None, None, None, None


def batch_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   running_mean: Optional[torch.Tensor] = None,
                   running_var: Optional[torch.Tensor] = None,
                   momentum: float = 0.99, eps: float = 1e-3,
                   swish: Optional[str] = None) -> torch.Tensor:
    """The batch norm of x [N, C, H, W] by its own moments with the swish
    `swish` ("after" the norm, "before" it, or None) beside it (module doc).
    scale and bias are [C]; the running stats, [C] and contiguous, are
    updated in place when given, and left alone when None. float32 on
    CUDA; float32 or float64 on the CPU."""
    if swish not in SWISH:
        raise ValueError("swish must be None, 'after' or 'before'")
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.float64):
        raise ValueError("x must be a float [N, C, H, W]")
    c = x.shape[1]
    for t in (scale, bias):
        if t.shape != (c,) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("scale and bias must be [{}] {} on {}".format(
                c, x.dtype, x.device))
    if (running_mean is None) != (running_var is None):
        raise ValueError("give both running stats or neither")
    for t in (running_mean, running_var):
        if t is not None and (t.shape != (c,) or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError("running stats must be contiguous [{}] {} on "
                             "{}".format(c, x.dtype, x.device))
    if x.device.type == "cuda":
        if x.dtype != torch.float32:
            raise ValueError("the kernels take float32")
        if not (x.is_contiguous() or channels_last(x)):
            x = x.contiguous()
        scale, bias = scale.contiguous(), bias.contiguous()
    elif x.device.type != "cpu":
        raise ValueError("batch_norm_act runs on cuda or cpu tensors")
    return BatchNormAct.apply(x, scale, bias, running_mean, running_var,
                              float(momentum), float(eps), swish)
