"""Shared model layers: flax-compatible conv and batch norm, drop-connect,
dropout and the initializers. Activations are NCHW inside the model.

What differs from the obvious `nn.Conv2d` / `nn.BatchNorm2d`:
  - `Conv2d` pads like flax `'SAME'`: pad_total = max((ceil(in/s)-1)*s +
    (k-1)*d + 1 - in, 0) with the smaller half first, so a stride-2 conv
    over an even input pads (0, 1) for k=3 and (1, 2) for k=5, which no
    symmetric `padding=` reproduces;
  - `compute_dtype` casts both the activation and the kernel (flax's
    `dtype=`); params stay float32. There is no autocast;
  - `FusedBatchNorm` takes the biased variance E[x^2]-E[x]^2 in float32,
    updates the running stats with flax momentum 0.99 (new = 0.99*old +
    0.01*batch, the biased variance included), uses eps 1e-3, and
    normalizes with one folded multiply-add in the compute dtype. With
    `always_batch_stats` it normalizes by the batch's moments in both
    modes and updates the running stats only in training (the skip
    decoder's layers, whose reference passes a literal training=True).
    With `axis_name` the batch moments E[x] and E[x^2] are averaged over
    that mesh axis (sync-BN, the JAX package's `lax.pmean`), so every
    shard of a split batch normalizes by, and keeps running stats of, the
    whole batch's moments; the axis must be bound
    (`parallel.mesh.bound`) when batch moments are taken. The swish beside
    a norm is the norm's (`swish="after"` or `"before"`, as the model
    places it), so that a float32 CUDA map normalized by its batch's
    moments, with no mesh axis or spatial context, goes through one
    hand-written kernel pair each way with its swish
    (`ops/batch_norm_act`); everything else (the CPU, bf16, sync-BN, a
    spatial context, the running moments, a traced forward) takes the
    composition of PyTorch ops;
  - a depthwise `Conv2d` (groups == in == out channels) of k 3 or 5,
    dilation 1, stride 1 or 2 and no bias, over a float32 channels-last
    CUDA map with no spatial context and no tracer (the backbone's
    wherever its input is NHWC in memory), goes through one hand-written
    kernel each way, which reads the SAME padding in place
    (`ops/depthwise_conv`); every other conv (the dense and 1x1 convs,
    bf16, NCHW maps, a spatial context, a traced forward) pads with
    `F.pad` and runs `F.conv2d`;
  - under a bound spatial context (`parallel/spatial.py`, the H axis split
    over ranks) a conv with a window (k > 1 or stride > 1) fetches the
    input rows its owned output rows read and pads only W, a batch norm
    without `axis_name` takes the moments of every rank's rows, and
    dropout keeps this rank's rows of the whole map's mask;
  - under a bound task axis (`task_axis`, the JAX package's `jax.vmap`
    over a meta-batch's tasks) every parameter and running stat is
    stacked [T, ...] (substituted with `torch.func.functional_call`) and
    the activations fold the task axis into channels, [B, T*C, H, W] with
    task t's channels at [t*C, (t+1)*C): a conv runs with T times the
    groups over its kernel viewed [T*Cout, Cin/groups, k, k], a batch
    norm's moments and running stats are per channel and so per task,
    drop-connect and dropout draw each task's mask from that task's own
    generator (a list of T generators takes the one generator's place)
    with the shape a one-task forward draws, and `cat` concatenates each
    task's channels (a plain `torch.cat` would mix tasks). `fold_nhwc`
    and `unfold_nchw` move the images and logits in and out of the
    folded layout. Under a task axis a sync-BN's `axis_name` averages
    the stacked [2, T*C] moments over the mesh axis in one all-reduce, so
    each task normalizes by its whole split batch. A task axis does not
    compose with a spatial context (NotImplementedError).
Parameter names keep the flax names (`kernel`, `bias`, `scale`; running
stats `mean`, `var`) so checkpoints map one to one and the l2 term can skip
batch norm by name.
"""
import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mliis_tpu_torch.ops import batch_norm_act as bn_act
from mliis_tpu_torch.ops import depthwise_conv as dw_conv
from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.parallel import spatial


_TASKS: contextvars.ContextVar = contextvars.ContextVar("task_axis",
                                                       default=None)


@contextlib.contextmanager
def task_axis(num_tasks: int):
    """Bind a task axis of `num_tasks` tasks for the block: the models'
    layers then compute T tasks at once in the folded layout."""
    if spatial.current() is not None:
        raise NotImplementedError("a task axis under a spatial context")
    token = _TASKS.set(int(num_tasks))
    try:
        yield
    finally:
        _TASKS.reset(token)


def fold_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> an NCHW view; under a task axis [T, B, H, W,
    C] -> the folded [B, T*C, H, W], channels-last in memory as the
    one-task view is."""
    t = _TASKS.get()
    if t is None:
        return x.permute(0, 3, 1, 2)
    _, b, h, w, c = x.shape
    return x.permute(1, 2, 3, 0, 4).reshape(b, h, w, t * c).permute(
        0, 3, 1, 2)


def unfold_nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, W] -> an NHWC view; under a task axis the folded
    [B, T*C, H, W] -> [T, B, H, W, C]."""
    t = _TASKS.get()
    if t is None:
        return x.permute(0, 2, 3, 1)
    b, tc, h, w = x.shape
    return x.reshape(b, t, tc // t, h, w).permute(1, 0, 3, 4, 2)


def cat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Channel concat of NCHW maps; under a task axis each task's channels
    in turn, so task t's block holds its own maps' channels (channels-last
    in memory, as `torch.cat` keeps channels-last maps)."""
    t = _TASKS.get()
    if t is None:
        return torch.cat(list(tensors), dim=1)
    b, _, h, w = tensors[0].shape
    nhwc = torch.cat([x.permute(0, 2, 3, 1).reshape(b, h, w, t, -1)
                      for x in tensors], dim=-1)
    return nhwc.reshape(b, h, w, -1).permute(0, 3, 1, 2)


def _task_draws(generator, shape, device, dtype=None) -> torch.Tensor:
    """Uniform draws of `shape` from `generator`; under a task axis one
    draw of that shape from each task's generator, stacked [B, T, ...]
    (`shape` is one task's, batch dim first)."""
    t = _TASKS.get()
    if t is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=dtype)
    if len(generator) != t:
        raise ValueError("a task axis of {} needs {} generators, got {}"
                         .format(t, t, len(generator)))
    return torch.stack([torch.rand(shape, generator=g, device=device,
                                   dtype=dtype) for g in generator], dim=1)


def same_padding(size: int, kernel: int, stride: int = 1,
                 dilation: int = 1) -> Tuple[int, int]:
    """(before, after) padding of flax/TF 'SAME' along one axis."""
    effective = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


def conv_kernel_init_(kernel: torch.Tensor, generator: torch.Generator):
    """Normal(0, sqrt(2/fan_out)), fan_out = kh*kw*out (torch layout
    [out, in, kh, kw])."""
    out, _, kh, kw = kernel.shape
    std = math.sqrt(2.0 / (kh * kw * out))
    with torch.no_grad():
        kernel.normal_(0.0, std, generator=generator)


def depthwise_kernel_init_(kernel: torch.Tensor, generator: torch.Generator):
    """TF DepthwiseConv2D treats the depth multiplier (1) as fan-out."""
    _, _, kh, kw = kernel.shape
    with torch.no_grad():
        kernel.normal_(0.0, math.sqrt(2.0 / (kh * kw)), generator=generator)


class Conv2d(nn.Module):
    """flax `nn.Conv` with 'SAME' padding over NCHW activations."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, depthwise_init: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.kernel_size = kernel_size
        self.depthwise_init = depthwise_init
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def reset_parameters(self, generator: torch.Generator):
        init = depthwise_kernel_init_ if self.depthwise_init \
            else conv_kernel_init_
        init(self.kernel, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, d = self.kernel_size, self.stride, self.dilation
        if spatial.current() is not None and (k > 1 or s > 1
                                              or x.shape[-2] == 0):
            if _TASKS.get() is not None:
                raise NotImplementedError("a task axis under a spatial "
                                          "context")
            return self._forward_sharded(x)
        ph = same_padding(x.shape[-2], k, s, d)
        pw = same_padding(x.shape[-1], k, s, d)
        dtype = self.compute_dtype or torch.result_type(x, self.kernel)
        x = x.to(dtype)
        kernel, bias, groups = self.kernel, self.bias, self.groups
        t = _TASKS.get()
        if t is not None:   # stacked [T, Cout, Cin/g, k, k]: T x the groups
            kernel = kernel.reshape((-1,) + tuple(kernel.shape[2:]))
            bias = None if bias is None else bias.reshape(-1)
            groups *= t
        if self._kernel_route(x, kernel, groups):
            return dw_conv.depthwise_conv(x, kernel.to(dtype), s, (ph, pw))
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        bias = None if bias is None else bias.to(dtype)
        return F.conv2d(x, kernel.to(dtype), bias, stride=s, dilation=d,
                        groups=groups)

    def _kernel_route(self, x: torch.Tensor, kernel: torch.Tensor,
                      groups: int) -> bool:
        """Whether the conv goes through `ops/depthwise_conv`'s kernels: a
        depthwise conv (groups == in == out channels; under a task axis
        the folded T*C) of k 3 or 5, dilation 1, stride 1 or 2 and no
        bias, over a float32 channels-last CUDA map (after the compute
        cast), with no spatial context, and not traced (the kernels read
        memory)."""
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and groups == x.shape[1] == kernel.shape[0]
                and kernel.shape[1] == 1 and self.bias is None
                and self.kernel_size in dw_conv.KERNEL_SIZES
                and self.stride in dw_conv.STRIDES and self.dilation == 1
                and kernel_library.channels_last(x)
                and spatial.current() is None
                and not torch.compiler.is_compiling())

    def _forward_sharded(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's output rows of the conv of an H-sharded map: the
        'SAME' padding of the global height, the input rows fetched from
        the ranks that own them (zeros past the image's edges). A rank with
        no output rows convolves a zero window of the kernel's height and
        keeps no row: its graph still holds every collective."""
        k, s, d = self.kernel_size, self.stride, self.dilation
        height = spatial.global_height(x)
        out_h, lo, hi = spatial.conv_windows(
            height, k, s, d, same_padding(height, k, s, d)[0])
        pw = same_padding(x.shape[-1], k, s, d)
        spatial.register(-(-x.shape[-1] // s), out_h)
        dtype = self.compute_dtype or torch.result_type(x, self.kernel)
        x = spatial.fetch_rows(x.to(dtype), lo, hi)
        effective = (k - 1) * d + 1
        x = F.pad(x, (pw[0], pw[1], 0, max(effective - x.shape[-2], 0)))
        bias = None if self.bias is None else self.bias.to(dtype)
        out = F.conv2d(x, self.kernel.to(dtype), bias, stride=s, dilation=d,
                       groups=self.groups)
        own = spatial.owned_rows(out_h)
        return out[:, :, :own[1] - own[0]]


class FusedBatchNorm(nn.Module):
    """Scale-bias-folded batch norm (the JAX package's `FusedBatchNorm`).

    `always_batch_stats=True` normalizes by the batch's moments whatever
    `train` says; `train` then only decides whether the running stats are
    updated, so an eval-mode forward leaves the buffers as they were.
    `axis_name` averages the batch moments over that bound mesh axis
    (under a task axis, every task's in one all-reduce); without one, a
    bound spatial context sums them over every rank's rows. `swish` is the
    swish beside the norm: applied to its output ("after"), to its input
    ("before"), or none (None)."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3,
                 compute_dtype: Optional[torch.dtype] = None,
                 always_batch_stats: bool = False,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.compute_dtype = compute_dtype
        self.always_batch_stats = always_batch_stats
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _kernel_route(self, x: torch.Tensor, train: bool) -> bool:
        """Whether the norm goes through `ops/batch_norm_act`'s kernels: a
        float32 CUDA map normalized by its batch's moments, with no mesh
        axis, no spatial context, and not traced (the kernels read
        memory)."""
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and self.compute_dtype in (None, torch.float32)
                and (train or self.always_batch_stats)
                and self.axis_name is None and spatial.current() is None
                and not torch.compiler.is_compiling())

    def forward(self, x: torch.Tensor, train: bool,
                swish: Optional[str] = None) -> torch.Tensor:
        if swish not in (None, "after", "before"):
            raise ValueError("swish must be None, 'after' or 'before'")
        if self._kernel_route(x, train):
            running = ((self.mean.view(-1), self.var.view(-1)) if train
                       else (None, None))
            return bn_act.batch_norm_act(
                x, self.scale.reshape(-1), self.bias.reshape(-1), *running,
                momentum=self.momentum, eps=self.epsilon, swish=swish)
        if swish == "before":
            x = F.silu(x)
        y = self._composition(x, train)
        return F.silu(y) if swish == "after" else y

    def _composition(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train or self.always_batch_stats:
            xf = x.float()
            if self.axis_name is None and spatial.current() is not None:
                mean, mean2 = spatial.moments(xf)
            else:
                mean = xf.mean((0, 2, 3))
                mean2 = xf.square().mean((0, 2, 3))
            if self.axis_name is not None:
                mean, mean2 = mesh_lib.pmean(torch.stack([mean, mean2]),
                                             self.axis_name)
            var = mean2 - mean.square()
            if train:   # the buffers may be stacked [T, C]: view them flat
                m = self.momentum
                with torch.no_grad():
                    self.mean.view(-1).mul_(m).add_((1.0 - m)
                                                    * mean.detach())
                    self.var.view(-1).mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.mean.reshape(-1), self.var.reshape(-1)
        inv = torch.rsqrt(var + self.epsilon) * self.scale.reshape(-1)
        add = self.bias.reshape(-1) - mean * inv
        dtype = self.compute_dtype or x.dtype
        return (x.to(dtype) * inv.to(dtype)[:, None, None]
                + add.to(dtype)[:, None, None])


swish = F.silu


def drop_connect(generator, x: torch.Tensor,
                 drop_rate: float) -> torch.Tensor:
    """Stochastic depth on the residual branch; batch dim first. Under a
    task axis each task drops its own samples' branches, drawn from its
    generator."""
    keep_prob = 1.0 - drop_rate
    t = _TASKS.get()
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    random_tensor = keep_prob + _task_draws(generator, shape, x.device,
                                            x.dtype)
    if t is None:
        return (x / keep_prob) * torch.floor(random_tensor)
    folded = x.reshape((x.shape[0], t, -1) + tuple(x.shape[2:]))
    return ((folded / keep_prob) * torch.floor(random_tensor)
            ).reshape(x.shape)


def traced_dropout(generator, x: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """Inverted dropout: keep with probability 1-rate, scale by 1/keep.
    Under a spatial context an NCHW map keeps this rank's rows of the
    mask drawn for every row, so the generator moves as in the unsharded
    forward. Under a task axis each task's mask is drawn from its own
    generator at one task's shape."""
    keep_prob = 1.0 - rate
    t = _TASKS.get()
    if t is not None:
        shape = (x.shape[0], x.shape[1] // t) + tuple(x.shape[2:])
        draw = _task_draws(generator, shape, x.device).reshape(x.shape)
    elif spatial.current() is None:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        shape = x.shape[:-2] + (spatial.global_height(x), x.shape[-1])
        draw = spatial.take_rows(torch.rand(shape, generator=generator,
                                            device=x.device))
    keep = draw < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
