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
Parameter names keep the flax names (`kernel`, `bias`, `scale`; running
stats `mean`, `var`) so checkpoints map one to one and the l2 term can skip
batch norm by name.
"""
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


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
        ph = same_padding(x.shape[-2], k, s, d)
        pw = same_padding(x.shape[-1], k, s, d)
        dtype = self.compute_dtype or torch.result_type(x, self.kernel)
        x = x.to(dtype)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x, self.kernel.to(dtype), bias, stride=s,
                        dilation=d, groups=self.groups)


class FusedBatchNorm(nn.Module):
    """Scale-bias-folded batch norm (the JAX package's `FusedBatchNorm`).

    `always_batch_stats=True` normalizes by the batch's moments whatever
    `train` says; `train` then only decides whether the running stats are
    updated, so an eval-mode forward leaves the buffers as they were."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3,
                 compute_dtype: Optional[torch.dtype] = None,
                 always_batch_stats: bool = False):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.compute_dtype = compute_dtype
        self.always_batch_stats = always_batch_stats
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

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train or self.always_batch_stats:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = xf.square().mean((0, 2, 3)) - mean.square()
            if train:
                m = self.momentum
                with torch.no_grad():
                    self.mean.mul_(m).add_((1.0 - m) * mean.detach())
                    self.var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        add = self.bias - mean * inv
        dtype = self.compute_dtype or x.dtype
        return (x.to(dtype) * inv.to(dtype)[:, None, None]
                + add.to(dtype)[:, None, None])


swish = F.silu


def drop_connect(generator: torch.Generator, x: torch.Tensor,
                 drop_rate: float) -> torch.Tensor:
    """Stochastic depth on the residual branch; batch dim first."""
    keep_prob = 1.0 - drop_rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    random_tensor = keep_prob + torch.rand(shape, generator=generator,
                                           device=x.device, dtype=x.dtype)
    return (x / keep_prob) * torch.floor(random_tensor)


def traced_dropout(generator: torch.Generator, x: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """Inverted dropout: keep with probability 1-rate, scale by 1/keep."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
