"""EfficientLab segmentation network: EfficientNet-b0/b3 encoder truncated
at reduction_4, optional Auto-DeepLab-style ASPP and DeepLab-v3+ skip
decoding, residual skip decoders (RSD), final dropout and a 1x1
projection, upsampled back to the input with align_corners bilinear.

The port of the JAX package's `models/efficientlab.py`. The public call
keeps the JAX layouts: NHWC float images in [0, 255] in, NHWC float32
logits and probabilities out; inside, activations are NCHW.

The skip decoder's batch norms (`decode_skip_batch_normalization` and
those of `sep_conv_{0,1}`) normalize by the batch's moments in every mode,
as the reference's literal training=True does, and update their running
stats only in a training forward (`FusedBatchNorm(always_batch_stats=
True)`). The JAX package's layers write their running stats at train=False
as well, so its eval-mode apply of a skip-decoding model raises unless the
caller makes `batch_stats` mutable; the port computes what that mutable
apply computes and keeps the buffers (ROADMAP.md section C). ASPP's
dropout rate is a fixed 0.5 in training, apart from the final layer's.

bf16 follows flax's `dtype=`: activations and kernels are cast to the
compute dtype at each conv and batch norm, params stay float32, and the
logits are float32. Where the JAX graph promotes (a resize to a new size
multiplies by float32 matrices; concatenating bf16 with float32), the port
promotes the same way.
"""
import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn

from mliis_tpu_torch.models import layers
from mliis_tpu_torch.models.efficientnet import EfficientNetFeatures
from mliis_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw

MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)

# (aspp feature dimension, encoder truncation block) per backbone.
_BACKBONE_CONFIG = {
    "efficientnet-b0": (112, 10),
    "efficientnet-b3": (136, 17),
}


def _cat(tensors):
    """Channel concat with jnp-style dtype promotion."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    return torch.cat([t.to(dtype) for t in tensors], dim=1)


def _dropout(x, rate, train, generator):
    return layers.traced_dropout(generator, x, rate) if train and rate > 0 \
        else x


class _ConvNlBn(nn.Module):
    """conv(use_bias) -> swish -> BN, the RSD branch unit."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dilation: int = 1,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = layers.Conv2d(in_features, features, kernel_size,
                                  dilation=dilation,
                                  compute_dtype=compute_dtype)
        self.batch_normalization = layers.FusedBatchNorm(
            features, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self.batch_normalization(layers.swish(self.conv(x)), train)


class ResidualSkipDecoder(nn.Module):
    """RSD module: upsample to the skip, concat, 3-branch mini-ASPP, fuse,
    residual add."""

    def __init__(self, in_features: int, skip_features: int,
                 num_output_filters: int, residual: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.residual = residual
        decoded = in_features + skip_features
        if in_features != num_output_filters:
            self.upsample_proj = _ConvNlBn(in_features, num_output_filters,
                                           1, compute_dtype=dt)
        nd = num_output_filters
        self.branch_0 = _ConvNlBn(decoded, nd, 1, compute_dtype=dt)
        self.branch_1 = _ConvNlBn(decoded, nd, 3, dilation=2,
                                  compute_dtype=dt)
        self.fuse = _ConvNlBn(2 * nd + decoded, num_output_filters, 3,
                              compute_dtype=dt)

    def forward(self, embedded: torch.Tensor, skip: torch.Tensor,
                train: bool) -> torch.Tensor:
        upsampled = resize_bilinear_align_corners_nchw(
            embedded, skip.shape[-2], skip.shape[-1])
        decoded = _cat([upsampled, skip])
        if hasattr(self, "upsample_proj"):
            upsampled = self.upsample_proj(upsampled, train)
        branch_0 = self.branch_0(decoded, train)
        branch_1 = self.branch_1(decoded, train)
        branch_2 = decoded.mean((2, 3), keepdim=True).expand_as(decoded)
        out = self.fuse(_cat([branch_0, branch_1, branch_2]), train)
        if self.residual:
            out = out + upsampled
        return out


class _SepConv(nn.Module):
    """Depthwise-separable conv with batch-statistics batch norms, the
    DeepLab skip decoder's unit. Its convs have no compute dtype: on bf16
    input they run in the promoted float32, as flax's do."""

    def __init__(self, in_features: int, features: int, kernel_size: int):
        super().__init__()
        self.depthwise_conv = layers.Conv2d(
            in_features, in_features, kernel_size, groups=in_features,
            use_bias=False, depthwise_init=True)
        self.batch_normalization = layers.FusedBatchNorm(
            in_features, always_batch_stats=True)
        self.pointwise_conv = layers.Conv2d(in_features, features, 1,
                                            use_bias=False)
        self.batch_normalization_1 = layers.FusedBatchNorm(
            features, always_batch_stats=True)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = layers.swish(self.batch_normalization(self.depthwise_conv(x),
                                                  train))
        return layers.swish(self.batch_normalization_1(
            self.pointwise_conv(x), train))


class Aspp(nn.Module):
    """Auto-DeepLab-style ASPP with dropout in place of batch norm: a 1x1
    branch, a 3x3 branch at dilation 6 and an image-pooling branch,
    concatenated as [pooled, 3x3, 1x1] and fused by a 1x1 conv. Its convs
    have no compute dtype (float32 on bf16 input, as in flax)."""

    def __init__(self, in_features: int, features: int,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.branch_0 = layers.Conv2d(in_features, features, 1)
        self.branch_1 = layers.Conv2d(in_features, features, 3, dilation=6)
        self.branch_2 = layers.Conv2d(in_features, features, 1)
        self.fuse = layers.Conv2d(3 * features, features, 1)

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        rate = self.dropout_rate
        b0 = _dropout(layers.swish(self.branch_0(x)), rate, train, generator)
        b1 = _dropout(layers.swish(self.branch_1(x)), rate, train, generator)
        # The pooled branch drops before its swish, the others after.
        b2 = layers.swish(_dropout(self.branch_2(x.mean((2, 3), keepdim=True)),
                                   rate, train, generator))
        b2 = b2.expand(-1, -1, x.shape[2], x.shape[3])
        out = self.fuse(_cat([b2, b1, b0]))
        return _dropout(layers.swish(out), rate, train, generator)


class EfficientLab(nn.Module):
    """The segmentation network; forward returns (logits, probabilities)
    at input resolution, both NHWC float32."""

    def __init__(self, n_classes: int = 1,
                 separate_background_channel: bool = True,
                 feature_extractor_name: str = "efficientnet-b0",
                 rsd: Optional[Sequence[int]] = (2,),
                 spatial_pyramid_pooling: bool = False,
                 skip_decoding: bool = False,
                 disable_rsd_residual_connections: bool = False,
                 final_layer_dropout_rate: Optional[float] = 0.2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_output_channels = (n_classes + 1 if separate_background_channel
                                  else n_classes)
        self.final_layer_dropout_rate = final_layer_dropout_rate
        self.compute_dtype = compute_dtype
        self.rsd = tuple(sorted(rsd or (), reverse=True))
        aspp_dim, max_block_num = _BACKBONE_CONFIG[feature_extractor_name]
        self.backbone_name = feature_extractor_name.replace("-", "_")
        features = EfficientNetFeatures(feature_extractor_name, max_block_num,
                                        compute_dtype=compute_dtype)
        self.add_module(self.backbone_name, features)
        channels = features.endpoint_channels()
        decoded = channels["reduction_4"]
        if spatial_pyramid_pooling:
            self.spatial_pyramid_pooling = Aspp(decoded, aspp_dim)
            decoded = aspp_dim
        if skip_decoding:
            skip_dim = aspp_dim // 2
            self.decode_skip_proj = layers.Conv2d(
                channels["reduction_2"], skip_dim, 1, use_bias=False)
            self.decode_skip_batch_normalization = layers.FusedBatchNorm(
                skip_dim, always_batch_stats=True)
            self.sep_conv_0 = _SepConv(decoded + skip_dim,
                                       aspp_dim + skip_dim, 3)
            self.sep_conv_1 = _SepConv(aspp_dim + skip_dim,
                                       aspp_dim + skip_dim, 3)
            decoded = aspp_dim + skip_dim
        for i in self.rsd:
            self.add_module(
                "decode_skip_connections_{}".format(i - 1),
                ResidualSkipDecoder(
                    decoded, channels["reduction_{}".format(i)], aspp_dim,
                    residual=not disable_rsd_residual_connections,
                    compute_dtype=compute_dtype))
            decoded = aspp_dim
        self.final_layer_weights = layers.Conv2d(
            decoded, self.n_output_channels, 1, compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator):
        """Fresh weights drawn from `generator` (flax's initializers)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, images: torch.Tensor, train: bool = True,
                final_layer_dropout_rate: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                upsample: bool = True):
        """images: [N, H, W, 3] float32 in [0, 255]. The logits are an NHWC
        view of the NCHW resize output. With `upsample=False` the logits
        stay NCHW at the decoder's resolution and no probabilities are
        computed (None takes their place): a caller with many classes
        resizes and takes its loss a piece at a time (joint/trainer.py)."""
        in_h, in_w = images.shape[1], images.shape[2]
        mean = torch.tensor(MEAN_RGB, dtype=images.dtype,
                            device=images.device)
        std = torch.tensor(STDDEV_RGB, dtype=images.dtype,
                           device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        _, endpoints = getattr(self, self.backbone_name)(x, train, generator)
        decoded = endpoints["reduction_4"]
        if hasattr(self, "spatial_pyramid_pooling"):
            decoded = self.spatial_pyramid_pooling(decoded, train, generator)
        if hasattr(self, "sep_conv_0"):
            decoded = resize_bilinear_align_corners_nchw(decoded, in_h // 4,
                                                         in_w // 4)
            skip = self.decode_skip_batch_normalization(
                self.decode_skip_proj(endpoints["reduction_2"]), train)
            decoded = _cat([decoded, layers.swish(skip)])
            decoded = self.sep_conv_1(self.sep_conv_0(decoded, train), train)
        for i in self.rsd:
            decoded = getattr(self, "decode_skip_connections_{}".format(
                i - 1))(decoded, endpoints["reduction_{}".format(i)], train)

        rate = final_layer_dropout_rate
        if rate is None:
            rate = self.final_layer_dropout_rate
        if rate is not None:
            decoded = _dropout(decoded, rate, train, generator)

        decoded = self.final_layer_weights(decoded).float()
        if not upsample:
            return decoded, None
        logits = resize_bilinear_align_corners_nchw(decoded, in_h, in_w)
        logits = logits.permute(0, 2, 3, 1)
        return logits, torch.softmax(logits, dim=-1)
