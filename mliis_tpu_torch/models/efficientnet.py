"""EfficientNet feature extractor (b0-b7 tables) with reduction endpoints
and block truncation, over NCHW activations.

The port of the JAX package's `models/efficientnet.py`: MBConv blocks
(expand -> depthwise -> SE -> project, id-skip with drop-connect),
width/depth compound scaling with filter rounding, and the `reduction_i`
endpoints EfficientLab consumes. Submodule names are the flax names.
"""
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from mliis_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel_size: int
    num_repeat: int
    input_filters: int
    output_filters: int
    expand_ratio: int
    id_skip: bool
    strides: Tuple[int, int]
    se_ratio: Optional[float]


BASE_BLOCKS: Tuple[BlockArgs, ...] = (
    BlockArgs(3, 1, 32, 16, 1, True, (1, 1), 0.25),
    BlockArgs(3, 2, 16, 24, 6, True, (2, 2), 0.25),
    BlockArgs(5, 2, 24, 40, 6, True, (2, 2), 0.25),
    BlockArgs(3, 3, 40, 80, 6, True, (2, 2), 0.25),
    BlockArgs(5, 3, 80, 112, 6, True, (1, 1), 0.25),
    BlockArgs(5, 4, 112, 192, 6, True, (2, 2), 0.25),
    BlockArgs(3, 1, 192, 320, 6, True, (1, 1), 0.25),
)

# model_name -> (width_coefficient, depth_coefficient, resolution, dropout)
EFFICIENTNET_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}


def round_filters(filters: int, width_coefficient: float,
                  depth_divisor: int = 8,
                  min_depth: Optional[int] = None) -> int:
    """Width scaling with divisor rounding."""
    if not width_coefficient:
        return filters
    filters *= width_coefficient
    min_depth = min_depth or depth_divisor
    new_filters = max(min_depth,
                      int(filters + depth_divisor / 2) // depth_divisor
                      * depth_divisor)
    if new_filters < 0.9 * filters:
        new_filters += depth_divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    if not depth_coefficient:
        return repeats
    return int(math.ceil(depth_coefficient * repeats))


def decode_truncate(specs: Sequence[BlockArgs],
                    max_block_num: Optional[int]) -> List[BlockArgs]:
    """Stage-level pre-truncation on unscaled repeat counts."""
    out, num_blocks = [], 0
    for spec in specs:
        num_blocks += spec.num_repeat
        if max_block_num is not None and num_blocks > max_block_num + 1:
            break
        out.append(spec)
    return out


def expand_block_list(model_name: str, max_block_num: Optional[int] = None
                      ) -> Tuple[List[BlockArgs], int]:
    """(blocks to build, drop-connect divisor): the divisor is the block
    count of the untruncated model (rate = global_rate * idx / divisor)."""
    width, depth, _, _ = EFFICIENTNET_PARAMS[model_name]
    all_blocks: List[BlockArgs] = []
    for spec in decode_truncate(BASE_BLOCKS, max_block_num):
        spec = dataclasses.replace(
            spec,
            input_filters=round_filters(spec.input_filters, width),
            output_filters=round_filters(spec.output_filters, width),
            num_repeat=round_repeats(spec.num_repeat, depth))
        all_blocks.append(spec)
        for _ in range(spec.num_repeat - 1):
            all_blocks.append(dataclasses.replace(
                spec, input_filters=spec.output_filters, strides=(1, 1),
                num_repeat=1))
    divisor = len(all_blocks)
    if max_block_num is not None:
        all_blocks = all_blocks[: max_block_num + 1]
    return all_blocks, divisor


class MBConvBlock(nn.Module):
    """Mobile inverted residual bottleneck with squeeze-and-excitation."""

    def __init__(self, args: BlockArgs,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        a = self.args = args
        dt = compute_dtype
        filters = a.input_filters * a.expand_ratio
        if a.expand_ratio != 1:
            self.expand_conv = layers.Conv2d(a.input_filters, filters, 1,
                                             use_bias=False, compute_dtype=dt)
            self.batch_normalization = layers.FusedBatchNorm(
                filters, compute_dtype=dt)
        self.depthwise_conv = layers.Conv2d(
            filters, filters, a.kernel_size, stride=a.strides[0],
            groups=filters, use_bias=False, depthwise_init=True,
            compute_dtype=dt)
        self.batch_normalization_1 = layers.FusedBatchNorm(filters,
                                                           compute_dtype=dt)
        self.has_se = a.se_ratio is not None and 0 < a.se_ratio <= 1
        if self.has_se:
            num_reduced = max(1, int(a.input_filters * a.se_ratio))
            self.se_reduce = layers.Conv2d(filters, num_reduced, 1,
                                           compute_dtype=dt)
            self.se_expand = layers.Conv2d(num_reduced, filters, 1,
                                           compute_dtype=dt)
        self.project_conv = layers.Conv2d(filters, a.output_filters, 1,
                                          use_bias=False, compute_dtype=dt)
        self.batch_normalization_2 = layers.FusedBatchNorm(
            a.output_filters, compute_dtype=dt)

    def forward(self, inputs: torch.Tensor, train: bool,
                drop_connect_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.args
        x = inputs
        if a.expand_ratio != 1:
            x = layers.swish(self.batch_normalization(self.expand_conv(x),
                                                      train))
        x = layers.swish(self.batch_normalization_1(self.depthwise_conv(x),
                                                    train))
        if self.has_se:
            se = x.mean((2, 3), keepdim=True)
            se = self.se_expand(layers.swish(self.se_reduce(se)))
            x = torch.sigmoid(se) * x
        x = self.batch_normalization_2(self.project_conv(x), train)
        if (a.id_skip and all(s == 1 for s in a.strides)
                and a.input_filters == a.output_filters):
            if train and drop_connect_rate:
                x = layers.drop_connect(generator, x, drop_connect_rate)
            x = x + inputs
        return x


class EfficientNetFeatures(nn.Module):
    """Stem + MBConv blocks, returning reduction endpoints 1..5 (the last
    block output at each spatial reduction 2^i)."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 max_block_num: Optional[int] = None,
                 drop_connect_rate: float = 0.2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        width, _, _, _ = EFFICIENTNET_PARAMS[model_name]
        self.blocks_args, self.divisor = expand_block_list(model_name,
                                                           max_block_num)
        self.drop_connect_rate = drop_connect_rate
        stem = round_filters(32, width)
        self.stem_conv = layers.Conv2d(3, stem, 3, stride=2, use_bias=False,
                                       compute_dtype=compute_dtype)
        self.stem_batch_normalization = layers.FusedBatchNorm(
            stem, compute_dtype=compute_dtype)
        for idx, args in enumerate(self.blocks_args):
            self.add_module("blocks_{}".format(idx),
                            MBConvBlock(args, compute_dtype=compute_dtype))

    def _is_reduction(self, idx: int) -> bool:
        blocks = self.blocks_args
        return idx == len(blocks) - 1 or blocks[idx + 1].strides[0] > 1

    def endpoint_channels(self) -> Dict[str, int]:
        """Channel count of each `reduction_i` endpoint."""
        out = {}
        for idx, args in enumerate(self.blocks_args):
            if self._is_reduction(idx):
                out["reduction_{}".format(len(out) + 1)] = args.output_filters
        return out

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        blocks = self.blocks_args
        x = layers.swish(self.stem_batch_normalization(self.stem_conv(x),
                                                       train))
        endpoints = {}
        reduction_idx = 0
        for idx in range(len(blocks)):
            is_reduction = self._is_reduction(idx)
            if is_reduction:
                reduction_idx += 1
            rate = (self.drop_connect_rate * idx / self.divisor
                    if self.divisor else 0.0)
            x = getattr(self, "blocks_{}".format(idx))(
                x, train=train, drop_connect_rate=rate, generator=generator)
            if is_reduction:
                endpoints["reduction_{}".format(reduction_idx)] = x
        return x, endpoints
