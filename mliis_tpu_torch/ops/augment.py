"""Batch augmentation of the meta path: the draws around the kernels.

The port of the JAX package's `ops/augment.augment_batch_pallas`: per
sample, the gate (keep the original with probability
`prob_to_return_original`), a uniform permutation of the six ops, a prefix
length 1..6, Philox seeds, and the rotation's angle in [-45, 45), border
mode in {reflect, constant, mirror, wrap}, fill-with-noise bit and cval in
[0, 256) are drawn from a `torch.Generator`, on the batch's device. Then,
as the JAX package routes it:
  - the fused route (square planes and `PALLAS_FUSED_SINGLE_LAUNCH`): one
    `full_pass` launch applies the whole composition;
  - the split route (H != W, or the flag off): a `cheap_pass` over the
    stages before the rotation, the plain-op rotation
    `rotate_shear_planar` (with a U{0..255} border-noise plane drawn here)
    on the samples whose prefix reaches it, and a `cheap_pass` over the
    stages after it, each pass with its own seed.

Layouts: NHWC images [B, H, W, 3] in [0, 255] and NHWC 2-channel one-hot
masks at the public call; the planar [B, C_img + 2, H, W] stack at the
kernels.
"""
from typing import Optional, Tuple

import torch

from mliis_tpu_torch.ops import augment_kernels
from mliis_tpu_torch.ops.augment_kernels import (NUM_OPS, ROTATE_OP,
                                                 rotate_shear_planar)

NUM_ROTATE_MODES = 4  # reflect, constant, mirror, wrap
# The JAX package's default: one `full_pass` launch where the planes are
# square. False sends every batch down the split route.
PALLAS_FUSED_SINGLE_LAUNCH = True


def to_planar(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Stack NHWC (images, masks) into a planar [B, C_img + C_msk, H, W]."""
    return torch.cat([images, masks], dim=-1).permute(0, 3, 1, 2).contiguous()


def from_planar(x: torch.Tensor, c_img: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    nhwc = x.permute(0, 2, 3, 1)
    return nhwc[..., :c_img], nhwc[..., c_img:]


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor,
                  prob_to_return_original: Optional[float] = None,
                  kernels: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random augmentation of float NHWC (images, masks).

    With probability `prob_to_return_original` (default 1/7, the
    Augmenter's) a sample passes through; otherwise a random prefix of a
    random permutation of the six ops is applied, by one `full_pass` where
    PALLAS_FUSED_SINGLE_LAUNCH holds and H == W, else by the split route. A sample that passes through gets prefix length 0, so
    the kernels do no work for it (the JAX package computes it and discards
    it). `kernels=False` takes the kernels' plain versions on any device
    (`--pallas_augment off`); the draws are the same."""
    if prob_to_return_original is None:
        prob_to_return_original = 1.0 / (NUM_OPS + 1)
    b, h, w, c_img = images.shape
    dev = images.device

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator,
                             device=dev, dtype=torch.int32)

    def rot_draws():
        return torch.stack([randint(-45, 45, (b,)),
                            randint(0, NUM_ROTATE_MODES, (b,)),
                            randint(0, 2, (b,)),
                            randint(0, 256, (b,))], dim=1)

    skip = torch.rand(b, generator=generator, device=dev) \
        <= prob_to_return_original
    perm = torch.argsort(torch.rand(b, NUM_OPS, generator=generator,
                                    device=dev), dim=1).to(torch.int32)
    perm = perm.contiguous()
    num = torch.where(skip, 0, randint(1, NUM_OPS + 1, (b,)))
    x = to_planar(images, masks)
    if kernels:
        full_pass = augment_kernels.full_pass
        cheap_pass = augment_kernels.cheap_pass
    else:
        full_pass = augment_kernels.full_pass_reference
        cheap_pass = augment_kernels.cheap_pass_reference
    if PALLAS_FUSED_SINGLE_LAUNCH and h == w:
        seeds = randint(0, 2 ** 31 - 1, (b,))
        out = full_pass(seeds, x, perm, num, rot_draws(), c_img=c_img)
        return from_planar(out, c_img)

    seeds = randint(0, 2 ** 31 - 1, (2, b))
    rot = rot_draws()
    border = randint(0, 256, (b, c_img, h, w)).float()
    rot_pos = torch.argmax((perm == ROTATE_OP).to(torch.int32), dim=1).to(
        torch.int32)
    pre = cheap_pass(seeds[0], x, perm, num,
                     torch.stack([torch.zeros_like(rot_pos), rot_pos],
                                 dim=1), c_img=c_img)
    rotated = rotate_shear_planar(pre, rot, c_img, border)
    mid = torch.where((rot_pos < num)[:, None, None, None], rotated, pre)
    post = cheap_pass(seeds[1], mid.contiguous(), perm, num,
                      torch.stack([rot_pos + 1,
                                   torch.full_like(rot_pos, NUM_OPS)],
                                  dim=1), c_img=c_img)
    return from_planar(post, c_img)
