"""Batch augmentation of the meta path: the draws around `full_pass`.

The port of the fused branch of the JAX package's
`ops/augment.augment_batch_pallas`: per sample, the gate (keep the original
with probability `prob_to_return_original`), a uniform permutation of the
six ops, a prefix length 1..6, a Philox seed, and the rotation's angle in
[-45, 45), border mode in {reflect, constant, mirror, wrap}, fill-with-noise
bit and cval in [0, 256) are drawn from a `torch.Generator`, on the batch's
device; the composition itself is one `full_pass` launch.

Layouts: NHWC images [B, H, W, 3] in [0, 255] and NHWC 2-channel one-hot
masks at the public call; the planar [B, C_img + 2, H, W] stack at the
kernel.
"""
from typing import Optional, Tuple

import torch

from mliis_tpu_torch.ops.augment_kernels import NUM_OPS, full_pass

NUM_ROTATE_MODES = 4  # reflect, constant, mirror, wrap


def to_planar(images: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Stack NHWC (images, masks) into a planar [B, C_img + C_msk, H, W]."""
    return torch.cat([images, masks], dim=-1).permute(0, 3, 1, 2).contiguous()


def from_planar(x: torch.Tensor, c_img: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    nhwc = x.permute(0, 2, 3, 1)
    return nhwc[..., :c_img], nhwc[..., c_img:]


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor,
                  prob_to_return_original: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random augmentation of float NHWC (images, masks).

    With probability `prob_to_return_original` (default 1/7, the
    Augmenter's) a sample passes through; otherwise a random prefix of a
    random permutation of the six ops is applied by one `full_pass`. A
    sample that passes through gets prefix length 0, so the kernel does no
    work for it (the JAX package computes it and discards it)."""
    if prob_to_return_original is None:
        prob_to_return_original = 1.0 / (NUM_OPS + 1)
    b, dev = images.shape[0], images.device
    c_img = images.shape[-1]

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator,
                             device=dev, dtype=torch.int32)

    skip = torch.rand(b, generator=generator, device=dev) \
        <= prob_to_return_original
    perm = torch.argsort(torch.rand(b, NUM_OPS, generator=generator,
                                    device=dev), dim=1).to(torch.int32)
    num = torch.where(skip, 0, randint(1, NUM_OPS + 1, (b,)))
    seeds = randint(0, 2 ** 31 - 1, (b,))
    rot = torch.stack([randint(-45, 45, (b,)),
                       randint(0, NUM_ROTATE_MODES, (b,)),
                       randint(0, 2, (b,)),
                       randint(0, 256, (b,))], dim=1)
    out = full_pass(seeds, to_planar(images, masks), perm.contiguous(), num,
                    rot, c_img=c_img)
    return from_planar(out, c_img)
