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

`augment_batch` is its draws (`draw_augment`, from one generator) and
their application (`apply_augment`); `augment_batches` makes T tasks'
draws, each from its own generator, and applies them in one pass over
the T*B samples, as the Pallas call gains a grid axis under `jax.vmap`.

Layouts: NHWC images [B, H, W, 3] in [0, 255] and NHWC 2-channel one-hot
masks at the public call; the planar [B, C_img + 2, H, W] stack at the
kernels.
"""
from typing import NamedTuple, Optional, Sequence, Tuple

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


class AugmentDraws(NamedTuple):
    """The per-sample draws of one batch: the op permutation, the prefix
    length (0 for a sample that passes through), the Philox seeds ([B] on
    the fused route, [2, B] on the split route: one a pass), the rotation's
    (angle, border mode, fill-with-noise bit, cval) and, on the split
    route, the border-noise plane."""
    perm: torch.Tensor
    num: torch.Tensor
    seeds: torch.Tensor
    rot: torch.Tensor
    border: Optional[torch.Tensor]


def draw_augment(generator: torch.Generator, b: int, h: int, w: int,
                 c_img: int, device,
                 prob_to_return_original: Optional[float] = None,
                 key_offset: int = 0, key_total: Optional[int] = None
                 ) -> AugmentDraws:
    """The draws of `augment_batch` for a batch of b samples of h x w,
    made from `generator` in its order; with `key_total`, made for the
    whole batch of key_total and sliced to [key_offset, key_offset + b)."""
    if prob_to_return_original is None:
        prob_to_return_original = 1.0 / (NUM_OPS + 1)
    total = b if key_total is None else key_total
    rows = slice(key_offset, key_offset + b)

    def randint(low, high, shape, dim=0):
        """Draws of `shape`, whose `dim` is the batch's, made for the whole
        batch; this slice's."""
        full = list(shape)
        full[dim] = total
        return torch.randint(low, high, full, generator=generator,
                             device=device, dtype=torch.int32
                             ).narrow(dim, key_offset, b)

    def rot_draws():
        return torch.stack([randint(-45, 45, (b,)),
                            randint(0, NUM_ROTATE_MODES, (b,)),
                            randint(0, 2, (b,)),
                            randint(0, 256, (b,))], dim=1)

    skip = torch.rand(total, generator=generator, device=device)[rows] \
        <= prob_to_return_original
    perm = torch.argsort(torch.rand(total, NUM_OPS, generator=generator,
                                    device=device)[rows], dim=1).to(
        torch.int32).contiguous()
    num = torch.where(skip, 0, randint(1, NUM_OPS + 1, (b,)))
    if PALLAS_FUSED_SINGLE_LAUNCH and h == w:   # the fused route
        seeds = randint(0, 2 ** 31 - 1, (b,))
        return AugmentDraws(perm, num, seeds, rot_draws(), None)
    seeds = randint(0, 2 ** 31 - 1, (2, b), dim=1)
    rot = rot_draws()
    border = randint(0, 256, (b, c_img, h, w)).float()
    return AugmentDraws(perm, num, seeds, rot, border)


def apply_augment(draws: AugmentDraws, images: torch.Tensor,
                  masks: torch.Tensor, kernels: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation of float NHWC (images, masks) that `draws` (made
    for this batch's shape) select: one `full_pass` on the fused route,
    two `cheap_pass` around the plain-op rotation on the split route."""
    c_img = images.shape[-1]
    x = to_planar(images, masks)
    if kernels:
        full_pass = augment_kernels.full_pass
        cheap_pass = augment_kernels.cheap_pass
    else:
        full_pass = augment_kernels.full_pass_reference
        cheap_pass = augment_kernels.cheap_pass_reference
    perm, num, seeds, rot = draws.perm, draws.num, draws.seeds, draws.rot
    if draws.border is None:
        out = full_pass(seeds, x, perm, num, rot, c_img=c_img)
        return from_planar(out, c_img)

    rot_pos = torch.argmax((perm == ROTATE_OP).to(torch.int32), dim=1).to(
        torch.int32)
    pre = cheap_pass(seeds[0].contiguous(), x, perm, num,
                     torch.stack([torch.zeros_like(rot_pos), rot_pos],
                                 dim=1), c_img=c_img)
    rotated = rotate_shear_planar(pre, rot, c_img, draws.border)
    mid = torch.where((rot_pos < num)[:, None, None, None], rotated, pre)
    post = cheap_pass(seeds[1].contiguous(), mid.contiguous(), perm, num,
                      torch.stack([rot_pos + 1,
                                   torch.full_like(rot_pos, NUM_OPS)],
                                  dim=1), c_img=c_img)
    return from_planar(post, c_img)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  masks: torch.Tensor,
                  prob_to_return_original: Optional[float] = None,
                  kernels: bool = True, key_offset: int = 0,
                  key_total: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample random augmentation of float NHWC (images, masks).

    With probability `prob_to_return_original` (default 1/7, the
    Augmenter's) a sample passes through; otherwise a random prefix of a
    random permutation of the six ops is applied, by one `full_pass` where
    PALLAS_FUSED_SINGLE_LAUNCH holds and H == W, else by the split route.
    A sample that passes through gets prefix length 0, so the kernels do
    no work for it (the JAX package computes it and discards it).
    `kernels=False` takes the kernels' plain versions on any device
    (`--pallas_augment off`); the draws are the same.

    With `key_total`, the batch is the samples [key_offset, key_offset + B)
    of a batch of key_total split over a mesh data axis: every per-sample
    draw is made for the whole batch and the slice's rows are applied, so
    the shard augments its samples as the whole batch would (each sample's
    noise comes from its own Philox seed)."""
    b, h, w, c_img = images.shape
    draws = draw_augment(generator, b, h, w, c_img, images.device,
                         prob_to_return_original, key_offset, key_total)
    return apply_augment(draws, images, masks, kernels)


def augment_batches(generators: Sequence[torch.Generator],
                    images: torch.Tensor, masks: torch.Tensor,
                    prob_to_return_original: Optional[float] = None,
                    kernels: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`augment_batch` of T batches at once: images [T, B, H, W, C_img],
    masks [T, B, H, W, 2], task t's draws made from generators[t] exactly
    as `augment_batch` makes them, then applied to the T*B samples
    together: one `full_pass` launch at B = T*B on the fused route, two
    `cheap_pass` launches and one rotation on the split route (the TPU
    kernel's extra grid axis under `jax.vmap`). Each sample's result
    depends only on its own draws, so task t's batch comes out as
    `augment_batch(generators[t], images[t], masks[t])` would give it."""
    t, b, h, w, c_img = images.shape
    per_task = [draw_augment(g, b, h, w, c_img, images.device,
                             prob_to_return_original) for g in generators]
    if len(per_task) != t:
        raise ValueError("{} batches need {} generators, got {}".format(
            t, t, len(per_task)))
    fused = per_task[0].border is None
    draws = AugmentDraws(
        *(torch.cat(parts, dim=1 if name == "seeds" and not fused else 0)
          if parts[0] is not None else None
          for name, parts in zip(AugmentDraws._fields, zip(*per_task))))
    out_i, out_m = apply_augment(draws, images.reshape((t * b,)
                                                       + images.shape[2:]),
                                 masks.reshape((t * b,) + masks.shape[2:]),
                                 kernels)
    return (out_i.reshape(images.shape),
            out_m.reshape((t, b) + out_m.shape[1:]))
