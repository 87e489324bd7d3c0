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

The per-image API of the JAX package (`additive_gaussian_noise`,
`exposure`, `random_eraser`, `fliplr`, `translate`, `rotate_img_mask`,
`apply_augmentations`) takes one (image [H, W, C_img], one-hot mask [H,
W, 2]) pair and a `torch.Generator`. It is plain PyTorch: the cheap ops
are `augment_kernels._compose_reference`'s, drawing from the generator
instead of Philox counters, and a rotation is the three DFT shears
(`rotate_shear_planar`) or, with `FAST_ROTATE = False`, the 4-tap
bilinear and nearest sampler (`rotate_4tap_planar`), which the split
route then uses too. The fused route always shears, as the JAX package's
`full_pass` does.

Layouts: NHWC images [B, H, W, 3] in [0, 255] and NHWC 2-channel one-hot
masks at the public call; the planar [B, C_img + 2, H, W] stack at the
kernels.
"""
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.ops import augment_kernels
from mliis_tpu_torch.ops.augment_kernels import (NUM_OPS, ROTATE_OP,
                                                 rotate_shear_planar)

NUM_ROTATE_MODES = 4  # reflect, constant, mirror, wrap
# The JAX package's default: one `full_pass` launch where the planes are
# square. False sends every batch down the split route.
PALLAS_FUSED_SINGLE_LAUNCH = True
# The JAX package's rotation toggle: the DFT shears (True) or the 4-tap
# sampler (False) on the split route and in the per-image ops.
FAST_ROTATE = True


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
    rotate = rotate_shear_planar if FAST_ROTATE else rotate_4tap_planar
    rotated = rotate(pre, rot, c_img, draws.border)
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
                    kernels: bool = True, key_offset: int = 0,
                    key_total: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`augment_batch` of T batches at once: images [T, B, H, W, C_img],
    masks [T, B, H, W, 2], task t's draws made from generators[t] exactly
    as `augment_batch` makes them, then applied to the T*B samples
    together: one `full_pass` launch at B = T*B on the fused route, two
    `cheap_pass` launches and one rotation on the split route (the TPU
    kernel's extra grid axis under `jax.vmap`). Each sample's result
    depends only on its own draws, so task t's batch comes out as
    `augment_batch(generators[t], images[t], masks[t], key_offset=,
    key_total=)` would give it: with `key_total` each task's draws are
    made for its whole batch and sliced to this data shard's rows."""
    t, b, h, w, c_img = images.shape
    per_task = [draw_augment(g, b, h, w, c_img, images.device,
                             prob_to_return_original, key_offset, key_total)
                for g in generators]
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


# --------------------------------------------------------------------------
# The 4-tap rotation and the per-image API.
# --------------------------------------------------------------------------

def _rotation_coords(h: int, w: int, angle: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[m, H, W] input-space sampling coordinates of a rotation by angle
    [m] degrees about the center, in float32 as the JAX package takes
    them."""
    theta = (-angle.float() * math.pi / 180.0)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = angle.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None] - cy
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :] - cx
    cos, sin = torch.cos(theta), torch.sin(theta)
    return cos * ys - sin * xs + cy, sin * ys + cos * xs + cx


def _fold_coords(c: torch.Tensor, n: int, mode: torch.Tensor
                 ) -> torch.Tensor:
    """Coordinates folded into [0, n-1] by border mode (scipy's): 0
    reflect (edge-duplicating), 1 constant (no fold), 2 mirror
    (edge-sharing), 3 wrap."""
    reflect = torch.remainder(c, 2.0 * n)
    reflect = torch.where(reflect > n - 1, 2.0 * n - 1.0 - reflect, reflect)
    mirror = torch.remainder(c, 2.0 * n - 2.0)
    mirror = torch.where(mirror > n - 1, 2.0 * n - 2.0 - mirror, mirror)
    wrap = torch.remainder(c, 1.0 * n)
    return torch.where(mode == 0, reflect, torch.where(
        mode == 2, mirror, torch.where(mode == 3, wrap, c)))


def rotate_4tap_planar(v: torch.Tensor, rot: torch.Tensor, c_img: int,
                       noise_img: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_rotate_4tap_planar` on planar v [m, C, H, W]:
    rot [m, 4] as for `rotate_shear_planar`. The image planes are sampled
    bilinearly and the mask planes at the nearest tap, after folding the
    inverse-rotation coordinates by the border mode; in constant mode a
    tap outside the image gives its weight to the fill (the constant
    rot[:, 3], or where rot[:, 2] == 1 noise_img [m, c_img, H, W] on the
    pixels no tap reaches) and the mask's nearest point outside gives
    background."""
    m, c_tot, h, w = v.shape
    src_y, src_x = _rotation_coords(h, w, rot[:, 0])
    mode = rot[:, 1, None, None]
    constant = mode == 1
    fy, fx = _fold_coords(src_y, h, mode), _fold_coords(src_x, w, mode)
    y0f, x0f = torch.floor(fy), torch.floor(fx)
    wy, wx = fy - y0f, fx - x0f
    y0 = y0f.long().clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)

    def inside(yt, xt):
        ok = ((yt >= -1e-6) & (yt <= h - 1 + 1e-6) & (xt >= -1e-6)
              & (xt <= w - 1 + 1e-6)).float()
        return torch.where(constant, ok, torch.ones_like(ok))

    taps = [((1 - wy) * (1 - wx) * inside(y0f, x0f), y0, x0),
            ((1 - wy) * wx * inside(y0f, x0f + 1), y0, x1),
            (wy * (1 - wx) * inside(y0f + 1, x0f), y1, x0),
            (wy * wx * inside(y0f + 1, x0f + 1), y1, x1)]
    flat = v.reshape(m, c_tot, h * w)
    sampled, mass, values = 0.0, 0.0, []
    for weight, yt, xt in taps:
        idx = (yt * w + xt).reshape(m, 1, h * w).expand(m, c_tot, h * w)
        vals = torch.gather(flat, 2, idx).reshape(m, c_tot, h, w)
        values.append(vals)
        sampled = sampled + weight[:, None] * vals
        mass = mass + weight
    fill_noise = (rot[:, 2] == 1)[:, None, None, None]
    cval = torch.where(fill_noise, -256.0, rot[:, 3].float()[:, None, None,
                                                              None])
    img = sampled[:, :c_img] + (1.0 - mass)[:, None] * cval
    img = torch.where((mass <= 1e-6)[:, None] & fill_noise, noise_img, img)
    img = torch.where(constant[:, None], img, sampled[:, :c_img])
    near = (wy >= 0.5).long() * 2 + (wx >= 0.5).long()
    msk = values[0][:, c_img:]
    for t in range(1, 4):
        msk = torch.where((near == t)[:, None], values[t][:, c_img:], msk)
    ny, nx = torch.round(src_y), torch.round(src_x)
    out = (ny < 0) | (ny > h - 1) | (nx < 0) | (nx > w - 1)
    bg = torch.zeros_like(msk)
    bg[:, 0] = 1.0
    msk = torch.where((constant & out)[:, None], bg, msk)
    return torch.cat([img, msk], dim=1)


def _generator_bits(generator: torch.Generator):
    """A bit source for `augment_kernels._compose_reference` that draws
    fresh words from `generator` in place of Philox at fixed counters."""
    def bits(key, counter, stream):
        shape = torch.broadcast_shapes(key.shape, counter.shape)
        words = torch.randint(0, 2 ** 32, (2,) + tuple(shape),
                              generator=generator, device=counter.device)
        return words[0], words[1]
    return bits


def _cheap_ops(generator: torch.Generator, x: torch.Tensor,
               ops: Sequence[int], c_img: int, **op_constants
               ) -> torch.Tensor:
    """The cheap ops `ops` (op indices, no rotation, none twice) applied
    in turn to planar x [1, C, H, W], drawn from `generator`."""
    order = list(ops) + [o for o in range(NUM_OPS) if o not in ops]
    perm = torch.tensor([order], dtype=torch.int32)
    applied = torch.arange(NUM_OPS)[None] < len(ops)
    return augment_kernels._compose_reference(
        torch.zeros(1, dtype=torch.int32), x, perm, applied, None, c_img,
        _generator_bits(generator),
        **{**augment_kernels._OP_CONSTANTS, **op_constants})


def _rotate(generator: torch.Generator, x: torch.Tensor, c_img: int,
            max_angle: int = 45) -> torch.Tensor:
    """A rotation of planar x [1, C, H, W] by an angle in [-max_angle,
    max_angle) with a random border mode, fill bit, cval and noise plane."""
    h, w = x.shape[-2:]
    draw = lambda low, high, shape=(): torch.randint(  # noqa: E731
        low, high, shape, generator=generator, device=x.device)
    rot = torch.stack([draw(-max_angle, max_angle), draw(0, NUM_ROTATE_MODES),
                       draw(0, 2), draw(0, 256)])[None].to(torch.int32)
    noise = draw(0, 256, (1, c_img, h, w)).float()
    rotate = rotate_shear_planar if FAST_ROTATE else rotate_4tap_planar
    return rotate(x, rot, c_img, noise)


def _per_image(fn: Callable[[torch.Tensor, int], torch.Tensor],
               image: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fn(planar x [1, C, H, W], c_img)` on one NHWC pair."""
    c_img = image.shape[-1]
    out_i, out_m = from_planar(fn(to_planar(image[None], mask[None]), c_img),
                               c_img)
    return out_i[0], out_m[0]


def random_eraser(generator, image, mask, s_l: float = 0.02,
                  s_h: float = 0.10, r_1: float = 0.3, r_2: float = 1.0 / 0.3,
                  v_l: float = 0.0, v_h: float = 255.0):
    """A rectangle of area in [s_l, s_h) of the image and aspect in [r_1,
    r_2) set to one value in [v_l, v_h), its mask to background."""
    return _per_image(lambda x, c: _cheap_ops(
        generator, x, [0], c, eraser_s_l=s_l, eraser_s_h=s_h, eraser_r_1=r_1,
        eraser_r_2=r_2, eraser_v_l=v_l, eraser_v_h=v_h), image, mask)


def translate(generator, image, mask, max_shift: int = 23):
    """A shift of 1..max_shift pixels along one axis, rolled or with the
    vacated stripe filled (the image by a random color, the mask by
    background)."""
    return _per_image(lambda x, c: _cheap_ops(generator, x, [1], c,
                                              max_shift=max_shift),
                      image, mask)


def fliplr(generator, image, mask):
    """The pair mirrored left to right; draws nothing."""
    del generator
    return image.flip(1), mask.flip(1)


def additive_gaussian_noise(generator, image, mask, mean_sd: float = 5.1):
    """Gaussian noise of sd |mean_sd + N(0, 1)| on the image, clipped to
    [0, 255]."""
    return _per_image(lambda x, c: _cheap_ops(generator, x, [3], c,
                                              noise_mean_sd=mean_sd),
                      image, mask)


def exposure(generator, image, mask, mean_sd: float = 12.75):
    """One brightness shift of sd |mean_sd + N(0, 1)| on the image, clipped
    to [0, 255]."""
    return _per_image(lambda x, c: _cheap_ops(generator, x, [4], c,
                                              exposure_mean_sd=mean_sd),
                      image, mask)


def rotate_img_mask(generator, image, mask, max_angle: int = 45):
    """A rotation by an angle in [-max_angle, max_angle) with a border mode
    from {reflect, constant, mirror, wrap} (`FAST_ROTATE` picks the
    sampler)."""
    return _per_image(lambda x, c: _rotate(generator, x, c, max_angle),
                      image, mask)


# The JAX package's order (the reference's list of augmenters).
AUG_FUNCS = (random_eraser, translate, fliplr, additive_gaussian_noise,
             exposure, rotate_img_mask)
_CHEAP_OPS = {random_eraser: 0, translate: 1, fliplr: 2,
              additive_gaussian_noise: 3, exposure: 4}


def apply_augmentations(generator: torch.Generator, image: torch.Tensor,
                        mask: torch.Tensor,
                        prob_to_return_original: Optional[float] = None,
                        aug_funcs: Sequence[Callable] = AUG_FUNCS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomly compose augmentations on one (image, mask) pair: with
    probability `prob_to_return_original` (default 1/(len(aug_funcs)+1))
    the pair is returned as it is, else a uniformly random prefix of
    length 1..len(aug_funcs) of a uniformly random permutation of
    `aug_funcs` is applied in order. Runs of this module's cheap ops go
    through one planar composition each, split at the rotation; any other
    function f(generator, image, mask) -> (image, mask) is called as it
    is."""
    n = len(aug_funcs)
    if prob_to_return_original is None:
        prob_to_return_original = 1.0 / (n + 1)
    dev = image.device
    skip = float(torch.rand((), generator=generator, device=dev)) \
        <= prob_to_return_original
    perm = torch.argsort(torch.rand(n, generator=generator, device=dev))
    num = int(torch.randint(1, n + 1, (), generator=generator, device=dev))
    if skip:
        return image, mask

    def compose(x, c_img):
        run = []
        for f in (aug_funcs[i] for i in perm[:num].tolist()):
            op = _CHEAP_OPS.get(f)
            if op is not None and op not in run:
                run.append(op)
                continue
            if run:
                x = _cheap_ops(generator, x, run, c_img)
            run = [] if op is None else [op]
            if f is rotate_img_mask:
                x = _rotate(generator, x, c_img)
            elif op is None:
                im, mk = f(generator, *(t[0] for t in from_planar(x, c_img)))
                x = to_planar(im[None], mk[None])
        return _cheap_ops(generator, x, run, c_img) if run else x

    return _per_image(compose, image, mask)
