"""Frozen plain copies of the port's augmentation: `full_pass` (the meta
path's six-op composition) and `fused_light_augment` (the joint path's
four ops), with the Philox4x32-10 stream both kernels draw from.

Copied from the port's plain versions (mliis_tpu_torch/ops/augment_kernels.py)
when the benchmark was defined, and never edited after: the benchmark's
reference computes the augmentation with these and imports nothing of the
port. The float32 matrix products of the DFT shears want TF32 off, which the
reference sets.
"""
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

NUM_OPS = 6
ROTATE_OP = 5
LIGHT_OPS = ("translate", "fliplr", "noise", "exposure")
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
NOISE_STREAM, ROT_NOISE_STREAM = 1, 64

BitSource = Callable[[torch.Tensor, torch.Tensor, int],
                     Tuple[torch.Tensor, torch.Tensor]]


# --------------------------------------------------------------------------
# Philox4x32-10 in integer tensor ops (int64 tensors holding uint32 values).
# --------------------------------------------------------------------------

def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the constant a times b, without int64
    overflow: b * a is split over the two 16-bit halves of a."""
    p_lo = b * (a & 0xFFFF)          # < 2^48
    p_hi = b * (a >> 16)             # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox_words(key: torch.Tensor, counter: torch.Tensor, stream: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First two words of Philox4x32-10 with key (key, 0) and counter
    (counter, stream, 0, 0). key [B, 1] and counter [1, N] int64 broadcast
    to [B, N]."""
    c0 = (counter + torch.zeros_like(key)) & _MASK32
    k0 = (key & _MASK32).expand_as(c0)
    c1 = torch.full_like(c0, stream)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k1 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c0, c1


def zero_bits(key: torch.Tensor, counter: torch.Tensor, stream: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-zero bit source: the JAX TPU interpreter's on-core PRNG."""
    z = torch.zeros(torch.broadcast_shapes(key.shape, counter.shape),
                    dtype=torch.int64, device=counter.device)
    return z, z


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """U[0,1): 23 random mantissa bits under the exponent of 1.0, minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-7))) \
        * torch.cos(2.0 * math.pi * u2)


def _randint(u: torch.Tensor, low: int, high: int) -> torch.Tensor:
    return (low + torch.floor(u * (high - low))).to(torch.int64)


# --------------------------------------------------------------------------
# Host-side constants shared by the kernel and the plain version.
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def dft_tables(n: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of 2 pi m / n for m < n, float64-accurate, as float32."""
    ang = torch.arange(n, dtype=torch.float64) * (2.0 * math.pi / n)
    return (torch.cos(ang).float().to(device),
            torch.sin(ang).float().to(device))



def rotation_trig(rot: torch.Tensor) -> torch.Tensor:
    """[B, 4] float32 (alpha, beta, cos t, sin t) of t = -angle degrees:
    the three-shear factors alpha = -tan(t/2), beta = sin t, and the exact
    rotation for the out-of-bounds test; computed in float64."""
    t = -rot[:, 0].double() * (math.pi / 180.0)
    return torch.stack([-torch.tan(t / 2.0), torch.sin(t), torch.cos(t),
                        torch.sin(t)], dim=1).float().contiguous()


# --------------------------------------------------------------------------
# Plain version.
# --------------------------------------------------------------------------

def _draw_cheap_params(key, bits: BitSource, c_tot, h, w, max_shift,
                       noise_mean_sd, exposure_mean_sd, eraser_s_l,
                       eraser_s_h, eraser_r_1, eraser_r_2, eraser_v_l=0.0,
                       eraser_v_h=255.0) -> Dict[str, torch.Tensor]:
    """The scalar draws, [B] each, in `_draw_cheap_params` order at fixed
    counters (each op rounded as the kernel rounds it): the eraser's area
    is s * H * W, its top in [0, H) and its left in [0, W), its value in
    [v_l, v_h) (the kernels' fixed [0, 255); only the per-image ops of
    `ops/augment.py` set another)."""
    count = 9 + c_tot + 6
    u = uniform_from_bits(bits(key, torch.arange(count, device=key.device)[
        None], 0)[0])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    er_s = ((u[:, 0] * f32(eraser_s_h - eraser_s_l) + f32(eraser_s_l))
            * float(h)) * float(w)
    er_r = u[:, 1] * f32(eraser_r_2 - eraser_r_1) + f32(eraser_r_1)
    shift = _randint(u[:, 7], 1, max_shift + 1)
    g = 9 + c_tot
    exp_sd = torch.abs(f32(exposure_mean_sd) + _box_muller(u[:, g + 2],
                                                           u[:, g + 3]))
    return {
        "er_w": torch.floor(torch.sqrt(er_s / er_r)).to(torch.int64),
        "er_h": torch.floor(torch.sqrt(er_s * er_r)).to(torch.int64),
        "er_top": _randint(u[:, 2], 0, h),
        "er_left": _randint(u[:, 3], 0, w),
        "er_c": u[:, 4] * f32(eraser_v_h - eraser_v_l) + f32(eraser_v_l),
        "vert": u[:, 5] < 0.5,
        "shift": torch.where(u[:, 6] < 0.5, shift, -shift),
        "do_roll": u[:, 8] < 0.5,
        "img_fill": u[:, 9:9 + c_tot] * 255.0,
        "noise_sd": torch.abs(f32(noise_mean_sd) + _box_muller(u[:, g],
                                                               u[:, g + 1])),
        "exp_shift": exp_sd * _box_muller(u[:, g + 4], u[:, g + 5]),
    }


def _fold_freqs(n: int, device) -> torch.Tensor:
    k = torch.arange(n, device=device)
    return torch.where(k < (n + 1) // 2, k, k - n).float()


@functools.lru_cache(maxsize=8)
def dft_matrices(n: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real and imaginary [n, n] DFT matrices cos / -sin(2 pi j k / n),
    taken from `dft_tables` at (j*k) mod n."""
    cos_tab, sin_tab = dft_tables(n, device)
    jk = (torch.arange(n, device=device)[:, None]
          * torch.arange(n, device=device)[None, :]) % n
    return cos_tab[jk], -sin_tab[jk]


def _shear_rows(v, shifts):
    """Circular shear of the last axis: out[..., q, p] = in(q, p - s[q]),
    as real DFT -> per-row phase -> inverse DFT. v [m, C, R, n], shifts
    [m, R]."""
    n = v.shape[-1]
    fr, fi = dft_matrices(n, v.device)
    c0 = -2.0 * math.pi / n
    theta = (c0 * _fold_freqs(n, v.device))[None, None, :] \
        * shifts[:, :, None]
    pr, pi = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    xr, xi = v @ fr, v @ fi
    yr = xr * pr - xi * pi
    yi = xr * pi + xi * pr
    return (yr @ fr + yi @ fi) / n


def rotate_shear_planar(v: torch.Tensor, rot: torch.Tensor, c_img: int,
                        noise_img: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_rotate_shear_planar` on planar v [m, C, H, W]
    (H != W allowed): the Paeth three-shear rotation by rot[:, 0] degrees
    (a W-length DFT for the two row shears, an H-length one for the column
    shear), the one-hot snap of the two mask planes, and in constant mode
    (rot[:, 1] == 1) the fill outside the exact inverse-rotation
    coordinates: noise_img [m, c_img, H, W] where rot[:, 2] == 1, else the
    constant rot[:, 3], and background on the masks. Plain PyTorch: in the
    JAX package it is XLA outside any kernel, and `full_pass` runs the
    same arithmetic in-kernel."""
    h, w = v.shape[-2:]
    trig = rotation_trig(rot)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, device=v.device, dtype=torch.float32) - cy
    cols = torch.arange(w, device=v.device, dtype=torch.float32) - cx
    alpha, beta = trig[:, 0:1], trig[:, 1:2]
    v = _shear_rows(v, alpha * rows)
    v = _shear_rows(v.transpose(-1, -2), beta * cols).transpose(-1, -2)
    v = _shear_rows(v, alpha * rows)
    fg = (v[:, c_img + 1] >= v[:, c_img]).float()
    v = torch.cat([v[:, :c_img], (1.0 - fg)[:, None], fg[:, None]], dim=1)

    ys = rows[None, :, None]
    xs = cols[None, None, :]
    cos_t, sin_t = trig[:, 2, None, None], trig[:, 3, None, None]
    src_y = cos_t * ys - sin_t * xs + cy
    src_x = sin_t * ys + cos_t * xs + cx
    oob = ((src_y < -0.5) | (src_y > h - 0.5) | (src_x < -0.5)
           | (src_x > w - 0.5)) & (rot[:, 1] == 1)[:, None, None]
    cval = torch.where((rot[:, 2] == 1)[:, None, None, None], noise_img,
                       rot[:, 3].float()[:, None, None, None])
    bg = torch.zeros_like(v[:, c_img:])
    bg[:, 0] = 1.0
    fill = torch.cat([cval.expand(-1, c_img, -1, -1), bg], dim=1)
    return torch.where(oob[:, None], fill, v)


_OP_CONSTANTS = dict(max_shift=23, noise_mean_sd=5.1, exposure_mean_sd=12.75,
                     eraser_s_l=0.02, eraser_s_h=0.10, eraser_r_1=0.3,
                     eraser_r_2=1.0 / 0.3)


def _compose_reference(seeds, x, perm, applied, rot, c_img, bits, max_shift,
                       noise_mean_sd, exposure_mean_sd, eraser_s_l,
                       eraser_s_h, eraser_r_1, eraser_r_2, eraser_v_l=0.0,
                       eraser_v_h=255.0):
    """The ops of `perm` at the stages where `applied` [B, 6] holds, one
    stage after another, with the counter map of the kernels' note. `rot`
    is None where no rotation stage is applied (`cheap_pass`)."""
    bits = bits or philox_words
    b, c_tot, h, w = x.shape
    dev = x.device
    perm, applied = perm.to(dev), applied.to(dev)
    key = seeds.to(dev, torch.int64)[:, None]
    p = _draw_cheap_params(key, bits, c_tot, h, w, max_shift, noise_mean_sd,
                           exposure_mean_sd, eraser_s_l, eraser_s_h,
                           eraser_r_1, eraser_r_2, eraser_v_l, eraser_v_h)
    pix = torch.arange(h * w, device=dev)[None]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    bg_vec = torch.zeros(c_tot - c_img, device=dev)
    bg_vec[0] = 1.0

    def fill_vec(img_value):          # [m, c_img] or [m] -> [m, C, 1, 1]
        if img_value.ndim == 1:
            img_value = img_value[:, None].expand(-1, c_img)
        return torch.cat([img_value, bg_vec.expand(img_value.shape[0], -1)],
                         dim=1)[:, :, None, None]

    def noise_planes(idx, stream0, fn):
        planes = [fn(*bits(key[idx], pix, stream0 + c)).view(-1, h, w)
                  for c in range(c_img)]
        return torch.stack(planes, dim=1)

    def eraser(v, idx):
        top, left = p["er_top"][idx, None, None], p["er_left"][idx, None, None]
        region = ((rows >= top) & (rows < top + p["er_h"][idx, None, None])
                  & (cols >= left) & (cols < left + p["er_w"][idx, None, None]))
        return torch.where(region[:, None], fill_vec(p["er_c"][idx]), v)

    def translate(v, idx):
        sh = p["shift"][idx][:, None]
        vert = p["vert"][idx, None, None, None]
        m = v.shape[0]

        def along(n):   # source line and stripe of each output line
            line = torch.arange(n, device=dev)[None]
            return (line - sh) % n, torch.where(sh >= 0, line < sh,
                                                line >= n + sh)

        src_h, stripe_h = along(h)
        src_w, stripe_w = along(w)
        rolled_h = torch.gather(v, 2, src_h[:, None, :, None].expand(
            m, c_tot, h, w))
        rolled_w = torch.gather(v, 3, src_w[:, None, None, :].expand(
            m, c_tot, h, w))
        stripe = torch.where(vert[:, 0], stripe_h[:, :, None],
                             stripe_w[:, None, :])
        rolled = torch.where(vert, rolled_h, rolled_w)
        filled = torch.where(stripe[:, None], fill_vec(p["img_fill"][
            idx, :c_img]), rolled)
        return torch.where(p["do_roll"][idx, None, None, None], rolled,
                           filled)

    def fliplr(v, idx):
        return v.flip(-1)

    def noise(v, idx):
        g = noise_planes(idx, NOISE_STREAM, lambda w0, w1: _box_muller(
            uniform_from_bits(w0), uniform_from_bits(w1)))
        img = torch.clamp(v[:, :c_img] + p["noise_sd"][idx, None, None,
                                                       None] * g, 0.0, 255.0)
        return torch.cat([img, v[:, c_img:]], dim=1)

    def exposure(v, idx):
        img = torch.clamp(v[:, :c_img] + p["exp_shift"][idx, None, None,
                                                        None], 0.0, 255.0)
        return torch.cat([img, v[:, c_img:]], dim=1)

    def rotate(v, idx):
        border = noise_planes(idx, ROT_NOISE_STREAM, lambda w0, w1: torch.floor(
            uniform_from_bits(w0) * 256.0))
        return rotate_shear_planar(v, rot[idx], c_img, border)

    ops = (eraser, translate, fliplr, noise, exposure)
    if rot is not None:
        rot = rot.to(dev)
        ops += (rotate,)
    x = x.clone()
    for stage in range(NUM_OPS):
        for op, fn in enumerate(ops):
            idx = torch.nonzero(applied[:, stage] & (perm[:, stage] == op)
                                )[:, 0]
            if idx.numel():
                x[idx] = fn(x[idx], idx)
    return x


def full_pass_reference(seeds: torch.Tensor, x: torch.Tensor,
                        perm: torch.Tensor, num: torch.Tensor,
                        rot: torch.Tensor, *, c_img: int = 3,
                        bits: Optional[BitSource] = None,
                        **op_constants) -> torch.Tensor:
    """Plain PyTorch `full_pass`: the same function, arguments and random
    stream as the kernel (see `full_pass`), at any plane size.
    `op_constants` are the kernel's keyword arguments (max_shift,
    noise_mean_sd, exposure_mean_sd, eraser_s_l, eraser_s_h, eraser_r_1,
    eraser_r_2; the TPU kernel's defaults where left out). `bits` replaces
    the Philox source (e.g. `zero_bits`)."""
    applied = torch.arange(NUM_OPS, device=x.device)[None] \
        < num.to(x.device)[:, None]
    return _compose_reference(seeds, x, perm, applied, rot, c_img, bits,
                              **{**_OP_CONSTANTS, **op_constants})



_LIGHT_DRAWS = 19   # scalar counters of csrc/light_augment.cu


def draw_light_params(seeds: torch.Tensor, *, prob_original: float = 0.0,
                      max_shift: int = 23, noise_mean_sd: float = 5.1,
                      exposure_mean_sd: float = 12.75,
                      bits: Optional[BitSource] = None
                      ) -> Dict[str, torch.Tensor]:
    """The per-sample draws of `fused_light_augment`, [B] or [B, k] each, at
    the counters of csrc/light_augment.cu's note: the gate, the op of each
    stage (`ops` [B, 4], the rank of four exact uint32 words, ties to the
    lower index), the prefix length `num` 1..4, and the translate, noise
    and exposure parameters."""
    bits = bits or philox_words
    key = seeds.to(torch.int64)[:, None]
    words = bits(key, torch.arange(_LIGHT_DRAWS, device=key.device)[None],
                 0)[0]
    u = uniform_from_bits(words)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    r = words[:, 1:5]
    lower = torch.arange(4, device=key.device)
    rank = ((r[:, None, :] > r[:, :, None])
            | ((r[:, None, :] == r[:, :, None])
               & (lower[None, :] < lower[:, None]))).sum(-1)
    ops = torch.empty_like(rank).scatter_(1, rank, lower.expand_as(rank))
    shift = _randint(u[:, 8], 1, max_shift + 1)
    exp_sd = torch.abs(f32(exposure_mean_sd) + _box_muller(u[:, 15],
                                                           u[:, 16]))
    return {
        "gate": u[:, 0] <= f32(prob_original),
        "ops": ops,
        "num": _randint(u[:, 5], 1, len(LIGHT_OPS) + 1),
        "vert": u[:, 6] < 0.5,
        "shift": torch.where(u[:, 7] < 0.5, shift, -shift),
        "do_roll": u[:, 9] < 0.5,
        "fill": u[:, 10:13] * 255.0,
        "noise_sd": torch.abs(f32(noise_mean_sd) + _box_muller(u[:, 13],
                                                               u[:, 14])),
        "exp_shift": exp_sd * _box_muller(u[:, 17], u[:, 18]),
    }


def fused_light_augment_reference(seeds: torch.Tensor, images: torch.Tensor,
                                  masks: torch.Tensor, *,
                                  prob_original: float = 0.0,
                                  max_shift: int = 23,
                                  noise_mean_sd: float = 5.1,
                                  exposure_mean_sd: float = 12.75,
                                  bits: Optional[BitSource] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `fused_light_augment`: the same function, arguments and
    random stream as the kernel, applied op by op in stage order. `bits`
    replaces the Philox source (e.g. `zero_bits`)."""
    bits = bits or philox_words
    b, h, w, c_img = images.shape
    dev = images.device
    key = seeds.to(dev, torch.int64)[:, None]
    p = draw_light_params(seeds.to(dev), prob_original=prob_original,
                          max_shift=max_shift, noise_mean_sd=noise_mean_sd,
                          exposure_mean_sd=exposure_mean_sd, bits=bits)
    pix = torch.arange(h * w, device=dev)[None]

    def translate(img, lab, idx):
        shift = p["shift"][idx, None]
        vert = p["vert"][idx, None, None]

        def along(n):   # source line and stripe of each output line
            line = torch.arange(n, device=dev)[None]
            stripe = torch.where(shift >= 0, line < shift, line >= n + shift)
            return (line - shift) % n, stripe

        src_y, stripe_y = along(h)
        src_x, stripe_x = along(w)
        m = img.shape[0]
        rolled_lab = torch.where(
            vert, torch.gather(lab, 1, src_y[:, :, None].expand(m, h, w)),
            torch.gather(lab, 2, src_x[:, None, :].expand(m, h, w)))
        rolled_img = torch.where(
            vert[..., None],
            torch.gather(img, 1, src_y[:, :, None, None].expand(m, h, w,
                                                                c_img)),
            torch.gather(img, 2, src_x[:, None, :, None].expand(m, h, w,
                                                                c_img)))
        stripe = torch.where(vert, stripe_y[:, :, None], stripe_x[:, None, :])
        stripe = stripe & ~p["do_roll"][idx, None, None]
        return (torch.where(stripe[..., None],
                            p["fill"][idx, None, None, :c_img], rolled_img),
                torch.where(stripe, torch.zeros_like(rolled_lab),
                            rolled_lab))

    def fliplr(img, lab, idx):
        return img.flip(2), lab.flip(2)

    def noise(img, lab, idx):
        g = torch.stack([_box_muller(*(uniform_from_bits(v) for v in bits(
            key[idx], pix, NOISE_STREAM + c))).view(-1, h, w)
            for c in range(c_img)], dim=-1)
        return torch.clamp(img + p["noise_sd"][idx, None, None, None] * g,
                           0.0, 255.0), lab

    def exposure(img, lab, idx):
        return torch.clamp(img + p["exp_shift"][idx, None, None, None], 0.0,
                           255.0), lab

    fns = (translate, fliplr, noise, exposure)
    images, masks = images.clone(), masks.clone()
    for stage in range(len(LIGHT_OPS)):
        active = ~p["gate"] & (p["num"] > stage)
        for op, fn in enumerate(fns):
            idx = torch.nonzero(active & (p["ops"][:, stage] == op))[:, 0]
            if idx.numel():
                images[idx], masks[idx] = fn(images[idx], masks[idx], idx)
    return images, torch.round(masks)


# --------------------------------------------------------------------------
# The kernel: build, load, launch.
# --------------------------------------------------------------------------
