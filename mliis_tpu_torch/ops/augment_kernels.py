"""The augmentation kernels, each with its wrapper, launch count and plain
PyTorch version, mirroring the TPU kernels of
`mliis_tpu/ops/pallas_augment.py`:

- `full_pass` (csrc/full_pass.cu) replaces `full_pass`
  (`_full_pass_kernel`): the meta path's six-op composition, one launch
  per batch. A rotated sample costs 3 shears x 4 products x 2*C*H*W^2
  FP32 operations (1.35 GFLOP at C=5, 224^2), an unrotated one only its
  read and write.
- `fused_light_augment` (csrc/light_augment.cu) replaces
  `fused_light_augment` (`_augment_kernel`): the joint path's four-op
  composition on NHWC images and class-id labels, one launch per
  augmented SGD step. It is bound by its bytes; the source note gives its
  design and its Philox counter map.

Every kernel is compiled from its source under csrc/ by `nvcc` for
sm_90a into BUILD_DIR at first use, one shared library per source, and
bound with ctypes.

Random numbers come from a counter-based Philox4x32-10 keyed by the
per-sample seed (csrc/philox.cuh), which the kernels and the plain
versions both implement. For `full_pass`:
  - the 20 scalar draws (at C_tot=5) sit at counters (i, 0) in the order of
    the TPU kernel's `_draw_cheap_params`;
  - the gaussian noise plane of channel c sits at (pixel, 1 + c), the
    rotation's border-noise plane at (pixel, 64 + c); both are drawn only
    where their op runs and are never staged in device memory;
  - a uniform keeps the 23-bit-mantissa construction of the TPU kernel and
    a normal its Box-Muller.
Both plain versions also take an injected bit source: with all-zero
bits they reproduce the JAX interpreter's all-zero on-core PRNG, which is
how the CPU tests hold them against the Pallas kernels.

The DFT tables are cos/sin(2 pi m / n) for m < n, computed in float64 and
indexed by (j*k) mod n, not cos of the large argument 2 pi j k / n. The
shear products run in FP32 (no TF32) in both versions.
"""
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

NUM_OPS = 6
ROTATE_OP = 5
# fused_light_augment's ops, in the TPU kernel's branch order.
LIGHT_OPS = ("translate", "fliplr", "noise", "exposure")
TRANSLATE, FLIPLR, NOISE, EXPOSURE = range(len(LIGHT_OPS))

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PACKAGE, "csrc")
KERNEL_SOURCES = ("full_pass", "light_augment")   # csrc/<name>.cu
_HEADERS = ("philox.cuh",)
BUILD_DIR = os.path.join(_PACKAGE, "_build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
# A block's shared memory on Hopper (232,448 B) less the kernel's static
# `Params` and a margin.
_MAX_SMEM = 232448 - 1024
_MAX_N = 256  # ceil(n / 32) <= kMaxPerLane in the kernel

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

def _draw_cheap_params(key, bits: BitSource, c_tot, n, max_shift,
                       noise_mean_sd, exposure_mean_sd, eraser_s_l,
                       eraser_s_h, eraser_r_1, eraser_r_2
                       ) -> Dict[str, torch.Tensor]:
    """The scalar draws, [B] each, in `_draw_cheap_params` order at fixed
    counters (each op rounded as the kernel rounds it)."""
    count = 9 + c_tot + 6
    u = uniform_from_bits(bits(key, torch.arange(count, device=key.device)[
        None], 0)[0])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    er_s = ((u[:, 0] * f32(eraser_s_h - eraser_s_l) + f32(eraser_s_l))
            * float(n)) * float(n)
    er_r = u[:, 1] * f32(eraser_r_2 - eraser_r_1) + f32(eraser_r_1)
    shift = _randint(u[:, 7], 1, max_shift + 1)
    g = 9 + c_tot
    exp_sd = torch.abs(f32(exposure_mean_sd) + _box_muller(u[:, g + 2],
                                                           u[:, g + 3]))
    return {
        "er_w": torch.floor(torch.sqrt(er_s / er_r)).to(torch.int64),
        "er_h": torch.floor(torch.sqrt(er_s * er_r)).to(torch.int64),
        "er_top": _randint(u[:, 2], 0, n),
        "er_left": _randint(u[:, 3], 0, n),
        "er_c": u[:, 4] * 255.0,
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


def _shear_rows(v, shifts, fr, fi):
    """Circular shear of the last axis: out[..., q, p] = in(q, p - s[q]),
    as real DFT -> per-row phase -> inverse DFT. v [m, C, R, n], shifts
    [m, R]."""
    n = v.shape[-1]
    c0 = -2.0 * math.pi / n
    theta = (c0 * _fold_freqs(n, v.device))[None, None, :] \
        * shifts[:, :, None]
    pr, pi = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    xr, xi = v @ fr, v @ fi
    yr = xr * pr - xi * pi
    yi = xr * pi + xi * pr
    return (yr @ fr + yi @ fi) / n


def _rotate(v, trig, rot, c_img, noise_img, fr, fi):
    """Three-shear rotation of planar v [m, C, n, n], one-hot snap of the
    mask planes, and the constant-mode fill from the exact coordinates."""
    n = v.shape[-1]
    ctr = (n - 1) / 2.0
    lines = torch.arange(n, device=v.device, dtype=torch.float32) - ctr
    alpha, beta = trig[:, 0:1], trig[:, 1:2]
    v = _shear_rows(v, alpha * lines, fr, fi)
    v = _shear_rows(v.transpose(-1, -2), beta * lines, fr, fi
                    ).transpose(-1, -2)
    v = _shear_rows(v, alpha * lines, fr, fi)
    fg = (v[:, c_img + 1] >= v[:, c_img]).float()
    v = torch.cat([v[:, :c_img], (1.0 - fg)[:, None], fg[:, None]], dim=1)

    ys = lines[None, :, None]
    xs = lines[None, None, :]
    cos_t, sin_t = trig[:, 2, None, None], trig[:, 3, None, None]
    src_y = cos_t * ys - sin_t * xs + ctr
    src_x = sin_t * ys + cos_t * xs + ctr
    oob = ((src_y < -0.5) | (src_y > n - 0.5) | (src_x < -0.5)
           | (src_x > n - 0.5)) & (rot[:, 1] == 1)[:, None, None]
    cval = torch.where((rot[:, 2] == 1)[:, None, None, None], noise_img,
                       rot[:, 3].float()[:, None, None, None])
    bg = torch.zeros_like(v[:, c_img:])
    bg[:, 0] = 1.0
    fill = torch.cat([cval.expand(-1, c_img, -1, -1), bg], dim=1)
    return torch.where(oob[:, None], fill, v)


def full_pass_reference(seeds: torch.Tensor, x: torch.Tensor,
                        perm: torch.Tensor, num: torch.Tensor,
                        rot: torch.Tensor, *, c_img: int = 3,
                        max_shift: int = 23, noise_mean_sd: float = 5.1,
                        exposure_mean_sd: float = 12.75,
                        eraser_s_l: float = 0.02, eraser_s_h: float = 0.10,
                        eraser_r_1: float = 0.3,
                        eraser_r_2: float = 1.0 / 0.3,
                        bits: Optional[BitSource] = None) -> torch.Tensor:
    """Plain PyTorch `full_pass`: the same function, arguments and random
    stream as the kernel (see `full_pass`). `bits` replaces the Philox
    source (e.g. `zero_bits`)."""
    bits = bits or philox_words
    b, c_tot, h, n = x.shape
    dev = x.device
    rot, perm, num = rot.to(dev), perm.to(dev), num.to(dev)
    key = seeds.to(dev, torch.int64)[:, None]
    p = _draw_cheap_params(key, bits, c_tot, n, max_shift, noise_mean_sd,
                           exposure_mean_sd, eraser_s_l, eraser_s_h,
                           eraser_r_1, eraser_r_2)
    trig = rotation_trig(rot)
    cos_tab, sin_tab = dft_tables(n, dev)
    jk = (torch.arange(n, device=dev)[:, None]
          * torch.arange(n, device=dev)[None, :]) % n
    fr, fi = cos_tab[jk], -sin_tab[jk]
    pix = torch.arange(h * n, device=dev)[None]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(n, device=dev)[None, None, :]
    bg_vec = torch.zeros(c_tot - c_img, device=dev)
    bg_vec[0] = 1.0

    def fill_vec(img_value):          # [m, c_img] or [m] -> [m, C, 1, 1]
        if img_value.ndim == 1:
            img_value = img_value[:, None].expand(-1, c_img)
        return torch.cat([img_value, bg_vec.expand(img_value.shape[0], -1)],
                         dim=1)[:, :, None, None]

    def noise_planes(idx, stream0, fn):
        planes = [fn(*bits(key[idx], pix, stream0 + c)).view(-1, h, n)
                  for c in range(c_img)]
        return torch.stack(planes, dim=1)

    def eraser(v, idx):
        top, left = p["er_top"][idx, None, None], p["er_left"][idx, None, None]
        region = ((rows >= top) & (rows < top + p["er_h"][idx, None, None])
                  & (cols >= left) & (cols < left + p["er_w"][idx, None, None]))
        return torch.where(region[:, None], fill_vec(p["er_c"][idx]), v)

    def translate(v, idx):
        shift = p["shift"][idx]
        vert = p["vert"][idx, None, None, None]
        sh = shift[:, None]
        line = torch.arange(n, device=dev)[None]
        src = (line - sh) % n                                     # [m, n]
        m = v.shape[0]
        rolled_h = torch.gather(v, 2, src[:, None, :, None].expand(
            m, c_tot, h, n))
        rolled_w = torch.gather(v, 3, src[:, None, None, :].expand(
            m, c_tot, h, n))
        stripe_1d = torch.where(sh >= 0, line < sh, line >= n + sh)
        stripe = torch.where(vert[:, 0], stripe_1d[:, :, None],
                             stripe_1d[:, None, :])
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
        return _rotate(v, trig[idx], rot[idx], c_img, border, fr, fi)

    ops = (eraser, translate, fliplr, noise, exposure, rotate)
    x = x.clone()
    for stage in range(NUM_OPS):
        active = num > stage
        for op, fn in enumerate(ops):
            idx = torch.nonzero(active & (perm[:, stage] == op))[:, 0]
            if idx.numel():
                x[idx] = fn(x[idx], idx)
    return x


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

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def _library_path(name: str) -> str:
    """BUILD_DIR/<name>_<digest>.so, the digest over the source, the shared
    headers and the flags."""
    h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for fname in (name + ".cu",) + _HEADERS:
        with open(os.path.join(_CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "{}_{}.so".format(name, h.hexdigest()[
        :12]))


def build_library(names: Sequence[str] = KERNEL_SOURCES,
                  verbose: bool = False) -> Dict[str, Tuple[str, float, str]]:
    """Compile csrc/<name>.cu for sm_90a into BUILD_DIR, one `nvcc` per
    source, all started together (once per digest). Returns {name: (library
    path, build seconds, compiler output)}; 0 seconds for a library that was
    already built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    jobs, out = {}, {}
    for name in names:
        lib = _library_path(name)
        if os.path.exists(lib):
            out[name] = (lib, 0.0, "")
            continue
        tmp = "{}.{}.tmp".format(lib, os.getpid())
        cmd = [_nvcc(), *(("-Xptxas", "-v") if verbose else ()),
               *_NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC_DIR, name + ".cu")]
        jobs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (lib, tmp, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append("{}:\n{}".format(name, log))
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.time() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "full_pass": [_PTR] * 9 + [_I32] * 5 + [_F32] * 6 + [_PTR],
    "light_augment": [_PTR] * 5 + [_I32] * 4 + [_F32] * 3 + [_PTR],
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> Callable:
    """The C launch function `<name>_launch` of csrc/<name>.cu."""
    lib = ctypes.CDLL(build_library((name,))[name][0])
    fn = getattr(lib, name + "_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = _I32
    return fn


_KERNEL_WARPS = 16  # kThreads / 32 in csrc/full_pass.cu


def smem_bytes(n: int) -> int:
    """Shared memory of one block at plane size n x n (csrc/full_pass.cu):
    the plane, two tables and 2n floats for each warp."""
    return 4 * (n * n + 2 * n + _KERNEL_WARPS * 2 * n)


def _check(seeds, x, perm, num, rot, c_img):
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [B, C, H, W]")
    b, c_tot, h, w = x.shape
    if h != w:
        raise ValueError("full_pass needs square planes, got {}x{}".format(
            h, w))
    if c_tot - c_img != 2:
        raise ValueError("full_pass needs a 2-channel one-hot mask")
    for name, t, shape in (("seeds", seeds, (b,)), ("perm", perm,
                                                    (b, NUM_OPS)),
                           ("num", num, (b,)), ("rot", rot, (b, 4))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError("{} must be contiguous int32 {} on {}".format(
                name, shape, x.device))
    if w > _MAX_N or smem_bytes(w) > _MAX_SMEM:
        raise ValueError("a {}x{} plane does not fit one block's shared "
                         "memory".format(h, w))


def full_pass(seeds: torch.Tensor, x: torch.Tensor, perm: torch.Tensor,
              num: torch.Tensor, rot: torch.Tensor, *, c_img: int = 3,
              max_shift: int = 23, noise_mean_sd: float = 5.1,
              exposure_mean_sd: float = 12.75, eraser_s_l: float = 0.02,
              eraser_s_h: float = 0.10, eraser_r_1: float = 0.3,
              eraser_r_2: float = 1.0 / 0.3) -> torch.Tensor:
    """The whole six-op composition over a planar batch in one launch.

    Args:
      seeds: [B] int32 per-sample Philox keys.
      x: [B, C_tot, H, W] float32 planar image + one-hot mask batch, H == W,
        C_tot - c_img == 2.
      perm: [B, 6] int32 op permutation (0 eraser, 1 translate, 2 fliplr,
        3 noise, 4 exposure, 5 rotation).
      num: [B] int32 prefix length.
      rot: [B, 4] int32 (angle degrees, border mode, fill with noise, cval).
    Returns the transformed batch. A CUDA tensor launches the kernel (and
    counts it in `full_pass.launches`); a CPU tensor takes the plain
    version; any other device raises.
    """
    _check(seeds, x, perm, num, rot, c_img)
    kwargs = dict(c_img=c_img, max_shift=max_shift,
                  noise_mean_sd=noise_mean_sd,
                  exposure_mean_sd=exposure_mean_sd, eraser_s_l=eraser_s_l,
                  eraser_s_h=eraser_s_h, eraser_r_1=eraser_r_1,
                  eraser_r_2=eraser_r_2)
    if x.device.type == "cpu":
        return full_pass_reference(seeds, x, perm, num, rot, **kwargs)
    if x.device.type != "cuda":
        raise ValueError("full_pass runs on cuda or cpu tensors")
    launch = _library("full_pass")
    b, c_tot, _, n = x.shape
    out = torch.empty_like(x)
    trig = rotation_trig(rot)
    cos_tab, sin_tab = dft_tables(n, x.device)
    with torch.cuda.device(x.device):   # the launch goes to x's card
        err = launch(
            x.data_ptr(), out.data_ptr(), seeds.data_ptr(), perm.data_ptr(),
            num.data_ptr(), rot.data_ptr(), trig.data_ptr(),
            cos_tab.data_ptr(), sin_tab.data_ptr(), b, c_tot, n, c_img,
            max_shift, _f32(noise_mean_sd), _f32(exposure_mean_sd),
            _f32(eraser_s_l), _f32(eraser_s_h - eraser_s_l),
            _f32(eraser_r_1), _f32(eraser_r_2 - eraser_r_1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("full_pass kernel launch failed: cudaError {}"
                           .format(err))
    full_pass.launches += 1
    return out


full_pass.launches = 0


def _f32(v: float) -> float:
    """v rounded to float32, as the kernel's float argument holds it."""
    return float(torch.tensor(v, dtype=torch.float32))


def fused_light_augment(seeds: torch.Tensor, images: torch.Tensor,
                        masks: torch.Tensor, *, prob_original: float = 0.0,
                        max_shift: int = 23, noise_mean_sd: float = 5.1,
                        exposure_mean_sd: float = 12.75
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-fused light augmentation in one launch.

    Args:
      seeds: [B] int32 per-sample Philox keys.
      images: [B, H, W, 3] contiguous float32 in [0, 255].
      masks: [B, H, W] contiguous float32 class-id maps.
    Returns augmented (images, masks) of the same shapes, the masks rounded
    to integers. A CUDA tensor launches the kernel (and counts it in
    `fused_light_augment.launches`); a CPU tensor takes the plain version;
    any other device raises.
    """
    if images.dtype != torch.float32 or images.ndim != 4 \
            or images.shape[-1] != 3 or not images.is_contiguous():
        raise ValueError("images must be a contiguous float32 [B, H, W, 3]")
    b, h, w, _ = images.shape
    for name, t, shape, dtype in (("masks", masks, (b, h, w), torch.float32),
                                  ("seeds", seeds, (b,), torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != images.device:
            raise ValueError("{} must be a contiguous {} {} on {}".format(
                name, dtype, shape, images.device))
    kwargs = dict(prob_original=prob_original, max_shift=max_shift,
                  noise_mean_sd=noise_mean_sd,
                  exposure_mean_sd=exposure_mean_sd)
    if images.device.type == "cpu":
        return fused_light_augment_reference(seeds, images, masks, **kwargs)
    if images.device.type != "cuda":
        raise ValueError("fused_light_augment runs on cuda or cpu tensors")
    launch = _library("light_augment")
    out_images, out_masks = torch.empty_like(images), torch.empty_like(masks)
    with torch.cuda.device(images.device):
        err = launch(
            images.data_ptr(), masks.data_ptr(), out_images.data_ptr(),
            out_masks.data_ptr(), seeds.data_ptr(), b, h, w, max_shift,
            _f32(prob_original), _f32(noise_mean_sd),
            _f32(exposure_mean_sd),
            torch.cuda.current_stream(images.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fused_light_augment kernel launch failed: "
                           "cudaError {}".format(err))
    fused_light_augment.launches += 1
    return out_images, out_masks


fused_light_augment.launches = 0
