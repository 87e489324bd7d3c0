"""The augmentation kernels, each with its wrapper and plain PyTorch
version, mirroring the TPU kernels of
`mliis_tpu/ops/pallas_augment.py`:

- `full_pass` (csrc/full_pass.cu) replaces `full_pass`
  (`_full_pass_kernel`): the meta path's six-op composition, one launch
  per batch, one read and one write a pixel. A rotated plane is split
  over a thread-block cluster (`full_pass_plan`) and sheared as
  half-spectrum matrix products on the tensor cores in 3xTF32, against
  the tables of `full_pass_tables`.
- `cheap_pass` (csrc/cheap_pass.cu) replaces `cheap_pass`
  (`_cheap_pass_kernel`): the split route's five cheap ops at the stages
  of a window, any H x W, two launches per batch around the plain-op
  rotation `rotate_shear_planar`. It is bound by its bytes.
- `fused_light_augment` (csrc/light_augment.cu) replaces
  `fused_light_augment` (`_augment_kernel`): the joint path's four-op
  composition on NHWC images and class-id labels, one launch per
  augmented SGD step. It is bound by its bytes; the source note gives its
  Philox counter map.
Both split each pixel's walk through the ops into a row part and a column
part, and stream source lines through a ring of shared-memory stages in
persistent blocks, a producer warp staging the lines and consumer warps
taking them as they come (csrc/row_ring.cuh): the blocks take the output
lines in a sample-interleaved order (`unit_order`), and `row_pass_plan`
picks the grid, the ring and the copy mode.

Each wrapper builds, binds, launches and counts its kernel through
`ops/kernel_library`.

Random numbers come from a counter-based Philox4x32-10 keyed by the
per-sample seed (csrc/philox.cuh), which the kernels and the plain
versions both implement. For `full_pass` and `cheap_pass`
(csrc/cheap_ops.cuh holds their shared draws and ops):
  - the 20 scalar draws (at C_tot=5) sit at counters (i, 0) in the order of
    the TPU kernel's `_draw_cheap_params`;
  - the gaussian noise plane of channel c sits at (pixel, 1 + c), the
    rotation's border-noise plane at (pixel, 64 + c); both are drawn only
    where their op runs and are never staged in device memory;
  - a uniform keeps the 23-bit-mantissa construction of the TPU kernel and
    a normal its Box-Muller.
Every plain version also takes an injected bit source: with all-zero
bits they reproduce the JAX interpreter's all-zero on-core PRNG, which is
how the CPU tests hold them against the Pallas kernels.

The plain version's DFT tables are cos/sin(2 pi m / n) for m < n,
computed in float64 and indexed by (j*k) mod n, not cos of the large
argument 2 pi j k / n; its shear products run in FP32. The kernel's
half-spectrum matrices are built in float64 the same way and split into
TF32 hi and lo parts (`tf32_split`), whose three products keep FP32
accuracy.
"""
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops.kernel_library import F32, I32, PTR, f32
from mliis_tpu_torch.utils import profiling

NUM_OPS = 6
_MAX_IMG_PLANES = 8  # kMaxImg in csrc/cheap_ops.cuh
ROTATE_OP = 5
# fused_light_augment's ops, in the TPU kernel's branch order.
LIGHT_OPS = ("translate", "fliplr", "noise", "exposure")
TRANSLATE, FLIPLR, NOISE, EXPOSURE = range(len(LIGHT_OPS))

MAX_FULL_PASS_N = 512  # the largest plane full_pass_plan fits a cluster
_MAX_CLUSTER, _MAX_GROUP = 8, 64   # kMaxCluster, kMaxGroup in full_pass.cu
_MAX_SMEM = 232448 - 1024          # kMaxSmem in full_pass.cu

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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def full_pass_plan(n: int) -> Tuple[int, int, int]:
    """(cs, group, shared-memory bytes a block) of csrc/full_pass.cu for
    n x n planes: a cluster of cs blocks (the least power of two that
    leaves each block at most 64 rows, R = ceil(n / cs)) holds a rotated
    plane; a block shears up to `group` of its lines at once (a multiple
    of 16, the most that fits). A block's shared memory: its R x n rows, a
    [group, k1 + 4] line buffer and a [group, 2 nhp + 4] spectrum buffer
    (k1 = n and nhp = n/2 + 1 rounded up to 8; the +4 keeps the mma's A
    fragments off shared bank conflicts)."""
    cs = 1
    while -(-n // cs) > _MAX_GROUP:
        cs *= 2
    rows = -(-n // cs)
    ld = _round_up(n, 8) + 4
    ld2 = 2 * _round_up(n // 2 + 1, 8) + 4
    if cs <= _MAX_CLUSTER:
        for group in range(min(_MAX_GROUP, _round_up(rows, 16)), 0, -16):
            smem = 4 * (rows * n + group * (ld + ld2))
            if smem <= _MAX_SMEM:
                return cs, group, smem
    raise ValueError("full_pass takes planes up to {0}x{0} on the card, got "
                     "{1}x{1}".format(MAX_FULL_PASS_N, n))


ROW_DIRECT, ROW_ASYNC, ROW_BULK = 0, 1, 2  # kDirect, kAsync, kBulk
_CHEAP_BLOCKS_PER_SM = 3  # kCheapBlocksPerSm in csrc/cheap_pass.cu
_LIGHT_BLOCKS_PER_SM = 2  # kLightBlocksPerSm in csrc/light_augment.cu
_ROW_CONSUMERS = 7       # kConsumers in csrc/row_ring.cuh: consumer warps
_ROW_MAX_STAGES = 32     # kMaxStages: stages of a block's ring
_ROW_BAR_BYTES = 2 * _ROW_MAX_STAGES * 8  # kBarBytes
_ROW_STATE_BYTES = 10240  # kStateBytes: a kernel's static shared memory
ROW_GROUP = 32           # kGroup: samples a group of the order
_ROW_MAX_W = 0x7FFF      # a column table entry's 15-bit x
_SM_SMEM = 233472        # shared memory of an SM
_BLOCK_RESERVED_SMEM = 1024  # the system's share of each block's
H100_SMS = 132


class RowPlan(NamedTuple):
    """A launch of a row kernel (csrc/row_ring.cuh): `grid` blocks, block j
    taking the units [j N / grid, (j + 1) N / grid) of the N units in
    `unit_order`; a ring of `stages` shared-memory stages a block, filled
    in `mode` (ROW_BULK, ROW_ASYNC; ROW_DIRECT: no ring); `smem` dynamic
    shared-memory bytes a block. The order is the C launch's."""
    grid: int
    stages: int
    mode: int
    smem: int


def row_smem_bytes(n_tab: int, stage_floats: int, stages: int) -> int:
    """`row_smem_layout` of csrc/row_ring.cuh: the mbarriers, the group's
    column tables (n_tab ints), then the ring's `stages` stages and each
    consumer warp's output line, of `stage_floats` floats each (each part
    rounded up to 4 entries)."""
    return _ROW_BAR_BYTES + 4 * (
        _round_up(n_tab, 4)
        + (stages + _ROW_CONSUMERS) * _round_up(stage_floats, 4))


def unit_order(u: int, batch: int, h: int, planes: int = 1
               ) -> Tuple[int, int, int]:
    """(sample, row, plane) of unit u of the row kernels' order (`UnitAt`):
    the samples in groups of ROW_GROUP, within a group of n samples row k
    is row k // n of the group's sample k % n, each row's `planes` units in
    a row."""
    k, c = divmod(u, planes)
    g0 = k // (ROW_GROUP * h) * ROW_GROUP
    n = min(ROW_GROUP, batch - g0)
    local = k - g0 * h
    return g0 + local % n, local // n, c


_ROW_MIN_STAGES = 8  # fewer blocks an SM before a shorter ring than this


def row_pass_plan(batch: int, h: int, w: int, planes: int,
                  stage_floats: int, max_blocks: int, sms: int = H100_SMS,
                  aligned: bool = True) -> RowPlan:
    """The launch of a row kernel of B x H x `planes` units whose stage
    holds `stage_floats` floats, on a card of `sms` SMs: the most blocks an
    SM (up to `max_blocks`, the kernel's __launch_bounds__) whose ring gets
    eight stages beside the group's column tables (one int a column and
    sample) and the consumers' output lines, the most stages (up to 32)
    that then fit, but no more than a block has units; bulk copies and
    16-byte stores when W % 4 == 0 and every pointer is 16-byte aligned,
    4-byte copies otherwise; no ring and no tables (ROW_DIRECT) when one
    stage does not fit or W passes a table entry's 15 bits. A block's
    shared memory counts its static part and the system's share."""
    units = batch * h * planes
    n_tab = min(batch, ROW_GROUP) * _round_up(w, 4)
    mode, stages, per_sm = ROW_DIRECT, 0, max_blocks
    if w <= _ROW_MAX_W:
        for need in (_ROW_MIN_STAGES, 1):
            for blocks in range(max_blocks, 0, -1):
                cap = min(_SM_SMEM // blocks - _BLOCK_RESERVED_SMEM,
                          _MAX_SMEM) - _ROW_STATE_BYTES
                fits = [s for s in range(_ROW_MAX_STAGES, need - 1, -1)
                        if row_smem_bytes(n_tab, stage_floats, s) <= cap]
                if fits:
                    mode = ROW_BULK if aligned and w % 4 == 0 else ROW_ASYNC
                    stages, per_sm = fits[0], blocks
                    break
            if mode != ROW_DIRECT:
                break
    grid = max(1, min(-(-units // _ROW_CONSUMERS), sms * per_sm))
    if mode != ROW_DIRECT:  # no more stages than a block has units
        stages = min(stages, -(-units // grid))
    smem = row_smem_bytes(0 if mode == ROW_DIRECT else n_tab,
                          0 if mode == ROW_DIRECT else stage_floats, stages)
    return RowPlan(grid, stages, mode, smem)


def cheap_pass_plan(batch: int, c_tot: int, h: int, w: int,
                    sms: int = H100_SMS, aligned: bool = True) -> RowPlan:
    """`row_pass_plan` of csrc/cheap_pass.cu: a unit is an output row of
    one plane, a stage holds its source row."""
    return row_pass_plan(batch, h, w, c_tot, w, _CHEAP_BLOCKS_PER_SM, sms,
                         aligned)


def light_plan(batch: int, h: int, w: int, sms: int = H100_SMS,
               aligned: bool = True) -> RowPlan:
    """`row_pass_plan` of csrc/light_augment.cu: a unit is an output row, a
    stage holds its source image row (3W floats) and label row (W)."""
    return row_pass_plan(batch, h, w, 1, 4 * w, _LIGHT_BLOCKS_PER_SM, sms,
                         aligned)


def _sms_and_alignment(dev: torch.device, tensors: Sequence[torch.Tensor]
                       ) -> Tuple[int, bool]:
    """The SM count of `dev`'s card and whether every tensor is 16-byte
    aligned."""
    return (kernel_library.sm_count(dev.index),
            all(t.data_ptr() % 16 == 0 for t in tensors))


def shear_matrices(n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's half-spectrum shear in float64: the forward [k1, 2 nhp]
    (columns: cos, then -sin of 2 pi j k / n for the bins k < n/2 + 1) and
    the inverse [2 nhp, k1] (rows: w_k cos / n, then -w_k sin / n; w_k 1 at
    DC and at the Nyquist bin of even n, 2 inside), zero-padded to k1 = n
    and nhp = n/2 + 1 rounded up to 8. With the phase of the folded
    frequencies between them they give `_shear_rows`."""
    k1, nh = _round_up(n, 8), n // 2 + 1
    nhp = _round_up(nh, 8)
    jk = (torch.arange(n)[:, None] * torch.arange(nh)[None]) % n
    ang = jk.double() * (2.0 * math.pi / n)
    fwd = torch.zeros(k1, 2 * nhp, dtype=torch.float64)
    fwd[:n, :nh] = torch.cos(ang)
    fwd[:n, nhp:nhp + nh] = -torch.sin(ang)
    w = torch.full((nh,), 2.0, dtype=torch.float64)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    inv = torch.zeros(2 * nhp, k1, dtype=torch.float64)
    inv[:nh, :n] = (w[:, None] / n) * torch.cos(ang.T)
    inv[nhp:nhp + nh, :n] = -(w[:, None] / n) * torch.sin(ang.T)
    return fwd, inv


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits), to nearest and ties
    away from zero (cvt.rna.tf32.f32's rounding)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) TF32 parts of a float64 matrix: hi + lo is m to about
    2^-22 relative, and hi.b + lo.b's products on the tensor cores keep
    FP32 accuracy."""
    hi = tf32_round(m.float())
    return hi, tf32_round((m - hi.double()).float())


def mma_fragments(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """[K, N] hi and lo parts in mma.m16n8k8's B-fragment order, [N/8, K/8,
    32, 4]: for n-tile nt, k-step ks and lane 4g + t the float4 (hi b0, hi
    b1, lo b0, lo b1) with b0 = B[8 ks + t, 8 nt + g], b1 = B[8 ks + t + 4,
    8 nt + g]."""
    k, n = hi.shape

    def part(m):   # [nt, ks, g, t, (row t, row t + 4)]
        return m.reshape(k // 8, 2, 4, n // 8, 8).permute(3, 0, 4, 2, 1)

    return torch.cat([part(hi), part(lo)], -1).reshape(
        n // 8, k // 8, 32, 4).contiguous()


@functools.lru_cache(maxsize=8)
def full_pass_tables(n: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's forward and inverse shear tables for n x n planes, in
    B-fragment order (`mma_fragments` of `tf32_split` of
    `shear_matrices`), float32 on `device`."""
    return tuple(mma_fragments(*tf32_split(m)).to(device)
                 for m in shear_matrices(n))


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


def cheap_applied(perm: torch.Tensor, num: torch.Tensor,
                  window: torch.Tensor) -> torch.Tensor:
    """[B, 6] True at the stages a `cheap_pass` applies: inside the window
    [lo, hi), below the prefix length, and not the rotation."""
    stage = torch.arange(NUM_OPS, device=perm.device)[None]
    window = window.to(perm.device)
    return ((stage >= window[:, :1]) & (stage < window[:, 1:])
            & (stage < num.to(perm.device)[:, None]) & (perm != ROTATE_OP))


def cheap_pass_reference(seeds: torch.Tensor, x: torch.Tensor,
                         perm: torch.Tensor, num: torch.Tensor,
                         window: torch.Tensor, *, c_img: int = 3,
                         bits: Optional[BitSource] = None,
                         **op_constants) -> torch.Tensor:
    """Plain PyTorch `cheap_pass`: the same function, arguments and random
    stream as the kernel (see `cheap_pass`), at any H x W; `op_constants`
    and `bits` as for `full_pass_reference`."""
    perm = perm.to(x.device)
    return _compose_reference(seeds, x, perm,
                              cheap_applied(perm, num, window), None, c_img,
                              bits, **{**_OP_CONSTANTS, **op_constants})


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
# The kernels: their C arguments before the stream (`kernel_library.bind`),
# checks and launches.
# --------------------------------------------------------------------------

_FULL_PASS_ARGS = [PTR] * 9 + [I32] * 8 + [F32] * 6
_CHEAP_PASS_ARGS = [PTR] * 6 + [I32] * 6 + [F32] * 6 + [I32] * 4
_LIGHT_ARGS = [PTR] * 5 + [I32] * 4 + [F32] * 3 + [I32] * 4


def _check(name, x, c_img, **index_args):
    """The checks both planar kernels make: x a contiguous float32 [B, C,
    H, W] with a 2-plane one-hot mask after c_img image planes; each of
    `index_args` (name: (tensor, trailing shape)) contiguous int32 [B, ...]
    on x's device."""
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [B, C, H, W]")
    b, c_tot = x.shape[:2]
    if c_tot - c_img != 2:
        raise ValueError("{} needs a 2-channel one-hot mask".format(name))
    for arg, (t, trailing) in index_args.items():
        shape = (b,) + trailing
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError("{} must be contiguous int32 {} on {}".format(
                arg, shape, x.device))


def _float_consts(noise_mean_sd, exposure_mean_sd, eraser_s_l, eraser_s_h,
                  eraser_r_1, eraser_r_2):
    """The six float op constants both planar kernels take, rounded to
    float32 as the plain version rounds them."""
    return (f32(noise_mean_sd), f32(exposure_mean_sd), f32(eraser_s_l),
            f32(eraser_s_h - eraser_s_l), f32(eraser_r_1),
            f32(eraser_r_2 - eraser_r_1))


@profiling.spanned("augment.full_pass")
def full_pass(seeds: torch.Tensor, x: torch.Tensor, perm: torch.Tensor,
              num: torch.Tensor, rot: torch.Tensor, *, c_img: int = 3,
              max_shift: int = 23, noise_mean_sd: float = 5.1,
              exposure_mean_sd: float = 12.75, eraser_s_l: float = 0.02,
              eraser_s_h: float = 0.10, eraser_r_1: float = 0.3,
              eraser_r_2: float = 1.0 / 0.3) -> torch.Tensor:
    """The whole six-op composition over a planar batch in one launch.

    Args:
      seeds: [B] int32 per-sample Philox keys.
      x: [B, C_tot, H, W] float32 planar image + one-hot mask batch, H == W
        (at most MAX_FULL_PASS_N, and c_img at most 8, on the card),
        C_tot - c_img == 2. The mask planes must be one-hot (bg == 1 - fg):
        the kernel rotates the fg plane alone and writes bg as 1 - fg, so
        after a rotation it may differ from the plain version's two-plane
        snap only at a tie |fg - 1/2| within rounding.
      perm: [B, 6] int32 op permutation (0 eraser, 1 translate, 2 fliplr,
        3 noise, 4 exposure, 5 rotation).
      num: [B] int32 prefix length.
      rot: [B, 4] int32 (angle degrees, border mode, fill with noise, cval).
    Returns the transformed batch. A CUDA tensor launches the kernel
    (counted under "full_pass" in `kernel_library.launches`); a CPU tensor
    takes the plain version; any other device raises.
    """
    _check("full_pass", x, c_img, seeds=(seeds, ()), perm=(perm, (NUM_OPS,)),
           num=(num, ()), rot=(rot, (4,)))
    b, c_tot, h, n = x.shape
    if h != n:
        raise ValueError("full_pass needs square planes, got {}x{}".format(
            h, n))
    floats = dict(noise_mean_sd=noise_mean_sd,
                  exposure_mean_sd=exposure_mean_sd, eraser_s_l=eraser_s_l,
                  eraser_s_h=eraser_s_h, eraser_r_1=eraser_r_1,
                  eraser_r_2=eraser_r_2)
    if x.device.type == "cpu":
        return full_pass_reference(seeds, x, perm, num, rot, c_img=c_img,
                                   max_shift=max_shift, **floats)
    if x.device.type != "cuda":
        raise ValueError("full_pass runs on cuda or cpu tensors")
    if n > MAX_FULL_PASS_N:
        raise ValueError("full_pass takes planes up to {0}x{0} on the card, "
                         "got {1}x{1}".format(MAX_FULL_PASS_N, n))
    if c_img > _MAX_IMG_PLANES:
        raise ValueError("full_pass takes at most {} image planes on the "
                         "card".format(_MAX_IMG_PLANES))
    fn = kernel_library.bind("full_pass", "full_pass", _FULL_PASS_ARGS)
    out = torch.empty_like(x)
    trig = rotation_trig(rot)
    cs, group, smem = full_pass_plan(n)
    fwd, inv = full_pass_tables(n, x.device)
    kernel_library.launch(
        "full_pass", fn, x.device, x.data_ptr(), out.data_ptr(),
        seeds.data_ptr(), perm.data_ptr(), num.data_ptr(), rot.data_ptr(),
        trig.data_ptr(), fwd.data_ptr(), inv.data_ptr(), b, c_tot, n, c_img,
        max_shift, cs, group, smem, *_float_consts(**floats))
    return out


@profiling.spanned("augment.cheap_pass")
def cheap_pass(seeds: torch.Tensor, x: torch.Tensor, perm: torch.Tensor,
               num: torch.Tensor, window: torch.Tensor, *, c_img: int = 3,
               max_shift: int = 23, noise_mean_sd: float = 5.1,
               exposure_mean_sd: float = 12.75, eraser_s_l: float = 0.02,
               eraser_s_h: float = 0.10, eraser_r_1: float = 0.3,
               eraser_r_2: float = 1.0 / 0.3) -> torch.Tensor:
    """The five cheap ops at the stages of a window, in one launch.

    Args:
      seeds: [B] int32 per-sample Philox keys.
      x: [B, C_tot, H, W] float32 planar image + one-hot mask batch (any H,
        W), C_tot - c_img == 2, c_img <= 8.
      perm: [B, 6] int32 op permutation, as for `full_pass`; the rotation
        stage (op 5) is skipped.
      num: [B] int32 prefix length.
      window: [B, 2] int32 [lo, hi): the stages this pass applies.
    Returns the transformed batch. A CUDA tensor launches the kernel
    (counted under "cheap_pass" in `kernel_library.launches`); a CPU tensor
    takes the plain version; any other device raises.
    """
    _check("cheap_pass", x, c_img, seeds=(seeds, ()),
           perm=(perm, (NUM_OPS,)), num=(num, ()), window=(window, (2,)))
    if c_img > _MAX_IMG_PLANES:
        raise ValueError("cheap_pass takes at most {} image planes".format(
            _MAX_IMG_PLANES))
    floats = dict(noise_mean_sd=noise_mean_sd,
                  exposure_mean_sd=exposure_mean_sd, eraser_s_l=eraser_s_l,
                  eraser_s_h=eraser_s_h, eraser_r_1=eraser_r_1,
                  eraser_r_2=eraser_r_2)
    if x.device.type == "cpu":
        return cheap_pass_reference(seeds, x, perm, num, window,
                                    c_img=c_img, max_shift=max_shift,
                                    **floats)
    if x.device.type != "cuda":
        raise ValueError("cheap_pass runs on cuda or cpu tensors")
    fn = kernel_library.bind("cheap_pass", "cheap_pass", _CHEAP_PASS_ARGS)
    out = torch.empty_like(x)
    b, c_tot, h, w = x.shape
    plan = cheap_pass_plan(b, c_tot, h, w,
                           *_sms_and_alignment(x.device, (x, out)))
    kernel_library.launch(
        "cheap_pass", fn, x.device, x.data_ptr(), out.data_ptr(),
        seeds.data_ptr(), perm.data_ptr(), num.data_ptr(), window.data_ptr(),
        b, c_tot, h, w, c_img, max_shift, *_float_consts(**floats), *plan)
    return out


@profiling.spanned("augment.light")
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
    to integers. A CUDA tensor launches the kernel (counted under
    "fused_light_augment" in `kernel_library.launches`); a CPU tensor takes
    the plain version; any other device raises.
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
    fn = kernel_library.bind("light_augment", "light_augment", _LIGHT_ARGS)
    out_images, out_masks = torch.empty_like(images), torch.empty_like(masks)
    plan = light_plan(b, h, w, *_sms_and_alignment(
        images.device, (images, masks, out_images, out_masks)))
    kernel_library.launch(
        "fused_light_augment", fn, images.device, images.data_ptr(),
        masks.data_ptr(), out_images.data_ptr(), out_masks.data_ptr(),
        seeds.data_ptr(), b, h, w, max_shift, f32(prob_original),
        f32(noise_mean_sd), f32(exposure_mean_sd), *plan)
    return out_images, out_masks
