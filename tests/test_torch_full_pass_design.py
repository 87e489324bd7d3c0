"""The arithmetic of the `full_pass` CUDA kernel (csrc/full_pass.cu), held
on the CPU against the plain version it is compared with on the card.

The kernel shears each line as two matrix products over the half
spectrum, on the tensor cores in the 3xTF32 split, against host-built
tables in the mma's B-fragment order; it rotates the fg mask plane alone
and writes bg as 1 - fg. A torch emulation of that shear lives here (not in
the package): TF32 keeps 10 mantissa bits (the tables' parts are rounded
on the host, the data's truncated as the tensor core reads them), and a
product of two TF32 values is exact in float32, so float32 products of the
parts emulate the tensor cores' FP32 accumulation. Inputs come from numpy
with the `rng` fixture's seed.
"""
import math

import numpy as np
import pytest
import torch

from mliis_tpu_torch.ops import augment_kernels as tk

SIZES = [7, 8, 33, 224]


def _tf32_truncate(v):
    """v as the tensor core reads a float32 operand: its low 13 mantissa
    bits dropped (the kernel's `tf32_hi` mask)."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a, b64, split):
    """a [L, K] float32 times the float64 table b64 [K, N] as the kernel
    takes it: 3xTF32 (lo.hi + hi.lo + hi.hi) or one-pass TF32."""
    b_hi, b_lo = tk.tf32_split(b64)
    a_hi = _tf32_truncate(a)
    if not split:
        return a_hi @ b_hi
    a_lo = _tf32_truncate(a - a_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _shear_emulated(v, shifts, split=True):
    """The kernel's shear of the rows of v [L, n] by shifts [L]: forward
    product, phase on the n/2 + 1 bins (Nyquist folded to -n/2), inverse
    product with the Hermitian weights."""
    lines, n = v.shape
    fwd, inv = tk.shear_matrices(n)
    k1, nhp, nh = fwd.shape[0], fwd.shape[1] // 2, n // 2 + 1
    a = torch.zeros(lines, k1)
    a[:, :n] = v
    x = _product(a, fwd, split)
    theta = (-2.0 * math.pi / n * tk._fold_freqs(n, "cpu")[:nh])[None] \
        * shifts[:, None]
    pc, ps = torch.cos(theta), torch.sin(theta)
    xr, xi = x[:, :nh], x[:, nhp:nhp + nh]
    y = torch.zeros(lines, 2 * nhp)
    y[:, :nh] = xr * pc - xi * ps
    y[:, nhp:nhp + nh] = xr * ps + xi * pc
    return _product(y, inv, split)[:, :n]


def _three_shears(plane, alpha, beta, shear):
    """Rows by alpha, columns by beta, rows by alpha, as the rotation."""
    n = plane.shape[-1]
    centred = torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0
    plane = shear(plane, alpha * centred)
    plane = shear(plane.T.contiguous(), beta * centred).T
    return shear(plane.contiguous(), alpha * centred)


def _reference_shear(v, shifts):
    return tk._shear_rows(v[None, None], shifts[None])[0, 0]


def _trig(angle):
    t = tk.rotation_trig(torch.tensor([[angle, 0, 0, 0]], dtype=torch.int32))
    return float(t[0, 0]), float(t[0, 1])


@pytest.mark.parametrize("n", SIZES)
def test_tf32_split_parts(n):
    """hi is TF32 (its low 13 mantissa bits zero), and hi + lo is the
    float64 matrix within 2^-22 relative, element by element."""
    for m in tk.shear_matrices(n):
        hi, lo = tk.tf32_split(m)
        for part in (hi, lo):
            assert not bool((part.view(torch.int32) & 0x1FFF).any())
        err = (hi.double() + lo.double() - m).abs()
        assert bool((err <= 2.0 ** -22 * m.abs()).all())


@pytest.mark.parametrize("n", [7, 33, 224])
def test_mma_fragments_follow_the_ptx_layout(n):
    """Lane 4g + t of n-tile nt, k-step ks holds B[8 ks + t, 8 nt + g] and
    B[8 ks + t + 4, 8 nt + g], hi then lo (mma.m16n8k8's B fragment)."""
    fwd, _ = tk.shear_matrices(n)
    hi, lo = tk.tf32_split(fwd)
    frag = tk.mma_fragments(hi, lo)
    k, cols = hi.shape
    assert frag.shape == (cols // 8, k // 8, 32, 4)
    nt, ks, lane = np.meshgrid(np.arange(cols // 8), np.arange(k // 8),
                               np.arange(32), indexing="ij")
    row, col = 8 * ks + lane % 4, 8 * nt + lane // 4
    for j, (m, r) in enumerate([(hi, 0), (hi, 4), (lo, 0), (lo, 4)]):
        assert torch.equal(frag[..., j], m[torch.from_numpy(row + r),
                                           torch.from_numpy(col)])


@pytest.mark.parametrize("n", SIZES)
def test_half_spectrum_shears_match_reference(rng, n):
    """The emulated kernel shear (half spectrum, Hermitian weights, the
    Nyquist fold, 3xTF32) against `_shear_rows` over three shears of
    uniform 0..255 noise at a 37 degree rotation: within 5e-3 abs."""
    plane = torch.from_numpy(rng.uniform(0, 255, (n, n)).astype(np.float32))
    alpha, beta = _trig(37)
    port = _three_shears(plane, alpha, beta, _shear_emulated)
    ref = _three_shears(plane, alpha, beta, _reference_shear)
    assert float((port - ref).abs().max()) <= 5e-3


def test_one_pass_tf32_misses_the_bar(rng):
    """Why the split: one-pass TF32 products are off by more than the 1e-2
    bar at 224^2 over the same three shears."""
    n = 224
    plane = torch.from_numpy(rng.uniform(0, 255, (n, n)).astype(np.float32))
    alpha, beta = _trig(37)
    one_pass = _three_shears(plane, alpha, beta, lambda v, s: _shear_emulated(
        v, s, split=False))
    ref = _three_shears(plane, alpha, beta, _reference_shear)
    assert float((one_pass - ref).abs().max()) > 1e-2


def _disc_masks(rng, b, n):
    yy, xx = np.mgrid[:n, :n]
    cy, cx = rng.uniform(0.3 * n, 0.7 * n, (2, b, 1, 1))
    r = rng.uniform(0.1 * n, 0.35 * n, (b, 1, 1))
    return ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2).astype(np.float32)


def test_one_plane_snap_matches_two_plane_snap(rng):
    """The kernel's snap fg' >= 1 - fg' of the rotated fg plane against
    `rotate_shear_planar`'s fg' >= bg' of both rotated planes, over 16
    drawn angles at 64^2: at most 1e-4 of the mask pixels differ."""
    b, n = 16, 64
    fg = _disc_masks(rng, b, n)
    imgs = rng.integers(0, 256, (b, 3, n, n)).astype(np.float32)
    x = torch.from_numpy(np.concatenate(
        [imgs, (1.0 - fg)[:, None], fg[:, None]], axis=1))
    angles = rng.integers(-45, 45, b)
    rot = torch.from_numpy(np.stack([angles, 0 * angles, 0 * angles,
                                     0 * angles], 1).astype(np.int32))
    ref = tk.rotate_shear_planar(x, rot, 3, torch.zeros(b, 3, n, n))
    flips = 0
    for i in range(b):
        alpha, beta = _trig(int(angles[i]))
        r = _three_shears(x[i, 4], alpha, beta, _shear_emulated)
        snapped = (r >= 1.0 - r).float()
        flips += int((snapped != ref[i, 4]).sum())
        assert torch.equal(ref[i, 3], 1.0 - ref[i, 4])
    assert flips <= 1e-4 * b * n * n


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_keeps_background_one_hot(seed):
    """`full_pass_reference` on drawn rows at 32^2 keeps bg == 1 - fg
    exactly for one-hot inputs: the identity the kernel's one mask plane
    relies on."""
    rng = np.random.default_rng(seed)
    b, n = 16, 32
    fg = (rng.random((b, 1, n, n)) > 0.5).astype(np.float32)
    x = torch.from_numpy(np.concatenate(
        [rng.integers(0, 256, (b, 3, n, n)).astype(np.float32), 1.0 - fg,
         fg], axis=1))
    perm = torch.from_numpy(np.stack([rng.permutation(6) for _ in range(b)])
                            .astype(np.int32))
    num = torch.from_numpy(rng.integers(1, 7, b).astype(np.int32))
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, b).astype(np.int32))
    rot = torch.from_numpy(np.stack([rng.integers(-45, 45, b),
                                     rng.integers(0, 4, b),
                                     rng.integers(0, 2, b),
                                     rng.integers(0, 256, b)], 1)
                           .astype(np.int32))
    out = tk.full_pass_reference(seeds, x, perm, num, rot)
    assert torch.equal(out[:, 3], 1.0 - out[:, 4])
    assert not torch.equal(out, x)


@pytest.mark.parametrize("n,cs,group", [(224, 4, 64), (225, 4, 64),
                                        (320, 8, 48), (512, 8, 16),
                                        (32, 1, 32)])
def test_plan_fits_a_block(n, cs, group):
    """The cluster table of csrc/full_pass.cu's note: each block's rows,
    line buffer and spectrum buffer fit the shared memory of one block."""
    got_cs, got_group, smem = tk.full_pass_plan(n)
    rows = -(-n // got_cs)
    assert (got_cs, got_group) == (cs, group)
    assert rows <= 64 and got_cs * rows >= n
    assert smem <= 232448 - 1024


def test_plan_refuses_planes_past_the_limit():
    with pytest.raises(ValueError):
        tk.full_pass_plan(tk.MAX_FULL_PASS_N + 1)
