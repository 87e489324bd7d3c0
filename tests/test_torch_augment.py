"""The port's `full_pass` against the JAX package's Pallas `full_pass`.

Exact cases: the Pallas kernel runs in TPU interpret mode, whose on-core
PRNG yields all-zero bits, and `full_pass_reference` takes the all-zero bit
source, so both see the same draws (tests/test_pallas_augment.py's six
cases). Random behaviour is held in distribution against the jnp path in
tests/test_torch_augment_distribution.py.

On the CPU the `full_pass` wrapper takes its plain version; the CUDA kernel
is held against that plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mliis_tpu.ops.augment import _rotate_shear_planar
from mliis_tpu.ops.pallas_augment import full_pass as jax_full_pass
from mliis_tpu_torch.ops import augment as taug
from mliis_tpu_torch.ops import augment_kernels as tk
from mliis_tpu_torch.ops import kernel_library

C_IMG = 3
ROTATE = 5


def _planar_batch(rng, b=2, h=32, w=32):
    imgs = rng.integers(0, 256, (b, 3, h, w)).astype(np.float32)
    fg = (rng.random((b, 1, h, w)) > 0.5).astype(np.float32)
    return np.concatenate([imgs, 1.0 - fg, fg], axis=1)


def _rows(b, perm_row, num, rot_row):
    return (np.arange(b, dtype=np.int32),
            np.tile(np.asarray(perm_row, np.int32)[None], (b, 1)),
            np.full((b,), num, np.int32),
            np.tile(np.asarray([rot_row], np.int32), (b, 1)))


def _run_both(x, perm_row, num, rot_row=(0, 0, 0, 0)):
    seeds, perm, nums, rot = _rows(x.shape[0], perm_row, num, rot_row)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_full_pass(
            jnp.asarray(seeds), jnp.asarray(x), jnp.asarray(perm),
            jnp.asarray(nums), jnp.asarray(rot), interpret=True))
    port = tk.full_pass_reference(
        torch.from_numpy(seeds), torch.from_numpy(x), torch.from_numpy(perm),
        torch.from_numpy(nums), torch.from_numpy(rot), bits=tk.zero_bits)
    return port.numpy(), ref


@pytest.mark.parametrize("perm_row,num", [
    ([0, 1, 2, 3, 4, 5], 0),      # prefix 0: identity
    ([2, 0, 1, 3, 4, 5], 1),      # fliplr
    ([0, 1, 2, 3, 4, 5], 3),      # eraser, translate, fliplr
    ([4, 3, 2, 1, 0, 5], 5),      # every cheap op, noise included
])
def test_cheap_ops_match_pallas(rng, perm_row, num):
    """1e-4 abs: the draws are identical; only log/cos of the gaussian
    scalars may round differently in the last ulp (noise ~60 on 0..255)."""
    x = _planar_batch(rng)
    port, ref = _run_both(x, perm_row, num)
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
    if num == 0:
        np.testing.assert_array_equal(port, x)


def test_zero_angle_rotation_is_near_identity(rng):
    """0 degrees: identity phase shifts, so the DFT round trip returns the
    input. 1e-3 abs on 0..255 for the port (float64-built twiddle tables);
    5e-2 to the Pallas kernel, whose twiddles are cos of the large
    argument 2 pi j k / n in float32. Masks snap back exactly."""
    x = _planar_batch(rng)
    port, ref = _run_both(x, [5, 0, 1, 2, 3, 4], 1, (0, 0, 0, 0))
    np.testing.assert_allclose(port[:, :3], x[:, :3], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(port[:, 3:], x[:, 3:])
    np.testing.assert_allclose(port, ref, atol=5e-2, rtol=0)


def test_rotation_matches_xla_shear_rotation(rng):
    """30 degrees, reflect mode, against the jnp `_rotate_shear_planar` and
    the Pallas kernel: 1e-2 abs on 0..255 (float32 DFT rounding), the one
    the Pallas test holds."""
    x = _planar_batch(rng)
    port, ref = _run_both(x, [5, 0, 1, 2, 3, 4], 1, (30, 0, 0, 0))
    for b in range(x.shape[0]):
        xla = np.asarray(_rotate_shear_planar(
            jnp.asarray(x[b]), 3, jnp.float32(30), jnp.int32(0), False,
            jnp.float32(0.0), jnp.zeros((3, 32, 32), jnp.float32)))
        np.testing.assert_allclose(port[b], xla, atol=1e-2, rtol=0)
    np.testing.assert_allclose(port, ref, atol=1e-2, rtol=0)


def test_constant_mode_fills_corners(rng):
    """44 degrees, constant mode, cval 7: the out-of-frame corner is exactly
    cval on the image planes and background on the mask planes, and the
    out-of-bounds sets of the two versions are the same pixels."""
    x = _planar_batch(rng)
    port, ref = _run_both(x, [5, 0, 1, 2, 3, 4], 1, (44, 1, 0, 7))
    assert np.all(port[:, :3, 0, 0] == 7.0)
    assert np.all(port[:, 3, 0, 0] == 1.0) and np.all(port[:, 4, 0, 0] == 0.0)
    np.testing.assert_array_equal(port[:, :3] == 7.0, ref[:, :3] == 7.0)
    np.testing.assert_allclose(port, ref, atol=1e-2, rtol=0)


def test_mask_stays_onehot_through_rotation(rng):
    """Every op in one composition (mirror mode at 17 degrees): the masks
    are exact one-hot and agree with the Pallas kernel; images 1e-2 abs."""
    x = _planar_batch(rng)
    port, ref = _run_both(x, [0, 1, 5, 2, 3, 4], 6, (17, 2, 0, 0))
    np.testing.assert_array_equal(port[:, 3] + port[:, 4], 1.0)
    assert set(np.unique(port[:, 4])) <= {0.0, 1.0}
    np.testing.assert_array_equal(port[:, 3:], ref[:, 3:])
    np.testing.assert_allclose(port[:, :3], ref[:, :3], atol=1e-2, rtol=0)


def test_philox_matches_known_answer():
    """Philox4x32-10 of Random123's known-answer vector: counter and key
    all 0xFFFFFFFF... is not reachable here (key word 1 and counter words
    2, 3 are 0), so check the all-zero vector: 6627e8d5 e169c58d bc57ac4c
    9b00dbd8 (Random123 kat_vectors, philox4x32_10 with zero inputs)."""
    w0, w1 = tk.philox_words(torch.zeros(1, 1, dtype=torch.int64),
                             torch.zeros(1, 1, dtype=torch.int64), 0)
    assert (int(w0), int(w1)) == (0x6627E8D5, 0xE169C58D)


def test_wrapper_checks_inputs():
    x = torch.zeros(2, 5, 32, 32)
    seeds, perm, nums, rot = (torch.from_numpy(a) for a in _rows(
        2, [0, 1, 2, 3, 4, 5], 1, (0, 0, 0, 0)))
    with pytest.raises(ValueError):
        tk.full_pass(seeds, torch.zeros(2, 5, 32, 16), perm, nums, rot)
    with pytest.raises(ValueError):
        tk.full_pass(seeds, torch.zeros(2, 6, 32, 32), perm, nums, rot)
    with pytest.raises(ValueError):
        tk.full_pass(seeds.long(), x, perm, nums, rot)
    before = kernel_library.launches["full_pass"]
    out = tk.full_pass(seeds, x, perm, nums, rot)
    assert out.shape == x.shape and kernel_library.launches[
        "full_pass"] == before
    # The plain version takes any square size: 320^2 no longer raises.
    big = torch.zeros(2, 5, 320, 320)
    assert tk.full_pass(seeds, big, perm, nums, rot).shape == big.shape


@pytest.mark.parametrize("n", [256, 320])
@pytest.mark.parametrize("perm_row,num,rot_row", [
    ([4, 3, 2, 1, 0, 5], 5, (0, 0, 0, 0)),     # every cheap op
    ([0, 1, 5, 2, 3, 4], 6, (17, 2, 0, 0)),    # every op, mirror mode
    ([5, 0, 1, 2, 3, 4], 1, (44, 1, 0, 7)),    # constant mode, cval 7
], ids=["cheap_ops", "all_ops", "constant_mode"])
def test_planes_past_224_match_pallas(rng, n, perm_row, num, rot_row):
    """Planes larger than one block's shared memory holds (csrc/full_pass.cu
    keeps them in device memory) against the Pallas kernel, with the 32^2
    cases' bars: the cheap ops 1e-4 abs; rotated image planes 5e-2 abs on
    0..255 (the zero-angle case's bar: the Pallas kernel's float32
    large-argument DFT matrices; 2.8e-2 seen at 320^2), and the masks one-hot
    with at most 1e-4 of their pixels flipped (chip_smoke.py's bar; none at
    32^2, 2e-5 seen at 320^2, fg/bg ties moved by that same DFT error)."""
    x = _planar_batch(rng, h=n, w=n)
    port, ref = _run_both(x, perm_row, num, rot_row)
    if ROTATE not in perm_row[:num]:
        np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)
        return
    np.testing.assert_array_equal(port[:, 3] + port[:, 4], 1.0)
    assert (port[:, 3:] != ref[:, 3:]).mean() <= 1e-4
    np.testing.assert_allclose(port[:, :3], ref[:, :3], atol=5e-2, rtol=0)
    if rot_row[1] == 1:
        assert np.all(port[:, :3, 0, 0] == rot_row[3])
        assert np.all(port[:, 3, 0, 0] == 1.0)


def test_gate_passes_samples_through(rng):
    """A gated sample leaves `augment_batch` exactly as it came in (its
    prefix length is 0); with the gate shut every sample is augmented; and
    to_planar / from_planar round-trip the NHWC pair."""
    images = torch.from_numpy(rng.integers(0, 256, (4, 16, 16, 3)).astype(
        np.float32))
    fg = torch.from_numpy((rng.random((4, 16, 16)) > 0.5).astype(np.float32))
    masks = torch.stack([1.0 - fg, fg], dim=-1)
    back = taug.from_planar(taug.to_planar(images, masks), C_IMG)
    assert torch.equal(back[0], images) and torch.equal(back[1], masks)
    gen = torch.Generator().manual_seed(0)
    same_i, same_m = taug.augment_batch(gen, images, masks, 1.0)
    assert torch.equal(same_i, images) and torch.equal(same_m, masks)
    aug_i, aug_m = taug.augment_batch(gen, images, masks, 0.0)
    assert all(not torch.equal(aug_i[k], images[k]) or not torch.equal(
        aug_m[k], masks[k]) for k in range(4))
    assert torch.equal(aug_m.sum(-1), torch.ones(4, 16, 16))


def test_fused_route_is_one_full_pass(rng):
    """On a square batch the default route draws, in order, the gate, the
    permutation, the prefix length, one seed and the rotation's four
    parameters, and applies one `full_pass`: the split route's extra draws
    leave it as it was."""
    images = torch.from_numpy(rng.integers(0, 256, (6, 16, 16, 3)).astype(
        np.float32))
    fg = torch.from_numpy((rng.random((6, 16, 16)) > 0.5).astype(np.float32))
    masks = torch.stack([1.0 - fg, fg], dim=-1)
    out = taug.augment_batch(torch.Generator().manual_seed(5), images, masks,
                             0.5)
    gen = torch.Generator().manual_seed(5)
    i32 = dict(generator=gen, dtype=torch.int32)
    skip = torch.rand(6, generator=gen) <= 0.5
    perm = torch.argsort(torch.rand(6, 6, generator=gen), 1).int()
    num = torch.where(skip, 0, torch.randint(1, 7, (6,), **i32))
    seeds = torch.randint(0, 2 ** 31 - 1, (6,), **i32)
    rot = torch.stack([torch.randint(lo, hi, (6,), **i32) for lo, hi in (
        (-45, 45), (0, 4), (0, 2), (0, 256))], 1)
    ref = taug.from_planar(tk.full_pass_reference(
        seeds, taug.to_planar(images, masks), perm, num, rot), C_IMG)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_augment_batch_at_320(rng, fused, monkeypatch):
    """The JAX CLI's default image size, 320^2, on both routes (it raised
    before planes past 224^2 were taken): the gate shut, every sample
    augmented, the masks one-hot."""
    images = torch.from_numpy(rng.integers(0, 256, (2, 320, 320, 3)).astype(
        np.float32))
    fg = torch.from_numpy((rng.random((2, 320, 320)) > 0.5).astype(
        np.float32))
    masks = torch.stack([1.0 - fg, fg], dim=-1)
    monkeypatch.setattr(taug, "PALLAS_FUSED_SINGLE_LAUNCH", fused)
    gen = torch.Generator().manual_seed(1)
    aug_i, aug_m = taug.augment_batch(gen, images, masks, 0.0)
    assert aug_i.shape == images.shape and aug_m.shape == masks.shape
    assert torch.equal(aug_m.sum(-1), torch.ones(2, 320, 320))
    assert bool(aug_i.isfinite().all())
