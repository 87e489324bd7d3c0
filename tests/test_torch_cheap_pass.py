"""The port's `cheap_pass` and split-route rotation against the JAX
package's Pallas `cheap_pass` and XLA `_rotate_shear_planar`.

Exact cases: the Pallas kernel runs in TPU interpret mode, whose on-core
PRNG yields all-zero bits, and `cheap_pass_reference` takes the all-zero
bit source, so both see the same draws (tests/test_pallas_augment.py's
cheap-pass cases), at 32^2 and at a non-square 24x40. On the CPU the
`cheap_pass` wrapper takes its plain version; the CUDA kernel is held
against that plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mliis_tpu.ops.augment import _rotate_shear_planar
from mliis_tpu.ops.pallas_augment import cheap_pass as jax_cheap_pass
from mliis_tpu_torch.ops import augment_kernels as tk
from mliis_tpu_torch.ops import kernel_library

SHAPES = [(32, 32), (24, 40)]


def _planar_batch(rng, h, w, b=2):
    imgs = rng.integers(0, 256, (b, 3, h, w)).astype(np.float32)
    fg = (rng.random((b, 1, h, w)) > 0.5).astype(np.float32)
    return np.concatenate([imgs, 1.0 - fg, fg], axis=1)


def _rows(b, perm_row, num, lo, hi):
    return (np.arange(b, dtype=np.int32),
            np.tile(np.asarray(perm_row, np.int32)[None], (b, 1)),
            np.full((b,), num, np.int32),
            np.tile(np.asarray([[lo, hi]], np.int32), (b, 1)))


def _run_both(x, perm_row, num, lo, hi):
    """(port with zero bits, Pallas kernel in interpret mode)."""
    args = _rows(x.shape[0], perm_row, num, lo, hi)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_cheap_pass(
            *(jnp.asarray(a) for a in args[:1]), jnp.asarray(x),
            *(jnp.asarray(a) for a in args[1:]), interpret=True))
    seeds, perm, nums, win = (torch.from_numpy(a) for a in args)
    port = tk.cheap_pass_reference(seeds, torch.from_numpy(x), perm, nums,
                                   win, bits=tk.zero_bits)
    return port.numpy(), ref


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("perm_row,num,lo,hi", [
    ([0, 1, 2, 3, 4, 5], 6, 3, 3),   # empty window
    ([0, 1, 2, 3, 4, 5], 0, 0, 6),   # zero prefix
    ([5, 0, 1, 2, 3, 4], 1, 0, 6),   # only the rotation applied
], ids=["empty_window", "zero_prefix", "rotation_only"])
def test_identity_windows(rng, h, w, perm_row, num, lo, hi):
    x = _planar_batch(rng, h, w)
    port, ref = _run_both(x, perm_row, num, lo, hi)
    np.testing.assert_array_equal(port, x)
    np.testing.assert_array_equal(ref, x)


@pytest.mark.parametrize("h,w", SHAPES)
def test_fliplr_exact(rng, h, w):
    x = _planar_batch(rng, h, w)
    port, ref = _run_both(x, [2, 0, 1, 3, 4, 5], 1, 0, 6)
    np.testing.assert_array_equal(port, x[..., ::-1])
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("h,w", SHAPES)
def test_eraser_marks_background(rng, h, w):
    """Zero bits: the box at (0, 0) with the least area, fill 0; the erased
    pixels' mask planes are background. The box is the Pallas kernel's,
    exactly (its area is s * H * W)."""
    x = _planar_batch(rng, h, w)
    port, ref = _run_both(x, [0, 1, 2, 3, 4, 5], 1, 0, 6)
    changed = np.any(port[:, :3] != x[:, :3], axis=1)
    assert changed.any()
    for b in range(x.shape[0]):
        assert np.all(port[b, 3][changed[b]] == 1.0)
        assert np.all(port[b, 4][changed[b]] == 0.0)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("h,w", SHAPES)
def test_translate_zero_bits_rolls_rows(rng, h, w):
    """Zero bits: vertical, shift +1, the roll branch: rows roll by 1."""
    x = _planar_batch(rng, h, w)
    port, ref = _run_both(x, [1, 0, 2, 3, 4, 5], 1, 0, 6)
    np.testing.assert_array_equal(port, np.roll(x, 1, axis=2))
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("perm_row", [[0, 1, 2, 3, 4, 5], [4, 3, 2, 1, 0, 5]])
def test_mask_stays_onehot(rng, h, w, perm_row):
    """Every cheap op, noise included: the masks stay exactly one-hot and
    agree with the Pallas kernel; images 1e-4 abs (the draws are identical;
    only log/cos of the gaussian scalars may round differently in the last
    ulp, on a noise of ~60 on 0..255)."""
    x = _planar_batch(rng, h, w)
    port, ref = _run_both(x, perm_row, 6, 0, 6)
    np.testing.assert_array_equal(port[:, 3] + port[:, 4], 1.0)
    np.testing.assert_array_equal(port[:, 3:], ref[:, 3:])
    np.testing.assert_allclose(port[:, :3], ref[:, :3], atol=1e-4, rtol=0)


def _drawn(rng, b, h, w):
    x = torch.from_numpy(_planar_batch(rng, h, w, b))
    perm = torch.from_numpy(np.stack([rng.permutation(6) for _ in range(b)])
                            .astype(np.int32))
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, b).astype(np.int32))
    return x, perm, seeds


def test_full_window_without_rotation_equals_full_pass(rng):
    """With the [0, 6) window and the prefix stopping before the rotation,
    `cheap_pass_reference` is `full_pass_reference`, bit for bit, on the
    Philox stream (one counter map for both)."""
    b = 16
    x, perm, seeds = _drawn(rng, b, 32, 32)
    num = torch.argmax((perm == tk.ROTATE_OP).int(), dim=1).int()
    window = torch.tensor([[0, 6]] * b, dtype=torch.int32)
    rot = torch.zeros(b, 4, dtype=torch.int32)
    cheap = tk.cheap_pass_reference(seeds, x, perm, num, window)
    full = tk.full_pass_reference(seeds, x, perm, num, rot)
    assert torch.equal(cheap, full)
    assert not torch.equal(cheap, x)


def test_windows_compose(rng):
    """Two passes over [0, k) and [k, 6) with the same seed equal one pass
    over [0, 6) (24x40, Philox stream): the window only selects stages."""
    b = 12
    x, perm, seeds = _drawn(rng, b, 24, 40)
    num = torch.from_numpy(rng.integers(0, 7, b).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 7, b).astype(np.int32))
    six = torch.full_like(k, 6)
    whole = tk.cheap_pass(seeds, x, perm, num, torch.stack([0 * k, six], 1))
    first = tk.cheap_pass(seeds, x, perm, num, torch.stack([0 * k, k], 1))
    both = tk.cheap_pass(seeds, first, perm, num, torch.stack([k, six], 1))
    assert torch.equal(whole, both)


@pytest.mark.parametrize("angle,mode,fill", [(30, 0, 0), (-44, 1, 0),
                                             (17, 1, 1), (-12, 2, 0),
                                             (40, 3, 0)])
def test_rectangular_rotation_matches_xla(rng, angle, mode, fill):
    """`rotate_shear_planar` on 24x40 against the jnp `_rotate_shear_planar`
    at the same angle, border mode and border-noise plane: the image planes
    within 1e-2 abs on 0..255 (2.4e-3 seen), the one-hot masks equal. The
    gap is float32 DFT rounding, most of it the JAX side's: its DFT
    matrices are cos/sin of the large argument 2 pi j k / n in float32
    (ROADMAP.md section C); the port's tables are float64-built. In
    constant mode the out-of-frame corner holds the fill on both sides."""
    h, w = 24, 40
    x = _planar_batch(rng, h, w, b=1)
    noise = rng.integers(0, 256, (1, 3, h, w)).astype(np.float32)
    rot = torch.tensor([[angle, mode, fill, 91]], dtype=torch.int32)
    port = tk.rotate_shear_planar(torch.from_numpy(x), rot, 3,
                                  torch.from_numpy(noise))[0].numpy()
    ref = np.asarray(_rotate_shear_planar(
        jnp.asarray(x[0]), 3, jnp.float32(angle), jnp.int32(mode),
        jnp.asarray(bool(fill)), jnp.float32(91.0), jnp.asarray(noise[0])))
    np.testing.assert_allclose(port[:3], ref[:3], atol=1e-2, rtol=0)
    np.testing.assert_array_equal(port[3:], ref[3:])
    np.testing.assert_array_equal(port[3] + port[4], 1.0)
    if mode == 1:
        expect = noise[0, :, 0, 0] if fill else 91.0
        np.testing.assert_array_equal(port[:3, 0, 0], expect)
        np.testing.assert_array_equal(ref[:3, 0, 0], expect)
        assert port[3, 0, 0] == 1.0


def test_zero_angle_rotation_is_near_identity(rng):
    """0 degrees on 24x40: identity phase shifts, so the two DFT round trips
    return the input within 1e-3 on 0..255; the masks come back exactly."""
    x = _planar_batch(rng, 24, 40)
    out = tk.rotate_shear_planar(torch.from_numpy(x), torch.zeros(
        2, 4, dtype=torch.int32), 3, torch.zeros(2, 3, 24, 40)).numpy()
    np.testing.assert_allclose(out[:, :3], x[:, :3], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(out[:, 3:], x[:, 3:])


def test_wrapper_checks_inputs():
    x = torch.zeros(2, 5, 24, 40)
    seeds, perm, nums, win = (torch.from_numpy(a) for a in _rows(
        2, [0, 1, 2, 3, 4, 5], 6, 0, 6))
    with pytest.raises(ValueError):
        tk.cheap_pass(seeds, torch.zeros(2, 6, 24, 40), perm, nums, win)
    with pytest.raises(ValueError):
        tk.cheap_pass(seeds, x, perm, nums, win[:, :1].contiguous())
    with pytest.raises(ValueError):
        tk.cheap_pass(seeds.long(), x, perm, nums, win)
    before = kernel_library.launches["cheap_pass"]
    out = tk.cheap_pass(seeds, x, perm, nums, win)
    assert out.shape == x.shape and kernel_library.launches[
        "cheap_pass"] == before
