"""The port's per-image augmentation API (`ops/augment.py`:
`random_eraser`, `translate`, `fliplr`, `additive_gaussian_noise`,
`exposure`, `rotate_img_mask`, `apply_augmentations`) and its
`FAST_ROTATE = False` rotation against the JAX package's.

The two draw from different streams, so the random ops are held in
distribution over 96 draws each: the image's mean and std, the share of
pixels changed and the foreground area, at the bars of
tests/test_torch_augment_distribution.py. `fliplr` and the 4-tap rotation
at a fixed angle, mode and fill are compared directly with
`mliis_tpu.ops.augment`; JAX's `FAST_ROTATE` is switched only inside the
test that needs it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.ops import augment as jaug
from mliis_tpu_torch.ops import augment as taug

H = W = 24
N = 96


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    fg = np.zeros((H, W), np.float32)
    fg[6:18, 4:16] = 1.0
    return image, np.stack([1.0 - fg, fg], axis=-1)


def _stats(image, mask, ref_image, ref_mask):
    i, m = np.asarray(image), np.asarray(mask)
    return np.array([i.mean(), i.std(),
                     (np.abs(i - ref_image).max(-1) > 1e-3).mean(),
                     (np.abs(m - ref_mask).max(-1) > 1e-3).mean(),
                     m[..., 1].mean()])


def _jax_stats(fn, image, mask, n=N, **kw):
    outs = jax.jit(jax.vmap(lambda k: fn(k, jnp.asarray(image),
                                         jnp.asarray(mask), **kw)))(
        jax.random.split(jax.random.PRNGKey(7), n))
    return np.stack([_stats(i, m, image, mask) for i, m in zip(*outs)])


def _port_stats(fn, image, mask, n=N, **kw):
    gen = torch.Generator().manual_seed(7)
    ti, tm = torch.from_numpy(image), torch.from_numpy(mask)
    rows = []
    for _ in range(n):
        i, m = fn(gen, ti, tm, **kw)
        assert i.shape == ti.shape and m.shape == tm.shape
        assert bool(torch.isfinite(i).all())
        np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, atol=1e-3)
        rows.append(_stats(i.numpy(), m.numpy(), image, mask))
    return np.stack(rows)


def _assert_same_distribution(js, ps):
    """Means over the draws: image mean within 3%, std within 5%, changed
    shares and foreground area within 0.08 and 0.03."""
    ja, pa = js.mean(0), ps.mean(0)
    assert abs(ja[0] - pa[0]) / ja[0] < 0.03, (ja, pa)
    assert abs(ja[1] - pa[1]) / ja[1] < 0.05, (ja, pa)
    assert abs(ja[2] - pa[2]) < 0.08, (ja, pa)
    assert abs(ja[3] - pa[3]) < 0.08, (ja, pa)
    assert abs(ja[4] - pa[4]) < 0.03, (ja, pa)


OPS = ["random_eraser", "translate", "additive_gaussian_noise", "exposure",
       "rotate_img_mask"]


@pytest.mark.parametrize("name", OPS)
def test_op_matches_jax_in_distribution(name):
    image, mask = _pair()
    _assert_same_distribution(_jax_stats(getattr(jaug, name), image, mask),
                              _port_stats(getattr(taug, name), image, mask))


@pytest.mark.parametrize("name,kw", [
    ("random_eraser", dict(s_l=0.2, s_h=0.3, v_l=10.0, v_h=20.0)),
    ("translate", dict(max_shift=4)),
    ("additive_gaussian_noise", dict(mean_sd=20.0)),
    ("exposure", dict(mean_sd=40.0)),
    ("rotate_img_mask", dict(max_angle=10))],
    ids=["eraser", "translate", "noise", "exposure", "rotate"])
def test_op_arguments_match_jax_in_distribution(name, kw):
    """Each op's own arguments, away from its defaults."""
    image, mask = _pair(1)
    _assert_same_distribution(
        _jax_stats(getattr(jaug, name), image, mask, **kw),
        _port_stats(getattr(taug, name), image, mask, **kw))


def test_eraser_value_range_and_background():
    """`random_eraser` paints one value in [v_l, v_h) and sets the mask to
    background there; the noise ops leave the mask alone."""
    image, mask = (torch.from_numpy(a) for a in _pair(2))
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        out_i, out_m = taug.random_eraser(gen, image, mask, v_l=100.0,
                                          v_h=101.0)
        changed = (out_i != image).any(-1)
        assert changed.any()
        vals = out_i[changed]
        assert bool(((vals >= 100.0) & (vals < 101.0)).all())
        assert torch.equal(vals, vals[:1].expand_as(vals))
        assert bool((out_m[changed] == torch.tensor([1.0, 0.0])).all())
    for fn in (taug.additive_gaussian_noise, taug.exposure):
        out_i, out_m = fn(gen, image, mask)
        assert torch.equal(out_m, mask)
        assert 0.0 <= float(out_i.min()) and float(out_i.max()) <= 255.0


def test_fliplr_matches_jax():
    image, mask = _pair(3)
    ji, jm = jaug.fliplr(jax.random.PRNGKey(0), jnp.asarray(image),
                         jnp.asarray(mask))
    ti, tm = taug.fliplr(torch.Generator(), torch.from_numpy(image),
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("angle", [30, -17, 44])
@pytest.mark.parametrize("mode", [0, 1, 2, 3],
                         ids=["reflect", "constant", "mirror", "wrap"])
@pytest.mark.parametrize("noise_fill", [False, True],
                         ids=["cval", "noise"])
def test_4tap_rotation_matches_jax(angle, mode, noise_fill):
    """`rotate_4tap_planar` at a fixed angle, mode and fill against the
    JAX package's `_rotate_4tap_planar`: the image planes within 1e-3 of
    0..255, at most 1% of the mask pixels apart (a nearest tap may differ
    where a coordinate's float32 rounding crosses a half pixel)."""
    image, mask = _pair(4)
    noise = np.random.default_rng(5).integers(0, 256, (3, H, W)).astype(
        np.float32)
    x = np.concatenate([image.transpose(2, 0, 1), mask.transpose(2, 0, 1)])
    ref = np.asarray(jaug._rotate_4tap_planar(
        jnp.asarray(x), 3, jnp.float32(angle), jnp.int32(mode),
        jnp.bool_(noise_fill), jnp.float32(77.0), jnp.asarray(noise)))
    rot = torch.tensor([[angle, mode, int(noise_fill), 77]],
                       dtype=torch.int32)
    out = taug.rotate_4tap_planar(torch.from_numpy(x)[None], rot, 3,
                                  torch.from_numpy(noise)[None])[0].numpy()
    np.testing.assert_allclose(out[:3], ref[:3], atol=1e-3, rtol=0)
    assert (out[3:] != ref[3:]).mean() <= 0.01


def test_slow_rotation_matches_jax_in_distribution(monkeypatch):
    """With `FAST_ROTATE = False` on both sides, `rotate_img_mask` samples
    with the 4-tap rotation, and the two agree in distribution."""
    monkeypatch.setattr(jaug, "FAST_ROTATE", False)
    monkeypatch.setattr(taug, "FAST_ROTATE", False)
    calls = []
    real = taug.rotate_4tap_planar
    monkeypatch.setattr(taug, "rotate_4tap_planar",
                        lambda *a: calls.append(1) or real(*a))
    image, mask = _pair(6)
    _assert_same_distribution(
        _jax_stats(jaug.rotate_img_mask, image, mask),
        _port_stats(taug.rotate_img_mask, image, mask))
    assert len(calls) == N


def test_split_route_rotates_with_the_4tap_sampler(monkeypatch):
    """On the split route, `FAST_ROTATE = False` sends the batch's
    rotation through `rotate_4tap_planar`; the fused route keeps
    `full_pass`'s shears."""
    calls = []
    real = taug.rotate_4tap_planar
    monkeypatch.setattr(taug, "rotate_4tap_planar",
                        lambda *a: calls.append(a[0].shape[0]) or real(*a))
    monkeypatch.setattr(taug, "FAST_ROTATE", False)
    g = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (4, 16, 16, 3), generator=g).float()
    fg = (torch.rand(4, 16, 16, generator=g) > 0.5).float()
    masks = torch.stack([1 - fg, fg], -1)
    taug.augment_batch(g, images, masks, 0.0)
    assert calls == []
    monkeypatch.setattr(taug, "PALLAS_FUSED_SINGLE_LAUNCH", False)
    out_i, out_m = taug.augment_batch(g, images, masks, 0.0)
    assert calls == [4]
    np.testing.assert_allclose(out_m.sum(-1).numpy(), 1.0, atol=1e-3)


def test_apply_augmentations_matches_jax_in_distribution():
    image, mask = _pair(7)
    _assert_same_distribution(
        _jax_stats(jaug.apply_augmentations, image, mask,
                   prob_to_return_original=0.25),
        _port_stats(taug.apply_augmentations, image, mask,
                    prob_to_return_original=0.25))


def test_apply_augmentations_gate_and_custom_functions():
    """Rate 1 returns the pair; rate 0 changes it; a custom list (a
    partial of `translate`, a function of its own, the rotation) applies
    a random prefix of it, calling the custom functions as they are."""
    image, mask = (torch.from_numpy(a) for a in _pair(8))
    gen = torch.Generator().manual_seed(3)
    out_i, out_m = taug.apply_augmentations(gen, image, mask, 1.0)
    assert torch.equal(out_i, image) and torch.equal(out_m, mask)
    changed = sum(not torch.equal(taug.apply_augmentations(
        gen, image, mask, 0.0)[0], image) for _ in range(8))
    assert changed >= 7
    seen = []

    def invert(generator, im, mk):
        seen.append(im.shape)
        return 255.0 - im, mk

    funcs = (functools.partial(taug.translate, max_shift=3), invert,
             taug.rotate_img_mask, taug.fliplr)
    for _ in range(12):
        out_i, out_m = taug.apply_augmentations(gen, image, mask, 0.0,
                                                aug_funcs=funcs)
        assert out_i.shape == image.shape
        np.testing.assert_allclose(out_m.sum(-1).numpy(), 1.0, atol=1e-3)
    assert seen and all(s == image.shape for s in seen)
