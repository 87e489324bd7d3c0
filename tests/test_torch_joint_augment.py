"""The port's `fused_light_augment` against the JAX package's.

  - Exact cases: the Pallas kernel in TPU interpret mode, whose on-core PRNG
    yields all-zero bits, against `fused_light_augment_reference` with the
    all-zero bit source.
  - Single ops: bits injected into the plain version select one op and its
    parameters; the JAX package's own op (its random normals replaced by
    the port's draws where it has any) runs on the same input.
  - Distribution: against the jnp `_augment_joint` the JAX trainer vmaps
    over `fold_in` keys, with the bars of experiments/fused_equivalence.py.

On the CPU the wrapper takes its plain version; the CUDA kernel is held
against that plain version on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mliis_tpu.joint.trainer import _augment_joint
from mliis_tpu.ops import augment as jaug
from mliis_tpu.ops.pallas_augment import \
    fused_light_augment as jax_fused_light_augment
from mliis_tpu_torch.ops import augment_kernels as tk
from mliis_tpu_torch.ops import kernel_library

B, H, W = 2, 32, 32


def _batch(rng, b=B, h=H, w=W, classes=3):
    images = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    masks = rng.integers(0, classes, (b, h, w)).astype(np.float32)
    return np.arange(b, dtype=np.int32), images, masks


@pytest.mark.parametrize("prob_original", [1.0, 0.0, -1.0])
def test_zero_bits_match_pallas(rng, prob_original):
    """All-zero draws, exact (max abs 0). Gate u=0 <= prob: at 1.0 and 0.0
    the samples pass through; at -1.0 the ranks tie, so the op order is the
    index order, num is 1, and u=0 picks a vertical roll by +1 of image and
    label."""
    seeds, images, masks = _batch(rng)
    with pltpu.force_tpu_interpret_mode():
        ref_i, ref_m = jax_fused_light_augment(
            jnp.asarray(seeds), jnp.asarray(images), jnp.asarray(masks),
            prob_original=prob_original)
    out_i, out_m = tk.fused_light_augment_reference(
        torch.from_numpy(seeds), torch.from_numpy(images),
        torch.from_numpy(masks), prob_original=prob_original,
        bits=tk.zero_bits)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    if prob_original >= 0:
        np.testing.assert_array_equal(out_i.numpy(), images)
        np.testing.assert_array_equal(out_m.numpy(), masks)
    else:
        np.testing.assert_array_equal(out_i.numpy(), np.roll(images, 1, 1))
        np.testing.assert_array_equal(out_m.numpy(), np.roll(masks, 1, 1))


def _word(u: float) -> int:
    """The Philox word whose uniform is u (23 mantissa bits)."""
    return int(u * 2 ** 23) << 9


def _bits(op, vert=True, shift=5, roll=True, fill=(0.2, 0.5, 0.9)):
    """A bit source that applies `op` alone (prefix 1), with the translate
    parameters given; stream 0 is injected, the noise streams are Philox."""
    words = [0] * 19
    words[0] = _word(0.5)                       # gate shut at prob 0
    for i in range(4):                          # `op` ranks first
        words[1 + i] = 4 if i == op else 1 + i % 3
    words[5] = _word(0.0)                       # num = 1
    words[6] = _word(0.25 if vert else 0.75)
    words[7] = _word(0.25 if shift > 0 else 0.75)
    words[8] = _word((abs(shift) - 0.5) / 23)
    words[9] = _word(0.25 if roll else 0.75)
    words[10:13] = [_word(f) for f in fill]
    words[13:19] = [_word(u) for u in (0.3, 0.1, 0.6, 0.7, 0.2, 0.4)]

    def bits(key, counter, stream):
        if stream != 0:
            return tk.philox_words(key, counter, stream)
        w = torch.tensor(words, dtype=torch.int64)[counter[0]]
        w = w.expand(key.shape[0], -1)
        return w, w

    return bits


def _port(op, images, masks, **kw):
    bits = _bits(op, **kw)
    seeds = torch.arange(images.shape[0], dtype=torch.int32)
    p = tk.draw_light_params(seeds, bits=bits)
    assert p["num"].tolist() == [1] * len(seeds)
    assert p["ops"][:, 0].tolist() == [op] * len(seeds)
    out_i, out_m = tk.fused_light_augment_reference(
        seeds, torch.from_numpy(images), torch.from_numpy(masks), bits=bits)
    return out_i.numpy(), out_m.numpy(), p


def test_fliplr_matches_jax(rng):
    """Labels exact, images 1e-4 (both exact)."""
    _, images, masks = _batch(rng)
    out_i, out_m, _ = _port(tk.FLIPLR, images, masks)
    for b in range(B):
        ref_i, ref_m = jaug.fliplr(None, jnp.asarray(images[b]),
                                   jnp.asarray(masks[b][..., None]))
        np.testing.assert_allclose(out_i[b], np.asarray(ref_i), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(out_m[b], np.asarray(ref_m)[..., 0])


@pytest.mark.parametrize("vert", [True, False], ids=["vertical",
                                                     "horizontal"])
@pytest.mark.parametrize("shift", [7, -11])
@pytest.mark.parametrize("roll", [True, False], ids=["roll", "stripe"])
def test_translate_matches_jax(rng, vert, shift, roll):
    """Against the JAX package's `_shift_planar` (the label rides as a
    fourth plane with fill 0): labels exact, images 1e-4."""
    _, images, masks = _batch(rng)
    out_i, out_m, p = _port(tk.TRANSLATE, images, masks, vert=vert,
                            shift=shift, roll=roll)
    assert p["shift"].tolist() == [shift] * B
    fill = np.concatenate([p["fill"][0].numpy(), [0.0]]).astype(np.float32)
    for b in range(B):
        x = np.concatenate([images[b].transpose(2, 0, 1), masks[b][None]])
        ref = np.asarray(jaug._shift_planar(
            jnp.asarray(x), 0 if vert else 1, jnp.int32(shift),
            jnp.asarray(roll), jnp.asarray(fill)))
        np.testing.assert_allclose(out_i[b], ref[:3].transpose(1, 2, 0),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(out_m[b], ref[3])


def _fake_normals(values):
    """jax.random.normal replaced by the given arrays, in call order."""
    queue = list(values)

    def normal(key, shape=(), dtype=jnp.float32):
        value = jnp.asarray(queue.pop(0), dtype)
        assert value.shape == tuple(shape)
        return value

    return normal


def test_noise_matches_jax(rng, monkeypatch):
    """The JAX package's `additive_gaussian_noise` with its two normal
    draws set to the port's (the sd's normal and the N(0,1) plane): labels
    exact, images 1e-4 (clipped to 0..255)."""
    _, images, masks = _batch(rng)
    out_i, out_m, _ = _port(tk.NOISE, images, masks)
    u = tk.uniform_from_bits(torch.tensor([_word(0.3), _word(0.1)]))
    sd_normal = float(tk._box_muller(u[0], u[1]))
    key = torch.arange(B, dtype=torch.int64)[:, None]
    pix = torch.arange(H * W)[None]
    planes = torch.stack([tk._box_muller(*(tk.uniform_from_bits(w) for w in
                                           tk.philox_words(key, pix, 1 + c)))
                          for c in range(3)], 1).view(B, 3, H, W)
    for b in range(B):
        monkeypatch.setattr(jax.random, "normal", _fake_normals(
            [np.float32(sd_normal), planes[b].numpy()]))
        ref_i, ref_m = jaug.additive_gaussian_noise(
            jax.random.PRNGKey(b), jnp.asarray(images[b]),
            jnp.asarray(masks[b][..., None]))
        np.testing.assert_allclose(out_i[b], np.asarray(ref_i), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(out_m[b], np.asarray(ref_m)[..., 0])
    assert np.abs(out_i - images).max() > 1.0


def test_exposure_matches_jax(rng, monkeypatch):
    """The JAX package's `exposure` with its two scalar normals set to the
    port's: labels exact, images 1e-4."""
    _, images, masks = _batch(rng)
    out_i, out_m, p = _port(tk.EXPOSURE, images, masks)
    u = tk.uniform_from_bits(torch.tensor([_word(v) for v in (0.6, 0.7, 0.2,
                                                              0.4)]))
    normals = [np.float32(tk._box_muller(u[0], u[1])),
               np.float32(tk._box_muller(u[2], u[3]))]
    for b in range(B):
        monkeypatch.setattr(jax.random, "normal", _fake_normals(normals))
        ref_i, ref_m = jaug.exposure(jax.random.PRNGKey(b),
                                     jnp.asarray(images[b]),
                                     jnp.asarray(masks[b][..., None]))
        np.testing.assert_allclose(out_i[b], np.asarray(ref_i), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(out_m[b], np.asarray(ref_m)[..., 0])
    assert abs(float(p["exp_shift"][0])) > 1.0


def _stats(images, masks, ref_images):
    i, m = np.asarray(images), np.asarray(masks)
    changed = (np.abs(i - ref_images).max(axis=(1, 2, 3)) > 1e-3).mean()
    return i.mean(), i.std(), float(changed), float((m > 0).mean())


def test_distribution_matches_jnp_augment_joint():
    """384 samples (24 batches of 16) at 32^2, prob_original 0, through the
    port's `fused_light_augment` and the JAX `_augment_joint` vmapped over
    fold_in keys: mean within 3%, std within 5%, changed fraction within
    0.08, label foreground area within 0.03; the port's labels integral
    and within the input's class set."""
    rng = np.random.default_rng(0)
    b, hw, reps = 16, 32, 24
    images = rng.integers(0, 256, (b, hw, hw, 3)).astype(np.float32)
    labels = np.zeros((b, hw, hw), np.int32)
    labels[:, 8:24, 6:20] = rng.integers(1, 5, (b, 1, 1))

    @jax.jit
    def jfn(key):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
        return jax.vmap(lambda k, i, l: _augment_joint(k, i, l, 4))(
            keys, jnp.asarray(images), jnp.asarray(labels))

    gen = torch.Generator().manual_seed(0)
    ti, tm = torch.from_numpy(images), torch.from_numpy(labels).float()
    js, ps = [], []
    for r in range(reps):
        js.append(_stats(*jfn(jax.random.PRNGKey(1000 + r)), images))
        seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=gen,
                              dtype=torch.int32)
        out_i, out_m = tk.fused_light_augment(seeds, ti, tm)
        assert torch.equal(out_m, out_m.round())
        assert set(out_m.unique().tolist()) <= set(np.unique(labels).tolist())
        ps.append(_stats(out_i, out_m, images))
    ja, pa = np.asarray(js).mean(0), np.asarray(ps).mean(0)
    assert abs(ja[0] - pa[0]) / ja[0] < 0.03, (ja, pa)
    assert abs(ja[1] - pa[1]) / ja[1] < 0.05, (ja, pa)
    assert abs(ja[2] - pa[2]) < 0.08, (ja, pa)
    assert abs(ja[3] - pa[3]) < 0.03, (ja, pa)


def test_wrapper_checks_inputs():
    """Wrong dtype, shape, contiguity or device raises; a CPU call takes
    the plain version and counts no launch."""
    seeds = torch.arange(2, dtype=torch.int32)
    images = torch.zeros(2, 8, 8, 3)
    masks = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds.long(), images, masks)
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds, images.double(), masks)
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds, torch.zeros(2, 8, 8, 4), masks)
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds, images, torch.zeros(2, 8, 4))
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds, images.transpose(1, 2), masks)
    with pytest.raises(ValueError):
        tk.fused_light_augment(seeds, images, masks.to("meta"))
    before = kernel_library.launches["fused_light_augment"]
    out_i, out_m = tk.fused_light_augment(seeds, images, masks,
                                          prob_original=1.0)
    assert torch.equal(out_i, images) and torch.equal(out_m, masks)
    assert kernel_library.launches["fused_light_augment"] == before
