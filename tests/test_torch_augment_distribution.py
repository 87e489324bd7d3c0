"""The port's `augment_batch` against the JAX package's jnp `augment_batch`
in distribution: the two draw from different random streams, so they are
held to the moments and invariants of experiments/fused_equivalence.py
over 384 samples, on the fused route (`full_pass`) and on the split route
(`cheap_pass`, the plain-op rotation, `cheap_pass`), square and not. On
the CPU the port's kernels take their plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.ops.augment import augment_batch
from mliis_tpu_torch.ops import augment as taug


def _stats(images, masks, ref_images):
    i, m = np.asarray(images), np.asarray(masks)
    changed = (np.abs(i - ref_images).max(axis=(1, 2, 3)) > 1e-3).mean()
    return (i.mean(), i.std(), float(changed), float(m[..., 1].mean()),
            float(np.abs(m.sum(-1) - 1.0).max()))


@pytest.mark.parametrize("fused,h,w", [(True, 32, 32), (False, 32, 32),
                                      (False, 24, 40)],
                         ids=["fused-32x32", "split-32x32", "split-24x40"])
def test_distribution_matches_jnp_augment_batch(fused, h, w, monkeypatch):
    """384 samples (24 batches of 16) through the port's `augment_batch` on
    one route and the JAX `augment_batch`, with the bars of
    experiments/fused_equivalence.py: |changed_frac| < 0.08, mean and std
    within 3% and 5%, fg area within 0.03, one-hot error < 1e-3."""
    rng = np.random.default_rng(0)
    b, reps = 16, 24
    images = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    fg = (rng.random((b, h, w)) > 0.5).astype(np.float32)
    masks = np.stack([1.0 - fg, fg], axis=-1)

    jfn = jax.jit(lambda k: augment_batch(k, jnp.asarray(images),
                                          jnp.asarray(masks), 0.5))
    monkeypatch.setattr(taug, "PALLAS_FUSED_SINGLE_LAUNCH", fused)
    gen = torch.Generator().manual_seed(0)
    ti, tm = torch.from_numpy(images), torch.from_numpy(masks)
    js, ps = [], []
    for r in range(reps):
        js.append(_stats(*jfn(jax.random.PRNGKey(1000 + r)), images))
        ps.append(_stats(*taug.augment_batch(gen, ti, tm, 0.5),
                         images))
    js, ps = np.asarray(js), np.asarray(ps)
    ja, pa = js[:, :4].mean(0), ps[:, :4].mean(0)
    assert abs(ja[2] - pa[2]) < 0.08
    assert abs(ja[0] - pa[0]) / ja[0] < 0.03
    assert abs(ja[1] - pa[1]) / ja[1] < 0.05
    assert abs(ja[3] - pa[3]) < 0.03
    assert ps[:, 4].max() < 1e-3
