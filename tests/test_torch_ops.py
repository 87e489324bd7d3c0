"""The port's ops against the JAX package's: resize, soft IoU, the
segmentation loss (dice, l2 and its batch-norm exclusion), the tree math
and the synthetic store. Inputs come from numpy seeds; all in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.data.synthetic import make_synthetic_store as jax_store
from mliis_tpu.ops import losses as jlosses
from mliis_tpu.ops import meta_math as jmm
from mliis_tpu.ops.metrics import soft_iou_flat_per_example as jax_iou
from mliis_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from mliis_tpu_torch.data.synthetic import (EXTENDED_SHAPES,
                                            make_synthetic_store)
from mliis_tpu_torch.ops import losses as tlosses
from mliis_tpu_torch.ops import meta_math as tmm
from mliis_tpu_torch.ops.metrics import soft_iou_flat_per_example
from mliis_tpu_torch.ops.resize import resize_bilinear_align_corners


@pytest.mark.parametrize("in_hw,out_hw", [((7, 5), (13, 9)), ((14, 14),
                                                              (56, 56)),
                                          ((9, 12), (4, 5)), ((6, 6), (6, 6)),
                                          ((5, 4), (1, 1))])
def test_resize_matches_tf1_align_corners(rng, in_hw, out_hw):
    """F.interpolate(align_corners=True) against the JAX package's matmul
    form of TF1's align_corners resize: 1e-5 abs on values of order 1."""
    x = rng.normal(size=(2,) + in_hw + (3,)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), *out_hw))
    out = resize_bilinear_align_corners(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_soft_iou_matches(rng):
    t = rng.random((4, 50)).astype(np.float32)
    p = rng.random((4, 50)).astype(np.float32)
    np.testing.assert_allclose(
        soft_iou_flat_per_example(torch.from_numpy(t),
                                  torch.from_numpy(p)).numpy(),
        np.asarray(jax_iou(jnp.asarray(t), jnp.asarray(p))), rtol=1e-6)


def _params(rng):
    """Nested flax-style params and the port's dotted names, with batch-norm
    params under each of the three name tokens."""
    nested = {
        "conv": {"kernel": rng.normal(size=(3, 3, 2, 4)), "bias":
                 rng.normal(size=(4,))},
        "blocks_0": {"batch_normalization": {"scale": rng.normal(size=(4,)),
                                             "bias": rng.normal(size=(4,))},
                     "project_conv": {"kernel": rng.normal(size=(1, 1, 4, 2))}},
        "fuse": {"BatchNorm_0": {"scale": rng.normal(size=(2,))}},
        "head_bn": {"scale": rng.normal(size=(2,))},
    }
    flat = {}

    def walk(d, prefix):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = v.astype(np.float32)
    walk(nested, "")
    jparams = {k: {kk: (jnp.asarray(vv.astype(np.float32))
                        if not isinstance(vv, dict) else
                        {a: jnp.asarray(b.astype(np.float32))
                         for a, b in vv.items()})
                   for kk, vv in v.items()} for k, v in nested.items()}
    return jparams, {k: torch.from_numpy(v) for k, v in flat.items()}


@pytest.mark.parametrize("dice,l2", [(True, True), (False, True),
                                     (True, False)])
def test_segmentation_loss_matches(rng, dice, l2):
    """CE + dice + l2 against the JAX loss: 1e-5 rel."""
    logits = rng.normal(size=(3, 8, 8, 2)).astype(np.float32)
    fg = (rng.random((3, 8, 8)) > 0.4).astype(np.float32)
    labels = np.stack([1.0 - fg, fg], -1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jparams, tparams = _params(rng)
    ref = jlosses.segmentation_loss(jnp.asarray(logits), jnp.asarray(probs),
                                    jnp.asarray(labels), jparams, dice=dice,
                                    l2=l2)
    out = tlosses.segmentation_loss(
        torch.from_numpy(logits), torch.from_numpy(probs),
        torch.from_numpy(labels), tparams, dice=dice, l2=l2)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_l2_skips_batch_norm_by_name(rng):
    """Only conv/kernel, conv/bias and project_conv/kernel count; the
    batch-norm params under 'batch_normalization', 'BatchNorm' and 'bn'
    tokens do not."""
    jparams, tparams = _params(rng)
    counted = sorted(k for k in tparams if not tlosses.is_bn_name(k))
    assert counted == ["blocks_0.project_conv.kernel", "conv.bias",
                       "conv.kernel"]
    expected = 0.0005 * sum(float((tparams[k] ** 2).sum()) / 2
                            for k in counted)
    np.testing.assert_allclose(tlosses.l2_term(tparams).item(), expected,
                               rtol=1e-6)
    np.testing.assert_allclose(tlosses.l2_term(tparams).item(),
                               float(jlosses.l2_term(jparams)), rtol=1e-6)


def test_meta_math_matches(rng):
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(4,)).astype(np.float32)}
    b = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in a.items()}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    pairs = [
        (tmm.tree_interpolate(ta, tb, 0.3), jmm.tree_interpolate(ja, jb, 0.3)),
        (tmm.tree_average([ta, tb]), jmm.tree_average([ja, jb])),
        (tmm.tree_sub(ta, tb), jmm.tree_sub(ja, jb)),
        (tmm.tree_add(ta, tb), jmm.tree_add(ja, jb)),
        (tmm.tree_scale(ta, 0.7), jmm.tree_scale(ja, 0.7)),
        (tmm.tree_weight_decay(ta, 0.9), jmm.tree_weight_decay(ja, 0.9)),
    ]
    for out, ref in pairs:
        for k in a:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shapes", [None, EXTENDED_SHAPES,
                                    ("triangle", "ring", "diamond")],
                         ids=["default", "extended", "held_out"])
def test_synthetic_store_is_byte_identical(shapes):
    """The default families, all eight, and the held-out three of
    experiments/curve_v2_r4: the same seed gives the same bytes."""
    ours = make_synthetic_store(num_tasks=9, examples_per_task=4,
                                image_size=24, seed=3, shapes=shapes)
    ref = jax_store(num_tasks=9, examples_per_task=4, image_size=24, seed=3,
                    shapes=shapes)
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.masks, ref.masks)
    np.testing.assert_array_equal(ours.counts, ref.counts)
    assert ours.names == ref.names
