"""The loss terms the meta-training flags name, against the JAX package's
`ops/losses.segmentation_loss`: label smoothing, l1, darc1, the
all-channel IoU of `binary_iou_loss=False`, and per-example weights with
TF's mean over nonzero weights (zero-weight rows included, and a batch of
only zero weights). The same numpy inputs go through both; values agree
within 1e-6 (abs and rel) in float32, and the gradients of the whole loss
with respect to the logits and the params within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta.inner_loop import LossConfig as JLossConfig
from mliis_tpu.ops import losses as jlosses
from mliis_tpu_torch.meta.inner_loop import LossConfig as TLossConfig
from mliis_tpu_torch.ops import losses as tlosses

CASES = {
    "smoothing": dict(label_smoothing=0.1),
    "all_channel_iou": dict(binary_iou_loss=False),
    "l1": dict(l1=True, l2=False),
    "darc1": dict(darc1=True),
    "weights": dict(example_weights=[1.0, 0.0, 1.0, 0.5]),
    "zero_weights_no_dice": dict(example_weights=[0.0, 0.0, 0.0, 0.0],
                                 dice=False, darc1=True),
    "everything": dict(label_smoothing=0.2, binary_iou_loss=False, l1=True,
                       darc1=True, example_weights=[0.0, 1.0, 1.0, 0.0]),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 6, 5, 2)).astype(np.float32) * 2.0
    fg = (rng.random((4, 6, 5)) > 0.5).astype(np.float32)
    labels = np.stack([1.0 - fg, fg], -1).astype(np.float32)
    params = {
        "conv0": {"kernel": rng.normal(size=(3, 3, 3, 4)).astype(np.float32)},
        "batch_normalization": {
            "scale": rng.normal(size=(4,)).astype(np.float32)},
        "final_layer_weights": {
            "kernel": rng.normal(size=(1, 1, 4, 2)).astype(np.float32),
            "bias": rng.normal(size=(2,)).astype(np.float32)},
    }
    return logits, labels, params


def _flat(params):
    return {"{}.{}".format(m, k): v for m, leaves in params.items()
            for k, v in leaves.items()}


def _jax_loss(logits, labels, params, kw):
    kw = dict(kw)
    if "example_weights" in kw:
        kw["example_weights"] = jnp.asarray(kw["example_weights"])
    return jlosses.segmentation_loss(logits, jax.nn.softmax(logits, -1),
                                     labels, params, **kw)


def _torch_loss(logits, labels, params, kw):
    kw = dict(kw)
    if "example_weights" in kw:
        kw["example_weights"] = torch.tensor(kw["example_weights"])
    return tlosses.segmentation_loss(logits, torch.softmax(logits, -1),
                                     labels, params, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_terms_match_jax(name):
    """The loss value within 1e-6 and its gradients (logits and params)
    within 1e-5, float32."""
    kw = CASES[name]
    logits, labels, params = _inputs(seed=len(name))
    jval, (jg_logits, jg_params) = jax.value_and_grad(
        lambda lg, p: _jax_loss(lg, jnp.asarray(labels), p, kw),
        argnums=(0, 1))(jnp.asarray(logits),
                        jax.tree_util.tree_map(jnp.asarray, params))
    t_logits = torch.tensor(logits, requires_grad=True)
    t_params = {k: torch.tensor(v, requires_grad=True)
                for k, v in _flat(params).items()}
    tval = _torch_loss(t_logits, torch.tensor(labels), t_params, kw)
    tval.backward()
    assert np.isfinite(float(jval))
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(jg_logits),
                               rtol=1e-5, atol=1e-5)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jg_params)).items():
        grad = t_params[k].grad   # None: a batch-norm param, no l1/l2 term
        grad = np.zeros_like(v) if grad is None else grad.numpy()
        np.testing.assert_allclose(grad, v, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_weighted_cross_entropy_matches_jax(smoothing):
    """The CE alone over [M, C] with weights that are zero for most rows:
    the mean over the nonzero-weight rows, within 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(50, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 50)]
    weights = (rng.random(50) > 0.8).astype(np.float32) * 2.0
    j = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), smoothing,
                                      weights=jnp.asarray(weights))
    t = tlosses.softmax_cross_entropy(torch.tensor(logits),
                                      torch.tensor(labels), smoothing,
                                      weights=torch.tensor(weights))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=1e-6)


def test_loss_config_fields_match_jax():
    """The port's LossConfig has the JAX package's fields and defaults."""
    assert dataclasses.asdict(TLossConfig()) == dataclasses.asdict(
        JLossConfig())
