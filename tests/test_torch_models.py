"""The port's model layers and EfficientLab-b0 against the JAX package's.

The EfficientLab check loads the committed checkpoint
experiments/curve_v2_r4/model.ckpt-3000.npz (EfficientLab rsd=(2, 4),
2.07 M params) into both frameworks rather than calling flax `init`, and
compares the eval forward at 32^2 in float32."""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.models import efficientnet as jeff
from mliis_tpu.models import layers as jlayers
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu_torch.models import efficientnet as teff
from mliis_tpu_torch.models import layers as tlayers
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils.checkpoint import load_jax_npz, params_to_jax

CKPT = "experiments/curve_v2_r4/model.ckpt-3000.npz"


def _nested(flat, collection):
    out = {}
    for key, value in flat.items():
        if not key.startswith(collection):
            continue
        node = out
        parts = key[len(collection):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_fused_batch_norm_train_output_and_stats(rng):
    """Train mode: output, and running mean/var after one update (flax
    momentum 0.99, biased variance), against the flax FusedBatchNorm in
    float32: 1e-5 abs."""
    x = (rng.normal(size=(4, 6, 6, 5)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(5,)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    mean0 = rng.normal(size=(5,)).astype(np.float32)
    var0 = rng.random(5).astype(np.float32) + 0.5
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    ref, mutated = jlayers.FusedBatchNorm().apply(
        variables, jnp.asarray(x), use_running_average=False,
        mutable=["batch_stats"])
    bn = tlayers.FusedBatchNorm(5)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    out = bn(_nchw(x), train=True).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(
        mutated["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(
        mutated["batch_stats"]["var"]), atol=1e-6, rtol=0)
    # eval mode uses the running stats
    ref_eval = jlayers.FusedBatchNorm().apply(
        mutated | {"params": variables["params"]}, jnp.asarray(x),
        use_running_average=True)
    out_eval = bn(_nchw(x), train=False).detach().numpy().transpose(
        0, 2, 3, 1)
    np.testing.assert_allclose(out_eval, np.asarray(ref_eval), atol=1e-5,
                               rtol=0)


def test_fused_batch_norm_bf16(rng):
    """bf16 compute dtype: moments in float32 from bf16 activations, one
    folded multiply-add in bf16. Agreement within one bf16 ulp (2^-8 rel)
    plus 1e-2 abs near zero."""
    x = (rng.normal(size=(4, 6, 6, 5)) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = {"params": {"scale": jnp.ones(5), "bias": jnp.zeros(5)},
                 "batch_stats": {"mean": jnp.zeros(5), "var": jnp.ones(5)}}
    ref, _ = jlayers.FusedBatchNorm(dtype=jnp.bfloat16).apply(
        variables, xb, use_running_average=False, mutable=["batch_stats"])
    bn = tlayers.FusedBatchNorm(5, compute_dtype=torch.bfloat16)
    out = bn(_nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
             train=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().detach().numpy().transpose(0, 2, 3, 1),
        np.asarray(ref.astype(jnp.float32)), rtol=2 ** -8, atol=1e-2)


@pytest.mark.parametrize("size,k,stride,groups,pad", [
    (32, 3, 2, 1, (0, 1)),      # the stem at an even input
    (224, 3, 2, 1, (0, 1)),
    (16, 5, 2, 6, (1, 2)),      # a strided 5x5 depthwise conv
    (112, 5, 2, 6, (1, 2)),
    (15, 3, 2, 1, (1, 1)),
    (16, 3, 1, 6, (1, 1)),
])
def test_same_padding_matches_flax(rng, size, k, stride, groups, pad):
    """flax 'SAME' pads the smaller half first; the port's Conv2d output
    equals flax nn.Conv's at 1e-4 abs (float32 conv order)."""
    assert tlayers.same_padding(size, k, stride) == pad
    if size > 64:
        return
    cin = cout = 6 if groups > 1 else 3
    x = rng.normal(size=(1, size, size, cin)).astype(np.float32)
    kernel = rng.normal(size=(k, k, cin // groups, cout)).astype(np.float32)
    ref = fnn.Conv(cout, (k, k), strides=(stride, stride),
                   feature_group_count=groups, use_bias=False).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    conv = tlayers.Conv2d(cin, cout, k, stride=stride, groups=groups,
                          use_bias=False)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    out = conv(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["efficientnet-b0", "efficientnet-b3"])
def test_block_tables_match(name):
    """The b0 and b3 block tables after truncation (EfficientLab's 10 and
    17) and the drop-connect divisor."""
    for max_block in (10 if name.endswith("b0") else 17, None):
        ours, div = teff.expand_block_list(name, max_block)
        ref, rdiv = jeff.expand_block_list(name, max_block)
        assert div == rdiv
        assert [tuple(vars(b).values()) for b in ours] == \
            [tuple(vars(b).values()) for b in ref]


def test_b3_endpoint_channels():
    feats = teff.EfficientNetFeatures("efficientnet-b3", 17)
    assert feats.endpoint_channels() == {"reduction_1": 24,
                                         "reduction_2": 32,
                                         "reduction_3": 48,
                                         "reduction_4": 136}


def test_efficientlab_eval_forward_from_checkpoint(rng):
    """EfficientLab-b0 rsd=(2, 4) from the committed npz, eval forward at
    32^2 in float32: logits within 2e-3 abs (values of order 10; float32
    conv order through ~60 layers), probabilities within 1e-4."""
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5)
    model.load_state_dict(load_jax_npz(CKPT), strict=True)
    flat = params_to_jax(model)
    with np.load(CKPT) as z:
        for k in flat:
            np.testing.assert_array_equal(flat[k], z[k])
    images = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.float32)
    variables = {"params": _nested(flat, "params/"),
                 "batch_stats": _nested(flat, "batch_stats/")}
    jlog, jprob = JaxEfficientLab(rsd=(2, 4)).apply(
        variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        tlog, tprob = model(torch.from_numpy(images), train=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-3,
                               rtol=0)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-4,
                               rtol=0)


def test_params_to_jax_returns_copies():
    """The exported arrays do not follow the module: a train-mode forward
    updates the running stats in place and leaves an earlier export as it
    was (views would let JAX read a half-updated buffer)."""
    bn = tlayers.FusedBatchNorm(3)
    flat = params_to_jax(bn)
    bn(torch.full((2, 3, 4, 4), 5.0), train=True)
    assert float(bn.mean[0]) > 0
    np.testing.assert_array_equal(flat["batch_stats/mean"], np.zeros(3))
    np.testing.assert_array_equal(flat["batch_stats/var"], np.ones(3))
