"""EfficientLab-b0 with ASPP and skip decoding in training against the JAX
package, in float32 on the CPU at 64^2: one train-mode loss (bce_dice +
l2), its gradients and the running stats it leaves.

ASPP's four dropouts and the final layer's draw from each framework's own
generator, so the test injects the same masks on both sides: each side's
`traced_dropout` is monkeypatched (in this test only) to take its keep
masks, in call order, from a numpy stream of one seed, drawn in NHWC and
transposed for the port. Drop-connect is off on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mliis_tpu.models.layers as jlayers
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta.episodes import onehot_mask
from mliis_tpu_torch.models import layers as tlayers
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests.test_torch_decoders import SIZE, build

CASES = [(True, False, (2,)), (False, True, (2, 4)), (True, True, (2,)),
         (True, True, (2, 4))]
IDS = ["aspp{}-skip{}-rsd{}".format(int(a), int(s), "".join(map(str, r)))
       for a, s, r in CASES]


def _flat(tree, prefix):
    return {prefix + "/".join(str(getattr(e, "key", e)) for e in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def injected_masks(monkeypatch):
    """Both sides' dropout masks from one numpy stream; returns the
    (jax, port) lists of the NHWC shapes drawn, in call order."""
    shapes = ([], [])
    streams = [np.random.default_rng(7), np.random.default_rng(7)]

    def jax_dropout(key, x, rate, deterministic):
        if deterministic:
            return x
        shapes[0].append(tuple(x.shape))
        keep = streams[0].random(x.shape) < 1.0 - rate
        return jnp.where(keep, x / (1.0 - rate), 0.0)

    def port_dropout(generator, x, rate):
        nhwc = (x.shape[0],) + tuple(x.shape[2:]) + (x.shape[1],)
        shapes[1].append(nhwc)
        keep = torch.from_numpy(np.ascontiguousarray(
            (streams[1].random(nhwc) < 1.0 - rate).transpose(0, 3, 1, 2)))
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    monkeypatch.setattr(jlayers, "drop_connect", lambda key, x, rate: x)
    monkeypatch.setattr(jlayers, "traced_dropout", jax_dropout)
    monkeypatch.setattr(tlayers, "traced_dropout", port_dropout)
    return shapes


@pytest.mark.parametrize("aspp,skip,rsd", CASES, ids=IDS)
def test_train_loss_gradients_and_stats_match(aspp, skip, rsd,
                                              injected_masks):
    """4 x 64^2, final dropout 0.5 and ASPP's 0.5 with injected masks:
    loss within 1e-5 rel, each parameter's gradient within 1e-4 of the
    whole gradient's norm, the running stats after the step (the skip
    decoder's batch-statistics norms included) within 1e-6 abs + 5e-5
    rel. The activations feeding the skip decoder are not normalized (the
    ASPP's reach about 50 here) and agree between the frameworks to about
    2e-5 relative in float32; a batch variance of 80 carries that into a
    running variance of 1.8 as 1.9e-5 abs, which no 1e-6 bound holds."""
    tmodel, jmodel, variables = build(aspp, skip, rsd,
                                      final_layer_dropout_rate=0.5)
    store = make_synthetic_store(num_tasks=1, examples_per_task=4,
                                 image_size=SIZE, seed=1)
    images = store.images[0].astype(np.float32)
    masks = onehot_mask(torch.as_tensor(store.masks[0]))
    (jloss, jbn), jgrads = jax.jit(jil.make_loss_and_grad(
        jmodel, jil.LossConfig()))(variables["params"],
                                   variables["batch_stats"],
                                   jnp.asarray(images),
                                   jnp.asarray(masks.numpy()),
                                   jax.random.PRNGKey(0), None)
    names = [k for k, _ in tmodel.named_parameters()]
    tloss, tgrads = til.make_loss_and_grad(tmodel, til.LossConfig())(
        torch.from_numpy(images), masks, None, None)
    assert injected_masks[0] == injected_masks[1]
    assert len(injected_masks[0]) == 1 + 4 * aspp
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = {k: v.numpy() for k, v in params_from_jax(
        _flat(jgrads, "params/")).items()}
    assert sorted(ref) == sorted(names)
    norm = np.sqrt(sum(float(np.square(v).sum()) for v in ref.values()))
    worst = max(float(np.linalg.norm(g.numpy() - ref[k]))
                for k, g in zip(names, tgrads)) / norm
    assert worst <= 1e-4, worst
    bn_ref = params_from_jax(_flat(jbn, "batch_stats/"))
    for k, b in tmodel.named_buffers():
        np.testing.assert_allclose(b.numpy(), bn_ref[k].numpy(), atol=1e-6,
                                   rtol=5e-5, err_msg=k)
