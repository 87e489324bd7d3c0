"""EfficientLab-b0 rsd=(2, 4) in training against the JAX package, in
float32 on the CPU (slow: the JAX side compiles the full model).

Drop-connect is off on both sides (monkeypatched in the JAX package,
`drop_connect_rate = 0` in the port) and so is the final dropout.

Gradients and meta-step updates are compared against the norm of the
whole gradient (or update), not tensor by tensor: the biases of batch
norms that feed a linear layer and another batch norm have an exactly
zero gradient, whose float32 noise has no scale of its own. The meta-step
is also sensitive: a 1e-6 relative perturbation of the initial weights
moves the update by about 5e-4 of its norm at 64^2 (measured with the port
on the CPU), which sets its tolerance. At 32^2 the same perturbation moves
it by about 7e-3: the deepest batch norms then see 2x2 maps, and the
comparison would test float32 rounding rather than the port, so both
tests run at 64^2.

The JAX variables are made from the port's weights by `params_to_jax`,
whose arrays are copies: were they views of the module's buffers, the
port's in-place running-stat update could race JAX's asynchronous
dispatch of the same step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mliis_tpu.models.layers as jlayers
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.meta import learners as jlr
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.meta.episodes import onehot_mask
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax
from tests.test_torch_meta import _jax_draws

pytestmark = pytest.mark.slow

SIZE = 64


def _nested(flat, collection):
    out = {}
    for key, value in flat.items():
        if key.startswith(collection):
            node = out
            parts = key[len(collection):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(value)
    return out


@pytest.fixture(scope="module")
def models():
    tmodel = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.0)
    getattr(tmodel, tmodel.backbone_name).drop_connect_rate = 0.0
    tmodel.reset_parameters(torch.Generator().manual_seed(0))
    flat = params_to_jax(tmodel)
    jstate = jil.ModelState(_nested(flat, "params/"),
                            _nested(flat, "batch_stats/"),
                            None)
    jstate = jstate._replace(opt=jil.init_opt_state(
        jstate.params, jil.OptimizerConfig("sgd")))
    return JaxEfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.0), \
        jstate, tmodel


@pytest.fixture
def no_jax_drop_connect(monkeypatch):
    monkeypatch.setattr(jlayers, "drop_connect", lambda key, x, rate: x)


def _global_close(ours, ref, tol):
    """max_k |ours_k - ref_k| / |ref| <= tol over dicts of arrays."""
    norm = np.sqrt(sum(float(np.square(v).sum()) for v in ref.values()))
    worst = max(float(np.linalg.norm(ours[k] - ref[k])) for k in ref) / norm
    assert worst <= tol, worst


def test_train_mode_gradients_and_stats_match(models, no_jax_drop_connect):
    """One train-mode loss and gradient (4 x 64^2, bce_dice + l2): loss
    1e-5 rel, each gradient within 1e-3 of the whole gradient's norm, the
    new running stats within 1e-4 abs."""
    jmodel, jstate, tmodel = models
    store = make_synthetic_store(num_tasks=1, examples_per_task=4,
                                 image_size=SIZE, seed=1)
    images = store.images[0].astype(np.float32)
    masks = onehot_mask(torch.as_tensor(store.masks[0]))
    (jloss, jbn), jgrads = jax.jit(jil.make_loss_and_grad(
        jmodel, jil.LossConfig()))(jstate.params, jstate.batch_stats,
                                   jnp.asarray(images),
                                   jnp.asarray(masks.numpy()),
                                   jax.random.PRNGKey(0), None)
    til.load_state(tmodel, til.init_model_state(tmodel,
                                                til.OptimizerConfig()))
    names = [k for k, _ in tmodel.named_parameters()]
    start = til.snapshot(tmodel, None)
    tloss, tgrads = til.make_loss_and_grad(tmodel, til.LossConfig())(
        torch.from_numpy(images), masks, None, None)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    ref = {k: v.numpy() for k, v in params_from_jax(
        {"params/" + "/".join(str(getattr(e, "key", e)) for e in path): v
         for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    ).items()}
    _global_close({k: g.numpy() for k, g in zip(names, tgrads)}, ref, 1e-3)
    bn_ref = params_from_jax(
        {"batch_stats/" + "/".join(str(getattr(e, "key", e)) for e in path):
         v for path, v in jax.tree_util.tree_flatten_with_path(jbn)[0]})
    for k, b in tmodel.named_buffers():
        np.testing.assert_allclose(b.numpy(), bn_ref[k].numpy(), atol=1e-4,
                                   rtol=0, err_msg=k)
    til.load_state(tmodel, start._replace(opt=None))


def test_chained_meta_step_matches(models, no_jax_drop_connect):
    """One chained FOMAML* meta-step of EfficientLab-b0 (2 tasks x (2 + 1
    tail) steps at batch 4, 64^2, augment off, lr 5e-4, JAX draws
    injected): the outer update agrees within 5e-3 of its norm, and the
    running stats within 1e-4 abs."""
    jmodel, jstate, tmodel = models
    store = make_synthetic_store(num_tasks=3, examples_per_task=8,
                                 image_size=SIZE, seed=1)
    kw = dict(num_shots=6, inner_batch_size=4, inner_iters=3,
              meta_batch_size=2, foml=True, tail_shots=2, augment=False)
    jcfg = jlr.MetaTrainConfig(**kw)
    key = jax.random.PRNGKey(4)
    jstep = jax.jit(jlr.make_chained_train_step(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg, n_max=8))
    jout = jstep(jstate, jnp.asarray(store.images), jnp.asarray(store.masks),
                 jnp.asarray(store.counts), key, jnp.float32(0.5),
                 jnp.float32(5e-4))
    draws = _jax_draws(key, jnp.asarray(store.counts), jcfg, 8, 3)
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    tout = tlr.make_chained_train_step(
        tmodel, til.LossConfig(), til.OptimizerConfig("sgd"),
        tlr.MetaTrainConfig(**kw))(
        tstate, torch.from_numpy(store.images),
        torch.from_numpy(store.masks), draws, 0.5, 5e-4)

    def flat(tree, prefix):
        return {prefix + "/".join(str(getattr(e, "key", e)) for e in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ref = params_from_jax(flat(jout.params, "params/"))
    ref_bn = params_from_jax(flat(jout.batch_stats, "batch_stats/"))
    _global_close({k: (tout.params[k] - tstate.params[k]).numpy()
                   for k in ref},
                  {k: (ref[k] - tstate.params[k]).numpy() for k in ref},
                  5e-3)
    for k, v in ref_bn.items():
        np.testing.assert_allclose(tout.batch_stats[k].numpy(), v.numpy(),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert int(tout.opt.step) == int(jout.opt.step) == 3
