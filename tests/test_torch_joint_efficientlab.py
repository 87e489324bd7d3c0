"""The port's joint trainer on EfficientLab-b0 (n_classes=4, rsd=(2,)) at
32^2 against the JAX package's `JointTrainer`, in float32 on the CPU
(slow: the JAX side compiles the full model).

Augmentation, the final dropout and drop-connect are off (drop-connect
monkeypatched in the JAX package, `drop_connect_rate = 0` in the port),
the batches are injected, and JAX starts from the port's weights. As in
tests/test_torch_efficientlab_train.py, updates are compared against the
norm of the whole update: at 32^2 the deepest batch norms see 2x2 maps,
which amplifies float32 rounding. For the same reason the steps take lr
5e-4 (bench.py's meta rate): at 5e-3 the third step's loss already
drifts by 4.7e-4 of itself between the two float32 CPU runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mliis_tpu.models.layers as jlayers
from mliis_tpu.joint import trainer as jtrainer
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu.utils.checkpoint import flatten_tree
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax
from tests.test_torch_efficientlab_train import _global_close, _nested

pytestmark = pytest.mark.slow

SIZE = 32


def test_joint_sgd_steps_and_val_step_match(monkeypatch):
    """K=3 SGD steps at batch 4 (lr 5e-4, l2, label smoothing 0.1): losses
    1e-4 rel, the update within 1e-2 of its norm, running stats 1e-3 abs;
    the val step's IoU and loss 1e-4 rel."""
    monkeypatch.setattr(jlayers, "drop_connect", lambda key, x, rate: x)
    store = make_synthetic_store(num_tasks=4, examples_per_task=4,
                                 image_size=SIZE, seed=3)
    ds = ttrainer.joint_dataset_from_task_store(store)
    jds = jtrainer.JointDataset(ds.images, ds.labels, ds.class_names)
    tmodel = EfficientLab(n_classes=ds.num_classes, rsd=(2,),
                          final_layer_dropout_rate=0.0)
    getattr(tmodel, tmodel.backbone_name).drop_connect_rate = 0.0
    tmodel.reset_parameters(torch.Generator().manual_seed(0))
    flat = params_to_jax(tmodel)
    jstate = jil.ModelState(_nested(flat, "params/"),
                            _nested(flat, "batch_stats/"), None)
    jstate = jstate._replace(opt=jil.init_opt_state(
        jstate.params, jil.OptimizerConfig("sgd")))
    kw = dict(batch_size=4, augment=False, l2=True, label_smoothing=0.1)
    jt = jtrainer.JointTrainer(
        JaxEfficientLab(n_classes=ds.num_classes, rsd=(2,),
                        final_layer_dropout_rate=0.0),
        jds, jds, jtrainer.JointTrainConfig(**kw), jil.OptimizerConfig("sgd"))
    tt = ttrainer.JointTrainer(tmodel, ds, ds,
                               ttrainer.JointTrainConfig(**kw),
                               til.OptimizerConfig("sgd"), device="cpu")
    idx = np.random.default_rng(0).integers(0, ds.num_examples, (3, 4))
    start = {k: v.detach().clone() for k, v in tmodel.named_parameters()}
    jout, jlosses = jt._train_launch(jstate, jnp.asarray(idx),
                                     jax.random.split(jax.random.PRNGKey(1),
                                                      3), jnp.float32(5e-4))
    opt = til.init_model_state(tmodel, til.OptimizerConfig("sgd")).opt
    tlosses = []
    for k in range(3):
        opt, loss = tt.train_step(opt, torch.from_numpy(idx[k]), None, 5e-4)
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    ref = params_from_jax(flatten_tree(jout.params, "params/"))
    _global_close({k: (v.detach() - start[k]).numpy()
                   for k, v in tmodel.named_parameters()},
                  {k: (ref[k] - start[k]).numpy() for k in ref}, 1e-2)
    ref_bn = params_from_jax(flatten_tree(jout.batch_stats, "batch_stats/"))
    for k, b in tmodel.named_buffers():
        np.testing.assert_allclose(b.numpy(), ref_bn[k].numpy(), atol=1e-3,
                                   rtol=0, err_msg=k)

    vidx = np.arange(4)
    jiou, jloss = jt._val_step(jout, jnp.asarray(vidx))
    tiou, tloss = tt.val_step(torch.from_numpy(vidx))
    np.testing.assert_allclose(float(tiou), float(jiou), rtol=1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
