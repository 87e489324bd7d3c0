"""The port's random init of the learning-evidence run's model
(EfficientLab-b0, rsd=(2, 4), final dropout 0.5, bf16 compute) against the
JAX package's, in distribution: the two draw from different generators
(Philox against threefry), so the values differ, but every tensor must
come from the same law.

- the same params and batch stats, in the same shapes (flax layout);
- every tensor the JAX init leaves constant (biases, norm scales, running
  means and variances) equal to JAX's exactly;
- every drawn tensor's mean and standard deviation within five standard
  errors of JAX's: for n draws of a law of deviation s, a sample's
  deviation has a standard error of about s / sqrt(2n), and the difference
  of two independent samples' deviations one of s / sqrt(n);
- the norm of all params within 1% of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta.inner_loop import OptimizerConfig as JaxOptimizerConfig
from mliis_tpu.meta.inner_loop import init_model_state
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils.checkpoint import params_to_jax


def _flat(tree, prefix):
    return {prefix + "/".join(p.key for p in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=[0, 1])
def inits(request):
    seed = request.param
    state = init_model_state(
        JaxEfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                        compute_dtype=jnp.bfloat16), seed, 32,
        JaxOptimizerConfig("sgd"), jit_init=True)
    ref = {**_flat(state.params, "params/"),
           **_flat(state.batch_stats, "batch_stats/")}
    model = EfficientLab(rsd=(2, 4), final_layer_dropout_rate=0.5,
                         compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    ours = {k: np.asarray(v, np.float64)
            for k, v in params_to_jax(model).items()}
    return ref, ours


def test_the_same_tensors_in_the_same_shapes(inits):
    ref, ours = inits
    assert sorted(ours) == sorted(ref)
    assert {k: v.shape for k, v in ours.items()} == {
        k: v.shape for k, v in ref.items()}


def test_the_constant_tensors_are_equal(inits):
    ref, ours = inits
    constant = [k for k, v in ref.items() if v.std() == 0]
    assert any("bias" in k for k in constant)
    assert any(k.startswith("batch_stats/") for k in constant)
    for k in constant:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_the_drawn_tensors_share_their_law(inits):
    ref, ours = inits
    drawn = [k for k, v in ref.items() if v.std() > 0]
    assert drawn == [k for k in ref if k.endswith("kernel")]
    far = []
    for k in drawn:
        n, s = ref[k].size, ref[k].std()
        if abs(ours[k].std() - s) > 5 * s / np.sqrt(n) or abs(
                ours[k].mean() - ref[k].mean()) > 5 * s * np.sqrt(2 / n):
            far.append((k, n, s, ours[k].std(), ref[k].mean(),
                        ours[k].mean()))
    assert not far, far
    norm = lambda d: np.sqrt(sum(float(np.square(v).sum())  # noqa: E731
                                 for k, v in d.items()
                                 if k.startswith("params/")))
    assert norm(ours) == pytest.approx(norm(ref), rel=0.01)
