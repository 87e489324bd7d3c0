"""The port's spatial partitioning (`parallel/spatial.py`: the image H axis
split over gloo ranks, rows exchanged by hand) against the JAX package's
GSPMD version and its unsharded forward and step, and against the port's
own unsharded runs.

Worlds of 4, 3 and 2 are spawned once each, together
(tests/torch_mesh_worker.py, which imports no JAX), and run every case;
this process computes the references from the same numpy inputs. The geometry covers an H the
world does not divide (20 over 3), levels with fewer rows than ranks
(EfficientLab's reduction 4 at 32^2 over 4 ranks and at 20 x 16 over 3:
a rank holds no row) and halos wider than a neighbour's rows (ASPP's
dilation-6 conv on reduction 4's 14 rows over 4 ranks, at 224 x 32).

The skip decoder's batch norms normalize by batch moments in every mode,
E[x^2] - E[x]^2 in float32 of maps whose mean is large against their
spread: two unsharded forwards that differ only in the order of the batch
differ by 3.5e-6 in probability, so the skip-decoding cases hold those
outputs and running stats at 1e-5 (ROADMAP.md section C); everything else
of the port's sharded runs is held within 1e-6 of its unsharded runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.parallel.spatial import (make_spatial_forward,
                                        make_spatial_mesh, shard_spatial)
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests import torch_mesh_worker as worker
from tests.test_torch_decoders import build
from tests.test_torch_meta import _jax_flat
from tests.tiny_model import TinySeg

TINY_LR, LAB_LR = 0.01, 5e-4     # LAB_LR: run.sh's inner learning rate
RUN_SH_LOSS = dict(l2=True)      # bce_dice + l2
# Hard geometry: (H, W) per case. 224 x 32 gives reduction 4 fourteen rows
# (3, 4, 3, 4 over 4 ranks) at the cost of a 85^2 image.
TALL = (224, 32)


def _inputs(seed, n, h, w):
    """Images in [0, 255] and two-channel [bg, fg] masks, from numpy."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    fg = (rng.uniform(size=(n, h, w)) > 0.5).astype(np.float32)
    return images, np.stack([1.0 - fg, fg], -1)


@pytest.fixture(scope="module")
def tiny():
    """TinySeg's JAX state and the port's state dict of the same weights."""
    jmodel = TinySeg()
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), 16,
                                  jil.OptimizerConfig("sgd"))
    return jmodel, jstate, params_from_jax(_jax_flat(jstate))


def _lab(aspp=False, skip=False, seed=0):
    """EfficientLab-b0 rsd (2, 4) (the main path's model): the port's
    state dict and the JAX twin with its variables."""
    tmodel, jmodel, variables = build(aspp, skip, (2, 4), seed=seed)
    return {k: v.detach().clone() for k, v in
            tmodel.state_dict().items()}, jmodel, variables


def _case(name, model, state_dict, images, masks, step=None, **kw):
    return dict(name=name, kind="spatial_case", model=model,
                state_dict=state_dict, images=torch.from_numpy(images),
                masks=torch.from_numpy(masks), step=step, **kw)


def _step(loss, lr, drop=None, seed=3):
    return dict(loss=loss, lr=lr, drop=drop, seed=seed)


def _lab_kwargs(aspp=False, skip=False, dropout=0.2):
    return dict(rsd=(2, 4), spatial_pyramid_pooling=aspp,
                skip_decoding=skip, final_layer_dropout_rate=dropout)


@pytest.fixture(scope="module")
def setup(tiny):
    """Every case by world, with its JAX pieces."""
    lab, lab_j, lab_v = _lab()
    skip_sd = _lab(aspp=True, skip=True)[0]
    tiny_sd = tiny[2]
    tiny_in = _inputs(0, 4, 16, 16)
    uneven_in = _inputs(1, 2, 20, 16)
    cases = {4: [
        _case("tiny_l2_off", "tiny", tiny_sd, *tiny_in,
              _step(dict(l2=False), TINY_LR)),
        _case("tiny_l2_on", "tiny", tiny_sd, *tiny_in,
              _step(dict(l2=True), TINY_LR)),
        _case("tiny_dropout", "tiny", tiny_sd, *tiny_in,
              _step(dict(l2=True), TINY_LR, drop=0.5),
              kwargs=dict(final_layer_dropout_rate=0.5)),
        _case("lab_32", "lab", lab, *_inputs(2, 2, 32, 32),
              kwargs=_lab_kwargs()),
        _case("lab_tall_step", "lab", lab, *_inputs(3, 2, *TALL),
              _step(RUN_SH_LOSS, LAB_LR, drop=0.5),
              kwargs=_lab_kwargs(dropout=0.5), drop_connect_rate=0.2),
        _case("aspp_skip_tall_step", "lab", skip_sd, *_inputs(4, 2, *TALL),
              _step(RUN_SH_LOSS, LAB_LR, drop=0.5),
              kwargs=_lab_kwargs(True, True, 0.5), drop_connect_rate=0.2),
    ], 3: [
        _case("tiny_uneven", "tiny", tiny_sd, *uneven_in,
              _step(dict(l2=True, darc1=True, label_smoothing=0.1),
                    TINY_LR)),
        _case("lab_uneven", "lab", lab, *uneven_in, kwargs=_lab_kwargs()),
    ], 2: [
        dict(name="gradcheck", kind="fetch_rows_gradcheck",
             x=torch.from_numpy(np.random.default_rng(5).normal(
                 size=(1, 2, 5, 3))),
             # Over 2 ranks the map's rows are [0, 2) and [2, 5): rank 0's
             # window starts 2 rows above the map and reaches into rank
             # 1's; rank 1's reaches into rank 0's and 2 rows past the end.
             lo=[-2, 1], hi=[4, 7]),
        dict(name="guards", kind="spatial_guards", model="tiny",
             state_dict=tiny_sd),
    ]}
    return cases, (lab_j, lab_v)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    cases, _ = setup
    return worker.spawn_worlds({
        world: (str(tmp_path_factory.mktemp("spatial{}".format(world))),
                world_cases) for world, world_cases in cases.items()})


def _case_named(setup, name):
    return next(c for cs in setup[0].values() for c in cs
                if c["name"] == name)


def _unsharded(setup, name):
    return worker.spatial_run(_case_named(setup, name))


def _assert_close(ranks, ref, atol, rtol=0.0, keys=("probs",)):
    """Every rank's `keys` within atol + rtol of the reference."""
    for r, out in enumerate(ranks):
        for key in keys:
            got, want = out[key], ref[key]
            if isinstance(want, dict):
                assert set(got) == set(want)
                for k in want:
                    np.testing.assert_allclose(
                        got[k].numpy(), want[k].numpy(), atol=atol,
                        rtol=rtol, err_msg="rank {} {} {}".format(r, key, k))
            else:
                np.testing.assert_allclose(
                    np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                    err_msg="rank {} {}".format(r, key))


def _jax_step(jmodel, jstate, images, masks, loss, lr):
    """The JAX package's unsharded loss-and-grad SGD step
    (tests/test_parallel.py's spatial train step, unsharded)."""
    loss_and_grad = jil.make_loss_and_grad(jmodel, jil.LossConfig(**loss))
    (value, new_bn), grads = jax.jit(loss_and_grad)(
        jstate.params, jstate.batch_stats, jnp.asarray(images),
        jnp.asarray(masks), jax.random.PRNGKey(0), jnp.float32(0.0))
    new_params, _ = jil.apply_optimizer(jstate.params, grads, jstate.opt,
                                        jnp.float32(lr),
                                        jil.OptimizerConfig("sgd"))
    return float(value), params_from_jax(_jax_flat(jstate._replace(
        params=new_params, batch_stats=new_bn)))


def test_tiny_forward_matches_jax_spatial_forward(setup, runs, tiny):
    """TinySeg at 16^2 over 4 ranks: the port's gathered probabilities
    within 1e-5 of JAX's `make_spatial_forward` on 4 of the 8 virtual
    devices (and of its unsharded apply), the JAX test's tolerance."""
    jmodel, jstate, _ = tiny
    images = np.asarray(_case_named(setup, "tiny_l2_off")["images"])
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    mesh = make_spatial_mesh(4)
    jsharded = make_spatial_forward(jmodel, mesh)(
        variables, shard_spatial(jnp.asarray(images), mesh))
    _, junsharded = jmodel.apply(variables, jnp.asarray(images),
                                 train=False)
    for ref in (jsharded, junsharded):
        _assert_close(runs["tiny_l2_off"], {"probs": np.asarray(ref)},
                      atol=1e-5)


@pytest.mark.parametrize("name", ["lab_32", "lab_uneven"])
def test_efficientlab_forward_matches_jax(setup, runs, name):
    """EfficientLab-b0 rsd (2, 4) sharded over 4 ranks at 32^2 and over 3
    at 20 x 16 (reduction 4's 2 rows leave ranks with none): probabilities
    within 1e-5 of the JAX package's unsharded apply, and within 1e-6 of
    the port's unsharded forward."""
    lab_j, lab_v = setup[1]
    images = np.asarray(_case_named(setup, name)["images"])
    _, jprobs = jax.jit(lambda v, x: lab_j.apply(v, x, train=False))(
        lab_v, jnp.asarray(images))
    _assert_close(runs[name], {"probs": np.asarray(jprobs)}, atol=1e-5)
    _assert_close(runs[name], _unsharded(setup, name), atol=1e-6)


@pytest.mark.parametrize("name", ["tiny_l2_off", "tiny_l2_on",
                                  "tiny_uneven"])
def test_step_matches_jax_unsharded_step(setup, runs, tiny, name):
    """One loss-and-grad SGD step on H shards (bce_dice with l2 off and
    on over 4 ranks; with l2, darc1 and label smoothing over 3 ranks at 20
    x 16) against the JAX package's unsharded step: the loss within rtol
    1e-5, params and batch-norm stats within 2e-5 abs + 1e-4 rel."""
    jmodel, jstate, _ = tiny
    case = _case_named(setup, name)
    loss, ref = _jax_step(jmodel, jstate, np.asarray(case["images"]),
                          np.asarray(case["masks"]), case["step"]["loss"],
                          case["step"]["lr"])
    for out in runs[name]:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        port = dict(out["params"], **out["batch_stats"])
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_allclose(port[k].numpy(), ref[k].numpy(),
                                       atol=2e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["tiny_l2_off", "tiny_l2_on",
                                  "tiny_dropout", "tiny_uneven",
                                  "lab_tall_step"])
def test_sharded_step_equals_unsharded(setup, runs, name):
    """The port's sharded step against its own unsharded step from the same
    weights, inputs and generator seed: final-layer dropout (each rank its
    rows of the whole mask) and, on EfficientLab at 224 x 32 with run.sh's
    loss and learning rate, drop-connect 0.2; probabilities, params and
    batch-norm stats within 1e-6, the loss within 1e-6 rel."""
    ref = _unsharded(setup, name)
    _assert_close(runs[name], ref, atol=1e-6,
                  keys=("probs", "params", "batch_stats"))
    for out in runs[name]:
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-6)


def test_aspp_skip_decoding_step_equals_unsharded(setup, runs):
    """ASPP (its dilation-6 conv's 6-row halo reaches two ranks away) and
    skip decoding, dropout 0.5 and drop-connect 0.2, at 224 x 32 over 4
    ranks: params within 1e-6 and the loss within 1e-6 rel of the port's
    unsharded step; the running stats within 1e-6, but those of the skip
    decoder's batch-statistics norms and the eval probabilities, which
    follow them, within 1e-5 (the module docstring)."""
    name = "aspp_skip_tall_step"
    ref = _unsharded(setup, name)
    _assert_close(runs[name], ref, atol=1e-6, keys=("params",))
    _assert_close(runs[name], ref, atol=1e-5, keys=("probs",))
    skip_norms = ("sep_conv_", "decode_skip_batch_normalization")
    for out in runs[name]:
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-6)
        for k, want in ref["batch_stats"].items():
            atol = 1e-5 if k.startswith(skip_norms) else 1e-6
            np.testing.assert_allclose(out["batch_stats"][k].numpy(),
                                       want.numpy(), atol=atol, err_msg=k)


def test_fetch_rows_gradcheck(runs):
    """`fetch_rows` forward and backward (its transpose) in float64 on a
    world of 2, by `torch.autograd.gradcheck`: windows past both edges of
    the map and across the other rank's rows."""
    x = np.random.default_rng(5).normal(size=(1, 2, 5, 3))
    padded = np.pad(x, ((0, 0), (0, 0), (2, 2), (0, 0)))
    want = np.concatenate([padded[:, :, 0:6], padded[:, :, 3:9]], 2)
    for out in runs["gradcheck"]:
        assert out["ok"]
        np.testing.assert_array_equal(out["out"].numpy(), want)


def test_spatial_guards(runs):
    """An unbound spatial axis raises, as do shards that are not the
    ranks' rows, a mesh without the spatial axis and a loss told to sum
    over two axes."""
    for out in runs["guards"]:
        assert out["unbound_fetch"].startswith("NameError")
        assert out["wrong_rows"].startswith("ValueError")
        assert out["task_mesh"].startswith("ValueError")
        assert out["two_axes"].startswith("ValueError")
