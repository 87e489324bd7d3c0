"""EfficientLab-b0's ASPP and skip decoding against the JAX package, on the
CPU at 64^2, for ASPP x skip decoding in {(on, off), (off, on), (on, on)}
and rsd (2,) and (2, 4).

Weights are the port's `reset_parameters` draws, carried to JAX by
`params_to_jax`. Drop-connect is off on both sides (monkeypatched in the
JAX package, `drop_connect_rate = 0` in the port).

The skip decoder's batch norms use batch statistics in every mode; the
JAX package's also write their running stats at train=False, so its eval
apply raises unless `batch_stats` is mutable. The eval forward is held
against JAX's `apply(train=False, mutable=["batch_stats"])`, which
computes the reference's semantics and discards the update; the port's
eval forward leaves its buffers bit for bit as they were.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import mliis_tpu.models.layers as jlayers
from mliis_tpu.models.efficientlab import EfficientLab as JaxEfficientLab
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils.checkpoint import params_to_jax

SIZE = 64
COMBOS = [(True, False), (False, True), (True, True)]
CASES = [(aspp, skip, rsd) for aspp, skip in COMBOS
         for rsd in ((2,), (2, 4))]
IDS = ["aspp{}-skip{}-rsd{}".format(int(a), int(s), "".join(map(str, r)))
       for a, s, r in CASES]


def nested(flat, collection):
    out = {}
    for key, value in flat.items():
        if key.startswith(collection):
            node = out
            parts = key[len(collection):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(value)
    return out


def build(aspp, skip, rsd, compute_dtype=None, seed=0, **kw):
    """The port's model (drop-connect off) and the JAX twin's variables."""
    kwargs = dict(rsd=rsd, spatial_pyramid_pooling=aspp, skip_decoding=skip,
                  **kw)
    tmodel = EfficientLab(compute_dtype=compute_dtype, **kwargs)
    getattr(tmodel, tmodel.backbone_name).drop_connect_rate = 0.0
    tmodel.reset_parameters(torch.Generator().manual_seed(seed))
    flat = params_to_jax(tmodel)
    variables = {"params": nested(flat, "params/"),
                 "batch_stats": nested(flat, "batch_stats/")}
    jdtype = None if compute_dtype is None else jnp.bfloat16
    return tmodel, JaxEfficientLab(compute_dtype=jdtype, **kwargs), variables


def images(seed=0, n=2):
    return np.random.default_rng(seed).uniform(
        0, 255, (n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture
def no_jax_drop_connect(monkeypatch):
    monkeypatch.setattr(jlayers, "drop_connect", lambda key, x, rate: x)


@pytest.mark.parametrize("aspp,skip,rsd", CASES, ids=IDS)
def test_eval_forward_matches_jax(aspp, skip, rsd):
    """float32 eval forward: logits within 1e-4 abs of JAX's mutable
    apply, probabilities within 1e-4 (a softmax moves no more than its
    logits); the buffers do not move."""
    tmodel, jmodel, variables = build(aspp, skip, rsd)
    x = images()
    (jlog, jprob), _ = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    before = {k: b.clone() for k, b in tmodel.named_buffers()}
    with torch.no_grad():
        tlog, tprob = tmodel(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tprob.numpy(), np.asarray(jprob), atol=1e-4,
                               rtol=0)
    for k, b in tmodel.named_buffers():
        assert torch.equal(b, before[k]), k


@pytest.mark.parametrize("aspp,skip", COMBOS,
                         ids=["aspp1-skip0", "aspp0-skip1", "aspp1-skip1"])
def test_bf16_eval_forward_matches_jax(aspp, skip):
    """compute_dtype bf16, rsd (2, 4). Every decoder module's output dtype
    is flax's (captured intermediates): the ASPP, `decode_skip_proj` and
    `_SepConv` convs have no dtype and run in the promoted float32, the RSD
    in bf16. The logits: bf16 rounds at every layer, and with skip
    decoding the logits are 30-50x larger than the rsd model's (about 30
    against 0.7 here), so the batch-norm bf16 test's per-element 2^-8 rel
    + 1e-2 abs does not carry over to a whole network. The port's logits
    must lie no farther from JAX's bf16 logits than twice as far as JAX's
    own bf16 logits lie from its float32 ones, in max and in mean abs."""
    tmodel, jmodel, variables = build(aspp, skip, (2, 4),
                                      compute_dtype=torch.bfloat16)
    x = jnp.asarray(images(1))
    (jlog, _), state = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(variables, x)
    (jlog32, _), _ = jax.jit(lambda v, x: jmodel.clone(
        compute_dtype=None).apply(v, x, train=False,
                                  mutable=["batch_stats"]))(variables, x)
    jdtypes = {k[:-len("/__call__")].replace("/", "."): str(v[0].dtype)
               for k, v in flatten_dict(state["intermediates"],
                                        sep="/").items()
               if not k.startswith(("efficientnet", "__call__"))}
    seen = {}
    for name, module in tmodel.named_modules():
        if name in jdtypes:
            module.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(
                    name, str(o.dtype).replace("torch.", "")))
    with torch.no_grad():
        tlog, _ = tmodel(torch.from_numpy(np.array(x)), train=False)
    assert tlog.dtype == torch.float32
    assert seen == jdtypes
    err = np.abs(tlog.numpy() - np.asarray(jlog))
    own = np.abs(np.asarray(jlog32) - np.asarray(jlog))
    assert err.max() <= 2 * own.max(), (err.max(), own.max())
    assert err.mean() <= 2 * own.mean(), (err.mean(), own.mean())


def test_batch_stats_norm_updates_only_in_training():
    """`always_batch_stats`: both modes normalize by the batch's moments;
    only train=True moves the running stats."""
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    bn = FusedBatchNorm(3, always_batch_stats=True)
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0)
                    ) * 3 + 2
    out_eval = bn(x, train=False)
    assert torch.equal(bn.mean, torch.zeros(3))
    assert torch.equal(bn.var, torch.ones(3))
    out_train = bn(x, train=True)
    torch.testing.assert_close(out_eval, out_train, rtol=0, atol=0)
    torch.testing.assert_close(bn.mean, 0.01 * x.mean((0, 2, 3)))
    assert abs(float(out_eval.detach().mean())) < 1e-5
