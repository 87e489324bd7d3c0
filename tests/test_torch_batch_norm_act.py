"""The model's batch norm and swish as one `torch.autograd.Function`
(`ops/batch_norm_act.py`) on the CPU: the plain version's hand-derived
backward and running-stat update against autograd of the composition that
`layers.FusedBatchNorm` runs everywhere else, the layer's kernel route
wired through the Function (folded task axis included), which calls take
that route, and the kernels' launch plan. The kernels themselves run on the
card: chip_smoke.py's `bn_kernel` phase holds them against the
composition."""
import copy
import types

import pytest
import torch
import torch.nn.functional as F

from mliis_tpu_torch.models import layers
from mliis_tpu_torch.ops import batch_norm_act as bn_act
from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.parallel import spatial

SWISHES = [None, "after", "before"]
C = 6
T = 3
EPS = 1e-3


def _map(dtype, channels_last, seed, shape=(4, C, 5, 7)):
    """A map whose channels sit off zero (mean 0.7, sd 1.5), as a conv's
    output does, so that E[x^2] - E[x]^2 cancels a little."""
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn(shape, generator=g, dtype=torch.float64)
         + 0.7).to(dtype)
    return x.to(memory_format=torch.channels_last) if channels_last else x


def _params(c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    scale = 1.0 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    bias = 0.2 * torch.randn(c, generator=g, dtype=torch.float64)
    mean = 0.1 * torch.randn(c, generator=g, dtype=torch.float64)
    var = 1.0 + 0.5 * torch.rand(c, generator=g, dtype=torch.float64)
    return [t.to(dtype) for t in (scale, bias, mean, var)]


def _composition(x, scale, bias, swish):
    """FusedBatchNorm's batch-moment composition and the swish beside it,
    in x's own dtype (the layer takes the moments in float32). Returns (y,
    batch mean, batch variance)."""
    u = F.silu(x) if swish == "before" else x
    mean = u.mean((0, 2, 3))
    var = u.square().mean((0, 2, 3)) - mean.square()
    inv = torch.rsqrt(var + EPS) * scale
    y = u * inv[:, None, None] + (bias - mean * inv)[:, None, None]
    return (F.silu(y) if swish == "after" else y), mean, var


def _gap(a, b):
    """max |a - b| over max |b|."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / float(b.abs().max())


def _layer(c, seed, **kwargs):
    bn = layers.FusedBatchNorm(c, **kwargs)
    with torch.no_grad():
        for p, v in zip((bn.scale, bn.bias, bn.mean, bn.var),
                        _params(c, torch.float32, seed)):
            p.copy_(v)
    return bn


# The float32 tolerances, as shares of the reference's largest value. y and
# the running stats: the plain forward is the composition's own sequence of
# ops (0 over 20 seeds); the bound leaves room for another order of the
# moments' sums. The gradients: autograd adds the mean's and the variance's
# paths as separate full-size terms that nearly cancel, where the
# hand-derived backward adds them as one centred term, so each rounds the
# cancelling terms differently: at most 5.4e-7 over 20 seeds, both layouts
# and every swish.
TOL32 = {"y": 1e-6, "dx": 4e-6, "d_scale": 4e-6, "d_bias": 4e-6,
         "running": 1e-6}


@pytest.mark.parametrize("swish", SWISHES, ids=str)
@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_plain_version_matches_autograd_of_the_composition(dtype,
                                                           channels_last,
                                                           swish):
    """y, dx, d_scale, d_bias and the updated running stats of the plain
    forward, hand-derived backward and update against autograd of the
    composition: in float64 to round-off (1e-12 of the largest value); in
    float32 against the layer's own composition (moments in float32),
    within TOL32."""
    x = _map(dtype, channels_last, 1)
    g = _map(dtype, channels_last, 2) - 0.7
    scale, bias, mean0, var0 = _params(C, dtype, 3)
    if dtype == torch.float64:
        xr, sr, br = (t.clone().requires_grad_(True) for t in (x, scale,
                                                                bias))
        y_ref, m, v = _composition(xr, sr, br, swish)
        dx_ref, ds_ref, db_ref = torch.autograd.grad(y_ref, (xr, sr, br), g)
        mean_ref = 0.99 * mean0 + 0.01 * m.detach()
        var_ref = 0.99 * var0 + 0.01 * v.detach()
        tol = dict.fromkeys(TOL32, 1e-12)
    else:
        bn = _layer(C, 3)
        xr = x.clone().requires_grad_(True)
        y_ref = bn(xr, True, swish=swish)
        dx_ref, ds_ref, db_ref = torch.autograd.grad(
            y_ref, (xr, bn.scale, bn.bias), g)
        mean_ref, var_ref = bn.mean, bn.var
        tol = TOL32
    y, stats = bn_act.batch_norm_act_forward_reference(x, scale, bias, EPS,
                                                       swish)
    dx, d_scale, d_bias = bn_act.batch_norm_act_backward_reference(
        x, g, stats, swish)
    mean, var = mean0.clone(), var0.clone()
    bn_act.update_running_stats_(mean, var, stats, 0.99)
    assert _gap(y, y_ref) <= tol["y"]
    assert _gap(dx, dx_ref) <= tol["dx"]
    assert _gap(d_scale, ds_ref) <= tol["d_scale"]
    assert _gap(d_bias, db_ref) <= tol["d_bias"]
    assert _gap(mean, mean_ref) <= tol["running"]
    assert _gap(var, var_ref) <= tol["running"]


@pytest.mark.parametrize("swish", SWISHES, ids=str)
def test_function_gradcheck_in_float64(swish):
    """The Function's CPU backward (the hand-derived one) is the gradient
    of its forward: `torch.autograd.gradcheck` in float64."""
    x = _map(torch.float64, True, 4, (3, 4, 3, 5)).requires_grad_(True)
    scale, bias, _, _ = _params(4, torch.float64, 5)
    assert torch.autograd.gradcheck(
        lambda a, s, b: bn_act.batch_norm_act(a, s, b, swish=swish),
        (x, scale.requires_grad_(True), bias.requires_grad_(True)))


def _kernel_route_on_cpu(monkeypatch):
    """The layer's kernel route taken by CPU maps too, so that the wiring
    (the flat params, the running stats' views, `train`) runs through the
    Function's plain version."""
    monkeypatch.setattr(
        layers.FusedBatchNorm, "_kernel_route",
        lambda self, x, train: train or self.always_batch_stats)


def _forward_and_grads(bn, x, g, train, swish):
    xr = x.clone().requires_grad_(True)
    y = bn(xr, train, swish=swish)
    return (y,) + torch.autograd.grad(y, (xr, bn.scale, bn.bias), g)


@pytest.mark.parametrize("swish", SWISHES, ids=str)
@pytest.mark.parametrize("train,always", [(True, False), (False, True),
                                          (True, True)],
                         ids=["train", "batch_stats_eval",
                              "batch_stats_train"])
def test_layer_kernel_route_matches_the_composition(train, always, swish,
                                                    monkeypatch):
    """FusedBatchNorm on its kernel route (the Function) against the same
    layer on the composition, channels-last float32: output, gradients and
    running stats within TOL32; with `always_batch_stats` and train=False
    the running stats stay as they were, bit for bit."""
    bn = _layer(C, 6, always_batch_stats=always)
    ref = copy.deepcopy(bn)
    before = (bn.mean.clone(), bn.var.clone())
    x = _map(torch.float32, True, 7)
    g = _map(torch.float32, True, 8) - 0.7
    expect = _forward_and_grads(ref, x, g, train, swish)
    _kernel_route_on_cpu(monkeypatch)
    kernel_library.launches["batch_norm_act"] = 0
    got = _forward_and_grads(bn, x, g, train, swish)
    for name, a, b in zip(("y", "dx", "d_scale", "d_bias"), got, expect):
        assert _gap(a, b) <= TOL32[name], name
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    if train:
        assert _gap(bn.mean, ref.mean) <= TOL32["running"]
        assert _gap(bn.var, ref.var) <= TOL32["running"]
    else:
        assert torch.equal(bn.mean, before[0])
        assert torch.equal(bn.var, before[1])
    assert kernel_library.launches["batch_norm_act"] == 0


@pytest.mark.parametrize("swish", SWISHES, ids=str)
def test_kernel_route_under_task_axis(swish, monkeypatch):
    """Under a task axis of T=3 (stacked [T, C] params and running stats,
    channels folded to T*C) the kernel route's output, stacked gradients
    and stacked running stats equal the composition's within TOL32."""
    bn = _layer(C, 9)
    x = _map(torch.float32, True, 10, (4, T * C, 5, 7))
    g = _map(torch.float32, True, 11, (4, T * C, 5, 7)) - 0.7
    results = []
    for route in ("composition", "kernel"):
        if route == "kernel":
            _kernel_route_on_cpu(monkeypatch)
        tree = {k: torch.stack([v.detach() * (1.0 + 0.1 * t)
                                for t in range(T)])
                for k, v in list(bn.named_parameters())
                + list(bn.named_buffers())}
        for k in ("scale", "bias"):
            tree[k].requires_grad_(True)
        xr = x.clone().requires_grad_(True)
        with layers.task_axis(T):
            y = torch.func.functional_call(bn, tree, (xr, True),
                                           {"swish": swish})
        grads = torch.autograd.grad(y, (xr, tree["scale"], tree["bias"]), g)
        results.append((y,) + grads + (tree["mean"], tree["var"]))
    names = ("y", "dx", "d_scale", "d_bias", "running", "running")
    for name, b, a in zip(names, *results):
        assert a.shape == b.shape
        assert _gap(a, b) <= TOL32[name], name


@pytest.mark.parametrize("swish", ["after", "before"])
def test_composition_keeps_todays_arithmetic(swish):
    """On the composition route the swish beside the norm is the
    `F.silu` the model applied around it before: bit for bit."""
    bn = _layer(C, 12)
    ref = copy.deepcopy(bn)
    x = _map(torch.float32, True, 13)
    y = bn(x, True, swish=swish)
    if swish == "after":
        expect = F.silu(ref(x, True))
    else:
        expect = ref(F.silu(x), True)
    assert torch.equal(y, expect)
    assert torch.equal(bn.mean, ref.mean) and torch.equal(bn.var, ref.var)


def _cuda_map(dtype=torch.float32):
    """What the route reads of a CUDA map, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


ROUTES = {
    # case: (layer kwargs, map, train, kernel route)
    "cuda_batch_moments": ({}, "cuda", True, True),
    "cuda_batch_stats_eval": ({"always_batch_stats": True}, "cuda", False,
                              True),
    "cpu": ({}, "cpu", True, False),
    "bfloat16_compute": ({"compute_dtype": torch.bfloat16}, "cuda", True,
                         False),
    "bfloat16_map": ({}, "cuda_bf16", True, False),
    "axis_name": ({"axis_name": "data"}, "cuda", True, False),
    "spatial_context": ({}, "cuda", True, False),
    "running_moments": ({}, "cuda", False, False),
    "traced": ({}, "cuda", True, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_choice(case, monkeypatch):
    """The kernel route is taken by a float32 CUDA map normalized by its
    batch's moments, with no mesh axis, no spatial context and no tracer,
    and by nothing else. The cases that take the composition run it on
    the CPU and launch nothing."""
    kwargs, where, train, kernel = ROUTES[case]
    bn = _layer(C, 14, **kwargs)
    if case == "spatial_context":
        monkeypatch.setattr(spatial, "current", lambda: object())
    if case == "traced":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    x = {"cuda": _cuda_map(), "cuda_bf16": _cuda_map(torch.bfloat16),
         "cpu": _map(torch.float32, True, 15)}[where]
    assert bn._kernel_route(x, train) is kernel
    if kernel or case in ("spatial_context", "axis_name"):
        return   # a composition that needs a bound mesh or context
    kernel_library.launches["batch_norm_act"] = 0
    x = _map(torch.float32, True, 15)
    if case.startswith("bfloat16"):
        x = x.to(torch.bfloat16)
    before = (bn.mean.clone(), bn.var.clone())
    y = bn(x, train, swish="after")
    assert kernel_library.launches["batch_norm_act"] == 0
    ref = _layer(C, 14, **kwargs)
    ref.mean.copy_(before[0])
    ref.var.copy_(before[1])
    assert torch.equal(y, F.silu(ref._composition(x, train)))


# b3's and b0's batch-norm inputs at the joint cells' batch (the largest,
# the deepest, an odd 75^2 plane, a folded task axis of 5 x 144 channels,
# one channel that is no multiple of 4).
PLAN_SHAPES = [(64, 144, 150, 150), (64, 816, 19, 19), (64, 192, 75, 75),
               (64, 96, 112, 112), (8, 5 * 144, 56, 56), (2, 6, 9, 9)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
def test_launch_plan_covers_the_map(shape, channels_last):
    """Every channel vector lies in one tile, a block holds at most
    THREADS threads, every row (plane) lies in one split, and the grid
    fits CUDA's limits: what csrc/batch_norm_act.cu's launch checks."""
    n, c, h, w = shape
    vec = 4 if (c if channels_last else h * w) % 4 == 0 else 1
    p = bn_act.launch_plan(shape, channels_last, vec, 132)
    assert 1 <= p.splits <= 65535
    if channels_last:
        assert p.tiles * p.tile_vecs * vec >= c
        assert (p.tiles - 1) * p.tile_vecs * vec < c
        assert 1 <= p.tile_vecs <= bn_act.MAX_TILE_VECS
        assert p.tile_vecs * p.groups <= bn_act.THREADS
        rows = n * h * w
        assert p.rows == rows and p.tickets == p.tiles
        assert p.splits * p.split_len >= rows
        assert (p.splits - 1) * p.split_len < rows
    else:
        assert p.tickets == c and p.splits <= n
        assert p.splits * p.split_len >= n
        assert (p.splits - 1) * p.split_len < n


def test_wrapper_refuses_what_it_does_not_take():
    x = _map(torch.float32, False, 16)
    scale, bias, mean, var = _params(C, torch.float32, 17)
    with pytest.raises(ValueError):
        bn_act.batch_norm_act(x, scale, bias, swish="sideways")
    with pytest.raises(ValueError):
        bn_act.batch_norm_act(x, scale[:-1], bias)
    with pytest.raises(ValueError):
        bn_act.batch_norm_act(x, scale, bias, running_mean=mean)
    with pytest.raises(ValueError):
        bn_act.batch_norm_act(x[0], scale, bias)
    with pytest.raises(ValueError):
        layers.FusedBatchNorm(C)(x, True, swish="sideways")
