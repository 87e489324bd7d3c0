"""The model's depthwise conv as one `torch.autograd.Function`
(`ops/depthwise_conv.py`) on the CPU: the plain version against `F.conv2d`
on an `F.pad`ed input and against the JAX package's grouped `nn.Conv`,
forward and both gradients, at the joint cells' planes; a gradcheck; the
layer's kernel route wired through the Function, a task axis folded; which
convs take that route; the launch plan; and the kernels' tiles, halos and
units emulated in float64. The kernels themselves run on the card:
chip_smoke.py's `dw_kernel` phase holds them against float64 and the
library, and `test_kernels_on_the_card` skips here."""
import copy
import math
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mliis_tpu_torch.models import layers
from mliis_tpu_torch.ops import depthwise_conv as dw
from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.parallel import spatial

C = 6
T = 3

# (H, k, stride): the joint cells' depthwise planes (b3's 150 -> 75 -> 38
# -> 19 at both strides, b0's 112 and 14) and an odd plane at stride 2
# with k 5 (SAME (2, 2)).
PLANES = [(150, 3, 2), (150, 3, 1), (75, 5, 2), (75, 3, 1), (38, 3, 2),
          (38, 5, 1), (19, 5, 1), (19, 3, 1), (112, 3, 2), (14, 5, 1),
          (15, 5, 2)]


def _padding(h, w, k, stride):
    return (layers.same_padding(h, k, stride),
            layers.same_padding(w, k, stride))


def _inputs(n, c, h, w, k, stride, dtype, seed, channels_last=True):
    """x, weight and an output gradient; x sits off zero as a swish's
    output does."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
         + 0.3).to(dtype)
    weight = (torch.randn(c, 1, k, k, generator=g, dtype=torch.float64)
              / k).to(dtype)
    ho, wo = -(-h // stride), -(-w // stride)
    grad = torch.randn(n, c, ho, wo, generator=g, dtype=torch.float64
                       ).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
        grad = grad.contiguous(memory_format=torch.channels_last)
    return x, weight, grad


def _library(x, weight, grad, stride, padding):
    """(y, dx, dw) of `F.conv2d` over the `F.pad`ed input, under
    autograd: the route every other conv keeps."""
    (pt, pb), (pl, pr) = padding
    xr = x.detach().clone().requires_grad_(True)
    wr = weight.detach().clone().requires_grad_(True)
    y = F.conv2d(F.pad(xr, (pl, pr, pt, pb)), wr, stride=stride,
                 groups=x.shape[1])
    return (y.detach(),) + torch.autograd.grad(y, (xr, wr), grad)


def _plain(x, weight, grad, stride, padding):
    y = dw.depthwise_conv_reference(x, weight, stride, padding)
    return (y,) + dw.depthwise_conv_backward_reference(x, weight, grad,
                                                       stride, padding)


def _gap(a, b):
    """max |a - b| over max |b|."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / float(b.abs().max())


# float32: the plain version and the library sum the same products in
# other orders (up to 25 a forward value and dx value, N Ho Wo for dw).
TOL32 = {"y": 2e-6, "dx": 2e-6, "dw": 2e-5}


@pytest.mark.parametrize("h,k,stride", PLANES, ids=str)
def test_plain_version_matches_the_library(h, k, stride):
    """y, dx and dw of the plain version against `F.conv2d` on the
    `F.pad`ed input: 1e-12 in float64, TOL32 in float32; y and dx
    channels-last like x."""
    w = h - 1 if h > 20 else h   # a plane that is not square
    padding = _padding(h, w, k, stride)
    for dtype in (torch.float64, torch.float32):
        x, weight, grad = _inputs(2, C, h, w, k, stride, dtype, h + k)
        got = _plain(x, weight, grad, stride, padding)
        expect = _library(x, weight, grad, stride, padding)
        for name, a, b in zip(("y", "dx", "dw"), got, expect):
            assert a.shape == b.shape, name
            bar = 1e-12 if dtype == torch.float64 else TOL32[name]
            assert _gap(a, b) <= bar, (name, dtype)
        assert got[0].is_contiguous(memory_format=torch.channels_last)
        assert got[1].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("h,k,stride", [(38, 3, 2), (19, 5, 1), (15, 5, 2),
                                        (16, 5, 2), (14, 3, 1)], ids=str)
def test_plain_version_matches_jax_grouped_conv(h, k, stride):
    """The forward and its vjp against the JAX package's depthwise conv,
    flax `nn.Conv(feature_group_count=C)` with 'SAME' padding, in
    float32."""
    x, weight, grad = _inputs(2, C, h, h, k, stride, torch.float32, 3 * h)
    got = _plain(x, weight, grad, stride, _padding(h, h, k, stride))
    conv = fnn.Conv(features=C, kernel_size=(k, k), strides=(stride, stride),
                    padding="SAME", feature_group_count=C, use_bias=False)
    kernel = jnp.asarray(weight.numpy().transpose(2, 3, 1, 0))  # HWIO
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())

    def apply(xv, kv):
        return conv.apply({"params": {"kernel": kv}}, xv)

    y, vjp = jax.vjp(apply, xj, kernel)
    dx, dk = vjp(jnp.asarray(grad.permute(0, 2, 3, 1).numpy()))
    expect = (torch.from_numpy(np.asarray(y)).permute(0, 3, 1, 2),
              torch.from_numpy(np.asarray(dx)).permute(0, 3, 1, 2),
              torch.from_numpy(np.asarray(dk).transpose(3, 2, 0, 1)))
    for name, a, b in zip(("y", "dx", "dw"), got, expect):
        assert a.shape == b.shape, name
        assert _gap(a, b) <= 10 * TOL32[name], name


@pytest.mark.parametrize("k,stride,h", [(3, 1, 5), (5, 2, 7), (3, 2, 6)])
def test_function_gradcheck_in_float64(k, stride, h):
    """The Function's CPU backward (the hand-derived one) is the gradient
    of its forward."""
    x, weight, _ = _inputs(2, 3, h, h + 1, k, stride, torch.float64, k + h)
    padding = _padding(h, h + 1, k, stride)
    assert torch.autograd.gradcheck(
        lambda a, b: dw.depthwise_conv(a, b, stride, padding),
        (x.requires_grad_(True), weight.requires_grad_(True)))


def _conv(c, k, stride, seed, **kwargs):
    conv = layers.Conv2d(c, c, k, stride=stride, groups=c, use_bias=False,
                         depthwise_init=True, **kwargs)
    conv.reset_parameters(torch.Generator().manual_seed(seed))
    return conv


def _kernel_route_on_cpu(monkeypatch):
    """The layer's kernel route taken by CPU maps too (the predicate's
    other conditions kept), so that the wiring runs through the Function's
    plain version."""
    route = layers.Conv2d._kernel_route

    def on_cpu(self, x, kernel, groups):
        stub = types.SimpleNamespace(
            device=torch.device("cuda"), dtype=x.dtype, shape=x.shape,
            is_contiguous=x.is_contiguous)
        return route(self, stub, kernel, groups)

    monkeypatch.setattr(layers.Conv2d, "_kernel_route", on_cpu)


def _forward_and_grads(conv, x, g):
    xr = x.clone().requires_grad_(True)
    y = conv(xr)
    return (y,) + torch.autograd.grad(y, (xr, conv.kernel), g)


@pytest.mark.parametrize("h,k,stride", [(19, 5, 1), (38, 3, 2), (15, 5, 2)],
                         ids=str)
def test_layer_kernel_route_matches_the_library(h, k, stride, monkeypatch):
    """Conv2d on its kernel route (the Function) against the same layer on
    `F.pad` + `F.conv2d`, channels-last float32: output and both gradients
    within TOL32, the output channels-last."""
    conv = _conv(C, k, stride, h)
    ref = copy.deepcopy(conv)
    x, _, g = _inputs(2, C, h, h, k, stride, torch.float32, h + 1)
    expect = _forward_and_grads(ref, x, g)
    _kernel_route_on_cpu(monkeypatch)
    got = _forward_and_grads(conv, x, g)
    for name, a, b in zip(("y", "dx", "dw"), got, expect):
        assert a.shape == b.shape
        assert _gap(a, b) <= TOL32[name], name
    assert got[0].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("k,stride", [(5, 1), (3, 2)])
def test_kernel_route_under_task_axis(k, stride, monkeypatch):
    """Under a task axis of T=3 (the kernel stacked [T, C, 1, k, k], the
    channels folded to T*C) the kernel route's output and stacked
    gradients equal the library route's within TOL32."""
    conv = _conv(C, k, stride, 20)
    x, _, g = _inputs(2, T * C, 11, 11, k, stride, torch.float32, 21)
    results = []
    for route in ("library", "kernel"):
        if route == "kernel":
            _kernel_route_on_cpu(monkeypatch)
        kernel = torch.stack([conv.kernel.detach() * (1.0 + 0.1 * t)
                              for t in range(T)]).requires_grad_(True)
        xr = x.clone().requires_grad_(True)
        with layers.task_axis(T):
            y = torch.func.functional_call(conv, {"kernel": kernel}, (xr,))
        results.append((y,) + torch.autograd.grad(y, (xr, kernel), g))
    for name, b, a in zip(("y", "dx", "dw"), *results):
        assert a.shape == b.shape
        assert _gap(a, b) <= TOL32[name], name


def _cuda_map(shape=(4, C, 9, 9), dtype=torch.float32, channels_last=True):
    """What the route reads of a CUDA map, without a card."""
    real = torch.empty(shape).to(memory_format=torch.channels_last
                                 if channels_last else
                                 torch.contiguous_format)
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=real.shape,
                                 is_contiguous=real.is_contiguous)


ROUTES = {
    # case: (layer kwargs, map kwargs, kernel route)
    "depthwise_k3": ({}, {}, True),
    "depthwise_k5_stride2": ({"kernel_size": 5, "stride": 2}, {}, True),
    "cpu": ({}, {"cpu": True}, False),
    "bfloat16": ({}, {"dtype": torch.bfloat16}, False),
    "nchw": ({}, {"channels_last": False}, False),
    "dilation": ({"dilation": 2}, {}, False),
    "groups_not_channels": ({"groups": 3}, {}, False),
    "dense": ({"groups": 1}, {}, False),
    "bias": ({"use_bias": True}, {}, False),
    "k7": ({"kernel_size": 7}, {}, False),
    "stride3": ({"stride": 3}, {}, False),
    "spatial_context": ({}, {}, False),
    "traced": ({}, {}, False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_choice(case, monkeypatch):
    """The kernel route is taken by a depthwise conv (groups == in == out
    channels) of k 3 or 5, dilation 1, stride 1 or 2, no bias, over a
    float32 channels-last CUDA map with no spatial context and no tracer,
    and by nothing else; the cases that keep the library run `F.pad` +
    `F.conv2d` on the CPU bit for bit and launch nothing."""
    kwargs, where, kernel = ROUTES[case]
    kw = dict(kernel_size=3, stride=1, dilation=1, groups=C,
              use_bias=False)
    kw.update(kwargs)
    conv = layers.Conv2d(C, C, kw.pop("kernel_size"), **kw)
    conv.reset_parameters(torch.Generator().manual_seed(22))
    if case == "spatial_context":
        monkeypatch.setattr(spatial, "current", lambda: object())
    if case == "traced":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if where.get("cpu"):
        x = torch.empty(4, C, 9, 9).to(memory_format=torch.channels_last)
    else:
        x = _cuda_map(dtype=where.get("dtype", torch.float32),
                      channels_last=where.get("channels_last", True))
    assert conv._kernel_route(x, conv.kernel, conv.groups) is kernel
    if case == "spatial_context":
        return   # a spatial context shards the conv (_forward_sharded)
    kernel_library.launches.clear()
    real, _, _ = _inputs(4, C, 9, 9, conv.kernel_size, conv.stride,
                         torch.float32, 23,
                         where.get("channels_last", True))
    if where.get("dtype") == torch.bfloat16:
        real = real.to(torch.bfloat16)
    y = conv(real)
    assert not kernel_library.launches
    ph = layers.same_padding(9, conv.kernel_size, conv.stride, conv.dilation)
    xp = F.pad(real.to(y.dtype), (ph[0], ph[1], ph[0], ph[1]))
    bias = None if conv.bias is None else conv.bias.to(y.dtype)
    expect = F.conv2d(xp, conv.kernel.to(y.dtype), bias, stride=conv.stride,
                      dilation=conv.dilation, groups=conv.groups)
    assert torch.equal(y, expect)


def test_backbone_depthwise_convs_take_the_route():
    """Every MBConv block's depthwise conv sees a channels-last map (the
    backbone runs channels-last from `fold_nhwc` on) and takes the route
    when the map is float32 on the card; the decoders' convs do not."""
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    model = EfficientLab(rsd=(2,), spatial_pyramid_pooling=True,
                         skip_decoding=True)
    model.reset_parameters(torch.Generator().manual_seed(24))
    routed = []

    def hook(module, args):
        x = args[0]
        stub = types.SimpleNamespace(device=torch.device("cuda"),
                                     dtype=x.dtype, shape=x.shape,
                                     is_contiguous=x.is_contiguous)
        routed.append((module, module._kernel_route(stub, module.kernel,
                                                    module.groups)))

    for m in model.modules():
        if isinstance(m, layers.Conv2d):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(255.0 * torch.rand(2, 64, 64, 3), train=True)
    backbone = set(getattr(model, model.backbone_name).modules())
    blocks = [m for m, _ in routed if m in backbone and m.groups > 1]
    assert len(blocks) == 11   # b0 cut at block 10
    assert all(r for m, r in routed if m in blocks)
    assert not any(r for m, r in routed if m not in blocks)


# The joint cells' depthwise inputs (b3's and b0's, batch 64), a folded
# task axis of 5 x 144 channels, and channel counts that are no multiple of
# 8 and of 4.
PLAN_CASES = [((64, 40, 150, 150), 3, 1), ((64, 24, 150, 150), 3, 1),
              ((64, 144, 150, 150), 3, 2), ((64, 192, 75, 75), 3, 1),
              ((64, 192, 75, 75), 5, 2), ((64, 288, 38, 38), 5, 1),
              ((64, 288, 38, 38), 3, 2), ((64, 576, 19, 19), 3, 1),
              ((64, 816, 19, 19), 5, 1), ((64, 96, 112, 112), 3, 2),
              ((64, 672, 14, 14), 5, 1), ((8, 5 * 144, 56, 56), 3, 1),
              ((2, 20, 9, 9), 5, 2), ((2, 6, 9, 9), 3, 1)]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape,k,stride", PLAN_CASES, ids=str)
def test_launch_plan_covers_the_map(shape, k, stride, backward):
    """Tiles of whole units cover the output grid (backward at stride 2
    the grid that owns every input row), the blocks cover the tiles, the
    shared memory fits SMEM_BUDGET, the channel slices cover C: what
    csrc/depthwise_conv.cu's launch checks."""
    n, c, h, w = shape
    (pt, _), (pl, _) = _padding(h, w, k, stride)
    p = dw.launch_plan(shape, k, stride, pt, pl, backward, 132)
    unit = dw.UNIT[stride]
    assert p.cs in dw.CHANNEL_SLICES
    assert p.slices * p.cs >= c > (p.slices - 1) * p.cs
    assert p.tile_h % unit == 0 and p.tile_w % unit == 0
    gh, gw = dw.output_grid(shape, k, stride, pt, pl, backward)
    if backward and stride == 2:
        assert 2 * gh - pt >= h and 2 * gw - pl >= w
    assert p.tiles == n * -(-gh // p.tile_h) * -(-gw // p.tile_w)
    assert p.blocks * p.tiles_per_block >= p.tiles and p.blocks <= 65535
    assert (p.blocks - 1) * p.tiles_per_block < p.tiles
    assert p.smem == dw.smem_bytes(k, stride, backward, p.cs, p.tile_h,
                                   p.tile_w) <= dw.SMEM_BUDGET
    units = (p.tile_h // unit) * (p.tile_w // unit)
    assert units <= dw.MAX_UNITS_A_THREAD * dw.THREADS // p.cs


def _tile(src, r0, c0, rows, cols):
    """src [C, Hs, Ws] rows [r0, r0 + rows) x columns [c0, c0 + cols),
    zeros outside: the kernel's cp.async copies with src-size 0."""
    out = src.new_zeros(src.shape[0], rows, cols)
    hs, ws = src.shape[1:]
    a, b = max(r0, 0), min(r0 + rows, hs)
    e, f = max(c0, 0), min(c0 + cols, ws)
    if a < b and e < f:
        out[:, a - r0:b - r0, e - c0:f - c0] = src[:, a:b, e:f]
    return out


def _emulate(x, weight, g, stride, padding, tile_h, tile_w, backward):
    """The kernels' tiles, halos, units and their compile-time windows, in
    float64, unit by unit as csrc/depthwise_conv.cu indexes them: y, or
    (dx, dw)."""
    n, c, h, w = x.shape
    k, s = weight.shape[-1], stride
    wt = weight[:, 0]
    pt, pl = padding[0][0], padding[1][0]
    r = dw.UNIT[s]
    xh, xw = (r - 1) * s + k, (r - 1) * s + k
    halo, h0 = (k - 1) // s, (k - 1) // 2
    ho, wo = -(-h // s), -(-w // s)
    gh, gw = dw.output_grid(x.shape, k, s, pt, pl, backward)
    out = (x.new_zeros(n, c, h, w) if backward
           else x.new_zeros(n, c, ho, wo))
    dwa = torch.zeros_like(wt)
    for img in range(n):
        for orow in range(0, gh, tile_h):
            for ocol in range(0, gw, tile_w):
                xt = _tile(x[img], orow * s - pt, ocol * s - pl,
                           (tile_h - 1) * s + k, (tile_w - 1) * s + k)
                if backward:
                    dt = _tile(g[img], orow - h0, ocol - h0,
                               tile_h + halo, tile_w + halo)
                for uh in range(tile_h // r):
                    for uw in range(tile_w // r):
                        xs = xt[:, uh * r * s:, uw * r * s:]
                        if not backward:
                            for a in range(r):
                                for b in range(r):
                                    acc = sum(
                                        xs[:, row, b * s + j] * wt[:, row
                                                                  - a * s, j]
                                        for row in range(xh)
                                        if 0 <= row - a * s < k
                                        for j in range(k))
                                    oh, ow = orow + uh * r + a, \
                                        ocol + uw * r + b
                                    if oh < ho and ow < wo:
                                        out[img, :, oh, ow] = acc
                            continue
                        ds = dt[:, uh * r:, uw * r:]
                        ih0 = (orow if s == 1 else orow * s - pt) + uh * r * s
                        iw0 = (ocol if s == 1 else ocol * s - pl) + uw * r * s
                        for p in range(s * r):
                            for q in range(s * r):
                                acc = sum(
                                    ds[:, row, bq] * wt[:, p + k - 1 - row * s,
                                                       q + k - 1 - bq * s]
                                    for row in range(r + halo)
                                    if 0 <= p + k - 1 - row * s < k
                                    for bq in range(r + halo)
                                    if 0 <= q + k - 1 - bq * s < k)
                                ih, iw = ih0 + p, iw0 + q
                                if 0 <= ih < h and 0 <= iw < w:
                                    out[img, :, ih, iw] = acc
                        for row in range(xh):
                            for a in range(r):
                                i = row - a * s
                                if not 0 <= i < k:
                                    continue
                                for b in range(r):
                                    dyv = ds[:, h0 + a, h0 + b]
                                    for j in range(k):
                                        dwa[:, i, j] += dyv * xs[:, row,
                                                                 b * s + j]
        assert xw == xh
    return (out, dwa[:, None]) if backward else out


@pytest.mark.parametrize("h,w,k,stride", [(19, 19, 5, 1), (10, 11, 3, 1),
                                          (10, 10, 3, 2), (15, 13, 5, 2),
                                          (9, 9, 5, 2), (7, 6, 3, 2)],
                         ids=str)
def test_kernels_blocking_emulated(h, w, k, stride):
    """The kernels' blocking in float64 (tiles of the launch plan, and
    tiles of one or two units so that halos cross tile edges) against the
    plain version: y, dx and dw within 1e-12."""
    padding = _padding(h, w, k, stride)
    x, weight, g = _inputs(2, 3, h, w, k, stride, torch.float64, h * w)
    y, dx, dwt = _plain(x, weight, g, stride, padding)
    unit = dw.UNIT[stride]
    for backward in (False, True):
        plan = dw.launch_plan(tuple(x.shape), k, stride, padding[0][0],
                              padding[1][0], backward, 132)
        for th, tw in ((plan.tile_h, plan.tile_w), (unit, 2 * unit)):
            got = _emulate(x, weight, g, stride, padding, th, tw, backward)
            if backward:
                assert _gap(got[0], dx) <= 1e-12
                assert _gap(got[1], dwt) <= 1e-12
            else:
                assert _gap(got, y) <= 1e-12


def test_wrapper_refuses_what_it_does_not_take():
    x, weight, _ = _inputs(2, C, 9, 9, 3, 1, torch.float32, 25)
    padding = _padding(9, 9, 3, 1)
    with pytest.raises(ValueError):
        dw.depthwise_conv(x, weight[:-1], 1, padding)
    with pytest.raises(ValueError):
        dw.depthwise_conv(x, weight.double(), 1, padding)
    with pytest.raises(ValueError):
        dw.depthwise_conv(x[0], weight, 1, padding)


def test_kernels_on_the_card():
    """The kernels against the plain version on the card, at one shape of
    each kernel size and stride: y, dx and dw within TOL32 of float64, the
    launches counted, two runs bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: chip_smoke.py's dw_kernel phase runs "
                    "the kernels")
    dev = torch.device("cuda")
    for h, k, stride in [(19, 5, 1), (38, 3, 2), (15, 5, 2), (20, 3, 1)]:
        padding = _padding(h, h, k, stride)
        x, weight, g = _inputs(4, 16, h, h, k, stride, torch.float64, h)
        truth = _plain(x, weight, g, stride, padding)
        runs = []
        for _ in range(2):
            kernel_library.launches.clear()
            xr = x.float().to(dev).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            wr = weight.float().to(dev).requires_grad_(True)
            y = dw.depthwise_conv(xr, wr, stride, padding)
            grads = torch.autograd.grad(y, (xr, wr), g.float().to(dev))
            runs.append((y.detach(),) + grads)
            assert kernel_library.launches["depthwise_conv"] == 1
            assert kernel_library.launches["depthwise_conv_grad"] == 1
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        for name, a, b in zip(("y", "dx", "dw"), runs[0], truth):
            assert _gap(a.cpu(), b) <= TOL32[name], name
        assert math.isfinite(float(runs[0][2].sum()))
