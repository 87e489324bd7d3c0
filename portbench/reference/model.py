"""Plain EfficientLab (Hendryx et al., arXiv:1912.06290) on an
EfficientNet encoder (Tan & Le, arXiv:1905.11946), as a function of a dict
of weights: the benchmark's reference forward.

It imports nothing of the program. What it computes follows the published
description as the program states it: the EfficientNet block table with
compound scaling and truncation at a block, MBConv blocks (expand,
depthwise, squeeze-and-excitation, project, an identity skip with
drop-connect), residual skip decoders (RSD), a final dropout and 1x1
projection, and an align-corners bilinear resize back to the input.
Conventions the weights and the draws depend on:

  - 'SAME' padding with the smaller half first; conv kernels [out, in/g,
    k, k]; names of the weights as the program's checkpoints hold them;
  - batch norm with the biased batch variance E[x^2] - E[x]^2 in float32,
    eps 1e-3, running stats updated with momentum 0.99 in training;
  - with a compute dtype (bf16 in the meta configuration) every conv and
    batch norm casts its input and weights to it; params stay float32; a
    resize to a new size and everything after the last conv run in
    float32, and a concat promotes to the widest input dtype;
  - drop-connect draws one uniform a sample in the activation's dtype,
    dropout one float32 uniform an element, each from the task's own
    generator, in layer order.

`quantize` is the lower-precision control: each conv's input and kernel
rounded to float8 e4m3 (a per-tensor scale to its largest magnitude), the
product then taken in the compute dtype; the gradient passes straight
through the rounding.
"""
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]

MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)

# (kernel, repeats, in, out, expand, stride, se ratio) of EfficientNet-b0.
BASE_BLOCKS = ((3, 1, 32, 16, 1, 1, 0.25), (3, 2, 16, 24, 6, 2, 0.25),
               (5, 2, 24, 40, 6, 2, 0.25), (3, 3, 40, 80, 6, 2, 0.25),
               (5, 3, 80, 112, 6, 1, 0.25), (5, 4, 112, 192, 6, 2, 0.25),
               (3, 1, 192, 320, 6, 1, 0.25))
# name -> (width, depth) coefficients.
SCALING = {"efficientnet-b0": (1.0, 1.0), "efficientnet-b3": (1.2, 1.4)}
DROP_CONNECT_RATE = 0.2
BN_EPS, BN_MOMENTUM = 1e-3, 0.99


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes of one EfficientLab, read from a configuration file."""
    backbone: str
    max_block: int
    decoder_dim: int
    rsd: Tuple[int, ...]
    out_channels: int
    final_dropout: float
    compute_dtype: Optional[torch.dtype]

    @staticmethod
    def from_config(cfg: dict) -> "Arch":
        m = cfg["model"]
        dtype = {"bfloat16": torch.bfloat16, "float32": None}[
            m["compute_dtype"]]
        return Arch(m["backbone"], m["max_block"], m["decoder_dim"],
                    tuple(sorted(m["rsd"], reverse=True)),
                    m["n_classes"] + 1, m["final_layer_dropout_rate"], dtype)


@dataclasses.dataclass(frozen=True)
class Block:
    kernel: int
    cin: int
    cout: int
    expand: int
    stride: int
    se: float


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def blocks(arch: Arch) -> Tuple[List[Block], int]:
    """(the blocks kept, the drop-connect divisor): stages whose cumulative
    unscaled repeats pass max_block + 1 are cut, then the kept stages are
    scaled and unrolled and truncated at max_block."""
    width, depth = SCALING[arch.backbone]
    out, total = [], 0
    for k, rep, cin, cout, e, s, se in BASE_BLOCKS:
        total += rep
        if total > arch.max_block + 1:
            break
        cin, cout = _round_filters(cin, width), _round_filters(cout, width)
        for r in range(int(math.ceil(depth * rep))):
            out.append(Block(k, cin if r == 0 else cout, cout, e,
                             s if r == 0 else 1, se))
    return out[:arch.max_block + 1], len(out)


def stem_channels(arch: Arch) -> int:
    return _round_filters(32, SCALING[arch.backbone][0])


def reductions(bl: Sequence[Block]) -> List[int]:
    """Indices of the blocks whose output is an endpoint reduction_i."""
    return [i for i in range(len(bl))
            if i == len(bl) - 1 or bl[i + 1].stride > 1]


def param_shapes(arch: Arch) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every weight and running stat: init is
    'conv', 'depthwise', 'zeros', 'ones', 'mean' or 'var'."""
    spec = []

    def conv(name, cin, cout, k, groups=1, bias=True, depthwise=False):
        spec.append((name + ".kernel", (cout, cin // groups, k, k),
                     "depthwise" if depthwise else "conv"))
        if bias:
            spec.append((name + ".bias", (cout,), "zeros"))

    def bn(name, c):
        spec.extend([(name + ".scale", (c,), "ones"),
                     (name + ".bias", (c,), "zeros"),
                     (name + ".mean", (c,), "mean"),
                     (name + ".var", (c,), "var")])

    bb = arch.backbone.replace("-", "_")
    stem = stem_channels(arch)
    conv(bb + ".stem_conv", 3, stem, 3, bias=False)
    bn(bb + ".stem_batch_normalization", stem)
    bl, _ = blocks(arch)
    for i, b in enumerate(bl):
        p = "{}.blocks_{}.".format(bb, i)
        f = b.cin * b.expand
        if b.expand != 1:
            conv(p + "expand_conv", b.cin, f, 1, bias=False)
            bn(p + "batch_normalization", f)
        conv(p + "depthwise_conv", f, f, b.kernel, groups=f, bias=False,
             depthwise=True)
        bn(p + "batch_normalization_1", f)
        red = max(1, int(b.cin * b.se))
        conv(p + "se_reduce", f, red, 1)
        conv(p + "se_expand", red, f, 1)
        conv(p + "project_conv", f, b.cout, 1, bias=False)
        bn(p + "batch_normalization_2", b.cout)
    ends = [bl[i].cout for i in reductions(bl)]
    decoded = ends[-1]
    nd = arch.decoder_dim
    for i in arch.rsd:
        p = "decode_skip_connections_{}.".format(i - 1)
        cat = decoded + ends[i - 1]
        units = []
        if decoded != nd:
            units.append(("upsample_proj", decoded, nd, 1))
        units += [("branch_0", cat, nd, 1), ("branch_1", cat, nd, 3),
                  ("fuse", 2 * nd + cat, nd, 3)]
        for name, cin, cout, k in units:
            conv(p + name + ".conv", cin, cout, k)
            bn(p + name + ".batch_normalization", cout)
        decoded = nd
    conv("final_layer_weights", decoded, arch.out_channels, 1)
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def is_bn(name: str) -> bool:
    """Batch-norm weights, which the l2 term skips: a '.'-part of the name
    that holds 'batch_normalization', 'batchnorm' or 'bn'."""
    return any(tok in part.lower() for part in name.split(".")
               for tok in ("batch_normalization", "batchnorm", "bn"))


def _same(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    eff = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, straight-through
    for the gradient."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = 448.0 / amax
    q = (t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q.to(t.dtype) - t.detach())


class Forward:
    """One forward of the network over `w` (weights and running stats by
    name). `generator` draws drop-connect and dropout; `train` takes batch
    moments and updates the running stats in `w` in place."""

    def __init__(self, arch: Arch, w: Tree, train: bool,
                 generator: Optional[torch.Generator] = None,
                 quantize: bool = False):
        self.arch, self.w, self.train = arch, w, train
        self.generator, self.quantize = generator, quantize

    def conv(self, name, x, k, stride=1, dilation=1, groups=1,
             dtype=None):
        kernel = self.w[name + ".kernel"]
        bias = self.w.get(name + ".bias")
        dtype = dtype or torch.promote_types(x.dtype, kernel.dtype)
        ph = _same(x.shape[-2], k, stride, dilation)
        pw = _same(x.shape[-1], k, stride, dilation)
        x = x.to(dtype)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        kernel = kernel.to(dtype)
        if self.quantize:
            x, kernel = fp8_round(x), fp8_round(kernel)
        return F.conv2d(x, kernel, None if bias is None else bias.to(dtype),
                        stride=stride, dilation=dilation, groups=groups)

    def bn(self, name, x, dtype=None):
        w = self.w
        if self.train:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = xf.square().mean((0, 2, 3)) - mean.square()
            with torch.no_grad():
                m = BN_MOMENTUM
                w[name + ".mean"].mul_(m).add_((1.0 - m) * mean.detach())
                w[name + ".var"].mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = w[name + ".mean"], w[name + ".var"]
        inv = torch.rsqrt(var + BN_EPS) * w[name + ".scale"]
        add = w[name + ".bias"] - mean * inv
        dtype = dtype or x.dtype
        return x.to(dtype) * inv.to(dtype)[:, None, None] \
            + add.to(dtype)[:, None, None]

    def rand(self, shape, device, dtype=None):
        """Uniforms from the generator, or the next ones of a `Tape`."""
        if isinstance(self.generator, Tape):
            return self.generator.pop(shape, dtype)
        return torch.rand(shape, generator=self.generator, device=device,
                          dtype=dtype)

    def drop_connect(self, x, rate):
        keep = 1.0 - rate
        u = self.rand((x.shape[0], 1, 1, 1), x.device, x.dtype)
        return (x / keep) * torch.floor(keep + u)

    def dropout(self, x, rate):
        keep = 1.0 - rate
        u = self.rand(tuple(x.shape), x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def mbconv(self, p, b: Block, x, rate):
        dt = self.arch.compute_dtype
        inputs = x
        if b.expand != 1:
            x = F.silu(self.bn(p + "batch_normalization",
                               self.conv(p + "expand_conv", x, 1, dtype=dt),
                               dt))
        f = b.cin * b.expand
        x = F.silu(self.bn(p + "batch_normalization_1",
                           self.conv(p + "depthwise_conv", x, b.kernel,
                                     b.stride, groups=f, dtype=dt), dt))
        se = x.mean((2, 3), keepdim=True)
        se = self.conv(p + "se_expand", F.silu(self.conv(
            p + "se_reduce", se, 1, dtype=dt)), 1, dtype=dt)
        x = torch.sigmoid(se) * x
        x = self.bn(p + "batch_normalization_2",
                    self.conv(p + "project_conv", x, 1, dtype=dt), dt)
        if b.stride == 1 and b.cin == b.cout:
            if self.train and rate:
                x = self.drop_connect(x, rate)
            x = x + inputs
        return x

    def unit(self, p, x, k, dilation=1):
        """conv (with bias) -> swish -> batch norm."""
        dt = self.arch.compute_dtype
        return self.bn(p + ".batch_normalization", F.silu(
            self.conv(p + ".conv", x, k, dilation=dilation, dtype=dt)), dt)

    def rsd(self, p, embedded, skip):
        up = resize(embedded, skip.shape[-2], skip.shape[-1])
        decoded = _cat([up, skip])
        if p + "upsample_proj.conv.kernel" in self.w:
            up = self.unit(p + "upsample_proj", up, 1)
        b0 = self.unit(p + "branch_0", decoded, 1)
        b1 = self.unit(p + "branch_1", decoded, 3, dilation=2)
        b2 = decoded.mean((2, 3), keepdim=True).expand_as(decoded)
        return self.unit(p + "fuse", _cat([b0, b1, b2]), 3) + up

    def __call__(self, images, drop_rate=None, upsample=True):
        a = self.arch
        dt = a.compute_dtype
        in_h, in_w = images.shape[1:3]
        mean = torch.tensor(MEAN_RGB, dtype=images.dtype,
                            device=images.device)
        std = torch.tensor(STDDEV_RGB, dtype=images.dtype,
                           device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        if dt is not None:
            x = x.to(dt)
        bb = a.backbone.replace("-", "_")
        x = F.silu(self.bn(bb + ".stem_batch_normalization",
                           self.conv(bb + ".stem_conv", x, 3, 2, dtype=dt),
                           dt))
        bl, divisor = blocks(a)
        ends = reductions(bl)
        endpoints = []
        for i, b in enumerate(bl):
            x = self.mbconv("{}.blocks_{}.".format(bb, i), b, x,
                            DROP_CONNECT_RATE * i / divisor)
            if i in ends:
                endpoints.append(x)
        decoded = endpoints[-1]
        for i in a.rsd:
            decoded = self.rsd("decode_skip_connections_{}.".format(i - 1),
                               decoded, endpoints[i - 1])
        rate = a.final_dropout if drop_rate is None else drop_rate
        if self.train and rate > 0:
            decoded = self.dropout(decoded, rate)
        decoded = self.conv("final_layer_weights", decoded, 1,
                            dtype=dt).float()
        if not upsample:
            return decoded, None
        logits = resize(decoded, in_h, in_w).permute(0, 2, 3, 1)
        return logits, torch.softmax(logits, dim=-1)


class Tape:
    """The uniforms of one training forward, drawn ahead from a generator
    in the order the forward draws them (`forward_draws`), then handed out
    in that order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def pop(self, shape, dtype=None):
        u = self.draws.pop(0)
        if tuple(u.shape) != tuple(shape) or (dtype is not None
                                              and u.dtype != dtype):
            raise ValueError("a draw of {} {} where {} {} was taped".format(
                tuple(shape), dtype, tuple(u.shape), u.dtype))
        return u


def forward_draws(arch: Arch, generator: torch.Generator, batch: int,
                  h: int, w: int, drop_rate: Optional[float] = None
                  ) -> Tape:
    """What a training forward of `batch` images at h x w draws from
    `generator`, in its order: a drop-connect uniform a sample (in the
    activation's dtype) in each identity-skip block with a rate, then
    the final dropout's float32 uniforms over the decoded map."""
    dev = generator.device
    act = arch.compute_dtype or torch.float32
    bl, divisor = blocks(arch)
    out = []
    for i, b in enumerate(bl):
        if b.stride == 1 and b.cin == b.cout and DROP_CONNECT_RATE * i:
            out.append(torch.rand((batch, 1, 1, 1), generator=generator,
                                  device=dev, dtype=act))
    rate = arch.final_dropout if drop_rate is None else drop_rate
    if rate > 0:
        ends = reductions(bl)
        if arch.rsd:
            level, channels = min(arch.rsd), arch.decoder_dim
        else:
            level, channels = len(ends), bl[ends[-1]].cout
        dh, dw = h, w
        for _ in range(level):
            dh, dw = -(-dh // 2), -(-dw // 2)
        out.append(torch.rand((batch, channels, dh, dw),
                              generator=generator, device=dev))
    return Tape(out)


def _cat(tensors):
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.to(dtype) for t in tensors], dim=1)


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Align-corners bilinear resize of NCHW x, in float32; a same-size
    resize returns x."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x.float(), size=(h, w), mode="bilinear",
                         align_corners=True)


def make_weights(arch: Arch, generator: torch.Generator, device
                 ) -> Tree:
    """Fresh weights from `generator` in one normal draw: conv kernels
    N(0, 2 / fan_out) with fan_out = k * k * out (k * k for a depthwise
    kernel), biases and batch-norm shifts 0, scales 1, running means 0
    and variances 1. Float32 on `device`."""
    spec = param_shapes(arch)
    sizes = [math.prod(s) for _, s, kind in spec
             if kind in ("conv", "depthwise")]
    noise = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind in ("conv", "depthwise"):
            n = math.prod(shape)
            fan = shape[2] * shape[3] * (1 if kind == "depthwise"
                                         else shape[0])
            out[name] = noise[at:at + n].view(shape) * math.sqrt(2.0 / fan)
            at += n
        elif kind in ("ones", "var"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def weights_from_npz(path: str, device) -> Tree:
    """The weights and running stats of a checkpoint in the flax npz
    layout ('params/' and 'batch_stats/' with '/'-joined paths, conv
    kernels [kh, kw, in, out])."""
    import numpy as np
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            for prefix in ("params/", "batch_stats/"):
                if key.startswith(prefix):
                    v = z[key]
                    if v.ndim == 4:
                        v = v.transpose(3, 2, 0, 1)
                    out[key[len(prefix):].replace("/", ".")] = torch.tensor(
                        np.ascontiguousarray(v), device=device)
    return out
