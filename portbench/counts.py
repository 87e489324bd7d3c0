"""The work the algorithm needs, counted from the configuration's layer
table and the cell's shapes, whatever implements it.

  - `forward_flops`: 2 * multiply-adds of every convolution of one image's
    forward (the EfficientNet blocks as the model's table gives them, the
    squeeze-and-excitation 1x1s at 1x1, the residual skip decoders, the
    final 1x1); a training pass counts three forwards (the backward takes
    two). Element-wise work, batch norms, resizes and the softmax are not
    counted: they are bound by bytes, not operations.
  - `full_pass_bytes`, `light_augment_bytes`: each kernel input read once
    and each output written once (float32 planes and the int32 draws).
The peaks of one H100 SXM are NVIDIA's data sheet's (dense, 700 W).
"""
from portbench.reference.model import (Arch, blocks, reductions,
                                       stem_channels)

PEAKS = {
    "bfloat16": 989e12,       # tensor cores, dense
    "float32": 67e12,         # outside the tensor cores (TF32 off)
    "hbm_bytes_per_s": 3.35e12,
}


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_flops(cin: int, cout: int, k: int, h: int, w: int,
               groups: int = 1) -> int:
    """2 * multiply-adds of a conv producing [cout, h, w]."""
    return 2 * cout * (cin // groups) * k * k * h * w


def forward_flops(arch: Arch, h: int, w: int) -> int:
    """FLOPs of one image's forward at h x w."""
    total = 0
    h, w = _out(h, 2), _out(w, 2)
    stem = stem_channels(arch)
    total += conv_flops(3, stem, 3, h, w)
    bl, _ = blocks(arch)
    sizes = []
    for b in bl:
        f = b.cin * b.expand
        if b.expand != 1:
            total += conv_flops(b.cin, f, 1, h, w)
        h, w = _out(h, b.stride), _out(w, b.stride)
        total += conv_flops(f, f, b.kernel, h, w, groups=f)
        red = max(1, int(b.cin * b.se))
        total += conv_flops(f, red, 1, 1, 1) + conv_flops(red, f, 1, 1, 1)
        total += conv_flops(f, b.cout, 1, h, w)
        sizes.append((h, w))
    ends = [(bl[i].cout,) + sizes[i] for i in reductions(bl)]
    decoded = ends[-1][0]
    nd = arch.decoder_dim
    for i in arch.rsd:
        c, sh, sw = ends[i - 1]
        cat = decoded + c
        if decoded != nd:
            total += conv_flops(decoded, nd, 1, sh, sw)
        total += conv_flops(cat, nd, 1, sh, sw)
        total += conv_flops(cat, nd, 3, sh, sw)
        total += conv_flops(2 * nd + cat, nd, 3, sh, sw)
        decoded = nd
        h, w = sh, sw
    if not arch.rsd:
        h, w = ends[-1][1:]
    return total + conv_flops(decoded, arch.out_channels, 1, h, w)


def training_flops(arch: Arch, h: int, w: int, images: int) -> int:
    """Forward and backward of `images` images: three forwards each."""
    return 3 * images * forward_flops(arch, h, w)


def full_pass_bytes(batch: int, h: int, w: int, planes: int = 5) -> int:
    """`full_pass`: the planar float32 batch in and out, and its int32
    draws (seed, 6-op permutation, prefix length, 4 rotation numbers)."""
    return 2 * batch * planes * h * w * 4 + 4 * 12 * batch


def light_augment_bytes(batch: int, h: int, w: int, channels: int = 3
                        ) -> int:
    """`fused_light_augment`: float32 images and labels in and out, and
    the int32 seeds."""
    return 2 * batch * h * w * (channels + 1) * 4 + 4 * batch
