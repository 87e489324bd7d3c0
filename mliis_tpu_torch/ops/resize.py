"""Bilinear resize with TF1 `align_corners=True` semantics, NHWC.

Corner pixels of source and target map onto each other
(scale = (in-1)/(out-1)). `F.interpolate(mode="bilinear",
align_corners=True)` implements the same map; tests/test_torch_ops.py holds
it against the JAX package's matmul form.

As in the JAX package, a resize to a new size computes in float32 (the JAX
form multiplies by float32 interpolation matrices, which promotes bf16
activations), while a same-size call returns its input unchanged.
"""
import torch
import torch.nn.functional as F


def resize_bilinear_align_corners_nchw(x: torch.Tensor, out_h: int,
                                       out_w: int) -> torch.Tensor:
    """Resize [N, C, H, W] to [N, C, out_h, out_w]."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Resize [N, H, W, C] to [N, out_h, out_w, C]."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    y = resize_bilinear_align_corners_nchw(x.permute(0, 3, 1, 2), out_h,
                                           out_w)
    return y.permute(0, 2, 3, 1)
