"""Bilinear resize with TF1 `align_corners=True` semantics, NHWC.

Corner pixels of source and target map onto each other
(scale = (in-1)/(out-1)). `F.interpolate(mode="bilinear",
align_corners=True)` implements the same map; tests/test_torch_ops.py holds
it against the JAX package's matmul form.

As in the JAX package, a resize to a new size computes in float32 (the JAX
form multiplies by float32 interpolation matrices, which promotes bf16
activations), while a same-size call returns its input unchanged.

Under a bound spatial context (`parallel/spatial.py`) the map is H-sharded
and `out_h` is the global height: each rank fetches the source rows of its
output rows and interpolates along W, then along H, with the global
coordinates' float32 weights, as PyTorch's bilinear kernel takes them.
"""
import torch
import torch.nn.functional as F

from mliis_tpu_torch.parallel import spatial


def resize_bilinear_align_corners_nchw(x: torch.Tensor, out_h: int,
                                       out_w: int) -> torch.Tensor:
    """Resize [N, C, H, W] to [N, C, out_h, out_w]."""
    if spatial.current() is not None:
        return _resize_sharded(x, out_h, out_w)
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x.float(), size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def _lerp(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """x's slices `first` and `second` along `dim`, blended by `weight`."""
    first, second = (torch.tensor(t, dtype=torch.long, device=x.device)
                     for t in taps[:2])
    shape = [1] * x.ndim
    shape[dim] = -1
    w1 = torch.tensor(taps[2], dtype=torch.float32,
                      device=x.device).view(shape)
    return (x.index_select(dim, first) * (1.0 - w1)
            + x.index_select(dim, second) * w1)


def _resize_sharded(x: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    in_h, in_w = spatial.global_height(x), x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    spatial.register(out_w, out_h)
    lo, hi, first, second, weight = spatial.resize_windows(in_h, out_h)
    x = spatial.fetch_rows(x.float(), lo, hi)
    if in_w != out_w:
        x = _lerp(x, 3, spatial.align_corners_taps(in_w, out_w, 0, out_w))
    return _lerp(x, 2, (first, second, weight))


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Resize [N, H, W, C] to [N, out_h, out_w, C]."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    y = resize_bilinear_align_corners_nchw(x.permute(0, 3, 1, 2), out_h,
                                           out_w)
    return y.permute(0, 2, 3, 1)
