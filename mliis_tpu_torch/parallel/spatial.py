"""Spatial partitioning: the image H axis split over the ranks of a mesh.

The port of the JAX package's `parallel/spatial.py`. There GSPMD inserts
the halo exchange for every conv, pool and resize window; PyTorch has no
such pass, so the port exchanges rows by hand. A world of D ranks (one
process a rank, `parallel/mesh.init_world`) shards every activation map
along H, and each windowed or pooled op is made exact on its shard:

  - rows: at a level of global height Hl, rank r owns rows
    [floor(r*Hl/D), floor((r+1)*Hl/D)). Any H works, a level with fewer
    rows than ranks too: a rank may own none and still takes part in
    every collective;
  - global heights are carried in a context (`bound`), never read off a
    local shape. W is never sharded, so a map's global height is looked
    up by its width: `bound` registers the images' (W, H), and every conv
    or resize that makes a map of a new width registers its global height.
    Two maps of one width with different heights raise;
  - `fetch_rows` (a `torch.autograd.Function`) returns global rows
    [lo, hi) of an H-sharded map, zeros outside [0, Hl). Forward: each
    owner writes the rows that other ranks need into a buffer with one
    slot a rank, and one sum all-reduce delivers them; every row of a slot
    has one writer, so the sum is exact in any dtype. Backward is the
    transpose: the cotangents go into the slots, one all-reduce, and each
    owner adds its slots into its rows' gradient. An all-reduce, because
    gloo, which runs ranks that share a card, takes CUDA tensors only for
    `all_reduce` and `broadcast`. A halo may reach any rank, not only the
    neighbours (ASPP's dilation-6 conv on a few rows a rank);
  - the hooks: `layers.Conv2d` fetches the input rows its owned output
    rows read and convolves with no H padding; `layers.FusedBatchNorm`
    takes the psum of the local sums of x and x^2 over the global count;
    the per-image means (squeeze-and-excite, the RSD's pooled branch,
    ASPP's image pool) are `mean_hw`, and what a pooled branch computes
    from its mean runs `replicated`, whole on every rank; `ops/resize`
    fetches the source rows of its owned output rows;
    `layers.traced_dropout` takes this rank's rows of the mask the
    unsharded forward draws; `ops/losses` and
    `meta/inner_loop.make_loss_and_grad` sum over the axis. With no
    context bound every hook runs the unsharded code;
  - every rank makes the same collectives in the same order, whatever its
    rows, and keeps each in its autograd graph (a rank with no output rows
    convolves a zero window and keeps none of it). The backward runs a
    graph's nodes in the reverse of the order they were made, so its
    collectives too meet in the same order on every rank.

The sums over the axis go through `mesh.psum`, whose backward all-reduces
the cotangent; `make_loss_and_grad` then averages the gradients over the
axis (`mesh.pmean_grads`), as on the data axis: the data gradient comes
out once and the replicated l2/l1 terms at their scale.
"""
import contextlib
import contextvars
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mliis_tpu_torch.parallel import mesh as mesh_lib

SPATIAL_AXIS = "sp"

_BOUND: contextvars.ContextVar = contextvars.ContextVar("bound_spatial",
                                                        default=None)


def make_spatial_mesh(num_devices: Optional[int] = None, device=None,
                      store_dir: Optional[str] = None) -> DeviceMesh:
    """A ("sp",) mesh over `num_devices` ranks (the whole world when None),
    started through `mesh.init_world`: NCCL when each rank has its own
    card, gloo when ranks share one or run on the CPU."""
    n = num_devices or mesh_lib._world_size()
    return mesh_lib._mesh((n,), (SPATIAL_AXIS,), device, store_dir,
                          "{}-rank spatial".format(n))


def rows(height: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank `rank`'s rows [lo, hi) of a level of `height` rows over `size`
    ranks."""
    return rank * height // size, (rank + 1) * height // size


def shard_spatial(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of an [N, H, W, C] tensor."""
    lo, hi = rows(x.shape[1], mesh.size(0), mesh.get_local_rank(SPATIAL_AXIS))
    return x[:, lo:hi]


@dataclasses.dataclass
class _Context:
    group: object
    size: int
    rank: int
    heights: Dict[int, int]     # a map's width -> its global height


@contextlib.contextmanager
def bound(mesh: DeviceMesh, height: int, width: int):
    """Bind `mesh`'s spatial axis, for images of global size height x
    width: every hook computes on this rank's rows of them."""
    if SPATIAL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError("a spatial context needs a mesh with the axis "
                         "{!r}; got {}".format(SPATIAL_AXIS,
                                               mesh.mesh_dim_names))
    ctx = _Context(mesh.get_group(SPATIAL_AXIS), mesh.size(0),
                   mesh.get_local_rank(SPATIAL_AXIS), {width: height})
    token = _BOUND.set(ctx)
    try:
        with mesh_lib.bound(mesh):
            yield mesh
    finally:
        _BOUND.reset(token)


@contextlib.contextmanager
def replicated():
    """For the block, no spatial context: the maps computed in it are
    whole on every rank (a pooled [N, C, 1, 1] branch), so the hooks run
    their unsharded code and dropout draws the map's own shape."""
    token = _BOUND.set(None)
    try:
        yield
    finally:
        _BOUND.reset(token)


def current() -> Optional[_Context]:
    """The bound spatial context, or None."""
    return _BOUND.get()


def _context() -> _Context:
    ctx = _BOUND.get()
    if ctx is None:
        raise NameError("unbound axis name: {} (no spatial context is "
                        "bound; see parallel.spatial.bound)".format(
                            SPATIAL_AXIS))
    return ctx


def register(width: int, height: int) -> None:
    """Record that maps of `width` have `height` global rows."""
    heights = _context().heights
    if heights.setdefault(width, height) != height:
        raise ValueError("two maps of width {} have global heights {} and "
                         "{}; a spatial context tells maps apart by their "
                         "width".format(width, heights[width], height))


def global_height(x: torch.Tensor, dim: int = -2) -> int:
    """The global size of `x`'s H axis `dim` (W is the axis after it):
    `x.shape[dim]` with no context bound."""
    ctx = _BOUND.get()
    if ctx is None:
        return x.shape[dim]
    width = x.shape[dim + 1]
    if width not in ctx.heights:
        raise KeyError("no global height is known for a map of width {}"
                       .format(width))
    return ctx.heights[width]


def owned_rows(height: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a level of `height` global rows."""
    ctx = _context()
    return rows(height, ctx.size, ctx.rank)


def take_rows(full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of an NCHW tensor that holds every row (a mask the
    unsharded forward draws)."""
    lo, hi = owned_rows(full.shape[-2])
    return full[..., lo:hi, :]


# --------------------------------------------------------------------------
# The row exchange.
# --------------------------------------------------------------------------

class _RowPlan:
    """Where every row of every rank's window [lo[q], hi[q]) comes from.

    A window is the part above the rank's own rows (`top`), the part it
    owns (`mid`) and the part below (`bot`). The buffer holds the top and
    bottom parts of every rank's window, one after another: `pieces` lists
    (g0, g1, offset) for each, in global rows."""

    def __init__(self, height: int, size: int, rank: int,
                 lo: Sequence[int], hi: Sequence[int]):
        self.own = rows(height, size, rank)
        self.pieces: List[Tuple[int, int, int]] = []
        self.parts = []          # this rank's window: (kind, g0, g1, offset)
        offset = 0
        for q in range(size):
            a, b = rows(height, size, q)
            l, h = lo[q], hi[q]
            for kind, g0, g1 in (("top", l, min(h, a)),
                                 ("mid", max(l, a), min(h, b)),
                                 ("bot", max(l, b), h)):
                if g0 >= g1:
                    continue
                if q == rank:
                    self.parts.append((kind, g0, g1, offset))
                if kind != "mid":
                    self.pieces.append((g0, g1, offset))
                    offset += g1 - g0
        self.total = offset

    def _mine(self, g0, g1):
        """The rows of [g0, g1) this rank owns, or None."""
        a, b = self.own
        i0, i1 = max(g0, a), min(g1, b)
        return (i0, i1) if i0 < i1 else None

    def forward(self, x: torch.Tensor, group) -> torch.Tensor:
        n, c, _, w = x.shape
        a = self.own[0]
        buf = x.new_zeros(n, c, self.total, w)
        for g0, g1, off in self.pieces:
            mine = self._mine(g0, g1)
            if mine:
                i0, i1 = mine
                buf[:, :, off + i0 - g0:off + i1 - g0] = x[:, :, i0 - a:i1 - a]
        if self.total:
            dist.all_reduce(buf, group=group)
        parts = [x[:, :, g0 - a:g1 - a] if kind == "mid"
                 else buf[:, :, off:off + g1 - g0]
                 for kind, g0, g1, off in self.parts]
        if not parts:
            return x.new_zeros(n, c, 0, w)
        return torch.cat(parts, 2)

    def backward(self, grad: torch.Tensor, local_shape, group
                 ) -> torch.Tensor:
        n, c, _, w = grad.shape
        a = self.own[0]
        gbuf = grad.new_zeros(n, c, self.total, w)
        gx = grad.new_zeros(local_shape)
        at = 0
        for kind, g0, g1, off in self.parts:
            piece = grad[:, :, at:at + g1 - g0]
            if kind == "mid":
                gx[:, :, g0 - a:g1 - a] += piece
            else:
                gbuf[:, :, off:off + g1 - g0] = piece
            at += g1 - g0
        if self.total:
            dist.all_reduce(gbuf, group=group)
        for g0, g1, off in self.pieces:
            mine = self._mine(g0, g1)
            if mine:
                i0, i1 = mine
                gx[:, :, i0 - a:i1 - a] += gbuf[:, :, off + i0 - g0:
                                                off + i1 - g0]
        return gx


class _FetchRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, plan, group):
        ctx.plan, ctx.group, ctx.local_shape = plan, group, x.shape
        return plan.forward(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.plan.backward(grad, ctx.local_shape, ctx.group), None, None


def fetch_rows(x: torch.Tensor, lo: Sequence[int], hi: Sequence[int]
               ) -> torch.Tensor:
    """Rows [lo[r], hi[r]) of the H-sharded NCHW map `x` on rank r, zeros
    outside the map: `lo` and `hi` give every rank's window (each rank
    writes the rows the others need), this rank gets its own. Every rank
    calls it with the same windows."""
    ctx = _context()
    plan = _RowPlan(global_height(x), ctx.size, ctx.rank, lo, hi)
    return _FetchRows.apply(x, plan, ctx.group)


# --------------------------------------------------------------------------
# The hooks' sharded halves.
# --------------------------------------------------------------------------

def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """The per-image mean over H and W of an NCHW map, [N, C, 1, 1]: the
    psum of the local sums over the global H*W when a context is bound."""
    if _BOUND.get() is None:
        return x.mean((2, 3), keepdim=True)
    count = global_height(x) * x.shape[-1]
    total = mesh_lib.psum(x.sum((2, 3), keepdim=True, dtype=torch.float32),
                          SPATIAL_AXIS)
    return (total / count).to(x.dtype)


def moments(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch norm's E[x] and E[x^2] per channel of a float32 NCHW map
    sharded over H: the psum of the local sums over the global count."""
    count = xf.shape[0] * global_height(xf) * xf.shape[-1]
    sums = mesh_lib.psum(torch.stack([xf.sum((0, 2, 3)),
                                      xf.square().sum((0, 2, 3))]),
                         SPATIAL_AXIS)
    mean, mean2 = sums / count
    return mean, mean2


def conv_windows(height: int, kernel: int, stride: int, dilation: int,
                 pad_before: int) -> Tuple[int, List[int], List[int]]:
    """(output height, every rank's input window lo, hi) of a conv over a
    level of `height` rows: the input rows its owned output rows read,
    with 'SAME' padding `pad_before` above the image."""
    ctx = _context()
    out = -(-height // stride)
    effective = (kernel - 1) * dilation + 1
    lo, hi = [], []
    for q in range(ctx.size):
        a, b = rows(out, ctx.size, q)
        lo.append(a * stride - pad_before)
        hi.append((b - 1) * stride - pad_before + effective if b > a
                  else lo[-1])
    return out, lo, hi


def align_corners_taps(in_n: int, out_n: int, start: int, stop: int
                       ) -> Tuple[List[int], List[int], List[float]]:
    """Output indices [start, stop) of an align-corners linear resize from
    `in_n` to `out_n`: each one's first and second source index and the
    second's weight, in float32 as PyTorch's bilinear kernels take them
    (source coordinate o * (in_n - 1) / (out_n - 1))."""
    scale = (np.float32(in_n - 1) / np.float32(out_n - 1) if out_n > 1
             else np.float32(0.0))
    first, second, weight = [], [], []
    for o in range(start, stop):
        src = scale * np.float32(o)
        f = int(src)
        first.append(f)
        second.append(f + 1 if f < in_n - 1 else f)
        weight.append(float(src - np.float32(f)))
    return first, second, weight


def resize_windows(in_h: int, out_h: int):
    """The H half of an align-corners resize of a level of `in_h` global
    rows to `out_h`: every rank's source window (lo, hi), and this rank's
    owned output rows' taps (`align_corners_taps`) relative to its
    window."""
    ctx = _context()
    lo, hi = [], []
    for q in range(ctx.size):
        a, b = rows(out_h, ctx.size, q)
        if b > a:
            lo.append(align_corners_taps(in_h, out_h, a, a + 1)[0][0])
            hi.append(align_corners_taps(in_h, out_h, b - 1, b)[1][0] + 1)
        else:
            lo.append(0)
            hi.append(0)
    first, second, weight = align_corners_taps(in_h, out_h,
                                               *rows(out_h, ctx.size,
                                                     ctx.rank))
    base = lo[ctx.rank]
    return (lo, hi, [f - base for f in first], [f - base for f in second],
            weight)


# --------------------------------------------------------------------------
# The sharded forward, and a gather for checks.
# --------------------------------------------------------------------------

def _global_rows(local_rows: int, mesh: DeviceMesh, device) -> int:
    """The global height of a map whose shards have `local_rows` rows on
    this rank: their sum over the axis, checked against this rank's
    share."""
    t = torch.tensor([float(local_rows)], device=device)
    dist.all_reduce(t, group=mesh.get_group(SPATIAL_AXIS))
    height = int(t.item())
    lo, hi = rows(height, mesh.size(0), mesh.get_local_rank(SPATIAL_AXIS))
    if hi - lo != local_rows:
        raise ValueError("rank {} holds {} rows of a map of {}; its share "
                         "is rows [{}, {})".format(
                             mesh.get_local_rank(SPATIAL_AXIS), local_rows,
                             height, lo, hi))
    return height


def make_spatial_forward(model: torch.nn.Module, mesh: DeviceMesh):
    """The eval-mode forward with images sharded over H:
    forward(images_local) -> probs_local, where `images_local` is this
    rank's rows of [N, H, W, 3] images (`shard_spatial`) and the
    probabilities stay H-sharded. The params are replicated; each conv and
    resize exchanges the rows its window needs."""
    if SPATIAL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError("a spatial forward needs a mesh with the axis "
                         "{!r}; got {}".format(SPATIAL_AXIS,
                                               mesh.mesh_dim_names))

    def forward(images_local: torch.Tensor) -> torch.Tensor:
        height = _global_rows(images_local.shape[1], mesh,
                              images_local.device)
        with torch.no_grad(), bound(mesh, height, images_local.shape[2]):
            _, probs = model(images_local, train=False)
        return probs

    return forward


def gather_spatial(x_local: torch.Tensor, mesh: DeviceMesh, height: int
                   ) -> torch.Tensor:
    """Every rank's rows of an H-sharded [N, H, W, C] tensor of `height`
    global rows, put together on every rank: one sum all-reduce of the
    zero-padded shards."""
    lo, hi = rows(height, mesh.size(0), mesh.get_local_rank(SPATIAL_AXIS))
    full = x_local.new_zeros((x_local.shape[0], height) + x_local.shape[2:])
    full[:, lo:hi] = x_local
    dist.all_reduce(full, group=mesh.get_group(SPATIAL_AXIS))
    return full
