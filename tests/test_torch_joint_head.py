"""The joint step's loss head (`ops/resized_ce`), on the CPU.

  - Its plain route against the composition the head replaces:
    `F.interpolate` to the labels' size and `F.cross_entropy`, a batch
    chunk at a time, through autograd; loss and gradient within 1e-6
    relative, the gradient in the logits' memory format; a float64
    `gradcheck` of the hand-derived backward.
  - The kernels' tables (`resized_ce_plan`): a float64 emulation of
    csrc/resized_ce.cu's blocking (forward units and column tiles; backward
    bands, column tiles, channel chunks, the halo cell row and the carried
    row) against the plain version, at shapes that cut each of them.
  - A label out of range raises on the plain route; the head refuses a
    bound spatial context.
  - The head's span: with spans on, the Function's forward and backward
    ops fall under `loss.head` through `portbench/spans.py`'s `reduce`.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as jt
from mliis_tpu_torch.meta import inner_loop as il
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops import kernel_library
from mliis_tpu_torch.ops import resized_ce as rce
from mliis_tpu_torch.utils import profiling
from portbench import spans


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, c, h, w, out_h, out_w, seed=0, layout="contiguous",
            labels="float", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    low = (torch.randn(n, c, h, w, generator=g) * 3).to(dtype)
    if layout == "channels_last":
        low = low.contiguous(memory_format=torch.channels_last)
    lab = torch.randint(0, c, (n, out_h, out_w), generator=g)
    lab = lab.float() if labels == "float" else lab.to(torch.int32)
    return low, lab


def _composition(low, labels, eps, chunk):
    """The head this module replaces: resize and CE a chunk at a time."""
    n = low.shape[0]
    out_h, out_w = labels.shape[1:]
    total = 0.0
    for i in range(0, n, chunk):
        logits = F.interpolate(low[i:i + chunk], size=(out_h, out_w),
                               mode="bilinear", align_corners=True)
        total = total + F.cross_entropy(logits, labels[i:i + chunk].long(),
                                        label_smoothing=eps, reduction="sum")
    return total / (n * out_h * out_w)


def _loss_and_grad(fn, low, *args):
    low = low.detach().requires_grad_(True)
    loss = fn(low, *args)
    (grad,) = torch.autograd.grad(loss, low)
    return loss.detach(), grad


SHAPES = {"odd": (3, 13, 7, 9, 30, 33), "wide": (2, 1001, 6, 6, 21, 21)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("labels", ["float", "int"])
def test_plain_route_matches_the_chunked_composition(shape, eps, layout,
                                                     labels):
    """Loss within 1e-6 rel of the composition in float32 and in float64,
    gradient within 1e-6 of its norm of the composition in float64, the
    gradient in the logits' memory format; no kernel launch on the CPU.
    (The float32 composition's own smoothed gradient lies 1.8e-6 of its
    norm from its float64 at C = 1001: PyTorch's log-softmax backward
    rounds there.)"""
    n, c, h, w, out_h, out_w = SHAPES[shape]
    low, lab = _inputs(n, c, h, w, out_h, out_w, layout=layout,
                       labels=labels)
    launches = kernel_library.launches["resized_ce"]
    loss, grad = _loss_and_grad(rce.resized_ce, low, lab, eps, 2)
    ref_loss, _ = _loss_and_grad(_composition, low, lab, eps, 2)
    exact_loss, exact_grad = _loss_and_grad(_composition, low.double(), lab,
                                            eps, 2)
    assert kernel_library.launches["resized_ce"] == launches
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(exact_loss), rtol=1e-6)
    assert float((grad.double() - exact_grad).norm()) \
        <= 1e-6 * float(exact_grad.norm())
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    assert grad.is_contiguous(memory_format=fmt)
    # The whole batch at once gives the same numbers as chunks of 2.
    whole_loss, whole_grad = _loss_and_grad(rce.resized_ce, low, lab, eps)
    np.testing.assert_allclose(float(whole_loss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(whole_grad.numpy(), grad.numpy(), rtol=1e-6,
                               atol=1e-12)


def test_hand_derived_backward_passes_gradcheck():
    low, lab = _inputs(2, 5, 4, 4, 9, 11, seed=3, labels="int",
                       dtype=torch.float64)
    low.requires_grad_(True)
    for eps in (0.0, 0.1):
        assert torch.autograd.gradcheck(
            lambda x: rce.ResizedCrossEntropy.apply(x, lab, eps, None),
            (low,), eps=1e-6, atol=1e-8, rtol=1e-6)


def test_wrapper_checks_its_inputs():
    low, lab = _inputs(2, 5, 4, 4, 9, 11)
    with pytest.raises(ValueError):
        rce.resized_ce(low.double(), lab)
    with pytest.raises(ValueError):
        rce.resized_ce(low, lab[:1])
    with pytest.raises(ValueError):
        rce.resized_ce(low.to("meta"), lab.to("meta"))


@pytest.mark.parametrize("bad", [5, -1])
@pytest.mark.parametrize("labels", ["float", "int"])
def test_plain_route_raises_on_a_label_out_of_range(bad, labels):
    """A label outside [0, C) raises, as `F.cross_entropy` does; the
    kernels make the loss and gradient NaN instead."""
    low, lab = _inputs(2, 5, 4, 4, 9, 11, labels=labels)
    lab[1, 3, 4] = bad
    with pytest.raises((RuntimeError, IndexError)):
        rce.resized_ce(low, lab)


def test_joint_head_refuses_a_bound_spatial_context(monkeypatch):
    """The head takes whole images: under a bound spatial context (H
    shards) it raises rather than take a shard for an image."""
    low, lab = _inputs(2, 5, 4, 4, 9, 11)
    monkeypatch.setattr(jt.spatial, "current", lambda: object())
    with pytest.raises(ValueError):
        jt.resized_cross_entropy(low, lab)


def test_axis_taps_are_pytorchs():
    """Interpolating with the taps reproduces `F.interpolate` to float32
    rounding, the corners exactly; `start` groups the output points by
    their first tap."""
    for n_in, n_out in ((56, 224), (7, 30), (9, 5), (1, 4), (5, 1)):
        lo, frac, start = rce.axis_taps(n_in, n_out)
        x = torch.randn(1, 1, 1, n_in)
        hi = np.minimum(lo + 1, n_in - 1)
        fr = torch.from_numpy(frac).double()
        mine = x[..., lo].double() * (1 - fr) + x[..., hi].double() * fr
        ref = F.interpolate(x, size=(1, n_out), mode="bilinear",
                            align_corners=True)
        np.testing.assert_allclose(mine.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)
        assert float(mine[..., 0]) == float(x[..., 0])
        assert len(start) == n_in + 1 and start[-1] == n_out
        for i in range(n_in):
            assert (lo[start[i]:start[i + 1]] == i).all()


def _emulate(low, labels, eps, plan):
    """csrc/resized_ce.cu's blocking in float64: (loss, stats, gradient of
    the loss)."""
    low = low.double()
    n, c, h, w = low.shape
    out_h, out_w = labels.shape[1:]
    ystart = plan.ystart.numpy()
    yfrac = plan.yfrac.double()
    xlo, xfrac = plan.xlo.numpy(), plan.xfrac.double()
    xstart = plan.xstart.numpy()
    lab = labels.long()
    lse = torch.full((n, out_h, out_w), float("nan"), dtype=torch.float64)
    total = 0.0

    def taps(b, i, x_begin, x_count, j_lo, span, c0, kc):
        """z [kc, x_count] at the two input rows of cell row i."""
        i1 = i + (i < h - 1)
        s = low[b, c0:c0 + kc][:, [i, i1], j_lo:j_lo + span]
        x = np.arange(x_begin, x_begin + x_count)
        j0 = xlo[x] - j_lo
        j1 = j0 + (xlo[x] < w - 1)
        lx = xfrac[x]
        u = s[:, :, j0] * (1 - lx) + s[:, :, j1] * lx
        return u[:, 0], u[:, 1]

    for b in range(n):
        for i, y_begin, rows, _ in plan.units.tolist():
            for x_begin, x_count, j_lo, span, *_ in plan.fwd_tiles.tolist():
                assert rows <= rce.MAX_ROWS and x_count <= rce.THREADS
                u0, u1 = taps(b, i, x_begin, x_count, j_lo, span, 0, c)
                for y in range(y_begin, y_begin + rows):
                    ly = yfrac[y]
                    z = u0 * (1 - ly) + u1 * ly
                    s = torch.logsumexp(z, 0)
                    cols = slice(x_begin, x_begin + x_count)
                    assert lse[b, y, cols].isnan().all()
                    lse[b, y, cols] = s
                    picked = z.gather(0, lab[b, y, cols][None])[0]
                    total += float((s - (1 - eps) * picked
                                    - eps / c * z.sum(0)).sum())
    assert not lse.isnan().any()

    grad = torch.full_like(low, float("nan"))
    scale = 1.0 / (n * out_h * out_w)
    for b in range(n):
        for i0 in range(0, h, rce.BAND):
            i_end = min(i0 + rce.BAND, h)
            for (x_begin, x_count, j_lo, span, j_begin, j_end,
                 _, _) in plan.bwd_tiles.tolist():
                x = np.arange(x_begin, x_begin + x_count)
                edge = xlo[x] == w - 1
                wx0 = torch.where(torch.from_numpy(edge), 1 - xfrac[x] +
                                  xfrac[x], 1 - xfrac[x])
                wx1 = torch.where(torch.from_numpy(edge),
                                  torch.zeros_like(xfrac[x]), xfrac[x])
                for c0 in range(0, c, rce.BWD_CHUNK):
                    kc = min(rce.BWD_CHUNK, c - c0)
                    carry = torch.zeros(kc, j_end - j_begin,
                                        dtype=torch.float64)
                    for ic in range(max(i0 - 1, 0), i_end):
                        fold = ic == h - 1
                        u0, u1 = taps(b, ic, x_begin, x_count, j_lo, span,
                                      c0, kc)
                        e = torch.zeros(2, kc, x_count, dtype=torch.float64)
                        for y in range(ystart[ic], ystart[ic + 1]):
                            ly = yfrac[y]
                            w0, w1 = (1.0, 0.0) if fold else (1 - ly, ly)
                            z = u0 * (1 - ly) + u1 * ly
                            p = torch.exp(z - lse[b, y, x]) - eps / c
                            hit = lab[b, y, x] - c0
                            (cols,) = torch.nonzero((hit >= 0) & (hit < kc),
                                                    as_tuple=True)
                            p[hit[cols], cols] -= 1 - eps
                            e[0] += w0 * p
                            e[1] += w1 * p
                        for jj, j in enumerate(range(j_begin, j_end)):
                            mine = slice(xstart[j] - x_begin,
                                         xstart[j + 1] - x_begin)
                            top = (e[:, :, mine] * wx0[mine]).sum(-1)
                            if j > 0:
                                left = slice(xstart[j - 1] - x_begin,
                                             xstart[j] - x_begin)
                                top = top + (e[:, :, left]
                                             * wx1[left]).sum(-1)
                            if ic >= i0:
                                cell = grad[b, c0:c0 + kc, ic, j]
                                assert cell.isnan().all()
                                grad[b, c0:c0 + kc, ic, j] = \
                                    (carry[:, jj] + top[0]) * scale
                            carry[:, jj] = top[1]
    assert not grad.isnan().any()
    return total * scale, lse, grad


KERNEL_SHAPES = {
    # the cell's geometry, cut in batch and channels: two backward chunks
    # and the last one ragged
    "cell": (1, 20, 56, 56, 224, 224),
    # odd sizes, three bands, C below a chunk
    "odd": (2, 5, 17, 9, 41, 30),
    # downsampling: cell rows and columns with no output point
    "down": (1, 7, 11, 13, 5, 6),
    # output rows and columns wider than a thread block: several forward
    # units a cell row, several column tiles each way
    "tiles": (1, 3, 3, 40, 20, 700),
    # single input row and column, single output row and column
    "points": (2, 4, 1, 1, 3, 5),
    "to_one": (1, 4, 3, 4, 1, 1),
}


@pytest.mark.parametrize("name", sorted(KERNEL_SHAPES))
def test_kernel_blocking_covers_every_pixel_once(name):
    """Each output pixel's statistics and each input pixel's gradient are
    written by exactly one (unit, tile) and one (band, tile, chunk), and the
    emulated kernels equal the plain version: loss within 1e-6 rel, the
    gradient within 1e-5 of its norm, the log-sum-exp within 1e-5."""
    n, c, h, w, out_h, out_w = KERNEL_SHAPES[name]
    low, lab = _inputs(n, c, h, w, out_h, out_w, seed=7)
    plan = rce.resized_ce_plan(h, w, out_h, out_w, torch.device("cpu"))
    assert plan.fwd_smem <= rce.MAX_SMEM and plan.bwd_smem <= rce.MAX_SMEM
    for eps in (0.0, 0.1):
        loss, lse, grad = _emulate(low, lab, eps, plan)
        ref_loss, ref_lse = rce.resized_ce_forward_reference(low, lab, eps)
        ref_grad = rce.resized_ce_backward_reference(
            low, lab, ref_lse, torch.tensor(1.0), eps)
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
        np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert float((grad - ref_grad).norm()) \
            <= 1e-5 * float(ref_grad.norm())


def test_tables_of_the_cells_shape():
    """56^2 -> 224^2: one column tile each way over all 224 columns, 56
    forward units of 1 to 5 rows, the shared memory under 48 KB."""
    plan = rce.resized_ce_plan(56, 56, 224, 224, torch.device("cpu"))
    assert plan.fwd_tiles.tolist() == [[0, 224, 0, 56, 0, 0, 0, 0]]
    (tile,) = plan.bwd_tiles.tolist()
    assert tile[:6] == [0, 224, 0, 56, 0, 56]
    rows = plan.units[:, 2].tolist()
    assert len(rows) == 56 and sum(rows) == 224 and max(rows) <= 5
    assert plan.fwd_smem <= rce.MAX_SMEM and plan.bwd_smem <= rce.MAX_SMEM


def test_the_heads_function_is_all_in_the_loss_head_span(tmp_path):
    """A tiny joint step profiled with spans on, with a made-up kernel
    launched from each host op of the head's Function and of its backward
    node: portbench/spans.py's `reduce` puts every one of them down to
    `loss.head`, none to joint.backward."""
    store = make_synthetic_store(num_tasks=3, examples_per_task=4,
                                 image_size=32, seed=0)
    ds = jt.joint_dataset_from_task_store(store)
    model = EfficientLab(n_classes=ds.num_classes, rsd=(2,))
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = jt.JointTrainer(
        model, ds, ds, jt.JointTrainConfig(batch_size=2, augment=True),
        il.OptimizerConfig("sgd"), device="cpu", log_fn=lambda *_: None)
    opt = il.init_opt_state(dict(model.named_parameters()),
                            il.OptimizerConfig("sgd"))
    args = (torch.tensor([0, 5]), torch.tensor([3, 4], dtype=torch.int32),
            0.01, torch.Generator().manual_seed(1))
    trainer.train_step(opt, *args)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            profiling.spans():
        trainer.train_step(opt, *args)
    path = os.path.join(str(tmp_path), "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    name = rce.ResizedCrossEntropy.__name__
    (fwd,) = [e for e in ops if e["name"] == name]
    (node,) = [e for e in ops if e["name"]
               == "autograd::engine::evaluate_function: " + name + "Backward"]
    # Every op in the Function and in the node, but the node's own row: work
    # of its own (gradient accumulation) is joint.backward's.
    head = [e for e in ops for r in (fwd, node)
            if _inside(e, r) and e is not node]
    assert {"aten::exp", "aten::upsample_bilinear2d_backward"} \
        <= {e["name"] for e in head if _inside(e, node)}
    table = spans.reduce(events + _stand_in_launches(head), wall_s=1.0)
    assert table.steps == 1
    assert table.device_us == {"loss.head": pytest.approx(len(head))}
    assert table.launches == {"loss.head": len(head)}


def _ns(e):
    start = round(e["ts"] * 1e3)
    return start, start + round(e["dur"] * 1e3)


def _inside(e, outer):
    """Whether host row `e` lies within host row `outer` (itself too)."""
    (s, t), (os_, ot) = _ns(e), _ns(outer)
    return e["tid"] == outer["tid"] and os_ <= s and t <= ot


def _stand_in_launches(rows):
    """For each host op of `rows`, a made-up CUDA launch call at its start
    and the 1 us kernel it launched, joined by their correlation id: the
    device work that op would make on the card."""
    out = []
    for k, e in enumerate(rows):
        corr = 10 ** 9 + k
        out.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "pid": e["pid"],
                    "tid": e["tid"], "ts": e["ts"], "dur": 0,
                    "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": "kernel", "name": "stand_in",
                    "pid": 0, "tid": 7, "ts": e["ts"], "dur": 1.0,
                    "args": {"correlation": corr}})
    return out
