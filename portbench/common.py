"""What the harness's drivers share: the card check, the program's model
built from a configuration, the synthetic stores made on the device from
the seed, the program's weights from the reference's, the leaf-by-leaf
comparison of trained weights, and the reduction of a profiler trace to
intervals.

Imports torch, the reference and the span table at module level; the
program only inside `program_model`.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference import train as ref
from portbench.reference.model import Arch, is_buffer
from portbench.spans import SpanTable

ROOT = os.path.dirname(os.path.abspath(__file__))
FAMILIES = ("rect", "ellipse", "cross", "stripes", "triangle", "ring",
            "diamond", "lshape")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "mliis_tpu")
# The `model` keys of a configuration that the harness honours: those
# `program_model` builds from, and `image_size`, every driver's input size.
MODEL_KEYS = ("backbone", "max_block", "decoder_dim", "rsd", "n_classes",
              "final_layer_dropout_rate", "compute_dtype", "image_size")


def load_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def shrink(config: dict, small: Optional[dict]) -> dict:
    """The configuration with the CPU tests' overrides of its model's
    keys (`small["model"]`)."""
    if not small or "model" not in small:
        return config
    return dict(config, model=dict(config["model"], **small["model"]))


def program_model(config: dict, device) -> torch.nn.Module:
    """The program's EfficientLab as the configuration's `model` states it
    (the mapping of `Arch.from_config`), on `device`. Raises ValueError,
    naming the key, for a configuration the program would not honour: a
    key no driver reads, a backbone the program has no table for, a
    compute dtype it has no name for, or a `max_block` or `decoder_dim`
    other than the built model's."""
    from mliis_tpu_torch.models.efficientlab import EfficientLab
    m = config["model"]
    unread = sorted(set(m) - set(MODEL_KEYS))
    if unread:
        raise ValueError("model.{}: no driver reads it".format(unread[0]))
    if m["compute_dtype"] not in ("float32", "bfloat16"):
        raise ValueError("model.compute_dtype: {!r} is neither float32 nor "
                         "bfloat16".format(m["compute_dtype"]))
    arch = Arch.from_config(config)
    try:
        model = EfficientLab(
            n_classes=m["n_classes"], separate_background_channel=True,
            feature_extractor_name=m["backbone"], rsd=tuple(m["rsd"]),
            final_layer_dropout_rate=m["final_layer_dropout_rate"],
            compute_dtype=arch.compute_dtype)
    except KeyError as err:
        if err.args != (m["backbone"],):
            raise
        raise ValueError("model.backbone: the program has no table for "
                         "{!r}".format(m["backbone"])) from None
    features = getattr(model, model.backbone_name)
    built = {"max_block": len(features.blocks_args) - 1,
             "decoder_dim": model.final_layer_weights.kernel.shape[1]}
    for key, value in built.items():
        if m[key] != value:
            raise ValueError("model.{}: {} stated, the program builds "
                             "{}".format(key, m[key], value))
    return model.to(device)


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """The module names whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole."""
    return sorted(n for n in names
                  if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def card(chips: int) -> torch.device:
    """The first card, after checking that `chips` cards are there; exits
    with code 2 and prints no result otherwise."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: needs {} CUDA device(s), found {}".format(
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def sync(device: torch.device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# --------------------------------------------------------------------------
# Synthetic tasks, rendered on the device (the shape families of the
# program's synthetic generator: textured backgrounds, one coloured shape of
# the task's family at a random place and scale per image).
# --------------------------------------------------------------------------

def _family_masks(fam, yy, xx, cy, cx, ry, rx):
    """[n, H, W] foreground of each image's family id `fam` [n]."""
    dy, dx = (yy - cy) / ry, (xx - cx) / rx
    ady, adx = (yy - cy).abs(), (xx - cx).abs()
    t = (yy - (cy - ry)) / (2 * ry)
    r2 = dy * dy + dx * dx
    shapes = (
        (ady < ry) & (adx < rx),
        r2 < 1.0,
        ((ady < 0.35 * ry) & (adx < rx)) | ((ady < ry) & (adx < 0.35 * rx)),
        (torch.remainder(torch.floor((yy - cy + ry) / (2 * ry / 5.0)), 2)
         == 0) & (ady < ry) & (adx < rx),
        (t >= 0) & (t <= 1) & (adx < rx * t),
        (r2 < 1.0) & (r2 > 0.36),
        (ady / ry + adx / rx) < 1.0,
        ((ady < ry) & ((xx - (cx - 0.6 * rx)).abs() < 0.4 * rx))
        | (((yy - (cy + 0.6 * ry)).abs() < 0.4 * ry) & (adx < rx)),
    )
    out = torch.zeros_like(shapes[0])
    for i, m in enumerate(shapes):
        out = torch.where(fam[:, None, None] == i, m, out)
    return out


def render_tasks(families: Sequence[int], per_task: int, size: int,
                 generator: torch.Generator, chunk: int = 512
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images [T, n, H, W, 3] uint8, masks [T, n, H, W] uint8, fg 255):
    task t draws shapes of family families[t] in one colour."""
    dev = generator.device
    t = len(families)
    n = t * per_task
    fam = torch.tensor(families, device=dev).repeat_interleave(per_task)
    color = torch.empty(t, 3, device=dev).uniform_(
        100, 255, generator=generator).repeat_interleave(per_task, 0)
    images = torch.empty(n, size, size, 3, dtype=torch.uint8, device=dev)
    masks = torch.empty(n, size, size, dtype=torch.uint8, device=dev)
    grid = torch.arange(size, device=dev, dtype=torch.float32)
    yy, xx = grid[None, :, None], grid[None, None, :]
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        m = b - a

        def u(lo, hi, shape):
            return torch.empty(shape, device=dev).uniform_(
                lo, hi, generator=generator)

        img = torch.randint(0, 256, (m, size, size, 3), generator=generator,
                            device=dev).float() * 0.3 + u(0, 150, (m, 1, 1, 3))
        cy, cx = u(0.25 * size, 0.75 * size, (2, m, 1, 1))
        ry, rx = u(0.1 * size, 0.25 * size, (2, m, 1, 1))
        fg = _family_masks(fam[a:b], yy, xx, cy, cx, ry, rx)
        shade = color[a:b, None, None, :] + 10.0 * torch.randn(
            (m, size, size, 3), generator=generator, device=dev)
        img = torch.where(fg[..., None], shade, img)
        images[a:b] = img.clamp(0, 255).to(torch.uint8)
        masks[a:b] = fg.to(torch.uint8) * 255
    return (images.view(t, per_task, size, size, 3),
            masks.view(t, per_task, size, size))


# --------------------------------------------------------------------------
# The profiler's trace as intervals.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """A profiled slice: device activity and host ops as (name, start_us,
    end_us), the slice's wall seconds, and what the driver says of it."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    inner_steps: int
    augment_batch: int
    image_size: int
    window_flops: float = 0.0
    window_s: float = 0.0
    compute: str = "bfloat16"
    spans: Optional[SpanTable] = None   # the span slice's, where profiled

    @property
    def kernels(self) -> List[Tuple[str, float, float]]:
        return [e for e in self.device if not is_copy(e[0])]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Sequence[Tuple[float, float]]
         ) -> List[Tuple[float, float]]:
    """The idle stretches between the union's pieces, (start, end)."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def trace_from_profile(prof) -> Tuple[list, list]:
    """(device events, host events) of a torch.profiler run."""
    device, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        row = (evt.name, float(tr.start), float(tr.end))
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    return device, host


def breakdown(trace: Trace, named: Optional[Trace] = None,
              top: int = 10) -> Dict[str, list]:
    """The device ops of `trace` that took most time, summed by name, and
    the longest idle gaps of `named` (a slice profiled with the host's ops
    too; `trace` itself by default), each named by the innermost host op
    running at the gap's middle."""
    named = trace if named is None else named
    by_name: Dict[str, float] = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(s, e) for _, s, e in named.device]),
                  key=lambda g: g[0] - g[1])[:top]
    host = sorted(named.host, key=lambda h: h[1])
    out = []
    for s, e in idle:
        mid = (s + e) / 2
        inner = None
        for name, hs, he in host:
            if hs > mid:
                break
            if he >= mid and (inner is None or hs >= inner[1]):
                inner = (name, hs)
        out.append([inner[0] if inner else "(no host op)", (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}


def load_port_weights(model: torch.nn.Module, w: Dict[str, torch.Tensor]
                      ) -> None:
    """Copy the benchmark's weights into the program's module, name for
    name; every weight and running stat has to be there, and no more."""
    own = dict(model.named_parameters())
    own.update(dict(model.named_buffers()))
    if set(own) != set(w):
        raise KeyError("weights differ from the program's by name: {}".format(
            sorted(set(own) ^ set(w))[:8]))
    with torch.no_grad():
        for k, v in own.items():
            if tuple(v.shape) != tuple(w[k].shape):
                raise ValueError("{}: {} vs {}".format(k, tuple(v.shape),
                                                       tuple(w[k].shape)))
            v.copy_(w[k])


def leaf_checks(w0, prog_after, ref_after, limits) -> List[tuple]:
    """(name, value, limit) over the weights the reference moves: the worst
    leaf's gap of the norm of the first update and of the change after the
    last checked step, and the median leaf's gap of each; where the states
    hold running stats, the median batch-norm buffer's norm of the
    difference after the first step over the reference's norm."""
    last = max(ref_after)
    names = [k for k in ref_after[1] if not is_buffer(k)]
    ref_first = {k: ref_after[1][k] - w0[k] for k in names}
    keep = ref.moving_leaves(ref_first)
    out = []
    for label, step in (("first_update", 1), ("change", last)):
        prog = {k: prog_after[step][k] - w0[k] for k in names}
        refd = {k: ref_after[step][k] - w0[k] for k in names}
        worst, _ = ref.leaf_gap(prog, refd, keep)
        median = ref.median_leaf_gap(prog, refd, keep)
        out += [(label + "_gap", worst, limits.get(label + "_gap")),
                (label + "_median_gap", median,
                 limits.get(label + "_median_gap"))]
    stats = [k for k in ref_after[1] if is_buffer(k)]
    if stats:
        stat_gaps = sorted(float((prog_after[1][k] - ref_after[1][k]).norm()
                             / ref_after[1][k].norm().clamp(min=1e-30))
                       for k in stats)
        out.append(("stats_median_gap", stat_gaps[len(stat_gaps) // 2],
                    limits.get("stats_median_gap")))
    return out
