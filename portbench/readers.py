"""The arithmetic the per-layer metric files share, over a profiled
slice (`common.Trace`). A reader that finds nothing to read returns None,
and the harness leaves its metric out."""
from typing import Callable, Optional

from portbench import counts
from portbench.common import Trace, union_us


def idle_pct(trace: Trace) -> Optional[float]:
    """100 * (1 - the union of the device's activity / the slice's wall)."""
    if not trace.device or trace.wall_s <= 0:
        return None
    busy = union_us([(s, e) for _, s, e in trace.device]) / 1e6
    return 100.0 * (1.0 - busy / trace.wall_s)


def launches_per_inner_step(trace: Trace) -> Optional[float]:
    """Device kernels in the slice over its inner steps."""
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.inner_steps


def roofline_pct(trace: Trace, kernel: str,
                 bytes_of: Callable[[int, int], int]) -> Optional[float]:
    """100 * the least time the kernel's bytes take at HBM3's peak over its
    mean device time in the slice (launches whose name holds `kernel`).
    Its operations bound it below its bytes at these sizes (PERF.md)."""
    times = [e - s for n, s, e in trace.kernels if kernel in n]
    if not times:
        return None
    mean_s = sum(times) / len(times) / 1e6
    least = bytes_of(trace.augment_batch, trace.image_size) \
        / counts.PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / mean_s


def step_mfu_pct(trace: Trace) -> Optional[float]:
    """100 * the window's counted FLOPs / its seconds / the card's peak in
    the configuration's compute dtype."""
    if trace.window_s <= 0 or trace.window_flops <= 0:
        return None
    return 100.0 * trace.window_flops / trace.window_s \
        / counts.PEAKS[trace.compute]
