"""Whole-run traces and phase timing for the training and evaluation loops.

The port of the JAX package's `utils/profiling.py`:
  - `trace(log_dir)`: a `torch.profiler` trace of a block, host activity
    and, on a CUDA device, the card's kernels, written into `log_dir` as a
    gzip-compressed Chrome trace (`<time>.pt.trace.json.gz`, which
    chrome://tracing and Perfetto read; a few dozen inner steps of the
    float32 model make about 150 MB of JSON, a tenth of that compressed)
    where the JAX package writes a TensorBoard profile;
  - `annotate(name)`: a `torch.profiler.record_function` range, so a phase
    shows up on a profiler timeline;
  - `PhaseTimer`: wall-clock seconds accumulated per named phase, with a
    JSONL export. On a CUDA device a phase ends with a
    `torch.cuda.synchronize`, so it holds the device's time and not the
    time to enqueue the work (the JAX package's `train_gecko` blocks on
    the state for the same reason). Inside `trace`, each phase is a range
    on the trace's timeline.
"""
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[str]:
    """Profile the block and write its gzip-compressed Chrome trace into
    `log_dir`; yields the trace file's path. CUDA activity is recorded
    when `device` is a CUDA device (default: the card, when torch has
    one)."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, time.strftime("%Y%m%d_%H%M%S")
                        + ".pt.trace.json.gz")
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(path)


def annotate(name: str):
    """Named range on profiler timelines."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates wall-clock per named phase; `device` is the device whose
    work a phase waits for at its end (None or a CPU device: no wait)."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            with annotate(name):
                yield
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}

    def dump(self, path: Optional[str] = None, log_fn=print) -> None:
        payload = json.dumps(self.summary(), sort_keys=True)
        if path is not None:
            with open(path, "a") as f:
                f.write(payload + "\n")
        log_fn("phase timings: {}".format(payload))
