"""Whole-run traces and phase timing for the training and evaluation loops.

The port of the JAX package's `utils/profiling.py`:
  - `trace(log_dir)`: a `torch.profiler` trace of a block, host activity
    and, on a CUDA device, the card's kernels, written into `log_dir` as a
    gzip-compressed Chrome trace (`<time>.pt.trace.json.gz`, which
    chrome://tracing and Perfetto read; a few dozen inner steps of the
    float32 model make about 150 MB of JSON, a tenth of that compressed)
    where the JAX package writes a TensorBoard profile;
  - `span(name, step)`: a named range on the profiler's timeline at a layer
    boundary of the program, opened only inside `spans()` (and so inside
    `trace`); otherwise a shared no-op;
  - `PhaseTimer`: wall-clock seconds accumulated per named phase, with a
    JSONL export. On a CUDA device a phase ends with a
    `torch.cuda.synchronize`, so it holds the device's time and not the
    time to enqueue the work (the JAX package's `train_gecko` blocks on
    the state for the same reason). Each phase is a `span`.

The spans the program opens, innermost layer last:
  - `joint.step` (`JointTrainer.train_step`, the root; its input is the
    trainer's step index) with, inside it, `joint.batch` (the batch's
    gather from the device store and its float cast) and `joint.backward`
    (the gradients, and a mesh's average of them);
  - `augment.light`, `augment.full_pass`, `augment.cheap_pass` (the
    augmentation wrappers of `ops/augment_kernels`, kernel or plain
    version);
  - `model.forward` (`EfficientLab.forward`);
  - `loss.head` (`joint/trainer.resized_cross_entropy`: the resize to the
    labels and the cross entropy, all chunks);
  - `loss.l2` (`ops/losses.l2_term`) and `optimizer.apply`
    (`meta/inner_loop.apply_optimizer_`);
  - the `PhaseTimer` phases of `meta/train.train_gecko` (`meta_step`,
    `eval_train`, `eval_test`).
A span is a `record_function` range: its host start and end share the
clock of the device activity in a profile that records the host's ops, and
the spans of one step nest inside its `joint.step` (whose step index a
profile with `record_shapes=True` shows as the range's input). The autograd
engine's backward nodes carry the sequence number of the forward op they
differentiate, which puts backward kernels down to the forward op's span.
"""
import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch

_NO_SPAN = contextlib.nullcontext()
_spans_on = False


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[str]:
    """Profile the block, with the program's spans on, and write its
    gzip-compressed Chrome trace into `log_dir`; yields the trace file's
    path. CUDA activity is recorded when `device` is a CUDA device
    (default: the card, when torch has one)."""
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
        with spans():
            yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        profiler.stop()
        profiler.export_chrome_trace(path)


@contextlib.contextmanager
def spans() -> Iterator[None]:
    """Open the program's spans inside the block (they are off outside
    it); the setting is the process's, restored on exit."""
    global _spans_on
    saved, _spans_on = _spans_on, True
    try:
        yield
    finally:
        _spans_on = saved


class _Span:
    """An open `record_function` range with `args` as its inputs (through
    the entry `torch.profiler` itself uses for ranges with arguments:
    `record_function`'s one string argument is not kept in a trace)."""
    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


def span(name: str, step: Optional[int] = None):
    """The named range around a block of the program, with `step` as its
    input, while `spans()` is on; else one shared no-op context, which
    reads no clock and records nothing."""
    if not _spans_on:
        return _NO_SPAN
    return _Span(name, () if step is None else (step,))


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
            with span(name):
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
