"""The program's spans in a profiled slice: each device event and each idle
gap of the device put down to the span of the program that caused it.

The program opens named `record_function` ranges at its layer boundaries
(`mliis_tpu_torch.utils.profiling.span`, off unless switched on; the
joint step's root is `joint.step`). `profile_spans(cell)` runs the cell's
fixed slice once more with them on, the host's ops and the card's
activity profiled, and `reduce` puts down, from the slice's Chrome trace:

  - each device event that is a kernel, memcpy or memset (its `cat`; GPU
    annotations and CUPTI's overhead rows are dropped) to the CUDA API
    call that launched it, by their shared `correlation` id, and so to
    the innermost host op around that call (the event's linked
    `External id` names only an op, and the kernels the program launches
    through ctypes have none around them, only their span);
  - an op inside an autograd node's call (`autograd::engine::
    evaluate_function: X` and, inside it, `X`) to the forward op that
    node differentiates: the last op of the node's sequence number on the
    node's forward thread; other backward work (gradient accumulation,
    nodes with no forward op) stays with the span around the node, the
    step's `joint.backward`;
  - the op to the innermost span around it, or to OUTSIDE;
  - the times in integer ns, as the profiler took them, so that nesting
    is exact;
  - each idle gap of the device's union to the innermost span of the
    host's main thread (the roots' thread) at the gap's middle.

Every kept device event is counted once. A traced run (run.py's
`run_cell`) profiles this slice third, after the slice on the card alone
and the one with the host's ops, and hands its table to the metric
readers as `common.Trace.spans` (None where the program has no spans).
"""
import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = "joint.step"
OUTSIDE = "(outside spans)"
KEPT = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation")
CALLS = ("cuda_runtime", "cuda_driver")
SPAN = "user_annotation"
EVALUATE = "autograd::engine::evaluate_function: "


@dataclasses.dataclass
class SpanTable:
    """Totals over the slice by span name, and its steps (root spans)."""
    steps: int
    wall_s: float
    device_us: Dict[str, float]
    launches: Dict[str, int]
    idle_us: Dict[str, float]
    host_self_us: Dict[str, float]
    step_idle_us: float
    kept_us: float
    dropped: Dict[str, Tuple[int, float]]   # other rows: cat -> (rows, us)

    def device_ms(self, *names: str) -> Optional[float]:
        """Device ms a step put down to the spans `names`."""
        if not self.steps:
            return None
        return sum(self.device_us.get(n, 0.0) for n in names) \
            / self.steps / 1e3

    def launches_per_step(self, *names: str) -> Optional[float]:
        if not self.steps:
            return None
        return sum(self.launches.get(n, 0) for n in names) / self.steps

    def step_idle_pct(self) -> Optional[float]:
        """100 * the device's idle time while the main thread is inside a
        root span, over the slice's wall."""
        if not self.steps or self.wall_s <= 0:
            return None
        return 100.0 * self.step_idle_us / 1e6 / self.wall_s

    def rows(self) -> List[list]:
        """[span, device ms, launches, idle ms, host self ms] a step, by
        device time."""
        names = set(self.device_us) | set(self.idle_us) \
            | set(self.host_self_us)
        per = max(self.steps, 1)
        out = [[n, self.device_us.get(n, 0.0) / per / 1e3,
                self.launches.get(n, 0) / per,
                self.idle_us.get(n, 0.0) / per / 1e3,
                self.host_self_us.get(n, 0.0) / per / 1e3] for n in names]
        return sorted(out, key=lambda r: -r[1])


class _Host:
    """The host's ops, spans and CUDA API calls of a trace, nested per
    thread (times in integer ns, as the profiler took them); the main
    thread is the one of the `root` spans."""

    def __init__(self, events: Sequence[dict], root: str = ROOT):
        rows = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in HOST + CALLS]
        ns = [(round(e["ts"] * 1e3), round(e["dur"] * 1e3)) for e in rows]
        order = sorted(range(len(rows)), key=lambda i: (
            rows[i]["tid"], ns[i][0], -ns[i][1]))
        self.rows = [rows[i] for i in order]
        self.start = [ns[i][0] for i in order]
        self.end = [ns[i][0] + ns[i][1] for i in order]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        tid = None
        for i, e in enumerate(self.rows):
            if e["tid"] != tid:
                tid, stack = e["tid"], []
            while stack and self.end[stack[-1]] < self.end[i]:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)
        self.calls = {e["args"]["correlation"]: i
                      for i, e in enumerate(self.rows)
                      if e["cat"] in CALLS and "correlation" in e["args"]}
        # Forward ops by (thread, sequence number): the last to start is
        # the one that made the autograd node (ops after it read the next
        # number).
        self.forward: Dict[tuple, int] = {}
        for i, e in enumerate(self.rows):
            a = e.get("args", {})
            if a.get("Sequence number", -1) >= 0 \
                    and not a.get("Fwd thread id"):
                self.forward[(e["tid"], a["Sequence number"])] = i
        self.fwd_tid = self._forward_threads()
        self._span: Dict[int, str] = {}
        self.roots = [i for i, e in enumerate(self.rows)
                      if e["cat"] == SPAN and e["name"] == root]
        self.main = self.rows[self.roots[0]]["tid"] if self.roots else None
        self.main_spans = [i for i, e in enumerate(self.rows)
                           if e["cat"] == SPAN and e["tid"] == self.main]

    def _forward_threads(self) -> Dict[int, object]:
        """The profiler's forward-thread ids of the backward nodes, mapped
        to the trace's thread ids: the thread holding most of their
        forward ops' sequence numbers."""
        votes: Dict[int, Dict[object, int]] = defaultdict(
            lambda: defaultdict(int))
        threads = {t for t, _ in self.forward}
        for e in self.rows:
            a = e.get("args", {})
            if e["name"].startswith(EVALUATE) and a.get("Fwd thread id"):
                for t in threads:
                    if (t, a.get("Sequence number")) in self.forward:
                        votes[a["Fwd thread id"]][t] += 1
        return {f: max(v, key=v.get) for f, v in votes.items()}

    def span_of(self, i: Optional[int]) -> str:
        """The innermost span around row `i` (itself, if a span)."""
        j, seen = i, []
        while j is not None:
            if j in self._span:
                name = self._span[j]
                break
            seen.append(j)
            if self.rows[j]["cat"] == SPAN:
                name = self.rows[j]["name"]
                break
            j = self.parent[j]
        else:
            name = OUTSIDE
        for k in seen:
            self._span[k] = name
        return name

    def span_at(self, t: int) -> str:
        """The innermost span of the main thread open at time `t` (ns)."""
        inner = None
        for i in self.main_spans:
            if self.start[i] > t:
                break
            if self.end[i] >= t:
                inner = i
        return OUTSIDE if inner is None else self.rows[inner]["name"]

    def attribute(self, i: int) -> str:
        """The span that the device work of row `i` (an op or the CUDA
        call that launched it) belongs to."""
        below, j = None, i
        while j is not None and not self.rows[j]["name"].startswith(
                EVALUATE):
            below, j = j, self.parent[j]
        if j is not None and below is not None and self.rows[below][
                "name"] == self.rows[j]["name"][len(EVALUATE):]:
            a = self.rows[j].get("args", {})
            f = self.forward.get((self.fwd_tid.get(a.get("Fwd thread id")),
                                  a.get("Sequence number")))
            if f is not None:
                return self.span_of(f)
        # Other backward work runs on the autograd engine's thread, which
        # opens no span: it belongs to the main thread's span that waits
        # for it (the step's joint.backward).
        k = i if j is None else j
        name = self.span_of(k)
        if name == OUTSIDE and self.rows[k]["tid"] != self.main:
            name = self.span_at(self.start[k])
        return name


def _minus(spans: Sequence[Tuple[int, int]],
           busy: Sequence[Tuple[int, int]]) -> int:
    """Length of the union of `spans` outside the sorted, disjoint `busy`
    pieces."""
    starts = [s for s, _ in busy]
    total, end = 0, None
    for s, e in sorted(spans):
        s = s if end is None else max(s, end)
        if e <= s:
            continue
        end = e
        length = e - s
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(busy) and busy[k][0] < e:
            length -= max(0, min(e, busy[k][1]) - max(s, busy[k][0]))
            k += 1
        total += length
    return total


def _pieces(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of the intervals as sorted, disjoint pieces."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events: Sequence[dict], wall_s: float,
           root: str = ROOT) -> SpanTable:
    """The slice's Chrome trace events put down to spans (module doc)."""
    host = _Host(events, root)
    device_ns: Dict[str, int] = defaultdict(int)
    launches: Dict[str, int] = defaultdict(int)
    dropped: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    kept = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat in HOST + CALLS:
            continue
        if cat not in KEPT:
            dropped[cat][0] += 1
            dropped[cat][1] += e["dur"]
            continue
        s, d = round(e["ts"] * 1e3), round(e["dur"] * 1e3)
        i = host.calls.get(e.get("args", {}).get("correlation"))
        name = OUTSIDE if i is None else host.attribute(i)
        device_ns[name] += d
        launches[name] += cat == "kernel"
        kept.append((s, s + d))

    busy = _pieces(kept)
    idle_ns: Dict[str, int] = defaultdict(int)
    for (_, s), (e, _) in zip(busy, busy[1:]):
        idle_ns[host.span_at((s + e) // 2)] += e - s
    host_self: Dict[str, int] = defaultdict(int)
    for i, e in enumerate(host.rows):
        if e["cat"] == SPAN:
            host_self[e["name"]] += host.end[i] - host.start[i]
            p = host.parent[i]
            while p is not None and host.rows[p]["cat"] != SPAN:
                p = host.parent[p]
            if p is not None:
                host_self[host.rows[p]["name"]] -= host.end[i] \
                    - host.start[i]
    us = lambda d: {k: v / 1e3 for k, v in d.items()}  # noqa: E731
    return SpanTable(
        steps=len(host.roots), wall_s=wall_s, device_us=us(device_ns),
        launches=dict(launches), idle_us=us(idle_ns),
        host_self_us=us(host_self),
        step_idle_us=_minus([(host.start[i], host.end[i])
                             for i in host.roots], busy) / 1e3,
        kept_us=sum(e - s for s, e in kept) / 1e3,
        dropped={k: (v[0], v[1]) for k, v in dropped.items()})


def profile_spans(cell) -> Optional[SpanTable]:
    """The cell's fixed slice once more, spans on, host and card profiled,
    reduced; None where the program has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mliis_tpu_torch.utils import profiling
    if not hasattr(profiling, "spans"):
        return None
    cuda = cell.dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof, profiling.spans():
        t = time.perf_counter()
        cell.trace_slice()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    table = reduce(events, wall)
    print("portbench: span slice {:.4f} s, {} steps, kept device time "
          "{:.4f} s, reduced in {:.1f} s; rows dropped {}".format(
              wall, table.steps, table.kept_us / 1e6,
              time.perf_counter() - t, table.dropped), file=sys.stderr)
    for row in table.rows():
        print("portbench: span {}: device {:.4f} ms, {:.2f} launches, "
              "idle {:.4f} ms, host self {:.4f} ms a step".format(*row),
              file=sys.stderr)
    return table
