"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

BENCHMARK.json names the cell's configuration (portbench/configs/
<config>.json) and traffic (portbench/traffic/<traffic>.json, which names
its driver, portbench/drivers/<driver>.py); each per-layer metric is read
by portbench/metrics/<metric>.py, and each cell's limits are
portbench/limits/<workload>.json. The run makes its inputs and weights
from the seed on the card, warms up (set-up), measures for --seconds
(the host side on one CPU thread, set-up's objects frozen out of the
collector's reach until the check), and prints one JSON line last: the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1, read from three slices profiled
after the window: the card's activity alone, then with the host's ops
(which name the idle gaps of `breakdown`), then with the host's ops and
the program's spans on (`spans.py`, the span table). It then checks the
timed path's results against the plain reference (portbench/reference)
and prints each number compared beside its limit. It exits non-zero and
prints no result without the cards the cell asks for, or when the
process holds a module of JAX or of the JAX package once the window has
closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# The kernel caches stay inside the checkout at fixed paths; the program's
# nvcc builds go to its own fixed mliis_tpu_torch/_build.
CACHE = os.path.join(CHECKOUT, "_portbench_cache")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, CHECKOUT)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload: str, entry: dict = None) -> dict:
    """The workload's entry, configuration, traffic and limits, and the
    metrics that apply to it. `entry` stands in for a cell that
    BENCHMARK.json does not list (the tests of a driver no cell uses yet);
    such a cell has the limits of its limits file, or none."""
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = entry or next((w for w in bench["workloads"]
                           if w["name"] == workload), None)
    if entry is None:
        raise SystemExit("portbench: no workload named {!r}".format(workload))

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    with open(os.path.join(HERE, "configs", entry["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(HERE, "limits", workload + ".json")
    limits = {}
    if os.path.isfile(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    return dict(entry=entry, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def driver_module(spec: dict):
    """The traffic's driver, portbench/drivers/<driver>.py."""
    name = spec["traffic"]["driver"]
    return load_module(os.path.join(HERE, "drivers", name + ".py"),
                       "portbench_driver_" + name)


def make_cell(spec: dict, seed: int, device, small=None):
    return driver_module(spec).Cell(spec["config"], spec["traffic"], seed,
                                    device, spec["limits"], small)


def end_to_end(spec: dict, window: dict, setup_s: float) -> dict:
    out = {}
    for m in spec["end_to_end"]:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            how = spec["traffic"]["e2e"][m["name"]]
            value = (window["seconds"] / window["units"]
                     if how == "seconds_per_unit"
                     else window["units"] / window["seconds"])
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def profile_slice(cell, window: dict, spec: dict, host: bool):
    """The driver's fixed slice under torch.profiler, as a `common.Trace`:
    the card's activity alone, or with `host` the host's ops too, which
    slow a host-paced slice (their trace, compressed, goes under TMPDIR,
    else under the checkout's cache). On the CPU (the tests) the host's
    ops are profiled either way."""
    from torch.profiler import ProfilerActivity, profile
    from portbench import common
    cuda = cell.dev.type == "cuda"
    activities = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    common.sync(cell.dev)
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        info = cell.trace_slice()
        common.sync(cell.dev)
        wall = time.perf_counter() - t
    device, host_ops = common.trace_from_profile(prof)
    if host:
        out_dir = os.path.join(os.environ.get("TMPDIR")
                               or os.path.join(CACHE, "traces"), "portbench")
        os.makedirs(out_dir, exist_ok=True)
        try:
            prof.export_chrome_trace(os.path.join(
                out_dir, spec["entry"]["name"] + ".trace.json.gz"))
        except (OSError, RuntimeError) as err:
            print("portbench: trace not written: {}".format(err),
                  file=sys.stderr)
    start = min([s for _, s, _ in device] + [s for _, s, _ in host_ops])

    def shift(rows):
        return [(n, s - start, e - start) for n, s, e in rows]

    return common.Trace(
        device=shift(device), host=shift(host_ops), wall_s=wall,
        inner_steps=info["inner_steps"],
        augment_batch=info["augment_batch"],
        image_size=cell.size, window_flops=window["flops"],
        window_s=window["seconds"],
        compute=spec["config"]["model"]["compute_dtype"])


def per_layer(spec: dict, trace) -> dict:
    out = {}
    for m in spec["per_layer"]:
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, dev,
             small=None, prepare=None):
    """Everything of a run after the look for the cards: set-up, the
    window, the profiled slice (`trace`), the check; returns the result
    (None when a forbidden module was imported). `small` shrinks the cell
    for the CPU tests, and `prepare(cell)` runs before its set-up there."""
    import torch
    from portbench import common
    cell = make_cell(spec, seed, dev, small)
    if prepare is not None:
        prepare(cell)
    cell.setup()
    # Set-up's objects go out of the collector's reach for the window and
    # the slices, so that no collection walks them there.
    gc.collect()
    gc.freeze()
    common.sync(dev)
    setup_s = time.perf_counter() - T0
    window = cell.window(seconds)
    metrics = end_to_end(spec, window, setup_s)
    times = window["unit_times"]
    print("portbench: window {:.3f} s, {} {}s; per-call seconds {}; median "
          "{:.4f}".format(window["seconds"], window["units"], cell.unit,
                          [round(t, 4) for t in times],
                          statistics.median(times)), file=sys.stderr)
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": spec["entry"]["chips"],
              "power_limit": common.power_limit() if cuda else None}
    result = {"correct": False, "attempted": window["units"], "failed": 0}
    breakdown = None
    if trace:
        # The metrics, busy_s and window_s from a slice profiled on the card
        # alone; the idle gaps' host ops from a second slice; the span
        # metrics' table from a third.
        from portbench import spans
        traced = profile_slice(cell, window, spec, host=False)
        busy = common.union_us([(s, e) for _, s, e in traced.device]) / 1e6
        device.update(busy_s=busy, window_s=traced.wall_s)
        named = profile_slice(cell, window, spec, host=True)
        breakdown = common.breakdown(traced, named)
        traced.spans = spans.profile_spans(cell)
        metrics = per_layer(spec, traced)
        print("portbench: profiled slice, the card alone: {:.4f} s, busy "
              "{:.4f} s; with the host's ops: {:.4f} s, busy {:.4f} s".format(
                  traced.wall_s, busy, named.wall_s,
                  common.union_us([(s, e) for _, s, e in named.device])
                  / 1e6), file=sys.stderr)
    device["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if cuda else 0)
    print("portbench: setup_s {:.3f}, memory_peak_bytes {}".format(
        setup_s, device["memory_peak_bytes"]), file=sys.stderr)
    gc.unfreeze()
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = cell.check()
    check_s = time.perf_counter() - t
    compared = [c for c in checks if c[2] is not None]
    correct = bool(compared) and all(value <= limit
                                     for _, value, limit in compared)
    found = common.forbidden_modules(list(sys.modules))
    if found:
        print("portbench: the run imported {}".format(", ".join(found)),
              file=sys.stderr)
        return None
    for name, value, _ in checks:
        print("reading {}: {}".format(name, value), file=sys.stderr)
    print("check seconds: {:.3f}; correct: {}".format(check_s, correct),
          file=sys.stderr)
    for name, value, limit in compared:
        print("check {}: {} (limit {})".format(name, value, limit),
              file=sys.stderr)
    result.update(correct=correct,
                  failed=0 if correct else window["units"],
                  metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in compared}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = cell_spec(args.workload)
    import torch
    from portbench import common
    dev = common.card(spec["entry"]["chips"])
    # One CPU thread for the program's host work: the card does the work.
    torch.set_num_threads(1)
    print("portbench: {} seed {} on {} ({})".format(
        args.workload, args.seed, torch.cuda.get_device_name(0),
        common.power_limit()), file=sys.stderr)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), dev)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
