"""Where one launch of the row kernels (`cheap_pass`, `fused_light_augment`)
spends its time, block by block, on one GPU.

Builds csrc/cheap_pass.cu and csrc/light_augment.cu with -DROW_TRACE (thread
0 of each block stamps the global timer at `row_pass`'s trace points, for
its first sample group: 0 entry, 1 the samples' indices and Philox words
drawn, 2 their layout draws and normals done, 3 its value draws done, 4
its share of the column tables built, 5 every consumer's share built, 6
its first unit landed, 7 exit; its first unit and its SM), sends the
wrappers through those builds, and launches each workload once after
evicting L2 (a 128 MB write), as chip_smoke.py draws it:
  - cheap_pass at B=8, 5 x 224^2: identity rows (num 0), the drawn rows of
    chip_smoke.py, and noise-only rows;
  - fused_light_augment at B=64, 224^2: the gate (a copy), and the seeds of
    chip_smoke.py.
Prints, for each, the launch's span (first entry to last exit) and each
phase's median and maximum over the blocks, with the blocks' entry spread;
with --out, writes the same as JSON to OUT/row_trace.json, and each
launch's blocks' stamps (with each block's first unit at 9) to
OUT/row_trace.npz.

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_row_kernels_trace.py [--out OUT]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PHASES = ("words", "layout+normals", "values", "tables", "tables sync",
          "first unit landed", "rest to exit")
POINTS, SM = 11, 10  # kTracePoints; the SM id's slot


def build_traced(kl, name):
    lib = os.path.join(kl.BUILD_DIR, "trace_{}.so".format(name))
    os.makedirs(kl.BUILD_DIR, exist_ok=True)
    subprocess.run([kl.nvcc(), "-DROW_TRACE", *kl.NVCC_FLAGS, "-o", lib,
                    os.path.join(kl.CSRC_DIR, name + ".cu")], check=True)
    return ctypes.CDLL(lib)


def summary(trace, grid):
    import numpy as np
    last = len(PHASES)
    t = trace[:grid, :last + 1].astype(np.float64)
    t0 = t[:, 0].min()
    out = {"span_us": (t[:, last].max() - t0) / 1e3,
           "entry_spread_us": (t[:, 0].max() - t0) / 1e3,
           "sms": int(len(set(trace[:grid, SM].tolist())))}
    for k, name in enumerate(PHASES):
        d = (t[:, k + 1] - t[:, k]) / 1e3
        out[name] = {"median_us": float(np.median(d)),
                     "max_us": float(d.max())}
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="a directory for the records")
    args = parser.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from mliis_tpu_torch.ops import augment_kernels as ak
    from mliis_tpu_torch.ops import kernel_library as kl
    dev = torch.device("cuda")
    libs = {name: build_traced(kl, name)
            for name in ("cheap_pass", "light_augment")}
    for lib in libs.values():
        lib.row_trace_read.argtypes = [ctypes.c_void_p]

    def bind(source, function, argtypes):
        """The wrappers' entry points, from the traced builds."""
        fn = getattr(libs[source], function + "_launch")
        fn.argtypes = list(argtypes) + [kl.PTR]
        fn.restype = kl.I32
        return fn

    kl.bind = bind
    flush = torch.empty(32 * 2 ** 20, device=dev)

    raw = {}

    def traced(name, call, plan):
        call()
        flush.fill_(1.0)
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        trace = np.zeros((4096, POINTS), dtype=np.uint64)
        libs[name].row_trace_read(trace.ctypes.data)
        raw["{} {}".format(name, len(raw))] = trace[:plan.grid]
        return dict(summary(trace, plan.grid), plan=plan._asdict())

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = {}
    x = cs._planar_batch(dev, 8, 224)
    i32 = dict(dtype=torch.int32, device=dev)
    _, drawn, _, _ = cs._cheap_pass_at(dev, 224, 224)
    seeds = torch.arange(8, **i32) + 5
    window = torch.tensor([[0, 6]] * 8, **i32)
    rows = {
        "identity": (seeds, torch.tensor([[0, 1, 2, 3, 4, 5]] * 8, **i32),
                     torch.zeros(8, **i32), window),
        "drawn": drawn,
        "noise only": (seeds, torch.tensor([[3, 0, 1, 2, 4, 5]] * 8, **i32),
                       torch.ones(8, **i32), window)}
    plan = ak.cheap_pass_plan(8, 5, 224, 224, sms)
    for tag, args in rows.items():
        results["cheap_pass 224^2 " + tag] = traced(
            "cheap_pass", lambda: ak.cheap_pass(args[0], x, *args[1:]),
            plan)
    _, (seeds, images, masks), _, plan = cs._light_at(dev, 64, 224, 224,
                                                      False)
    for tag, prob in (("gate (copy)", 1.0), ("drawn", 0.0)):
        results["light B=64 224^2 " + tag] = traced(
            "light_augment", lambda: ak.fused_light_augment(
                seeds, images, masks, prob_original=prob), plan)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for tag, r in results.items():
        print("{}: span {:.2f} us, entry spread {:.2f} us, {} SMs | ".format(
            tag, r["span_us"], r["entry_spread_us"], r["sms"]) + " | ".join(
            "{} {:.2f}/{:.2f}".format(p, r[p]["median_us"], r[p]["max_us"])
            for p in PHASES), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "row_trace.npz"), **raw)
        with open(os.path.join(args.out, "row_trace.json"), "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
