"""The row kernels (`cheap_pass`, `fused_light_augment`) against an earlier
version of them, timed in turns on one GPU.

The earlier version's csrc/ is taken from a directory (`--parent`, e.g. a
`git archive` of the earlier commit's mliis_tpu_torch/csrc unpacked into a
git-ignored directory); its cheap_pass.cu and light_augment.cu are built
with the same nvcc flags and called through their own C interface (one
block a tile of 1,024 pixels, no plan). At each size of chip_smoke.py's
kernel phases (cheap_pass at B=8: 5 x 224^2, 5 x 160 x 224, 5 x 320^2,
5 x 161 x 225; fused_light_augment at B=64, 224^2 and B=8, 225^2, on
chip_smoke.py's inputs) the two outputs must be equal, bit for bit; then
each is timed as chip_smoke.py times a kernel (a CUDA graph's replay, with
a cold L2 and a warm one), in turns: earlier, current, current, earlier.
Prints one line a size and the card's name and power limit; with --out,
writes the same as JSON to OUT/row_kernels_ab.json.

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_row_kernels_ab.py --parent DIR [--out OUT]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_ARGTYPES = {  # the earlier C interfaces, without the plan
    "cheap_pass": [_P] * 6 + [_I] * 6 + [_F] * 6 + [_P],
    "light_augment": [_P] * 5 + [_I] * 4 + [_F] * 3 + [_P],
}


def build_parent(ak, csrc):
    fns = {}
    for name, argtypes in PARENT_ARGTYPES.items():
        lib = os.path.join(ak.BUILD_DIR, "parent_{}.so".format(name))
        os.makedirs(ak.BUILD_DIR, exist_ok=True)
        subprocess.run([ak._nvcc(), *ak._NVCC_FLAGS, "-o", lib,
                        os.path.join(csrc, name + ".cu")], check=True)
        fn = getattr(ctypes.CDLL(lib), name + "_launch")
        fn.argtypes, fn.restype = argtypes, _I
        fns[name] = fn
    return fns


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True,
                        help="the earlier version's mliis_tpu_torch/csrc")
    parser.add_argument("--out", help="a directory for the JSON record")
    args = parser.parse_args()
    import torch
    import chip_smoke as cs
    from mliis_tpu_torch.ops import augment_kernels as ak
    dev = torch.device("cuda")
    old = build_parent(ak, args.parent)
    ak.build_library(("cheap_pass", "light_augment"))
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa

    def old_cheap(seeds, x, perm, num, window):
        out = torch.empty_like(x)
        b, c_tot, h, w = x.shape
        err = old["cheap_pass"](
            x.data_ptr(), out.data_ptr(), seeds.data_ptr(), perm.data_ptr(),
            num.data_ptr(), window.data_ptr(), b, c_tot, h, w, 3, 23,
            *ak._float_consts(5.1, 12.75, 0.02, 0.10, 0.3, 1.0 / 0.3),
            stream())
        assert err == 0, err
        return out

    def old_light(seeds, images, masks):
        out_i, out_m = torch.empty_like(images), torch.empty_like(masks)
        b, h, w, _ = images.shape
        err = old["light_augment"](
            images.data_ptr(), masks.data_ptr(), out_i.data_ptr(),
            out_m.data_ptr(), seeds.data_ptr(), b, h, w, 23, 0.0,
            ak._f32(5.1), ak._f32(12.75), stream())
        assert err == 0, err
        return out_i, out_m

    cases = []
    for h, w in cs.CHEAP_SIZES:
        _, a, x, _ = cs._cheap_pass_at(dev, h, w)
        cases.append(("cheap_pass 5x{}x{}".format(h, w), (x,),
                      lambda xx, a=a: old_cheap(a[0], xx, *a[1:]),
                      lambda xx, a=a: ak.cheap_pass(a[0], xx, *a[1:]),
                      2 * x.numel() * 4))
    for b, size, _ in cs.LIGHT_SIZES:
        _, (seeds, images, masks), _, _ = cs._light_at(dev, b, size, size,
                                                       False)
        cases.append(("fused_light_augment B={} {}^2".format(b, size),
                      (images, masks),
                      lambda i, m, s=seeds: old_light(s, i, m),
                      lambda i, m, s=seeds: ak.fused_light_augment(s, i, m),
                      2 * (images.numel() + masks.numel()) * 4))
    rows = []
    for tag, inputs, f_old, f_new, nbytes in cases:
        same = all(torch.equal(p, q) for p, q in zip(
            torch.utils._pytree.tree_leaves(f_old(*inputs)),
            torch.utils._pytree.tree_leaves(f_new(*inputs))))
        turns = []
        for which, fn in (("parent", f_old), ("current", f_new),
                          ("current", f_new), ("parent", f_old)):
            cold, _ = cs.cold_graph_ms(fn, inputs, nbytes)
            warm = cs.graph_ms(lambda: fn(*inputs), 20)
            turns.append({"kernel": which, "cold_ms": cold, "warm_ms": warm})
        row = {"case": tag, "outputs_equal": same, "turns": turns}
        for which in ("parent", "current"):
            for key in ("cold_ms", "warm_ms"):
                row["{}_{}".format(which, key)] = sum(
                    t[key] for t in turns if t["kernel"] == which) / 2
        rows.append(row)
        print("{}: outputs equal {} | cold ms parent {:.4f} current {:.4f} "
              "| warm ms parent {:.4f} current {:.4f} | turns {}".format(
                  tag, same, row["parent_cold_ms"], row["current_cold_ms"],
                  row["parent_warm_ms"], row["current_warm_ms"],
                  ["{}:{:.4f}".format(t["kernel"], t["cold_ms"])
                   for t in turns]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "row_kernels_ab.json"), "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    print(card)
    if not all(r["outputs_equal"] for r in rows):
        sys.exit("the two versions' outputs differ")


if __name__ == "__main__":
    main()
