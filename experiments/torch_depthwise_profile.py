"""Where a joint benchmark cell's depthwise convolutions spend the card's
time: one op-level torch.profiler run of the cell's steps, each kernel's
device time put down to the op that launched it and, for the convs and
their SAME pads, to the conv's input shape.

Builds the cell as portbench/run.py does (its set-up runs the first
checked steps, which warm every shape), runs one more step with a hook on
every padded `layers.Conv2d` to learn each conv's input shape, kernel size
and stride, then profiles `--steps` steps (CPU and CUDA activities, the
ops' input shapes recorded). For each depthwise conv input shape (the
convs that share it summed) it prints the device ms a step of the forward, the input gradient (cuDNN's dgrad
kernels under `aten::convolution_backward`), the weight gradient (its
wgrad kernels) and, under the SAME pad in front of the conv
(`aten::constant_pad_nd`), the pad's copy and fill, and the pad's backward (under
`ConstantPadNdBackward0`); the hand-written kernel
(`depthwise_conv_kernel<K, S, backward, CS>`) counts as the forward or
the backward by its name. The stem's and the decoder's convs and pads
are summed apart, and the step's other device time by op. Writes the table as JSON to
`--out` and prints it.

Usage, from the root of a checkout on a machine with the card:
  python3 experiments/torch_depthwise_profile.py --workload \
      joint-train.b3-1000 --seed 12345 [--steps 8] [--out FILE]
"""
import argparse
import collections
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FORWARD_OPS = ("aten::cudnn_convolution", "aten::_conv_depthwise2d")
CONV_OPS = FORWARD_OPS + ("aten::convolution_backward",
                          "aten::constant_pad_nd")


def conv_inputs(cell):
    """{padded input shape: (input shape, kind, k, stride)} of every
    padded conv of one training step: kind "depthwise" (groups == in ==
    out channels), "stem" (3 input channels) or "dense"."""
    from mliis_tpu_torch.models import layers
    seen = {}

    def hook(module, args):
        x = args[0]
        k, s = module.kernel_size, module.stride
        if k == 1 and s == 1:
            return
        n, c, h, w = x.shape
        kind = ("depthwise" if module.groups == c == module.kernel.shape[0]
                else "stem" if c == 3 else "dense")
        ph = layers.same_padding(h, k, s, module.dilation)
        pw = layers.same_padding(w, k, s, module.dilation)
        padded = (n, c, h + sum(ph), w + sum(pw))
        seen[padded] = ((n, c, h, w), kind, k, s)

    handles = [m.register_forward_pre_hook(hook) for m in
               cell.model.modules() if isinstance(m, layers.Conv2d)]
    cell.step()
    for h in handles:
        h.remove()
    return seen


def _ancestors(event):
    out = []
    while event is not None:
        out.append(event)
        event = event.cpu_parent
    return out


def attribute(events, convs, steps):
    """({depthwise input shape: {part: ms}}, {other op: ms}, {kernel:
    ms}), device ms a step. `convs` is `conv_inputs`'s table."""
    unpadded = {v[0]: v for v in convs.values()}
    per_shape = collections.defaultdict(collections.Counter)
    other = collections.Counter()
    kernels = collections.Counter()

    def shapes_of(op):
        return [tuple(s) for s in (op.input_shapes or [])]

    for ev in events:
        if not getattr(ev, "kernels", None):
            continue
        chain = _ancestors(ev)
        names = [e.name for e in chain]
        for kern in ev.kernels:
            ms = kern.duration / 1e3 / steps
            kernels[kern.name[:90]] += ms
            lname = kern.name.lower()
            if "depthwise_conv_kernel" in lname:
                other["hand-written depthwise kernel, " + (
                    "backward" if ", true," in lname else "forward")] += ms
                continue
            if any("ConstantPadNdBackward" in n for n in names):
                # the pad's backward slices the padded map's gradient
                inner = next((e for e in chain if shapes_of(e)), None)
                conv = next((convs.get(t) or unpadded.get(t)
                             for t in (shapes_of(inner) if inner else [])
                             if convs.get(t) or unpadded.get(t)), None)
                if conv is not None and conv[1] == "depthwise":
                    per_shape[conv[0]]["pad_backward"] += ms
                else:
                    other["pad_backward ({} convs)".format(
                        conv[1] if conv else "unknown")] += ms
                continue
            op = next((e for e in chain if e.name in CONV_OPS), None)
            if op is None:
                other[next((n for n in names if n.startswith("aten::")),
                           names[-1])] += ms
                continue
            shapes = shapes_of(op)
            if op.name == "aten::constant_pad_nd":
                conv = unpadded.get(shapes[0] if shapes else None)
                what = "pad_fill" if "fill" in lname else "pad_copy"
                if conv is not None and conv[1] == "depthwise":
                    per_shape[conv[0]][what] += ms
                else:
                    other["{} ({} convs)".format(
                        what, conv[1] if conv else "unknown")] += ms
                continue
            backward = op.name == "aten::convolution_backward"
            x_shape, w_shape = shapes[1:3] if backward else shapes[:2]
            # a padded conv's input is the padded map (a 1x1 conv's may
            # have a depthwise conv's unpadded shape)
            conv = convs.get(x_shape)
            if (conv is None or conv[1] != "depthwise"
                    or w_shape != (x_shape[1], 1, conv[2], conv[2])):
                other[op.name + " ({} convs)".format(
                    conv[1] if conv and conv[1] != "depthwise"
                    else "1x1")] += ms
                continue
            what = "forward"
            if backward:
                what = ("wgrad" if "wgrad" in lname else "dgrad"
                        if "dgrad" in lname else "backward_other")
            per_shape[conv[0]][what] += ms
    return per_shape, other, kernels


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import common, run

    spec = run.cell_spec(args.workload)
    dev = common.card(spec["entry"]["chips"])
    torch.set_num_threads(1)
    cell = run.make_cell(spec, args.seed, dev)
    cell.setup()
    convs = conv_inputs(cell)
    common.sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(args.steps):
            cell.step()
        common.sync(dev)
    per_shape, other, kernels = attribute(prof.events(), convs, args.steps)
    totals = collections.Counter()
    rows = []
    kinds = collections.defaultdict(set)
    for shape, kind, k, s in convs.values():
        if kind == "depthwise":
            kinds[shape].add((k, s))
    for shape, ks in kinds.items():
        part = per_shape.get(shape, {})
        totals.update(part)
        rows.append(dict(shape=list(shape), k_stride=sorted(ks),
                         total=sum(part.values()), **part))
    rows.sort(key=lambda r: -r["total"])
    step_ms = sum(kernels.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"workload": args.workload, "seed": args.seed,
           "steps": args.steps, "card": smi,
           "device_ms_a_step": step_ms,
           "depthwise_input_shapes": len(rows),
           "depthwise_total": dict(totals),
           "depthwise_ms_a_step": sum(totals.values()),
           "by_input_shape": rows,
           "other_ops": dict(other.most_common(25)),
           "top_kernels": kernels.most_common(20)}
    text = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
