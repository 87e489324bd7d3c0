"""The readings that the cells' limits are set from: for each seed, the
numbers `check` compares with the program in place (its sound runs), and
for each control seed the same numbers with the reference in the nearest
lower precision in the program's place (TF32 for the float32 joint path,
float8 e4m3 operands for the bf16 meta path). With `--fault` the
program's runs have that fault of the driver's `FAULTS` planted under
them.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds S] [--small JSON]

One process, one cell built per seed (set-up, `--seconds` of the window
where the cell's check samples from it); prints one JSON line a seed and a
summary. Not part of the benchmark's runs. `--small` runs the cell shrunk
on the CPU (the tests use it).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402


def readings(spec: dict, seeds, control_seeds, seconds: float,
             small=None, device=None, fault=None):
    """{"program": {seed: readings}, "control": {seed: readings}} of the
    cell `spec` (`run.cell_spec`)."""
    import torch
    from portbench import common
    dev = device or common.card(spec["entry"]["chips"])
    out = {"program": {}, "control": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        cell = run.make_cell(spec, seed, dev, small)
        undo = []
        if fault:
            def patch(obj, name, value):
                undo.append((obj, name, getattr(obj, name)))
                setattr(obj, name, value)
            run.driver_module(spec).FAULTS[fault](cell, patch)
        cell.setup()
        if hasattr(cell, "keep"):
            cell.window(seconds)
        row = {}
        if seed in seeds:
            row["program"] = {n: v for n, v, _ in cell.check()}
            out["program"][seed] = row["program"]
        if seed in control_seeds:
            row["control"] = {n: v for n, v, _ in cell.control()}
            out["control"][seed] = row["control"]
        row.update(seed=seed, seconds=time.perf_counter() - t)
        print(json.dumps(row), flush=True)
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
        cell.release()
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--small", default=None)
    parser.add_argument("--fault", default=None,
                        help="plant this fault of the driver's FAULTS under "
                        "the program's runs")
    args = parser.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    small = json.loads(args.small) if args.small else None
    dev = None
    if small is not None:
        import torch
        dev = torch.device("cpu")
    out = readings(run.cell_spec(args.workload), ints(args.seeds),
                   ints(args.control_seeds),
                   args.seconds, small, dev, args.fault)
    summary = {}
    for side, rows in out.items():
        names = sorted({n for r in rows.values() for n in r})
        summary[side] = {n: [min(r[n] for r in rows.values()),
                             max(r[n] for r in rows.values())]
                         for n in names}
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
