"""The port's learning-evidence curve held against the TPU's three seeds.

Reads a run of experiments/torch_curve_v2.py (its curve.json, and its
result.json and timings.jsonl where present) and the committed TPU runs
of experiments/tpu_curve_v2.py (curve_v2_r4 = seed 0, curve_v2_seed1,
curve_v2_seed2), and prints one JSON object:
  - for every evaluation point of the run from FROM_ITER on: the run's
    held-out mean IoU, the TPU seeds' at the same iteration, and the band
    [lowest TPU seed - MARGIN, highest + MARGIN] it must lie in;
  - the baseline mean IoU (bar: below BASELINE_BAR) and whether the last
    point's task-level CI95 excludes zero;
  - the seconds of a meta-iteration (median, 10th and 90th percentile,
    min and max over the iterations behind the committed curve: the last
    run of each iteration, so a resumed segment's repeats count once) and
    of an evaluation point, with the device the run names;
  - `bar_met`: every point in its band, the baseline under its bar and
    the last CI above zero.
Exits 1 when the bar is not met.

Usage, from the root of a checkout:
  python3 experiments/torch_curve_band.py \\
      --run experiments/torch_curve_v2_seed0
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_RUNS = tuple(os.path.join(ROOT, "experiments", r) for r in (
    "curve_v2_r4", "curve_v2_seed1", "curve_v2_seed2"))
# The largest task-level CI95 half-width TPU seeds 1 and 2 record over
# iterations 100-600: one run's own scoring noise.
MARGIN = 0.07
FROM_ITER = 100
BASELINE_BAR = 0.01


def load_curve(run_dir):
    """{iter: mean IoU} of a run's curve.json."""
    with open(os.path.join(run_dir, "curve.json")) as f:
        return {int(p[0]): float(p[1]) for p in json.load(f)}


def bands(curve, tpu_curves, from_iter, margin):
    """One row a point of `curve` from `from_iter` on that every TPU curve
    recorded."""
    rows = []
    for it in sorted(curve):
        if it < from_iter or not all(it in c for c in tpu_curves):
            continue
        seeds = [c[it] for c in tpu_curves]
        lo, hi = min(seeds) - margin, max(seeds) + margin
        rows.append({"iter": it, "port": curve[it], "tpu_seeds": seeds,
                     "band": [lo, hi], "inside": lo <= curve[it] <= hi})
    return rows


def _percentile(values, q):
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def seconds(run_dir, last_iter):
    """Summaries of timings.jsonl's meta-iteration and evaluation-point
    seconds up to `last_iter`, the last line of each iteration counted."""
    path = os.path.join(run_dir, "timings.jsonl")
    if not os.path.exists(path):
        return None
    iters, evals = {}, {}
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            if e.get("iter", e.get("eval_at")) > last_iter:
                continue   # run after the newest checkpoint, then lost
            if "iter" in e:
                iters[e["iter"]] = e["s"]
            else:
                evals[e["eval_at"]] = e["s"]

    def summary(d):
        v = list(d.values())
        return {"count": len(v), "median": _percentile(v, 0.5),
                "p10": _percentile(v, 0.1), "p90": _percentile(v, 0.9),
                "min": min(v), "max": max(v)} if v else None

    return {"meta_iteration_s": summary(iters),
            "evaluation_point_s": summary(evals)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", default=os.path.join(
        ROOT, "experiments", "torch_curve_v2_seed0"))
    args = p.parse_args(argv)
    result = {}   # a run cut between its segments has none yet
    if os.path.exists(os.path.join(args.run, "result.json")):
        with open(os.path.join(args.run, "result.json")) as f:
            result = json.load(f)
    with open(os.path.join(args.run, "curve.json")) as f:
        points = json.load(f)
    baseline, last = points[0][1], points[-1]
    rows = bands(load_curve(args.run), [load_curve(d) for d in TPU_RUNS],
                 FROM_ITER, MARGIN)
    last_ci_excludes_zero = len(last) == 4 and last[2] - last[3] > 0
    baseline_ok = baseline < BASELINE_BAR
    out = {"run": os.path.relpath(args.run, ROOT),
           "device": result.get("device"),
           "meta_iters_done": result.get("meta_iters_done"),
           "margin": MARGIN, "points": rows,
           "baseline_mean_iou": baseline,
           "last_point": last,
           "last_ci_excludes_zero": last_ci_excludes_zero,
           "seconds": seconds(args.run, last[0]),
           "bar_met": bool(rows) and all(r["inside"] for r in rows)
           and baseline_ok and last_ci_excludes_zero}
    print(json.dumps(out))
    return 0 if out["bar_met"] else 1


if __name__ == "__main__":
    sys.exit(main())
