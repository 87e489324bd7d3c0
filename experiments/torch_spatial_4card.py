"""The port's spatial partitioning on four cards over NCCL, one process a
card:

    python3 experiments/torch_spatial_4card.py

It starts `python -m torch.distributed.run --standalone --nproc_per_node 4`
on itself; every rank has a card of its own, so the world takes NCCL. At
chip_smoke.py's `spatial` widths (EfficientLab-b0 rsd=(2, 4) float32,
dropout 0.5, drop-connect 0.2, 8 synthetic images at 1024^2):
  1. rank 0 alone runs the three runs whole (`chip_smoke._spatial_runs`:
     the eval forward, one loss-and-grad SGD step, the ASPP + skip
     decoding eval forward), the reference;
  2. the four ranks run them on H shards (a `("sp",)` mesh of 4, 256 rows
     a rank) and are held to the reference with chip_smoke.py's bars;
  3. the four ranks run the step alone at 2048^2 (64 rows a rank at
     reduction 4), a size whose training activations (about 70 GB by the
     1024^2 step's peak) outgrow one card: its wall, each rank's peak and
     a finite loss.
Prints one JSON line a part and exits non-zero if a gap bar, a launch
count, a backend or a loss is off. The card's name and power limit come
first.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
LARGE = 2048


def rank_main(outdir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from mliis_tpu_torch.parallel import spatial
    mesh = spatial.make_spatial_mesh(RANKS, "cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "device": str(dev)}
    if rank == 0:
        out["whole"], arrays = cs._spatial_runs(dev)
        torch.save(arrays, os.path.join(outdir, "whole.pt"))
        del arrays
        torch.cuda.empty_cache()
    dist.barrier()
    out["sharded"], arrays = cs._spatial_runs(dev, mesh)
    if rank == 0:
        torch.save(arrays, os.path.join(outdir, "sharded.pt"))
    del arrays
    torch.cuda.empty_cache()
    cs.SPATIAL_SIZE = LARGE
    out["large"], _ = cs._spatial_runs(dev, mesh, runs=("step",))
    with open(os.path.join(outdir, "rank{}.json".format(rank)), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    outdir = tempfile.mkdtemp(prefix="spatial4_")
    t0 = time.time()
    code = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), os.path.abspath(__file__),
         "--rank", outdir], timeout=1500).returncode
    print("the world of {} ran {:.2f} s, exit code {}".format(
        RANKS, time.time() - t0, code), flush=True)
    if code != 0:
        return 1
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from mliis_tpu_torch.meta.inner_loop import (OptimizerConfig,
                                                 init_model_state)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, "rank{}.json".format(r))) as f:
            ranks.append(json.load(f))
    whole = torch.load(os.path.join(outdir, "whole.pt"))
    sharded = torch.load(os.path.join(outdir, "sharded.pt"))
    start = cs._cpu_state(init_model_state(cs._spatial_model("cpu", False),
                                           OptimizerConfig("sgd")))
    none = {k: 0 for k in cs.KERNELS}
    ok = {r["backend"] for r in ranks} == {"nccl"}
    print(json.dumps({"backends": [r["backend"] for r in ranks],
                      "devices": [r["device"] for r in ranks]}))
    ref = ranks[0]["whole"]
    for run in cs.SPATIAL_RUNS:
        line = {"part": run, "whole": ref[run],
                "per_rank": [r["sharded"][run] for r in ranks]}
        if run == "step":
            line["gap"] = cs._state_gap(sharded["state"], whole["state"],
                                        start)
            line["loss_gap"] = abs(ranks[0]["sharded"]["step"]["loss"]
                                   - ref["step"]["loss"])
            good = (line["gap"][1] <= cs.SPATIAL_STATE_BAR
                    and line["loss_gap"] <= cs.SPATIAL_STATE_BAR
                    * abs(ref["step"]["loss"]))
        else:
            key = "probs" if run == "forward" else "decoders"
            line["gap"] = float((sharded[key] - whole[key]).abs().max())
            good = line["gap"] <= cs.SPATIAL_PROB_BAR
        good = good and all(r["sharded"][run]["launches"] == none
                            for r in ranks)
        ok = ok and good
        print(json.dumps(dict(line, ok=good)), flush=True)
    large = [r["large"]["step"] for r in ranks]
    good = all(math.isfinite(s["loss"]) and s["launches"] == none
               for s in large)
    ok = ok and good
    print(json.dumps({"part": "step_{}".format(LARGE), "ok": good,
                      "per_rank": large}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
