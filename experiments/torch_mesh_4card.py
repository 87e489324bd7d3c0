"""The port's sharded strategies on four cards over NCCL, one process a card:

    python3 experiments/torch_mesh_4card.py

It starts `python -m torch.distributed.run --standalone --nproc_per_node 4`
on itself; every rank has a card of its own, so the world takes NCCL. At
chip_smoke.py's `mesh` widths (EfficientLab-b0 rsd=(2, 4) float32, 224^2,
FOMAML* 10 shots with a tail of 5, 59 steps at batch 8, meta-batch 5):
  1. one library meta-step unsharded (rank 0 alone, the reference), then
     on a task mesh of 4 and on a 2x2 (task, data) mesh with the sync-BN
     model, from the same state and draw seed (dropout and drop-connect
     0): each state's largest gap to the reference, as a share of the
     reference's largest change;
  2. the meta-training CLI with `--mesh_tasks 4` and with `--mesh_tasks 2
     --mesh_data 2` (the `train` phase's flags, 1 meta-iter, 10 evaluation
     steps a task): seconds a meta-step, mean IoU, peak memory;
  3. 2 joint steps at 1001 channels and batch 64, unsharded on rank 0 and
     data-parallel over the 4 cards (16 a rank): seconds a step and the
     gap.
Each part's kernel launches are counted on every rank and summed. Prints
one JSON line per part and exits non-zero if a launch count, a gap bar or
a backend is off. The card's name and power limit come first.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


def rank_main(outdir):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from mliis_tpu_torch.meta import learners as lr
    from mliis_tpu_torch.meta.inner_loop import LossConfig, OptimizerConfig
    from mliis_tpu_torch.parallel import mesh as mesh_lib
    dev = mesh_lib.init_world(RANKS, "cuda")
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "device": str(dev)}

    def summed(launches):
        t = torch.tensor([float(launches[k]) for k in cs.KERNELS],
                         device=dev)
        dist.all_reduce(t)
        return {k: int(v) for k, v in zip(cs.KERNELS, t.tolist())}

    def meta_step(model, mesh, cfg, state, batch):
        step = (lr.make_chained_train_step(model, LossConfig(),
                                           OptimizerConfig("sgd"), cfg)
                if mesh is None else mesh_lib.make_sharded_train_step(
                    model, LossConfig(), OptimizerConfig("sgd"), cfg, mesh))
        draws = lr.draw_meta_step(cs.MESH_STEP_SEED, batch[2], cfg, 10)
        torch.cuda.synchronize()
        cs.reset_launches()
        t0 = time.time()
        new = cs._cpu_state(step(state, batch[0], batch[1], draws, 0.1,
                                 5e-4))
        torch.cuda.synchronize()
        return new, time.time() - t0, cs.read_launches()

    model, batch, cfg, state = cs._mesh_meta_setup(dev)
    start = cs._cpu_state(state)
    if rank == 0:
        ref, wall, launches = meta_step(model, None, cfg, state, batch)
        out["unsharded"] = {"wall": wall, "launches": launches}
    dist.barrier()
    for name, mesh, sync in (
            ("task4", mesh_lib.make_task_mesh(RANKS, dev), False),
            ("2x2", mesh_lib.make_task_data_mesh(2, 2, dev), True)):
        m = mesh_lib.sync_bn_copy(model) if sync else model
        new, wall, launches = meta_step(m, mesh, cfg, state, batch)
        out[name] = {"wall": wall, "launches": summed(launches)}
        if rank == 0:
            out[name]["gap"] = cs._state_gap(new, ref, start)
    del model, state, batch
    torch.cuda.empty_cache()

    for name, flags in (("cli_task4", ["--mesh_tasks", "4"]),
                        ("cli_2x2", ["--mesh_tasks", "2", "--mesh_data",
                                     "2"])):
        ckpt = os.path.join(outdir, name)
        argv = cs.TRAIN_ARGV + cs.MESH_CUT + flags + ["--checkpoint", ckpt]
        _, text, launches, wall, peak = cs._run_cli(argv, dev)
        out[name] = {"wall": wall, "peak": peak,
                     "launches": summed(launches), "iou": cs._mean_iou(text)}
        if rank == 0:
            with open(os.path.join(ckpt, "phase_timings.jsonl")) as f:
                out[name]["meta_step_s"] = json.loads(
                    f.readline())["meta_step"]["mean_s"]

    model, ds, jcfg, batches, state = cs._mesh_joint_setup(dev)
    jstart = cs._cpu_state(state)
    if rank == 0:
        jref, seconds, launches, peak = cs._run_joint(model, ds, jcfg,
                                                      batches, state, dev)
        out["joint_unsharded"] = {"seconds": seconds, "peak": peak,
                                  "launches": launches}
    dist.barrier()
    del model
    torch.cuda.empty_cache()
    model, ds, jcfg, batches, state = cs._mesh_joint_setup(
        dev, mesh_lib.DATA_AXIS)
    new, seconds, launches, peak = cs._run_joint(
        model, ds, jcfg, batches, state, dev,
        mesh_lib.make_data_mesh(RANKS, dev))
    out["joint_4"] = {"seconds": seconds, "peak": peak,
                      "launches": summed(launches)}
    if rank == 0:
        out["joint_4"]["gap"] = cs._state_gap(new, jref, jstart)
    with open(os.path.join(outdir, "rank{}.json".format(rank)), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    outdir = tempfile.mkdtemp(prefix="mesh4_")
    t0 = time.time()
    code = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(RANKS), os.path.abspath(__file__),
         "--rank", outdir], timeout=1500).returncode
    print("the world of {} ran {:.2f} s, exit code {}".format(
        RANKS, time.time() - t0, code), flush=True)
    if code != 0:
        return 1
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(outdir, "rank{}.json".format(r))) as f:
            ranks.append(json.load(f))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    meta = {"full_pass": 5 * 58, "cheap_pass": 0, "fused_light_augment": 0}
    cli = {"full_pass": 5 * 58 + (6 + 2) * 10 + (1 + 2) * 10,
           "cheap_pass": 0, "fused_light_augment": 0}
    expect = {"unsharded": meta, "task4": meta,
              "2x2": dict(meta, full_pass=2 * 5 * 58), "cli_task4": cli,
              # The 2x2 CLI: each task's data ranks augment its halves.
              "cli_2x2": dict(cli, full_pass=2 * 5 * 58 + 11 * 10),
              "joint_unsharded": {"full_pass": 0, "cheap_pass": 0,
                                  "fused_light_augment": 2},
              "joint_4": {"full_pass": 0, "cheap_pass": 0,
                          "fused_light_augment": RANKS * 2}}
    bars = {"task4": cs.MESH_TASK_BAR, "2x2": cs.MESH_DATA_BAR,
            "joint_4": cs.MESH_JOINT_BAR}
    ok = {r["backend"] for r in ranks} == {"nccl"}
    print(json.dumps({"backends": [r["backend"] for r in ranks],
                      "devices": [r["device"] for r in ranks]}))
    for part, launches in expect.items():
        line = dict(ranks[0][part], per_rank={
            k: [r.get(part, {}).get(k) for r in ranks]
            for k in ("wall", "peak", "seconds") if k in ranks[0][part]})
        good = line["launches"] == launches and (
            part not in bars or line["gap"][1] <= bars[part])
        ok = ok and good
        print(json.dumps({"part": part, "ok": good, "expect": launches,
                          **line}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2]))
    sys.exit(main())
