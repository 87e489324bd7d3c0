"""The rank side of the port's sharded tests: spawned gloo worlds on the CPU.

`spawn(world, out_dir, cases)` starts `world` processes with
`torch.multiprocessing` (spawn), which join a gloo group through a file
under `out_dir` (no port, so parallel pytest workers never collide), run
every case in order and save each rank's result of case `name` to
`<out_dir>/<name>.rank<r>.pt`. This module imports only torch, numpy and
the port, so the children never import JAX; the test that spawns them
holds the results against the JAX package and the port's own world of 1.

A case is a dict with `name`, `kind` (a function below) and its arguments.
"""
import datetime
import os
import shlex

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.joint import trainer as ttrainer
from mliis_tpu_torch.meta import episodes as tep
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.meta import train as ttrain
from mliis_tpu_torch.meta import uho_eval as tuho
from mliis_tpu_torch.models import layers
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops import losses as tlosses
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.parallel import spatial
from tests.torch_tiny_model import TorchTinySeg


def tiny_model(state_dict, bn_axis_name=None, n_out=2):
    model = TorchTinySeg(n_output_channels=n_out, bn_axis_name=bn_axis_name)
    model.load_state_dict(state_dict, strict=True)
    return model


def meta_draws(case, counts):
    """The case's injected draws (the JAX key discipline's indices), or the
    port's own slot-indexed draws of `case["seed"]`."""
    cfg = tlr.MetaTrainConfig(**case["cfg"])
    if case.get("injected") is None:
        return tlr.draw_meta_step(case["seed"], counts, cfg, case["n_max"])
    task_ids, tasks = case["injected"]
    return tlr.MetaStepDraws(
        task_ids, [tlr.TaskDraws(*t) for t in tasks],
        [tep.slot_generator(case["seed"], s, "cpu")
         for s in range(cfg.meta_batch_size)])


def store_tensors(store_kw):
    return make_synthetic_store(**store_kw).to_torch("cpu")


# --------------------------------------------------------------------------
# Case kinds: each returns what the rank saves.
# --------------------------------------------------------------------------

def meta_step(case):
    """One sharded meta-step on a task mesh (`mesh` = (n,)) or a (task,
    data) mesh; the model has sync-BN where the data axis is > 1."""
    shape = case["mesh"]
    mesh = (mesh_lib.make_task_mesh(shape[0], "cpu") if len(shape) == 1
            else mesh_lib.make_task_data_mesh(*shape, "cpu"))
    sync = len(shape) == 2 and shape[1] > 1
    model = tiny_model(case["state_dict"], "data" if sync else None)
    cfg = tlr.MetaTrainConfig(**case["cfg"])
    step = mesh_lib.make_sharded_train_step(
        model, til.LossConfig(**case["loss"]), til.OptimizerConfig("sgd"),
        cfg, mesh, chain_local=case.get("chain_local", False))
    images, masks, counts = store_tensors(case["store"])
    state = mesh_lib.replicate_to_mesh(
        til.init_model_state(model, til.OptimizerConfig("sgd")), mesh)
    out = step(state, images, masks, meta_draws(case, counts),
               case["meta_step_size"], case["lr"])
    return {"params": out.params, "batch_stats": out.batch_stats,
            "step": int(out.opt.step)}


def sync_bn(case):
    """A batch split over a 4-rank data axis through a sync-BN
    FusedBatchNorm: this rank's output and input gradient, its local
    parameter gradients (their sum over the ranks is the batch's) and
    the running stats."""
    mesh = mesh_lib.make_data_mesh(dist.get_world_size(), "cpu")
    x, w = case["x"], case["w"]
    local = x.shape[0] // dist.get_world_size()
    rows = slice(dist.get_rank() * local, (dist.get_rank() + 1) * local)
    bn = layers.FusedBatchNorm(x.shape[1], axis_name="data")
    bn.load_state_dict(case["bn"])
    xs = x[rows].clone().requires_grad_(True)
    with mesh_lib.bound(mesh):
        out = bn(xs, train=True)
        loss = (out * w[rows]).sum()
        gx, gscale, gbias = torch.autograd.grad(loss, [xs, bn.scale,
                                                       bn.bias])
    return {"out": out.detach(), "grad_x": gx, "grad_scale": gscale,
            "grad_bias": gbias, "mean": bn.mean.clone(),
            "var": bn.var.clone()}


def evaluation(case):
    """GeckoEvaluator(mesh=) and EarlyStoppingEvaluator(mesh=) on a task
    mesh of the world, from generators seeded `case["seed"]`."""
    mesh = mesh_lib.make_task_mesh(None, "cpu")
    model = tiny_model(case["state_dict"])
    store = make_synthetic_store(**case["store"])
    state = til.init_model_state(model, til.OptimizerConfig("sgd"))
    ev = tev.GeckoEvaluator(model, til.LossConfig(),
                            til.OptimizerConfig("sgd"),
                            tev.EvalConfig(**case["eval"]), store,
                            device="cpu", mesh=mesh)
    ious = ev.evaluate_tasks(state, case["tasks"],
                             torch.Generator().manual_seed(case["seed"]),
                             0.05, aug_rate=0.5)
    es = tuho.EarlyStoppingEvaluator(model, til.LossConfig(),
                                     til.OptimizerConfig("sgd"), store,
                                     device="cpu", mesh=mesh, **case["es"])
    names, steps, es_ious = es.evaluate_with_early_stopping(
        state, torch.Generator().manual_seed(case["seed"]),
        eval_all_tasks=True, **case["es_call"])
    return {"ious": ious, "names": names, "steps": steps,
            "es_ious": es_ious}


def joint_steps(case):
    """JointTrainer(mesh=) steps on a data mesh of the world from the
    given state, batches and seeds."""
    mesh = mesh_lib.make_data_mesh(None, "cpu")
    ds = ttrainer.joint_dataset_from_task_store(
        make_synthetic_store(**case["store"]))
    model = tiny_model(case["state_dict"], "data", ds.num_classes + 1)
    trainer = ttrainer.JointTrainer(
        model, ds, ds, ttrainer.JointTrainConfig(**case["cfg"]),
        til.OptimizerConfig("sgd"), device="cpu", mesh=mesh)
    opt = til.init_model_state(model, til.OptimizerConfig("sgd")).opt
    losses = []
    for idx, seeds in zip(case["idx"], case["seeds"]):
        opt, loss = trainer.train_step(opt, idx, seeds, 0.05,
                                       torch.Generator().manual_seed(0))
        losses.append(float(loss))
    state = til.snapshot(model, opt)
    return {"params": state.params, "batch_stats": state.batch_stats,
            "losses": losses, "step": int(opt.step)}


def _raised(fn):
    try:
        fn()
    except (AssertionError, ValueError, RuntimeError, NameError) as e:
        return "{}: {}".format(type(e).__name__, e)
    return "nothing raised"


def guards(case):
    """The misconfigurations that need a world, each one's exception."""
    mesh22 = mesh_lib.make_task_data_mesh(2, 2, "cpu")
    sd = case["state_dict"]
    loss, opt = til.LossConfig(), til.OptimizerConfig("sgd")
    bad = tlr.MetaTrainConfig(num_shots=6, inner_batch_size=3,
                              inner_iters=2, meta_batch_size=2,
                              augment=False)
    ok = tlr.MetaTrainConfig(num_shots=6, inner_batch_size=4, inner_iters=2,
                             meta_batch_size=2, augment=False)
    ds = ttrainer.joint_dataset_from_task_store(
        make_synthetic_store(num_tasks=2, examples_per_task=4,
                             image_size=16, seed=2))
    return {
        "indivisible_inner_batch": _raised(
            lambda: mesh_lib.make_sharded_train_step(
                tiny_model(sd, "data"), loss, opt, bad, mesh22)),
        "no_sync_bn_axis": _raised(
            lambda: mesh_lib.make_sharded_train_step(
                tiny_model(sd), loss, opt, ok, mesh22)),
        "mesh_size_not_world": _raised(
            lambda: mesh_lib.make_task_mesh(2, "cpu")),
        "joint_without_sync_bn": _raised(
            lambda: ttrainer.JointTrainer(
                TorchTinySeg(n_output_channels=ds.num_classes + 1), ds, ds,
                ttrainer.JointTrainConfig(batch_size=8), opt, device="cpu",
                mesh=mesh_lib.make_data_mesh(None, "cpu"))),
        "unbound_axis": _raised(
            lambda: tiny_model(sd, "data")(torch.zeros(2, 16, 16, 3))),
    }


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def drivers(case):
    """train_gecko on a 2x2 mesh, then both CLIs on the world, each rank
    with its own output directory: returns the files each rank wrote and
    the final params."""
    from mliis_tpu_torch.cli import joint_train, run_metasegnet
    root = os.path.join(case["out"], "rank{}".format(dist.get_rank()))
    model = tiny_model(case["state_dict"])
    state = til.init_model_state(model, til.OptimizerConfig("sgd"))
    train, test = (make_synthetic_store(**case["store"]).subset(r)
                   for r in (range(2, 8), range(0, 2)))
    cfg = tlr.MetaTrainConfig(**case["cfg"])
    out = ttrain.train_gecko(
        model, state, train, test, os.path.join(root, "gecko"),
        til.LossConfig(), til.OptimizerConfig("sgd"), cfg,
        ttrain.TrainLoopConfig(**case["loop"]), torch.Generator(),
        device="cpu")
    cli = run_metasegnet.main(
        shlex.split(case["cli"]) + ["--checkpoint",
                                    os.path.join(root, "cli")],
        device="cpu")
    joint = joint_train.main(
        shlex.split(case["joint_cli"]) + ["--checkpoint",
                                          os.path.join(root, "joint")],
        device="cpu")
    return {"files": _files(root), "gecko": out.params, "cli": cli.params,
            "joint": joint.params}


def spatial_model(case):
    """The case's model ("tiny": TorchTinySeg; "lab": EfficientLab with
    `kwargs`) with its weights, drop-connect at `drop_connect_rate`."""
    if case["model"] == "tiny":
        model = TorchTinySeg(**case.get("kwargs", {}))
    else:
        model = EfficientLab(**case["kwargs"])
        getattr(model, model.backbone_name).drop_connect_rate = \
            case.get("drop_connect_rate", 0.0)
    model.load_state_dict(case["state_dict"], strict=True)
    return model


def spatial_run(case, mesh=None):
    """The eval forward's probabilities, then one loss-and-grad SGD step
    (`case["step"]`: loss flags, lr, drop rate, generator seed) from the
    same weights: sharded over `mesh`'s spatial axis, or whole without
    one. Returns the whole probabilities (gathered), the loss and the new
    state. The test process calls it with no mesh for the reference."""
    model = spatial_model(case)
    images, masks = case["images"], case["masks"]
    height, width = images.shape[1:3]
    out = {}
    if mesh is None:
        with torch.no_grad():
            out["probs"] = model(images, train=False)[1]
    else:
        probs = spatial.make_spatial_forward(model, mesh)(
            spatial.shard_spatial(images, mesh))
        out["probs"] = spatial.gather_spatial(probs, mesh, height)
        images = spatial.shard_spatial(images, mesh)
        masks = spatial.shard_spatial(masks, mesh)
    step = case.get("step")
    if step is None:
        return out
    opt = til.init_opt_state(dict(model.named_parameters()),
                             til.OptimizerConfig("sgd"))
    loss_and_grad = til.make_loss_and_grad(model,
                                           til.LossConfig(**step["loss"]))
    generator = torch.Generator().manual_seed(step["seed"])
    if mesh is None:
        loss, grads = loss_and_grad(images, masks, generator, step["drop"])
    else:
        with spatial.bound(mesh, height, width):
            loss, grads = loss_and_grad(images, masks, generator,
                                        step["drop"])
    opt = til.apply_optimizer_(list(model.parameters()), grads, opt,
                               step["lr"], til.OptimizerConfig("sgd"))
    state = til.snapshot(model, opt)
    out.update(loss=float(loss), params=state.params,
               batch_stats=state.batch_stats)
    return out


def spatial_case(case):
    """`spatial_run` on a spatial mesh of the world."""
    return spatial_run(case, spatial.make_spatial_mesh(None, "cpu"))


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank holds whole; its gradient is
    averaged over the ranks, each of which holds the part that flowed
    through its own rows (times the world size, psum's convention)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad / dist.get_world_size()


def fetch_rows_gradcheck(case):
    """`torch.autograd.gradcheck` in float64 of the whole map -> every
    rank's window, put together: each rank takes its rows of the same
    map, fetches its window (`case["lo"]`, `case["hi"]`) and the windows
    are summed into place, so every rank checks the same function and
    perturbs the same element at the same time."""
    mesh = spatial.make_spatial_mesh(None, "cpu")
    x = case["x"].clone().requires_grad_(True)
    lo, hi = case["lo"], case["hi"]
    sizes = [h - l for l, h in zip(lo, hi)]
    rank = dist.get_rank()

    def windows(full):
        local = spatial.shard_spatial(
            _Replicated.apply(full).permute(0, 2, 3, 1),
            mesh).permute(0, 3, 1, 2)
        window = spatial.fetch_rows(local, lo, hi)
        placed = torch.nn.functional.pad(window, (
            0, 0, sum(sizes[:rank]), sum(sizes[rank + 1:])))
        return mesh_lib.psum(placed, spatial.SPATIAL_AXIS)

    with spatial.bound(mesh, x.shape[2], x.shape[3]):
        ok = torch.autograd.gradcheck(windows, (x,), eps=1e-6, atol=1e-8)
        out = windows(x.detach())
    return {"ok": ok, "out": out}


def spatial_guards(case):
    """What the spatial path refuses, each one's exception."""
    mesh = spatial.make_spatial_mesh(None, "cpu")
    x = torch.zeros(1, 2, 4, 3)
    model = spatial_model(case)
    logits = torch.zeros(1, 4, 4, 2)
    return {
        "unbound_fetch": _raised(lambda: spatial.fetch_rows(
            x, [0, 0], [1, 1])),
        "wrong_rows": _raised(lambda: spatial.make_spatial_forward(
            model, mesh)(torch.zeros(1, 3 + 2 * dist.get_rank(), 16, 3))),
        "task_mesh": _raised(lambda: spatial.make_spatial_forward(
            model, mesh_lib.make_task_mesh(None, "cpu"))),
        "two_axes": _raised(lambda: tlosses.segmentation_loss(
            logits, logits, logits, data_axis_name="data",
            spatial_axis_name=spatial.SPATIAL_AXIS)),
    }


KINDS = {f.__name__: f for f in (meta_step, sync_bn, evaluation,
                                 joint_steps, guards, drivers, spatial_case,
                                 fetch_rows_gradcheck, spatial_guards)}


def _rank(rank, world, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "gloo_store"), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        for case in cases:
            torch.save(KINDS[case["kind"]](case), os.path.join(
                out_dir, "{}.rank{}.pt".format(case["name"], rank)))
    finally:
        dist.destroy_process_group()


def spawn(world, out_dir, cases):
    """Run `cases` on a gloo world of `world` spawned processes; returns
    {case name: [each rank's result]}."""
    return spawn_worlds({world: (out_dir, cases)})


def spawn_worlds(worlds):
    """`spawn` for several worlds at once, {world: (out_dir, cases)}, all
    started before any is joined."""
    running = []
    for world, (out_dir, cases) in worlds.items():
        os.makedirs(out_dir, exist_ok=True)
        running.append(mp.spawn(_rank, args=(world, out_dir, cases),
                                nprocs=world, join=False))
    for context in running:
        while not context.join():
            pass
    return {c["name"]: [torch.load(os.path.join(
        out_dir, "{}.rank{}.pt".format(c["name"], r)), weights_only=False)
        for r in range(world)] for world, (out_dir, cases) in worlds.items()
        for c in cases}
