"""Task- and data-sharded strategies on torch.distributed.

The port of the JAX package's `parallel/mesh.py`. JAX runs one process over
N devices and shards with `shard_map`; the port runs one process a rank, as
`torchrun` launches it:
  - `RANK`, `WORLD_SIZE`, `LOCAL_RANK` and `LOCAL_WORLD_SIZE` come from the
    environment. A rank's card is cuda:LOCAL_RANK % device_count, set
    before the group starts (`init_world`);
  - the backend follows from the layout: NCCL where every rank has a card
    of its own; gloo where ranks share a card (LOCAL_WORLD_SIZE >
    device_count, which NCCL refuses; gloo takes CUDA tensors for
    `all_reduce` and `broadcast`) and on the CPU. The choice is logged. If
    NCCL fails to start on a card of its own, that is an error;
  - a mesh is a `DeviceMesh` with the dimensions ("task",), ("data",) or
    ("task", "data"), row-major over the ranks like the JAX package's
    reshape of its device list. Its size must be the world's. A mesh of 1
    without the torchrun environment starts a world of 1 by itself, on a
    FileStore under `store_dir`; a larger one raises;
  - the collectives are sum all-reduces and broadcasts. A module or a loss
    names an axis (`layers.FusedBatchNorm(axis_name=)`,
    `losses.segmentation_loss(data_axis_name=)`) and reaches its group
    through the mesh that `bound(mesh)` binds, as flax reaches the axes of
    the enclosing shard_map; an axis name with no mesh bound raises.
    `psum` all-reduces its cotangent in backward, as JAX's psum VJP does;
  - rank 0 alone writes checkpoints, metrics, CSVs, exports and logs
    (`is_writer`); the other ranks compute.

The sharded meta-step and evaluation take slot-indexed random streams
(`episodes.slot_generator`): meta-batch slot s, or evaluation task j,
draws from its own generator whichever rank runs it, so a world of N
computes what a world of 1 computes, up to the order of the sums.
"""
import contextlib
import contextvars
import copy
import math
import os
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mliis_tpu_torch.device import resolve_device

TASK_AXIS = "task"
DATA_AXIS = "data"

_BOUND: contextvars.ContextVar = contextvars.ContextVar("bound_mesh",
                                                        default=None)


# --------------------------------------------------------------------------
# The world and its meshes.
# --------------------------------------------------------------------------

def _torchrun_env():
    """(rank, world, local rank, local world) from torchrun's environment,
    or None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return (rank, world, int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_size(size: int, world: int, what: str) -> None:
    if size != world:
        raise ValueError("need {} devices for a {} mesh; the world has {} "
                         "ranks".format(size, what, world))


def init_world(size: int, device=None, store_dir: Optional[str] = None,
               what: Optional[str] = None, log_fn=print) -> torch.device:
    """Join the torchrun world, or start a world of 1 outside it, and check
    that it has `size` ranks; returns this rank's device (the card unless
    the caller asks for the CPU). A world already started is joined as it
    is."""
    dev = resolve_device(device)
    what = what or str(size)
    if dist.is_initialized():
        _check_size(size, dist.get_world_size(), what)
        return _rank_device(dev)
    env = _torchrun_env()
    if env is None and size != 1:
        raise RuntimeError(
            "a {} mesh runs one process a rank: launch it with torchrun "
            "--nproc_per_node {}".format(what, size))
    rank, world, local_rank, local_world = env or (0, 1, 0, 1)
    _check_size(size, world, what)
    backend, why = "gloo", "the CPU"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % count)
        torch.cuda.init()
        if local_world > count:
            why = "{} ranks share {} card(s), which NCCL refuses".format(
                local_world, count)
        else:
            backend, why = "nccl", "a card a rank"
    if env is None:
        store_dir = store_dir or tempfile.mkdtemp(prefix="world_")
        os.makedirs(store_dir, exist_ok=True)
        path = os.path.join(store_dir, ".world_store")
        if os.path.exists(path):   # left by an earlier world of 1 here
            os.remove(path)
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    if rank == 0:
        log_fn("torch.distributed: a world of {} on {} ({})".format(
            world, backend, why))
    return _rank_device(dev)


@contextlib.contextmanager
def world(size: int, device=None, store_dir: Optional[str] = None,
          log_fn=print):
    """`init_world` for the length of the block; a world it started is
    destroyed at the end. Yields this rank's device."""
    started = not dist.is_initialized()
    dev = init_world(size, device, store_dir, log_fn=log_fn)
    try:
        yield dev
    finally:
        if started:
            dist.destroy_process_group()


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    env = _torchrun_env()
    return env[1] if env else 1


def _mesh(shape, names, device, store_dir, what) -> DeviceMesh:
    dev = init_world(math.prod(shape), device, store_dir, what)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_task_mesh(num_devices: Optional[int] = None, device=None,
                   store_dir: Optional[str] = None) -> DeviceMesh:
    """A ("task",) mesh over `num_devices` ranks (the whole world when
    None)."""
    n = num_devices or _world_size()
    return _mesh((n,), (TASK_AXIS,), device, store_dir, "{}-rank".format(n))


def make_data_mesh(num_devices: Optional[int] = None, device=None,
                   store_dir: Optional[str] = None) -> DeviceMesh:
    """A ("data",) mesh: the joint trainer's batch splits over it and batch
    norm all-reduces its moments across it (sync-BN)."""
    n = num_devices or _world_size()
    return _mesh((n,), (DATA_AXIS,), device, store_dir, "{}-rank".format(n))


def make_task_data_mesh(num_task_devices: int, num_data_devices: int,
                        device=None, store_dir: Optional[str] = None
                        ) -> DeviceMesh:
    """A 2D (task, data) mesh: the meta-batch shards over the task axis
    while each task's inner-loop batch splits over the data axis with
    sync-BN."""
    return _mesh((num_task_devices, num_data_devices), (TASK_AXIS, DATA_AXIS),
                 device, store_dir,
                 "{}x{}".format(num_task_devices, num_data_devices))


def is_writer() -> bool:
    """True on rank 0, and outside a world: the one process that writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def writer_log(log_fn):
    """`log_fn` on the writer, a log that drops its lines elsewhere."""
    return log_fn if is_writer() else (lambda *_: None)


@contextlib.contextmanager
def quiet_unless_writer():
    """Standard output dropped for the block on every rank but the writer
    (rank 0 alone logs)."""
    if is_writer():
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def axis_size_of(mesh: DeviceMesh, axis_name: str) -> int:
    """The mesh's extent along `axis_name`; 1 where it has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis_name)) if axis_name in names else 1


def share(n: int, mesh: DeviceMesh, axis_name: str = TASK_AXIS) -> range:
    """This rank's contiguous share of n items along `axis_name`: items
    [r*k, (r+1)*k) with k = ceil(n / axis size), clipped to n."""
    size = axis_size_of(mesh, axis_name)
    r = mesh.get_local_rank(axis_name) if size > 1 else 0
    k = -(-n // size)
    return range(min(r * k, n), min((r + 1) * k, n))


# --------------------------------------------------------------------------
# Axes bound for the modules and losses that name them.
# --------------------------------------------------------------------------

@contextlib.contextmanager
def bound(mesh: DeviceMesh):
    """Bind `mesh`'s axes for the modules and losses that name them."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def _bound_mesh(axis_name: str) -> DeviceMesh:
    mesh = _BOUND.get()
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise NameError("unbound axis name: {} (no mesh with this axis is "
                        "bound; see parallel.mesh.bound)".format(axis_name))
    return mesh


def axis_size(axis_name: str) -> int:
    return axis_size_of(_bound_mesh(axis_name), axis_name)


def axis_index(axis_name: str) -> int:
    return _bound_mesh(axis_name).get_local_rank(axis_name)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group in forward and backward (JAX's psum and its VJP)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum of `x` over the bound axis, differentiable."""
    return _AllReduceSum.apply(x, _bound_mesh(axis_name).get_group(
        axis_name))


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return psum(x, axis_name) / axis_size(axis_name)


class _AllReduceMax(torch.autograd.Function):
    """Max over a group; backward hands the summed cotangent to the ranks
    whose value is the max (psum's convention for the cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad * (x == out).to(grad.dtype), None


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Max of `x` over the bound axis, differentiable."""
    return _AllReduceMax.apply(x, _bound_mesh(axis_name).get_group(
        axis_name))


def all_reduce_sum(tensors: Sequence[torch.Tensor], group
                   ) -> List[torch.Tensor]:
    """The sums over `group` of same-dtype tensors, in one flat
    all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [piece.view_as(t) for piece, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def pmean_grads(grads: Sequence[torch.Tensor], axis_name: str
                ) -> List[torch.Tensor]:
    """Gradients averaged over the bound axis (JAX's `lax.pmean` of the
    gradient tree), in one flat all-reduce."""
    mesh = _bound_mesh(axis_name)
    n = axis_size_of(mesh, axis_name)
    return [g / n for g in all_reduce_sum(grads, mesh.get_group(axis_name))]


def _tree_map(fn, tree):
    """`fn` on every tensor of a tree of dicts, lists and (named) tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def replicate_to_mesh(tree, mesh: DeviceMesh):
    """A copy of `tree` on this rank's device holding rank 0's values:
    one broadcast a tensor over the world the mesh spans."""
    dev = _rank_device(torch.device(mesh.device_type))

    def replicate(t):
        t = t.detach().to(dev, copy=True)
        if dist.get_world_size() > 1:
            dist.broadcast(t, src=0)
        return t

    return _tree_map(replicate, tree)


def any_rank(flag: bool, device) -> bool:
    """True on every rank when `flag` holds on any (a sum all-reduce over
    the world), so that all ranks leave a loop at the same step."""
    t = torch.tensor([float(flag)], device=device)
    dist.all_reduce(t)
    return bool(t.item() > 0)


def sync_bn_copy(model: torch.nn.Module,
                 axis_name: str = DATA_AXIS) -> torch.nn.Module:
    """A copy of `model` whose batch norms all-reduce their moments over
    `axis_name` (the JAX package's `dataclasses.replace(model,
    bn_axis_name=...)`); the same parameter and buffer names."""
    from mliis_tpu_torch.models.layers import FusedBatchNorm
    synced = copy.deepcopy(model)
    for module in synced.modules():
        if isinstance(module, FusedBatchNorm):
            module.axis_name = axis_name
    synced.bn_axis_name = axis_name
    return synced


# --------------------------------------------------------------------------
# The sharded meta-step and evaluation.
# --------------------------------------------------------------------------

def make_sharded_train_step(model, loss_config, opt_config, config,
                            mesh: DeviceMesh, chain_local: bool = False):
    """Meta-train step with the meta-batch sharded over the task axis:
    train_step(state, store_images, store_masks, draws, meta_step_size, lr)
    -> new ModelState, with `draws` from `learners.draw_meta_step`, the
    same on every rank.

    Rank d of the task axis owns the slots [d*local_n, (d+1)*local_n),
    local_n = ceil(meta_batch / task ranks), and runs them together on a
    task axis (`learners.make_batched_per_task_fn`, the JAX package's
    vmap of a rank's slots) or, with `chain_local`, one after another; a
    padded slot (slot >= meta_batch) does no work (the JAX
    package runs it at weight 0). The updates, batch stats and optimizer
    slots are summed over the rank's slots, all-reduced over the task
    axis in one flat sum and divided by meta_batch, as the chained step
    divides its sums (`learners.finish_meta_step`). Each slot draws from
    its own generator, so the step computes what the unsharded chained
    step computes from the same draws, up to the order of the sums.

    With a 2D (task, data) mesh each inner-loop batch also splits over the
    data axis (`inner_loop.DataShardSpec`): sync-BN moments, axis-aware
    loss reductions and averaged gradients keep the adaptation exact, the
    FOMAML* tail step runs whole on every data rank, and dropout and
    drop-connect draw each data shard's own stream. The rank's slots run
    on a task axis beside the data axis as without one (the sync-BN
    moments of all its tasks in one all-reduce), unless `chain_local`.

    The JAX package's `n_max` is not a parameter: the draws come with the
    step's arguments, as for `learners.make_chained_train_step`.
    """
    from mliis_tpu_torch.meta.inner_loop import DataShardSpec
    from mliis_tpu_torch.meta.learners import (finish_meta_step,
                                               make_batched_per_task_fn,
                                               make_per_task_fn,
                                               sum_over_slots,
                                               sum_over_slots_batched)
    if TASK_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError("the meta-step shards over a mesh with a 'task' "
                         "axis; got {}".format(mesh.mesh_dim_names))
    m = config.meta_batch_size
    local_n = -(-m // axis_size_of(mesh, TASK_AXIS))
    data_shard = None
    n_data = axis_size_of(mesh, DATA_AXIS)
    if n_data > 1:
        if config.inner_batch_size % n_data:
            raise ValueError("inner_batch_size must be a multiple of the "
                             "data-mesh size")
        bn_axis = getattr(model, "bn_axis_name", None)
        if bn_axis != DATA_AXIS:
            raise ValueError(
                "a (task, data) mesh requires the model built with "
                "bn_axis_name='data' (sync-BN); got {!r}".format(bn_axis))
        if config.precompute_augment:
            raise ValueError("data-axis sharding augments in the loop "
                             "(precompute unsupported)")
        data_shard = DataShardSpec(axis_name=DATA_AXIS, num_shards=n_data)
    d = mesh.get_local_rank(TASK_AXIS)
    slots = range(min(d * local_n, m), min((d + 1) * local_n, m))
    if chain_local or not slots:
        per_task = make_per_task_fn(model, loss_config, opt_config, config,
                                    data_shard=data_shard)
        local_sums = sum_over_slots
    else:
        per_task = make_batched_per_task_fn(model, loss_config, opt_config,
                                            config, data_shard=data_shard)
        local_sums = sum_over_slots_batched
    task_group = mesh.get_group(TASK_AXIS)

    def train_step(state, store_images, store_masks, draws, meta_step_size,
                   lr):
        with bound(mesh):
            sums = local_sums(per_task, state, store_images, store_masks,
                              draws, slots, lr)
        flat = [t for tree in sums for t in tree.values()]
        reduced = iter(all_reduce_sum(flat, task_group))
        sums = tuple({k: next(reduced) for k in s} for s in sums)
        return finish_meta_step(state, sums, config, meta_step_size)

    return train_step


def make_sharded_eval_chunk(model, loss_config, opt_config, config,
                            mesh: DeviceMesh):
    """The evaluation of a list of tasks sharded over the task axis:
    eval_chunk(state, store_images, store_masks, store_counts,
    task_indices, seed, lr, drop_rate, aug_rate) -> per-task mean IoU.
    Each task rank evaluates its contiguous share of the tasks, task j
    drawing from its own generator (`seed`, j), on a task axis in chunks
    of ceil(task_chunk_size / task ranks) or, with `chain_chunk`, one
    after another, and the IoUs are all-reduced into place
    (`evaluate.make_eval_chunk_fn`)."""
    from mliis_tpu_torch.meta.evaluate import make_eval_chunk_fn
    if TASK_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError("the evaluation shards over a mesh with a 'task' "
                         "axis; got {}".format(mesh.mesh_dim_names))
    return make_eval_chunk_fn(model, loss_config, opt_config, config,
                              mesh=mesh)
