"""The inner loop: k-shot adaptation as a Python loop of SGD steps.

The port of the JAX package's `meta/inner_loop.py`, whose `lax.scan`
becomes a loop here. Each step gathers its batch, augments it with one
`full_pass` launch, runs forward and backward, and updates the module's
parameters in place. Model state moves between steps of the meta-learner
as `ModelState` snapshots (dicts of tensors keyed by the module's names);
`adapt` loads a snapshot into the module, trains it, and returns a new
snapshot, leaving its input untouched.

Optimizers follow TF1:
  - GradientDescentOptimizer: theta -= lr * g;
  - AdamOptimizer(beta1=0): v = b2 v + (1-b2) g^2;
    theta -= lr*sqrt(1-b2^t) * g/(sqrt(v)+eps).
Weight decay is the reference's multiplicative pre-step op, applied before
the gradient is taken.

Augmentation has one route, `full_pass` (the kernel on the card, its plain
version on the CPU), for the in-loop and the precomputed path alike; the
JAX package resolves its `pallas_augment=None` per path and hands the
precompute path the unresolved value. `pallas_augment=False` takes the
plain version on any device.

With a `DataShardSpec` every step's batch splits over a mesh data axis
(the JAX package's DataShardSpec): a rank takes its contiguous slice of
the step's batch indices and of the whole batch's augmentation draws,
the loss sums across the axis, the model's batch norms sync their
moments (it must be built with `bn_axis_name` = the axis) and the
gradients are averaged over the axis. Dropout and drop-connect draw each
shard's own stream (`episodes.shard_generator`), as the JAX package folds
each shard's dropout key; everything else equals the unsharded step up
to the order of the sums.

`make_batched_adapt_fn` adapts T tasks at once on a task axis (the body
the JAX package runs under `jax.vmap`): the state is stacked [T, ...]
(`stack_states`), each step gathers and augments the T batches in one
pass (`episodes.assemble_batches`, one `full_pass` launch at T times the
batch), runs one forward and backward of the module with the stacked
params and running stats substituted (`torch.func.functional_call`
under `layers.task_axis`), takes the sum of the T tasks' losses, whose
gradient is each task's own, and updates the stacked params in place
(the optimizer's step count is shared; `batched_sgd_step`, which the
early-stopping traces share). Task t draws its augmentation, dropout and
drop-connect from generators[t], in the order `adapt` draws them from
its one generator, so task t adapts as `adapt` would adapt it alone, up
to float rounding. With a `DataShardSpec` each task's batch splits over
the data axis as `adapt` splits its one task's.
"""
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.models import layers
from mliis_tpu_torch.ops import losses as losses_lib
from mliis_tpu_torch.parallel import mesh as mesh_lib
from mliis_tpu_torch.parallel import spatial
from mliis_tpu_torch.utils import profiling

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The loss flags (`ops/losses.segmentation_loss`). `remat` is the JAX
    package's activation rematerialization, a memory trade that changes no
    result: it is accepted, and the port keeps its activations."""
    label_smoothing: float = 0.0
    dice: bool = True           # bce_dice when True, plain CE otherwise
    binary_iou_loss: bool = True
    l2: bool = True
    l1: bool = False
    darc1: bool = False
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"           # "sgd" | "adam" (beta1=0)
    beta2: float = 0.999
    epsilon: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DataShardSpec:
    """Split each inner-loop batch over the mesh axis `axis_name` of
    `num_shards` ranks; the inner batch size must be a multiple of it."""
    axis_name: str
    num_shards: int


class OptState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    v: Tree                     # second moments (scalar zeros for sgd)


class ModelState(NamedTuple):
    """Trainable params, batch-norm running stats and optimizer slots."""
    params: Tree
    batch_stats: Tree
    opt: OptState


def init_opt_state(params: Tree, opt_config: OptimizerConfig) -> OptState:
    if opt_config.name == "sgd":
        v = {k: torch.zeros((), dtype=p.dtype, device=p.device)
             for k, p in params.items()}
    else:
        v = {k: torch.zeros_like(p) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), v)


def snapshot(model: torch.nn.Module, opt: OptState) -> ModelState:
    """Copy of the module's params and buffers, with `opt`."""
    return ModelState(
        {k: p.detach().clone() for k, p in model.named_parameters()},
        {k: b.detach().clone() for k, b in model.named_buffers()}, opt)


def init_model_state(model: torch.nn.Module,
                     opt_config: OptimizerConfig) -> ModelState:
    state = snapshot(model, None)
    return state._replace(opt=init_opt_state(state.params, opt_config))


def load_state(model: torch.nn.Module, state: ModelState) -> None:
    """Copy a snapshot's params and running stats into the module."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(state.params[k])
        for k, b in model.named_buffers():
            b.copy_(state.batch_stats[k])


@profiling.spanned("optimizer.apply")
def apply_optimizer_(params, grads, opt_state: OptState, lr: float,
                     opt_config: OptimizerConfig) -> OptState:
    """Update the `params` list in place; returns the new OptState."""
    step = opt_state.step + 1
    with torch.no_grad():
        if opt_config.name == "sgd":
            torch._foreach_add_(params, grads, alpha=-lr)
            return OptState(step, opt_state.v)
        b2 = opt_config.beta2
        t = int(step)
        lr_t = lr * (1.0 - b2 ** t) ** 0.5
        names = list(opt_state.v)
        v = [opt_state.v[k] for k in names]
        new_v = torch._foreach_mul(v, b2)
        torch._foreach_addcmul_(new_v, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(new_v)
        torch._foreach_add_(denom, opt_config.epsilon)
        torch._foreach_addcdiv_(params, grads, denom, value=-lr_t)
        return OptState(step, dict(zip(names, new_v)))


def make_loss_and_grad(model: torch.nn.Module, loss_config: LossConfig,
                       data_axis_name: Optional[str] = None):
    """(images, masks, generator, drop_rate) -> (loss, grads) at the
    module's current params; the forward updates the running stats.

    With `data_axis_name` the batch is one shard of a batch split over that
    bound axis: the loss is the whole batch's (axis sums inside it) and
    the gradients are averaged over the axis. The average, not the sum, is
    exact: the axis sum's backward hands every shard the summed cotangent,
    so a shard's data gradient comes out at num_shards times its share,
    while the replicated l2/l1 terms come out at their true scale on every
    shard; the average rescales the first and keeps the second.

    Under a bound spatial context (`parallel/spatial.py`) images and masks
    are this rank's rows: the loss sums over the spatial axis in the same
    way, the row exchanges' transposes carry each rank's cotangents to the
    rows' owners, and the averaged gradients are the whole images'."""
    params = dict(model.named_parameters())

    def loss_and_grad(images, masks, generator, drop_rate):
        spatial_axis_name = (spatial.SPATIAL_AXIS if spatial.current()
                             is not None else None)
        axis_name = data_axis_name or spatial_axis_name
        logits, probs = model(images, train=True,
                              final_layer_dropout_rate=drop_rate,
                              generator=generator)
        loss = losses_lib.segmentation_loss(
            logits, probs, masks, params,
            label_smoothing=loss_config.label_smoothing,
            dice=loss_config.dice,
            binary_iou_loss=loss_config.binary_iou_loss, l2=loss_config.l2,
            l1=loss_config.l1, darc1=loss_config.darc1,
            data_axis_name=data_axis_name,
            spatial_axis_name=spatial_axis_name)
        grads = torch.autograd.grad(loss, list(params.values()))
        if axis_name is not None:
            grads = mesh_lib.pmean_grads(grads, axis_name)
        return loss.detach(), grads

    return loss_and_grad


def sgd_step(model: torch.nn.Module, loss_config: LossConfig,
             opt_config: OptimizerConfig, weight_decay_rate: float = 1.0,
             data_axis_name: Optional[str] = None):
    """One inner step on the module: (opt, images, masks, generator, lr,
    drop_rate) -> (opt, loss)."""
    loss_and_grad = make_loss_and_grad(model, loss_config, data_axis_name)
    params = list(model.parameters())

    def step(opt: OptState, images, masks, generator, lr, drop_rate):
        if weight_decay_rate != 1.0:
            with torch.no_grad():
                torch._foreach_mul_(params, weight_decay_rate)
        loss, grads = loss_and_grad(images, masks, generator, drop_rate)
        return apply_optimizer_(params, grads, opt, lr, opt_config), loss

    return step


def step_batches(batch: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                 steps: int, precompute: bool):
    """The batches batch(0), ..., batch(steps - 1): each made when its step
    takes it, or with `precompute` all made before the first step and
    staged in bf16 (the JAX package's memory-bound variant)."""
    if not precompute:
        return (batch(i) for i in range(steps))
    staged = [tuple(t.to(torch.bfloat16) for t in batch(i))
              for i in range(steps)]
    return (tuple(t.float() for t in b) for b in staged)


def shard_batch_indices(idx_matrix: torch.Tensor, generators,
                        data_shard: Optional[DataShardSpec]):
    """This data shard's part of an index matrix [..., steps, batch] (one
    task's, or T tasks' stacked): (its columns, their first position, the
    whole batch, and for each task's generator the stream the model draws
    dropout and drop-connect from, `episodes.shard_generator`). Without a
    shard: the whole matrix, 0, None and `generators`."""
    if data_shard is None:
        return idx_matrix, 0, None, list(generators)
    total = idx_matrix.shape[-1]
    local = total // data_shard.num_shards
    offset = mesh_lib.axis_index(data_shard.axis_name) * local
    return (idx_matrix[..., offset:offset + local], offset, total,
            [episodes.shard_generator(g, offset) for g in generators])


def make_adapt_fn(model: torch.nn.Module, loss_config: LossConfig,
                  opt_config: OptimizerConfig,
                  weight_decay_rate: float = 1.0, augment: bool = True,
                  precompute_augment: bool = False,
                  pallas_augment: Optional[bool] = None,
                  data_shard: Optional[DataShardSpec] = None) -> Callable:
    """Builds adapt(state, support_images_u8, support_masks_u8, idx_matrix,
    generator, lrs, drop_rate=None, aug_rate=None) -> (adapted ModelState,
    per-step losses [steps]).

    idx_matrix: [steps, batch] indices into the support set; lrs: [steps]
    learning rates. precompute_augment=True augments every step's batch
    before the loop and stages it in bf16 (the JAX package's memory-bound
    variant); the default augments inside each step. pallas_augment None
    or True augments through the kernels' wrappers, False through their
    plain versions. `data_shard` splits every step's batch over a bound
    mesh data axis (not with precompute_augment)."""
    if data_shard is not None and precompute_augment:
        raise ValueError("data_shard + precompute_augment is not supported")
    step_fn = sgd_step(model, loss_config, opt_config, weight_decay_rate,
                       data_shard.axis_name if data_shard else None)

    def adapt(state: ModelState, support_images_u8, support_masks_u8,
              idx_matrix, generator, lrs, drop_rate=None, aug_rate=None
              ) -> Tuple[ModelState, torch.Tensor]:
        load_state(model, state)
        opt = state.opt
        lr_list = [float(v) for v in torch.as_tensor(lrs, dtype=torch.float32)]
        idx_matrix, offset, total, (model_generator,) = \
            shard_batch_indices(idx_matrix, [generator], data_shard)

        def batch(i):
            return episodes.assemble_batch(
                support_images_u8, support_masks_u8, idx_matrix[i],
                generator, aug_rate=aug_rate, augment=augment,
                kernels=pallas_augment is not False, key_offset=offset,
                key_total=total)

        losses = []
        for lr, (images, masks) in zip(lr_list, step_batches(
                batch, len(lr_list), precompute_augment and augment)):
            opt, loss = step_fn(opt, images, masks, model_generator, lr,
                                drop_rate)
            losses.append(loss)
        if not losses:   # zero steps: a FOMAML* task of one inner step
            return snapshot(model, opt), torch.zeros(0)
        return snapshot(model, opt), torch.stack(losses)

    return adapt


def stack_states(states: Sequence[ModelState]) -> ModelState:
    """T states -> one with every param, running stat and optimizer slot
    stacked [T, ...]; the optimizer's step count is the first's (a task
    axis shares it)."""
    def stack(trees):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    return ModelState(stack([s.params for s in states]),
                      stack([s.batch_stats for s in states]),
                      OptState(states[0].opt.step,
                               stack([s.opt.v for s in states])))


def unstack_states(state: ModelState) -> list:
    """A stacked state -> its T states (views of it)."""
    n = next(iter(state.params.values())).shape[0]

    def take(tree, t):
        return {k: v[t] for k, v in tree.items()}
    return [ModelState(take(state.params, t), take(state.batch_stats, t),
                       OptState(state.opt.step, take(state.opt.v, t)))
            for t in range(n)]


def task_forward(model: torch.nn.Module, params: Tree, buffers: Tree,
                 images: torch.Tensor, **kwargs):
    """The module's forward on a task axis: images [T, B, H, W, 3] through
    the module with the stacked `params` and `buffers` in place of its own
    (a train-mode forward updates `buffers`' running stats in place)."""
    with layers.task_axis(images.shape[0]):
        return torch.func.functional_call(model, {**params, **buffers},
                                          (images,), kwargs)


def task_axis_state(states: ModelState, device, params_order: Sequence[str]
                    ) -> Tuple[Tree, Tree, OptState]:
    """A stacked state's params (leaves that require grad, in the module's
    order), running stats and optimizer slots, copied onto `device` for a
    task axis's steps to update in place."""
    params = {k: states.params[k].detach().to(device, copy=True)
              .requires_grad_(True) for k in params_order}
    buffers = {k: v.detach().to(device, copy=True)
               for k, v in states.batch_stats.items()}
    opt = OptState(states.opt.step.to(device),
                   {k: v.to(device) for k, v in states.opt.v.items()})
    return params, buffers, opt


def batched_sgd_step(model: torch.nn.Module, loss_config: LossConfig,
                     opt_config: OptimizerConfig,
                     weight_decay_rate: float = 1.0,
                     data_axis_name: Optional[str] = None):
    """`sgd_step` on a task axis: step(params, buffers, opt, images [T, B,
    H, W, 3], masks [T, B, H, W, 2], generators, lr, drop_rate) -> (opt,
    losses [T]). One forward and backward of the module with the stacked
    `params` and `buffers` substituted; the sum of the T tasks' losses,
    whose gradient is each task's own; the stacked params updated in
    place. With `data_axis_name` each task's batch is this shard's part:
    the losses sum over the axis and the gradients are averaged over it,
    as in `make_loss_and_grad`."""

    def step(params: Tree, buffers: Tree, opt: OptState, images, masks,
             generators, lr, drop_rate) -> Tuple[OptState, torch.Tensor]:
        plist = list(params.values())
        if weight_decay_rate != 1.0:
            with torch.no_grad():
                torch._foreach_mul_(plist, weight_decay_rate)
        logits, probs = task_forward(
            model, params, buffers, images, train=True,
            final_layer_dropout_rate=drop_rate, generator=generators)
        loss = losses_lib.segmentation_losses(
            logits, probs, masks, params,
            label_smoothing=loss_config.label_smoothing,
            dice=loss_config.dice,
            binary_iou_loss=loss_config.binary_iou_loss,
            l2=loss_config.l2, l1=loss_config.l1, darc1=loss_config.darc1,
            data_axis_name=data_axis_name)
        grads = torch.autograd.grad(loss.sum(), plist)
        if data_axis_name is not None:
            grads = mesh_lib.pmean_grads(grads, data_axis_name)
        return (apply_optimizer_(plist, grads, opt, lr, opt_config),
                loss.detach())

    return step


def make_batched_adapt_fn(model: torch.nn.Module, loss_config: LossConfig,
                          opt_config: OptimizerConfig,
                          weight_decay_rate: float = 1.0,
                          augment: bool = True,
                          precompute_augment: bool = False,
                          pallas_augment: Optional[bool] = None,
                          data_shard: Optional[DataShardSpec] = None
                          ) -> Callable:
    """`make_adapt_fn` on a task axis: adapt(states, support_images_u8,
    support_masks_u8, idx_matrix, generators, lrs, drop_rate=None,
    aug_rate=None) -> (adapted stacked ModelState, per-step losses [T,
    steps]).

    states: a stacked ModelState (`stack_states`); support_images_u8 [T,
    S, H, W, 3], support_masks_u8 [T, S, H, W], idx_matrix [T, steps,
    batch], generators: T generators, lrs: [steps], the same for every
    task. The input state may lie on any device and is left untouched;
    the adapted state lies on the support images' device. The module's
    own parameters are not used. `data_shard` splits every task's batch
    over a bound mesh data axis, task by task as `make_adapt_fn` splits
    its one task's (not with precompute_augment)."""
    if data_shard is not None and precompute_augment:
        raise ValueError("data_shard + precompute_augment is not supported")
    params_order = [k for k, _ in model.named_parameters()]
    step_fn = batched_sgd_step(model, loss_config, opt_config,
                               weight_decay_rate,
                               data_shard.axis_name if data_shard else None)

    def adapt(states: ModelState, support_images_u8, support_masks_u8,
              idx_matrix, generators, lrs, drop_rate=None, aug_rate=None
              ) -> Tuple[ModelState, torch.Tensor]:
        generators = list(generators)
        n_tasks = len(generators)
        params, buffers, opt = task_axis_state(
            states, support_images_u8.device, params_order)
        lr_list = [float(v) for v in torch.as_tensor(lrs, dtype=torch.float32)]
        idx_matrix, offset, total, model_generators = shard_batch_indices(
            idx_matrix, generators, data_shard)

        def batch(i):
            return episodes.assemble_batches(
                support_images_u8, support_masks_u8, idx_matrix[:, i],
                generators, aug_rate=aug_rate, augment=augment,
                kernels=pallas_augment is not False, key_offset=offset,
                key_total=total)

        losses = []
        for lr, (images, masks) in zip(lr_list, step_batches(
                batch, len(lr_list), precompute_augment and augment)):
            opt, loss = step_fn(params, buffers, opt, images, masks,
                                model_generators, lr, drop_rate)
            losses.append(loss)
        adapted = ModelState({k: p.detach() for k, p in params.items()},
                             buffers, opt)
        if not losses:   # zero steps: a FOMAML* task of one inner step
            return adapted, torch.zeros((n_tasks, 0))
        return adapted, torch.stack(losses, dim=1)

    return adapt


def make_lr_array(lr: float, total_steps: int,
                  scheduler: Optional[str] = "fixed",
                  decay_rate: float = 0.5,
                  decay_after_n_steps: int = 5,
                  min_lr: float = 1e-7) -> torch.Tensor:
    """[total_steps] float32 per-step inner learning rates."""
    if scheduler in (None, "fixed", "constant"):
        return torch.full((total_steps,), lr, dtype=torch.float32)
    steps = torch.arange(total_steps, dtype=torch.float32)
    if scheduler == "cosine_anneal":
        lrs = 0.5 * lr * (1.0 + torch.cos(torch.pi * steps / total_steps))
        return torch.clamp(lrs, min=0.0)
    if scheduler in ("step", "step_decay"):
        m = torch.floor(steps / decay_after_n_steps)
        return torch.clamp(lr * torch.pow(decay_rate, m), min=min_lr)
    raise ValueError("Unknown lr scheduler: {}".format(scheduler))
