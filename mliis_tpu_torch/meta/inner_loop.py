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
"""
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mliis_tpu_torch.meta import episodes
from mliis_tpu_torch.ops import losses as losses_lib

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


def make_loss_and_grad(model: torch.nn.Module, loss_config: LossConfig):
    """(images, masks, generator, drop_rate) -> (loss, grads) at the
    module's current params; the forward updates the running stats."""
    params = dict(model.named_parameters())

    def loss_and_grad(images, masks, generator, drop_rate):
        logits, probs = model(images, train=True,
                              final_layer_dropout_rate=drop_rate,
                              generator=generator)
        loss = losses_lib.segmentation_loss(
            logits, probs, masks, params,
            label_smoothing=loss_config.label_smoothing,
            dice=loss_config.dice,
            binary_iou_loss=loss_config.binary_iou_loss, l2=loss_config.l2,
            l1=loss_config.l1, darc1=loss_config.darc1)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), grads

    return loss_and_grad


def sgd_step(model: torch.nn.Module, loss_config: LossConfig,
             opt_config: OptimizerConfig, weight_decay_rate: float = 1.0):
    """One inner step on the module: (opt, images, masks, generator, lr,
    drop_rate) -> (opt, loss)."""
    loss_and_grad = make_loss_and_grad(model, loss_config)
    params = list(model.parameters())

    def step(opt: OptState, images, masks, generator, lr, drop_rate):
        if weight_decay_rate != 1.0:
            with torch.no_grad():
                torch._foreach_mul_(params, weight_decay_rate)
        loss, grads = loss_and_grad(images, masks, generator, drop_rate)
        return apply_optimizer_(params, grads, opt, lr, opt_config), loss

    return step


def make_adapt_fn(model: torch.nn.Module, loss_config: LossConfig,
                  opt_config: OptimizerConfig,
                  weight_decay_rate: float = 1.0, augment: bool = True,
                  precompute_augment: bool = False,
                  pallas_augment: Optional[bool] = None) -> Callable:
    """Builds adapt(state, support_images_u8, support_masks_u8, idx_matrix,
    generator, lrs, drop_rate=None, aug_rate=None) -> (adapted ModelState,
    per-step losses [steps]).

    idx_matrix: [steps, batch] indices into the support set; lrs: [steps]
    learning rates. precompute_augment=True augments every step's batch
    before the loop and stages it in bf16 (the JAX package's memory-bound
    variant); the default augments inside each step. pallas_augment None
    or True augments through the kernels' wrappers, False through their
    plain versions."""
    step_fn = sgd_step(model, loss_config, opt_config, weight_decay_rate)

    def adapt(state: ModelState, support_images_u8, support_masks_u8,
              idx_matrix, generator, lrs, drop_rate=None, aug_rate=None
              ) -> Tuple[ModelState, torch.Tensor]:
        load_state(model, state)
        opt = state.opt
        lr_list = [float(v) for v in torch.as_tensor(lrs, dtype=torch.float32)]

        def batch(i):
            return episodes.assemble_batch(
                support_images_u8, support_masks_u8, idx_matrix[i],
                generator, aug_rate=aug_rate, augment=augment,
                kernels=pallas_augment is not False)

        staged = None
        if precompute_augment and augment:
            staged = [tuple(t.to(torch.bfloat16) for t in batch(i))
                      for i in range(len(lr_list))]
        losses = []
        for i, lr in enumerate(lr_list):
            if staged is None:
                images, masks = batch(i)
            else:
                images, masks = (t.float() for t in staged[i])
            opt, loss = step_fn(opt, images, masks, generator, lr, drop_rate)
            losses.append(loss)
        if not losses:   # zero steps: a FOMAML* task of one inner step
            return snapshot(model, opt), torch.zeros(0)
        return snapshot(model, opt), torch.stack(losses)

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
