"""The joint baseline's step in blocks: `train.joint_step`'s arithmetic,
with each chunk's resize and cross entropy recomputed in the backward.

`train.joint_step` keeps each chunk's log-softmax over the labels' size
for the backward: at EfficientLab-b3's 300^2, batch 64 and 1001 channels,
three chunks of up to 23 images, 8.3 GB each, beside the forward's
activations, more than the card's memory under PyTorch's default
allocator. Here each chunk's `F.interpolate` + `F.cross_entropy` runs
under `torch.utils.checkpoint` (non-reentrant), so the backward holds only
the logits at the decoder's resolution (1.44 GB at b3) and one chunk's
recomputed head at a time. The forward runs once (it draws dropout and
drop-connect from the generator); the augmentation, the chunks of under
2^31 elements, the sum, the l2 term and the update are `train`'s, in the
same order, so the two steps agree bit for bit where the platform's
kernels are deterministic.
"""
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import augment as aug
from portbench.reference import train as ref
from portbench.reference.model import Arch, Forward


def _head_sum(logits, labels):
    """The summed cross entropy of one chunk's logits resized to its
    labels."""
    h, w = labels.shape[1:]
    resized = F.interpolate(logits, size=(h, w), mode="bilinear",
                            align_corners=True)
    return F.cross_entropy(resized, labels.long(), reduction="sum")


def joint_step(arch: Arch, w: ref.Tree, images, labels, seeds, generator,
               lr: float, quantize: bool = False) -> torch.Tensor:
    """One SGD step of the joint baseline on `w` in place, as
    `train.joint_step` takes it (its arguments and its result), each
    chunk's head recomputed in the backward."""
    images, labels = aug.fused_light_augment_reference(
        seeds, images.float(), labels.float(), prob_original=0.0)
    names = ref.params_of(w)
    for k in names:
        w[k].requires_grad_(True)
    low, _ = Forward(arch, w, True, generator, quantize)(images,
                                                         upsample=False)
    n, c = low.shape[:2]
    h, wd = labels.shape[1:]
    k = max(1, min(n, ref.MAX_ELEMENTS // (c * h * wd)))
    total = 0.0
    for i in range(0, n, k):
        total = total + checkpoint(_head_sum, low[i:i + k], labels[i:i + k],
                                   use_reentrant=False)
    loss = total / (n * h * wd) + ref.l2(w)
    params = [w[k] for k in names]
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        torch._foreach_add_(params, grads, alpha=-lr)
    for k in names:
        w[k].requires_grad_(False)
    return loss.detach()
