"""The reference's training and evaluation steps: plain PyTorch, one task
at a time, from the weights and seeds the benchmark hands out.

  - `sgd_step`: forward (train mode), the loss, its gradient, theta -= lr g;
  - `adapt`: k-shot adaptation, each step's batch gathered from the support
    set by the index matrix and augmented (six-op composition) with the
    slot's draws;
  - `meta_step`: FOMAML* (first-order MAML with a tail): per slot, 10
    shots split 5 / 5, inner_iters - 1 augmented steps on the train half,
    one raw step on the tail; theta <- theta + eps * mean(last-step
    displacement); the running stats are the slots' mean;
  - `eval_task`: adapt on 5 support shots for inner_iters augmented steps,
    then predict the 5 query shots with the running stats;
  - `joint_step`: the 1000-way baseline's step: the four-op augmentation of
    a batch, the resized cross entropy over 1001 channels plus l2.

The loss of the meta path is the softmax cross entropy over pixels minus
ln(2 IoU / (IoU + 1)), IoU the batch mean of the per-image soft IoU on the
foreground channel (bce_dice), plus 5e-4 * sum(v^2) / 2 over the weights
that are not batch norm's (l2).
"""
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import augment as aug
from portbench.reference import draws as dr
from portbench.reference.model import (Arch, Forward, forward_draws,
                                       is_bn, is_buffer)

Tree = Dict[str, torch.Tensor]
EPSILON = 1e-7
WEIGHT_DECAY = 5e-4
MAX_ELEMENTS = 2 ** 31 - 1


def params_of(w: Tree) -> List[str]:
    return [k for k in w if not is_buffer(k)]


def l2(w: Tree) -> torch.Tensor:
    """5e-4 * sum(v^2) / 2 over the weights that are not batch norm's."""
    flat = torch.cat([v.reshape(-1) for k, v in w.items()
                      if not is_buffer(k) and not is_bn(k)])
    return WEIGHT_DECAY * flat.square().sum() / 2.0


def seg_loss(logits, probs, labels, w: Tree) -> torch.Tensor:
    """bce_dice + l2 of NHWC logits against one-hot labels [N, H, W, 2]."""
    n = logits.shape[0]
    ce = -(labels * F.log_softmax(logits, dim=-1)).sum(-1).mean()
    t, p = labels[..., 1].reshape(n, -1), probs[..., 1].reshape(n, -1)
    inter = (p * t).sum(1)
    iou = ((inter + EPSILON) / (p.sum(1) + t.sum(1) - inter + EPSILON)
           ).mean()
    return ce - torch.log(2.0 * iou / (iou + 1.0)) + l2(w)


def sgd_step(arch: Arch, w: Tree, images, labels, generator, lr: float,
             drop_rate: Optional[float], quantize: bool) -> torch.Tensor:
    """One SGD step on `w` in place; returns the loss."""
    names = params_of(w)
    for k in names:
        w[k].requires_grad_(True)
    logits, probs = Forward(arch, w, True, generator, quantize)(
        images, drop_rate)
    loss = seg_loss(logits, probs, labels, w)
    params = [w[k] for k in names]
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        torch._foreach_add_(params, grads, alpha=-lr)
    for k in names:
        w[k].requires_grad_(False)
    return loss.detach()


def adapt(arch: Arch, w: Tree, images_u8, masks_u8, idx, generator,
          lr: float, augmented: bool, prob_original: float,
          drop_rate: Optional[float], quantize: bool,
          chunk: int = 128) -> Tree:
    """A copy of `w` after one SGD step for each row of idx [steps, B].
    Each step draws its augmentation, then its forward's uniforms; the
    draws of all steps are made first, in that order, so that the steps'
    augmentations can be applied `chunk` images at a time."""
    w = {k: v.detach().clone() for k, v in w.items()}
    steps, b = idx.shape
    h, wd = images_u8.shape[1:3]
    dev = images_u8.device
    aug_draws, tapes = [], []
    for _ in range(steps):
        if augmented:
            aug_draws.append(dr.augment_draws(generator, b, prob_original,
                                              dev))
        tapes.append(forward_draws(arch, generator, b, h, wd, drop_rate))
    flat = idx.reshape(-1)
    images = images_u8[flat].float()
    masks = dr.onehot_mask(masks_u8[flat])
    if augmented:   # planar [N, 5, H, W], viewed NHWC a step at a time
        perm, num, seeds, rot = (torch.cat(p) for p in zip(*aug_draws))
        planar = torch.cat([images, masks], dim=-1).permute(0, 3, 1, 2)
        planar = torch.cat([aug.full_pass_reference(
            seeds[a:a + chunk], planar[a:a + chunk].contiguous(),
            perm[a:a + chunk], num[a:a + chunk], rot[a:a + chunk], c_img=3)
            for a in range(0, flat.shape[0], chunk)])
        nhwc = planar.permute(0, 2, 3, 1)
        images, masks = nhwc[..., :3], nhwc[..., 3:]
    for i in range(steps):
        sl = slice(i * b, (i + 1) * b)
        sgd_step(arch, w, images[sl], masks[sl], tapes[i], lr, drop_rate,
                 quantize)
    return w


def meta_step(arch: Arch, w: Tree, store_images, store_masks, counts,
              seed: int, m: dict, eps: float, lr: float,
              quantize: bool = False) -> Tree:
    """One FOMAML* meta-step of `m`'s sizes (num_shots, tail_shots,
    inner_batch, inner_iters, meta_batch, aug_rate) from `w`, slot s drawing
    from fold_in(seed, s)."""
    dev = store_images.device
    n_max = store_images.shape[1]
    num_tasks = store_images.shape[0]
    shots, tail = m["num_shots"], m["tail_shots"]
    updates, stats = [], []
    for s in range(m["meta_batch"]):
        g = dr.slot_generator(seed, s, dev)
        tid = int(dr.task_id(g, num_tasks))
        shot = dr.shot_indices(g, counts[tid], shots, n_max)
        train_rel, tail_rel = dr.split(g, shots, tail)
        idx = dr.epoch_batches(g, shots - tail, m["inner_batch"],
                               m["inner_iters"] - 1)
        images, masks = store_images[tid][shot], store_masks[tid][shot]
        pre = adapt(arch, w, images[train_rel], masks[train_rel], idx, g,
                    lr, True, 1.0 - m["aug_rate"], None, quantize)
        final = adapt(arch, pre, images[tail_rel], masks[tail_rel],
                      torch.arange(tail, device=dev)[None], g, lr, False,
                      1.0, None, quantize)
        updates.append({k: final[k] - pre[k] for k in params_of(w)})
        stats.append({k: final[k] for k in w if is_buffer(k)})
    new = {}
    for k, v in w.items():
        if is_buffer(k):
            new[k] = torch.stack([s[k] for s in stats]).mean(0)
        else:
            new[k] = v + eps * torch.stack([u[k] for u in updates]).mean(0)
    return new


def eval_task(arch: Arch, w: Tree, images_u8, masks_u8, count, seed: int,
              slot: int, e: dict, lr: float, drop_rate: float,
              quantize: bool = False) -> Tuple[Tree, torch.Tensor]:
    """(the adapted weights, the query images' indices into the row) of
    one evaluation episode of the task row (images_u8 [n, H, W, 3]) at
    list position `slot` of a chunk seeded `seed`: `inner_iters`
    augmented SGD steps on the support shots."""
    dev = images_u8.device
    g = dr.slot_generator(seed, slot, dev)
    total = e["num_shots"] + e["test_shots"]
    shot = dr.shot_indices(g, count, total, images_u8.shape[0])
    support_rel, query_rel = dr.split(g, total, e["test_shots"])
    idx = dr.epoch_batches(g, e["num_shots"], e["inner_batch"],
                           e["inner_iters"])
    support, query = shot[support_rel], shot[query_rel]
    adapted = adapt(arch, w, images_u8[support], masks_u8[support], idx, g,
                    lr, True, 1.0 - e["aug_rate"], drop_rate, quantize)
    return adapted, query


def predict(arch: Arch, w: Tree, images_u8, quantize: bool = False
            ) -> torch.Tensor:
    """Query probabilities [Q, H, W, 2] with the running stats."""
    with torch.no_grad():
        _, probs = Forward(arch, {k: v.clone() for k, v in w.items()},
                           False, None, quantize)(images_u8.float())
    return probs.float()


def joint_step(arch: Arch, w: Tree, images, labels, seeds, generator,
               lr: float, quantize: bool = False) -> torch.Tensor:
    """One SGD step of the joint baseline on `w` in place: the batch
    (uint8 images [B, H, W, 3], int class maps [B, H, W]) augmented by the
    four light ops (every sample augmented), the logits at the decoder's
    resolution resized to the labels a chunk of under 2^31 at a time, the
    mean cross entropy plus l2. Returns the loss."""
    images, labels = aug.fused_light_augment_reference(
        seeds, images.float(), labels.float(), prob_original=0.0)
    names = params_of(w)
    for k in names:
        w[k].requires_grad_(True)
    low, _ = Forward(arch, w, True, generator, quantize)(images,
                                                         upsample=False)
    n, c = low.shape[:2]
    h, wd = labels.shape[1:]
    k = max(1, min(n, MAX_ELEMENTS // (c * h * wd)))
    total = 0.0
    for i in range(0, n, k):
        logits = F.interpolate(low[i:i + k], size=(h, wd), mode="bilinear",
                               align_corners=True)
        total = total + F.cross_entropy(logits, labels[i:i + k].long(),
                                        reduction="sum")
    loss = total / (n * h * wd) + l2(w)
    params = [w[k] for k in names]
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        torch._foreach_add_(params, grads, alpha=-lr)
    for k in names:
        w[k].requires_grad_(False)
    return loss.detach()


def meta_step_size(step: int, meta_iters: int, initial: float,
                   final: float) -> float:
    """The linear anneal of the meta step size."""
    frac = step / meta_iters
    return frac * final + (1.0 - frac) * initial


def leaf_gap(prog: Tree, ref: Tree, keep: Optional[List[str]] = None
             ) -> Tuple[float, str]:
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of
    norm(ref) and the median leaf's norm(ref), over the leaves `keep` (all
    of ref's by default); with the leaf it came from."""
    keep = list(ref) if keep is None else keep
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    median = sorted(ref_n.values())[len(ref_n) // 2]
    worst, leaf = 0.0, ""
    for k in keep:
        gap = abs(float(prog[k].double().norm()) - ref_n[k]) \
            / max(ref_n[k], median, 1e-30)
        if gap > worst or math.isnan(gap):
            worst, leaf = gap, k
    return worst, leaf


def median_leaf_gap(prog: Tree, ref: Tree, keep: List[str]) -> float:
    """The median over the leaves `keep` of |norm(prog) - norm(ref)| /
    norm(ref)."""
    gaps = sorted(abs(float(prog[k].double().norm())
                      - float(ref[k].double().norm()))
                  / max(float(ref[k].double().norm()), 1e-30) for k in keep)
    return gaps[len(gaps) // 2]


def moving_leaves(ref_first: Tree, share: float = 1e-3) -> List[str]:
    """Leaves whose reference first update is at least `share` of the
    median leaf's: the others move by round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in ref_first.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= share * median]
