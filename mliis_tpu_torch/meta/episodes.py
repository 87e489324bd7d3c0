"""Episode sampling and inner-loop batch assembly, on the store's device.

The port of the JAX package's `meta/episodes.py`. Every draw takes an
explicit `torch.Generator` on the device of the tensors it indexes, so a
meta-step makes no host round trip:
  - support/query splits are shuffled permutation splits;
  - without-replacement mini-batches are concatenated permutations of the
    support set (epochs whose partial batches carry across boundaries);
  - with-replacement batches draw `batch_size` distinct examples each.

The streams are slot-indexed, as the JAX package's `slot_keys`: a
meta-step draws one seed from the run's generator (`draw_seed`), and its
meta-batch slot s (or an evaluation's task j) draws everything, its task,
shots, batches, augmentation and dropout, from its own generator seeded
from that seed and s (`slot_generator`). The draws of a slot are then the
same whichever rank of a mesh runs it and whatever else runs beside it.
"""
import zlib
from typing import Optional, Sequence, Tuple

import torch

from mliis_tpu_torch.ops.augment import augment_batch, augment_batches


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit words."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed derived from `seed` and `data` (JAX's fold_in)."""
    return _mix64(_mix64(seed & _M64) ^ (data & _M64)) >> 1


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from `generator` (a host read of one number)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def slot_generator(seed: int, slot: int, device) -> torch.Generator:
    """The generator of meta-batch slot (or evaluation task) `slot` of
    the draw seeded `seed`, on `device`."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, slot))


def shard_generator(generator: torch.Generator,
                    offset: int) -> torch.Generator:
    """A data shard's own stream beside a slot's shared `generator`: seeded
    from where that generator stands (its state, read on the host) and
    the shard's first sample position, leaving the shared stream where it
    is."""
    where = zlib.crc32(generator.get_state().numpy().tobytes())
    return torch.Generator(device=generator.device).manual_seed(
        fold_in(fold_in(generator.initial_seed(), where), offset))


def onehot_mask(mask_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W] uint8 fg-255 mask -> [..., H, W, 2] float32 one-hot."""
    mask = mask_u8.float()
    return torch.stack([255.0 - mask, mask], dim=-1) / 255.0


def sample_task_ids(generator: torch.Generator, num_tasks: int,
                    meta_batch_size: int, device) -> torch.Tensor:
    """Uniform task sampling with replacement across the meta-batch."""
    return torch.randint(0, num_tasks, (meta_batch_size,),
                         generator=generator, device=device)


def sample_shot_indices(generator: torch.Generator, count: torch.Tensor,
                        num_shots: int, n_max: int) -> torch.Tensor:
    """`num_shots` distinct indices among the `count` valid slots of a
    padded task row; valid indices repeat when count < num_shots."""
    dev = count.device
    scores = torch.rand(n_max, generator=generator, device=dev)
    scores = torch.where(torch.arange(n_max, device=dev) < count, scores,
                         torch.full_like(scores, float("inf")))
    order = torch.argsort(scores)
    rank = torch.arange(num_shots, device=dev)
    return torch.where(rank < count, order[:num_shots],
                       order[rank % torch.clamp(count, min=1)])


def split_support_query(generator: torch.Generator, total: int,
                        test_shots: int, device
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shuffle, then split off the last `test_shots`."""
    perm = torch.randperm(total, generator=generator, device=device)
    return perm[: total - test_shots], perm[total - test_shots:]


def split_with_replacement(generator: torch.Generator, total: int,
                           train_shots: int, test_shots: int, device
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides drawn i.i.d. with replacement."""
    train = torch.randint(0, total, (train_shots,), generator=generator,
                          device=device)
    test = torch.randint(0, total, (test_shots,), generator=generator,
                         device=device)
    return train, test


def epoch_batch_indices(generator: torch.Generator, n: int, batch_size: int,
                        num_batches: int, device) -> torch.Tensor:
    """[num_batches, batch_size] indices cycling without replacement
    through reshuffled epochs."""
    needed = num_batches * batch_size
    n_epochs = -(-needed // n)
    perms = torch.cat([torch.randperm(n, generator=generator, device=device)
                       for _ in range(n_epochs)])
    return perms[:needed].reshape(num_batches, batch_size)


def replacement_batch_indices(generator: torch.Generator, n: int,
                              batch_size: int, num_batches: int,
                              device) -> torch.Tensor:
    """Each batch is `batch_size` distinct examples, batches independent."""
    if batch_size > n:
        raise ValueError("replacement sampling needs batch_size <= pool "
                         "size ({} > {})".format(batch_size, n))
    return torch.stack([torch.randperm(n, generator=generator,
                                       device=device)[:batch_size]
                        for _ in range(num_batches)])


def batch_indices(generator: torch.Generator, n: int, batch_size: int,
                  num_batches: int, replacement: bool = False,
                  device=None) -> torch.Tensor:
    """[num_batches, batch_size] indices into n examples; [0, batch_size]
    for no batches (a FOMAML* task of one inner step)."""
    if num_batches == 0:
        return torch.zeros((0, batch_size), dtype=torch.long, device=device)
    if replacement:
        return replacement_batch_indices(generator, n, batch_size,
                                         num_batches, device)
    return epoch_batch_indices(generator, n, batch_size, num_batches, device)


def assemble_batch(support_images_u8: torch.Tensor,
                   support_masks_u8: torch.Tensor, idx: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   aug_rate: Optional[float] = None, augment: bool = True,
                   kernels: bool = True, key_offset: int = 0,
                   key_total: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather one inner-loop batch and augment it.

    support_images_u8 [S, H, W, 3] uint8, support_masks_u8 [S, H, W] uint8,
    idx [B]. aug_rate is the probability to augment a sample; None uses the
    Augmenter default gate 6/7; `kernels=False` augments with the kernels'
    plain versions. When `idx` is one shard's slice of a batch of
    `key_total` samples split over a mesh data axis, `key_offset` is the
    slice's first position: the augmentation draws for the whole batch
    and applies the slice's draws (`augment.augment_batch`). Returns
    float32 images [B, H, W, 3] in [0, 255] and one-hot masks
    [B, H, W, 2]."""
    images = support_images_u8[idx].float()
    masks = onehot_mask(support_masks_u8[idx])
    if not augment:
        return images, masks
    prob_original = None if aug_rate is None else 1.0 - aug_rate
    return augment_batch(generator, images, masks, prob_original, kernels,
                         key_offset=key_offset, key_total=key_total)


def gather_tasks(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row idx[t, j] of task t's x[t]: x [T, S, ...], idx [T, B] ->
    [T, B, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def assemble_batches(support_images_u8: torch.Tensor,
                     support_masks_u8: torch.Tensor, idx: torch.Tensor,
                     generators: Optional[Sequence[torch.Generator]] = None,
                     aug_rate: Optional[float] = None, augment: bool = True,
                     kernels: bool = True, key_offset: int = 0,
                     key_total: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`assemble_batch` of T tasks at once: support_images_u8 [T, S, H,
    W, 3], support_masks_u8 [T, S, H, W], idx [T, B]; task t's batch
    gathered from its own support set and augmented with draws from
    generators[t], all T batches in one pass (`augment.augment_batches`;
    `key_offset` and `key_total` as for `assemble_batch`, each task's
    draws made for its whole batch). Returns images [T, B, H, W, 3] and
    one-hot masks [T, B, H, W, 2]."""
    images = gather_tasks(support_images_u8, idx).float()
    masks = onehot_mask(gather_tasks(support_masks_u8, idx))
    if not augment:
        return images, masks
    prob_original = None if aug_rate is None else 1.0 - aug_rate
    return augment_batches(generators, images, masks, prob_original,
                           kernels, key_offset, key_total)
