"""The random streams of an episode, re-derived from the seeds the
benchmark hands out.

A meta-step (or an evaluation chunk) has one 62-bit seed; its slot s draws
everything, its task, shots, split, batch order, augmentation, dropout and
drop-connect, from a `torch.Generator` on the device seeded with
fold_in(seed, s) (splitmix64's finalizer). The functions below make the
draws in the order and with the shapes the stated protocol makes them, so
the same seed on the same device gives the same numbers.
"""
from typing import Tuple

import torch

_M64 = (1 << 64) - 1
NUM_OPS = 6
NUM_ROTATE_MODES = 4


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 63-bit seed from `seed` and `data`."""
    return _mix64(_mix64(seed & _M64) ^ (data & _M64)) >> 1


def draw_seed(generator: torch.Generator) -> int:
    """One 62-bit seed from `generator`."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def slot_generator(seed: int, slot: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_in(seed, slot))


def onehot_mask(mask_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W] uint8 (foreground 255) -> [..., H, W, 2] float32."""
    mask = mask_u8.float()
    return torch.stack([255.0 - mask, mask], dim=-1) / 255.0


def task_id(generator, num_tasks: int) -> torch.Tensor:
    return torch.randint(0, num_tasks, (1,), generator=generator,
                         device=generator.device)


def shot_indices(generator, count: torch.Tensor, num_shots: int,
                 n_max: int) -> torch.Tensor:
    """`num_shots` distinct indices among a task row's `count` valid ones
    (the order of uniform scores; repeats when count < num_shots)."""
    dev = count.device
    scores = torch.rand(n_max, generator=generator, device=dev)
    scores = torch.where(torch.arange(n_max, device=dev) < count, scores,
                         torch.full_like(scores, float("inf")))
    order = torch.argsort(scores)
    rank = torch.arange(num_shots, device=dev)
    return torch.where(rank < count, order[:num_shots],
                       order[rank % torch.clamp(count, min=1)])


def split(generator, total: int, test: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """A shuffle of range(total); its last `test` are split off."""
    perm = torch.randperm(total, generator=generator,
                          device=generator.device)
    return perm[:total - test], perm[total - test:]


def epoch_batches(generator, n: int, batch: int, steps: int
                  ) -> torch.Tensor:
    """[steps, batch] indices into n examples, through reshuffled epochs."""
    if steps == 0:
        return torch.zeros((0, batch), dtype=torch.long,
                           device=generator.device)
    needed = steps * batch
    perms = torch.cat([torch.randperm(n, generator=generator,
                                      device=generator.device)
                       for _ in range(-(-needed // n))])
    return perms[:needed].reshape(steps, batch)


def augment_draws(generator, b: int, prob_original: float, device):
    """The per-sample draws of the six-op augmentation (square planes):
    (perm [b, 6], prefix length [b] (0 passes through), Philox seeds [b],
    rotation [b, 4]: angle, border mode, noise-fill bit, fill value)."""
    def randint(low, high):
        return torch.randint(low, high, (b,), generator=generator,
                             device=device, dtype=torch.int32)

    skip = torch.rand(b, generator=generator, device=device) \
        <= prob_original
    perm = torch.argsort(torch.rand(b, NUM_OPS, generator=generator,
                                    device=device), dim=1).to(
        torch.int32).contiguous()
    num = torch.where(skip, 0, randint(1, NUM_OPS + 1))
    seeds = randint(0, 2 ** 31 - 1)
    rot = torch.stack([randint(-45, 45), randint(0, NUM_ROTATE_MODES),
                       randint(0, 2), randint(0, 256)], dim=1)
    return perm, num, seeds, rot


def light_seeds(generator, steps: int, batch: int) -> torch.Tensor:
    """[steps, batch] int32 per-sample seeds of the joint augmentation."""
    return torch.randint(0, 2 ** 31 - 1, (steps, batch),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)


def epoch_order(generator, n: int, steps: int, batch: int) -> torch.Tensor:
    """[steps, batch] example indices: shuffled visits of n examples."""
    needed = steps * batch
    order = torch.cat([torch.randperm(n, generator=generator,
                                      device=generator.device)
                       for _ in range(-(-needed // n))])
    return order[:needed].view(steps, batch)
