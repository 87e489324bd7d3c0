"""Synthetic binary-segmentation task generator (numpy).

A copy of the JAX package's generator: the same seed gives byte-identical
arrays (tests/test_torch_ops.py checks it). Each synthetic "class" is a
shape/colour family placed at random positions and scales over textured
backgrounds, so k-shot adaptation is learnable. Only the default shape
families are copied.
"""
import numpy as np

from mliis_tpu_torch.data.task_store import TaskStore

_SHAPES = ("rect", "ellipse", "cross")


def _render_shape(shape: str, yy, xx, cy, cx, ry, rx):
    if shape == "rect":
        return (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
    if shape == "ellipse":
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    if shape == "cross":
        return ((np.abs(yy - cy) < 0.35 * ry) & (np.abs(xx - cx) < rx)) | \
               ((np.abs(yy - cy) < ry) & (np.abs(xx - cx) < 0.35 * rx))
    raise ValueError("unknown shape family: {}".format(shape))


def _render_example(rng: np.random.Generator, shape: str, color: np.ndarray,
                    image_size: int):
    h = w = image_size
    yy, xx = np.mgrid[0:h, 0:w]
    image = rng.integers(0, 256, (h, w, 3)).astype(np.float32) * 0.3
    image += rng.uniform(0, 150, (1, 1, 3))

    cy = rng.uniform(0.25 * h, 0.75 * h)
    cx = rng.uniform(0.25 * w, 0.75 * w)
    ry = rng.uniform(0.1 * h, 0.25 * h)
    rx = rng.uniform(0.1 * w, 0.25 * w)

    fg = _render_shape(shape, yy, xx, cy, cx, ry, rx)
    image[fg] = color + rng.normal(0, 10, (int(fg.sum()), 3))
    image = np.clip(image, 0, 255).astype(np.uint8)
    mask = (fg * 255).astype(np.uint8)
    return image, mask


def make_synthetic_store(num_tasks: int = 16, examples_per_task: int = 10,
                         image_size: int = 64, seed: int = 0) -> TaskStore:
    rng = np.random.default_rng(seed)
    tasks, names = [], []
    for t in range(num_tasks):
        shape = _SHAPES[t % len(_SHAPES)]
        color = rng.uniform(100, 255, 3)
        images, masks = [], []
        for _ in range(examples_per_task):
            img, msk = _render_example(rng, shape, color, image_size)
            images.append(img)
            masks.append(msk)
        tasks.append((np.stack(images), np.stack(masks)))
        names.append("synthetic_{}_{:04d}".format(shape, t))
    return TaskStore.from_task_arrays(tasks, names)
