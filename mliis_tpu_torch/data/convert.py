"""Dataset converters: FSS-1000 image directories -> task shards, and the
joint shards read back.

The port of the JAX package's `data/convert.py` (numpy, PIL and the
shard codecs; mliis_tpu/data/convert.py:31-229), with the reference
converters' semantics:
  - per-task shards (data/fss_1000_image_to_tfrecord.py): each class
    directory of {i}.jpg + {i}.png pairs becomes one gzip tfrecord (or
    npz) shard; an image that is not exactly 224 x 224 is skipped; a mask
    keeps its first channel (foreground 255);
  - joint shards (data/fss_1000_image_to_joint_tfrecord_shards.py):
    `convert_fss_1000_joint` writes class-level train/val/test splits as
    uint16 class-index maps (0 = background) in round-robin shards of
    about 200 examples, with a `classes.txt` class list;
    `load_joint_shards` reads one split back for the joint CLI's
    `--joint_shard_dir`.
PIL is imported only when an image is read: the card's machine has no PIL,
so the converters run where the raw images are.

    python -m mliis_tpu_torch.data.convert --fss_root DIR --out_dir OUT
"""
import glob
import os
from multiprocessing import get_context
from typing import List, Optional, Tuple

import numpy as np

from mliis_tpu_torch.data import manifests, native_loader, tfrecord
from mliis_tpu_torch.data.manifests import IMAGE_DIMS


def _read_image(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im)


def load_class_dir(class_dir: str, image_dims: int = IMAGE_DIMS
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The {i}.jpg / {i}.png pairs of one class directory, sorted by name:
    (images [n, W, W, 3] uint8, masks [n, W, W] uint8); a pair without its
    mask or of the wrong size is skipped."""
    images, masks = [], []
    for jpg in sorted(glob.glob(os.path.join(class_dir, "*.jpg")),
                      key=os.path.basename):
        stem = os.path.splitext(os.path.basename(jpg))[0]
        png = os.path.join(class_dir, stem + ".png")
        if not os.path.exists(png):
            continue
        img = _read_image(jpg)
        msk = _read_image(png)
        if img.shape[0] != image_dims or img.shape[1] != image_dims:
            print("{} is not of expected image dimensions. "
                  "Skipping this sample".format(jpg))
            continue
        if msk.ndim > 2:
            msk = msk[:, :, 0]
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        images.append(img[:, :, :3].astype(np.uint8))
        masks.append(msk.astype(np.uint8))
    if not images:
        return (np.zeros((0, image_dims, image_dims, 3), np.uint8),
                np.zeros((0, image_dims, image_dims), np.uint8))
    return np.stack(images), np.stack(masks)


def _convert_one(job) -> Optional[str]:
    class_dir, out_dir, fmt, image_dims = job
    name = os.path.basename(class_dir.rstrip("/"))
    images, masks = load_class_dir(class_dir, image_dims)
    if images.shape[0] == 0:
        print("No valid samples in {}; skipping shard.".format(class_dir))
        return None
    if fmt == "tfrecord":
        out_path = os.path.join(out_dir, name + ".tfrecord.gzip")
        native_loader.write_shard(out_path, images, masks)
    else:
        out_path = os.path.join(out_dir, name + ".npz")
        np.savez_compressed(out_path, images=images, masks=masks)
    return out_path


def _class_dirs(fss_root: str) -> List[str]:
    return sorted(d for d in glob.glob(os.path.join(fss_root, "*"))
                  if os.path.isdir(d))


def convert_fss_1000(fss_root: str, out_dir: str, fmt: str = "tfrecord",
                     image_dims: int = IMAGE_DIMS,
                     num_workers: int = 8) -> List[str]:
    """One shard per class directory under `fss_root`; returns the paths
    written."""
    if fmt not in ("tfrecord", "npz"):
        raise ValueError("fmt must be tfrecord or npz, not {}".format(fmt))
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(d, out_dir, fmt, image_dims) for d in _class_dirs(fss_root)]
    if num_workers > 1 and len(jobs) > 1:
        with get_context("spawn").Pool(min(num_workers, 8)) as pool:
            results = pool.map(_convert_one, jobs)
    else:
        results = [_convert_one(j) for j in jobs]
    written = [r for r in results if r]
    print("Wrote {} shards to {}".format(len(written), out_dir))
    return written


def convert_fss_1000_joint(fss_root: str, out_dir: str,
                           num_val_tasks: int = 0,
                           fp_k_test_set: bool = False,
                           examples_per_shard: int = 200,
                           image_dims: int = IMAGE_DIMS,
                           num_workers: int = 8) -> List[str]:
    """Joint-training shards: test classes from the canonical (or FP-k)
    manifest, `num_val_tasks` val classes popped off the sorted remainder,
    class ids 1.. in sorted class order, examples dealt round-robin into
    shards of about `examples_per_shard`."""
    os.makedirs(out_dir, exist_ok=True)
    all_classes = sorted(os.path.basename(d) for d in _class_dirs(fss_root))
    test_ids = set(manifests.FP_K_TEST_TASK_IDS if fp_k_test_set
                   else manifests.TEST_TASK_IDS)
    train_classes = [c for c in all_classes if c not in test_ids]
    test_classes = [c for c in all_classes if c in test_ids]
    train_classes, val_classes = manifests.split_train_test_tasks(
        train_classes, num_val_tasks, reproducible_splits=True)
    class_to_id = {c: i + 1 for i, c in enumerate(all_classes)}

    written = []
    for set_name, classes in (("train", train_classes), ("val", val_classes),
                              ("test", test_classes)):
        all_images, all_labels = [], []
        for class_name in classes:
            images, masks = load_class_dir(os.path.join(fss_root, class_name),
                                           image_dims)
            if images.shape[0] == 0:
                continue
            all_images.append(images)
            # uint16: FSS-1000's class ids run to 1000.
            all_labels.append((masks > 127).astype(np.uint16)
                              * np.uint16(class_to_id[class_name]))
        if not all_images:
            continue
        images = np.concatenate(all_images)
        labels = np.concatenate(all_labels)
        num_shards = max(1, -(-images.shape[0] // examples_per_shard))
        shard_args = []
        for s in range(num_shards):
            sel = np.arange(s, images.shape[0], num_shards)
            path = os.path.join(out_dir, "{}_{:03d}.tfrecord.gzip".format(
                set_name, s))
            shard_args.append((path, images[sel], labels[sel]))
        if num_workers > 1 and len(shard_args) > 1:
            with get_context("spawn").Pool(min(num_workers, 8)) as pool:
                pool.starmap(tfrecord.write_segmentation_shard, shard_args)
        else:
            for args in shard_args:
                tfrecord.write_segmentation_shard(*args)
        written.extend(a[0] for a in shard_args)
    with open(os.path.join(out_dir, "classes.txt"), "w") as f:
        f.write("\n".join(all_classes) + "\n")
    print("Wrote {} joint shards to {}".format(len(written), out_dir))
    return written


def load_joint_shards(shard_dir: str, split: str,
                      image_dims: int = IMAGE_DIMS):
    """The shards of one split -> (images uint8, labels uint16 class-index
    maps, class list)."""
    paths = sorted(glob.glob(os.path.join(
        shard_dir, "{}_*.tfrecord*".format(split))))
    images, labels = [], []
    for path in paths:
        imgs, lbls = tfrecord.read_segmentation_shard(path, image_dims)
        images.append(imgs)
        labels.append(lbls)
    with open(os.path.join(shard_dir, "classes.txt")) as f:
        class_names = [line.strip() for line in f if line.strip()]
    if not images:
        return (np.zeros((0, image_dims, image_dims, 3), np.uint8),
                np.zeros((0, image_dims, image_dims), np.uint16), class_names)
    return np.concatenate(images), np.concatenate(labels), class_names


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="Convert FSS-1000 image dirs to task shards.")
    parser.add_argument("--fss_root", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--format", default="tfrecord",
                        choices=["tfrecord", "npz"])
    parser.add_argument("--image_dims", type=int, default=IMAGE_DIMS)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--joint", action="store_true",
                        help="Write joint-training split shards instead of "
                             "per-task shards.")
    parser.add_argument("--num_val_tasks", type=int, default=0)
    parser.add_argument("--fp_k_test_set", action="store_true")
    args = parser.parse_args(argv)
    if args.joint:
        convert_fss_1000_joint(args.fss_root, args.out_dir,
                               num_val_tasks=args.num_val_tasks,
                               fp_k_test_set=args.fp_k_test_set,
                               image_dims=args.image_dims,
                               num_workers=args.num_workers)
    else:
        convert_fss_1000(args.fss_root, args.out_dir, args.format,
                         args.image_dims, args.num_workers)


if __name__ == "__main__":
    main()
