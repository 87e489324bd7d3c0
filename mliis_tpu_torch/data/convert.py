"""Joint shards -> arrays: the reading half of the JAX package's
`data/convert.py`, used by the joint CLI's `--joint_shard_dir`.

A joint shard directory holds `<split>_NNN.tfrecord.gzip` shards of uint16
class-index maps and a `classes.txt` class list. The FSS-1000 converter
that writes them (it reads images with PIL) is not ported (ROADMAP.md).
"""
import glob
import os

import numpy as np

from mliis_tpu_torch.data import tfrecord
from mliis_tpu_torch.data.manifests import IMAGE_DIMS


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
