"""ctypes bindings of the native C++ tfrecord shard reader and writer.

The port of the JAX package's `data/native_loader.py`. The library is the
committed `native/libtfrecord_loader.so`, built from
`native/tfrecord_loader.cc` by `make -C native` (zlib and pthreads, no
Python headers): a thread pool that counts, reads and writes the
reference's gzip TFRecord shards in parallel. Where the library is absent
or does not load on this machine, every function takes the Python codec
(`data/tfrecord.py`), which reads and writes the same bytes: a choice of
data reader, made on the host. `reader_name()` says which one runs.
"""
import ctypes
import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from mliis_tpu_torch.data import tfrecord

LIB_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native",
    "libtfrecord_loader.so"))

_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _load_library() -> Optional[ctypes.CDLL]:
    """The library with its signatures declared, or None when it is absent
    or the loader refuses it."""
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError as e:
        print("native_loader: {} does not load ({}); the Python codec "
              "reads the shards".format(LIB_PATH, e))
        return None
    lib.tl_count_examples.argtypes = [ctypes.c_char_p]
    lib.tl_count_examples.restype = ctypes.c_int
    lib.tl_read_shards_parallel.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P, _U8P,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int]
    lib.tl_read_shards_parallel.restype = ctypes.c_int
    lib.tl_write_shard.argtypes = [ctypes.c_char_p, _U8P, _U8P,
                                   ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.tl_write_shard.restype = ctypes.c_int
    lib.tl_write_shards_parallel.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P, _U8P,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int]
    lib.tl_write_shards_parallel.restype = ctypes.c_int
    return lib


def native_loader_available() -> bool:
    return _load_library() is not None


def reader_name() -> str:
    """"native" or "Python": the codec the functions below use."""
    return "native" if native_loader_available() else "Python"


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def count_examples(path: str) -> int:
    lib = _load_library()
    if lib is None:
        return len(tfrecord.read_tfrecord_file(
            path, gzipped=path.endswith("gzip")))
    count = lib.tl_count_examples(path.encode())
    if count < 0:
        raise IOError("native loader failed on {} (code {})".format(
            path, count))
    return count


def read_shards(paths: List[str], image_size: int, max_examples: int,
                num_threads: int = 8
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Many shards into padded arrays: (images [S, max_examples, W, W, 3]
    uint8, masks [S, max_examples, W, W] uint8, counts [S] int32); a shard
    longer than `max_examples` is cut."""
    n = len(paths)
    images = np.zeros((n, max_examples, image_size, image_size, 3), np.uint8)
    masks = np.zeros((n, max_examples, image_size, image_size), np.uint8)
    counts = np.zeros((n,), np.int32)
    lib = _load_library()
    if lib is None:
        for i, path in enumerate(paths):
            imgs, msks = tfrecord.read_segmentation_shard(path, image_size)
            c = min(imgs.shape[0], max_examples)
            images[i, :c], masks[i, :c], counts[i] = imgs[:c], msks[:c], c
        return images, masks, counts
    ok = lib.tl_read_shards_parallel(
        _c_paths(paths), n, images.ctypes.data_as(_U8P),
        masks.ctypes.data_as(_U8P),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_examples, image_size * image_size * 3, image_size * image_size,
        num_threads)
    if ok != n:
        bad = [(paths[i], int(counts[i])) for i in range(n) if counts[i] < 0]
        raise IOError("native loader failed on {} shards: {}".format(
            n - ok, bad[:5]))
    return images, masks, counts


def write_shard(path: str, images: np.ndarray, masks: np.ndarray) -> None:
    """One gzip TFRecord shard in the reference's format."""
    lib = _load_library()
    if lib is None:
        tfrecord.write_segmentation_shard(path, images, masks)
        return
    images = np.ascontiguousarray(images, np.uint8)
    masks = np.ascontiguousarray(masks, np.uint8)
    n = images.shape[0]
    rc = lib.tl_write_shard(path.encode(), images.ctypes.data_as(_U8P),
                            masks.ctypes.data_as(_U8P), n,
                            int(np.prod(images.shape[1:])),
                            int(np.prod(masks.shape[1:])))
    if rc != n:
        raise IOError("native writer failed on {} (code {})".format(path, rc))


def write_shards(paths: List[str], images: np.ndarray, masks: np.ndarray,
                 offsets: np.ndarray, counts: np.ndarray,
                 num_threads: int = 8) -> None:
    """Many shards from one flat example store, in parallel: shard i holds
    examples [offsets[i], offsets[i] + counts[i])."""
    lib = _load_library()
    if lib is None:
        for path, lo, c in zip(paths, offsets, counts):
            lo, hi = int(lo), int(lo) + int(c)
            tfrecord.write_segmentation_shard(path, images[lo:hi],
                                              masks[lo:hi])
        return
    images = np.ascontiguousarray(images, np.uint8)
    masks = np.ascontiguousarray(masks, np.uint8)
    n = len(paths)
    offsets64 = np.ascontiguousarray(offsets, np.int64)
    counts32 = np.ascontiguousarray(counts, np.int32)
    results = np.zeros((n,), np.int32)
    ok = lib.tl_write_shards_parallel(
        _c_paths(paths), n, images.ctypes.data_as(_U8P),
        masks.ctypes.data_as(_U8P),
        offsets64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(np.prod(images.shape[1:])), int(np.prod(masks.shape[1:])),
        results.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), num_threads)
    if ok != n:
        bad = [(paths[i], int(results[i])) for i in range(n)
               if results[i] < 0]
        raise IOError("native writer failed on {} shards: {}".format(
            n - ok, bad[:5]))
