"""TFRecord + tf.train.Example codec in numpy, without TensorFlow.

The port's copy of the JAX package's codec: gzip TFRecord framing
(length-delimited records, each with a masked CRC32C) around Examples whose
'image' and 'mask' features are raw bytes. Per-task shards hold uint8
masks with foreground 255; joint shards hold little-endian uint16 class
maps, told apart by their byte length.
"""
import gzip
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def _crc32c_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire format: what Example needs.
# ---------------------------------------------------------------------------

def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _length_delimited(field_number: int, payload: bytes) -> bytes:
    return (_encode_varint((field_number << 3) | 2)
            + _encode_varint(len(payload)) + payload)


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field_number, wire_type, payload) over a serialized message."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _decode_varint(buf, pos)
        field_number, wire_type = key >> 3, key & 7
        if wire_type == 2:
            length, pos = _decode_varint(buf, pos)
            yield field_number, wire_type, buf[pos:pos + length]
            pos += length
        elif wire_type == 0:
            value, pos = _decode_varint(buf, pos)
            yield field_number, wire_type, value
        elif wire_type in (1, 5):   # 64-bit, 32-bit
            size = 8 if wire_type == 1 else 4
            yield field_number, wire_type, buf[pos:pos + size]
            pos += size
        else:
            raise ValueError("Unsupported wire type {}".format(wire_type))


def _submessages(buf: bytes, field_number: int) -> Iterator[bytes]:
    for fnum, wtype, payload in _iter_fields(buf):
        if fnum == field_number and wtype == 2:
            yield payload


def encode_example(features: Dict[str, bytes]) -> bytes:
    """{name: raw bytes} -> a serialized Example of BytesList features."""
    entries = b""
    for name, value in features.items():
        feature = _length_delimited(1, _length_delimited(1, value))
        entry = (_length_delimited(1, name.encode("utf-8"))
                 + _length_delimited(2, feature))
        entries += _length_delimited(1, entry)
    return _length_delimited(1, entries)


def decode_example(buf: bytes) -> Dict[str, List[bytes]]:
    """A serialized Example -> {feature name: [bytes, ...]}."""
    out: Dict[str, List[bytes]] = {}
    for features in _submessages(buf, 1):
        for entry in _submessages(features, 1):
            key, values = None, []
            for fnum, wtype, payload in _iter_fields(entry):
                if fnum == 1 and wtype == 2:
                    key = payload.decode("utf-8")
                elif fnum == 2 and wtype == 2:
                    for bytes_list in _submessages(payload, 1):
                        values.extend(_submessages(bytes_list, 1))
            if key is not None:
                out[key] = values
    return out


# ---------------------------------------------------------------------------
# TFRecord framing.
# ---------------------------------------------------------------------------

def read_tfrecord_file(path: str, gzipped: bool = True) -> List[bytes]:
    opener = gzip.open if gzipped else open
    with opener(path, "rb") as f:
        data = f.read()
    records, pos = [], 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        pos += 12                      # the length and its crc
        records.append(data[pos:pos + length])
        pos += length + 4              # the record and its crc
    return records


def write_tfrecord_file(path: str, records: Sequence[bytes],
                        gzipped: bool = True) -> None:
    opener = gzip.open if gzipped else open
    with opener(path, "wb") as f:
        for record in records:
            length = struct.pack("<Q", len(record))
            f.write(length)
            f.write(struct.pack("<I", _masked_crc(length)))
            f.write(record)
            f.write(struct.pack("<I", _masked_crc(record)))


# ---------------------------------------------------------------------------
# Segmentation shards.
# ---------------------------------------------------------------------------

def read_segmentation_shard(path: str, image_width: int = 224
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """One shard -> (images [N, W, W, 3] uint8, masks [N, W, W]): uint8 for
    per-task shards, uint16 for joint class maps."""
    images, masks = [], []
    for record in read_tfrecord_file(path, gzipped=path.endswith("gzip")):
        feats = decode_example(record)
        images.append(np.frombuffer(feats["image"][0], np.uint8).reshape(
            image_width, image_width, 3))
        buf = feats["mask"][0]
        dtype = "<u2" if len(buf) == 2 * image_width * image_width \
            else np.uint8
        masks.append(np.frombuffer(buf, dtype).reshape(image_width,
                                                       image_width))
    if not images:
        return (np.zeros((0, image_width, image_width, 3), np.uint8),
                np.zeros((0, image_width, image_width), np.uint8))
    return np.stack(images), np.stack(masks)


def write_segmentation_shard(path: str, images: np.ndarray,
                             masks: np.ndarray) -> None:
    """Write (images uint8, masks uint8 or uint16) as one gzip shard; uint16
    masks go to disk little-endian."""
    records = []
    for img, mask in zip(images, masks):
        mask = (np.ascontiguousarray(mask, "<u2") if masks.dtype == np.uint16
                else np.ascontiguousarray(mask, np.uint8))
        records.append(encode_example({
            "image": np.ascontiguousarray(img, np.uint8).tobytes(),
            "mask": mask.tobytes()}))
    write_tfrecord_file(path, records, gzipped=True)


def count_examples_in_tfrecords(paths: Sequence[str]) -> int:
    """The number of records in the shards `paths` (gzipped where the name
    ends in "gzip")."""
    return sum(len(read_tfrecord_file(path, gzipped=path.endswith("gzip")))
               for path in paths)
