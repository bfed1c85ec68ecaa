"""TensorBoard event files of scalars, written without TensorFlow,
tensorboard or protobuf: what `tf.summary.create_file_writer(log_dir)` and
`tf.summary.scalar(tag, value, step)` write, as the JAX package's
MetricsLogger writes them where TensorFlow imports.

A file `events.out.tfevents.<secs>.<host>.<pid>.<n>.v2` in the log
directory holds TFRecords: each a uint64 length, the masked CRC-32C of the
length's 8 bytes, the data, and the data's masked CRC-32C (little-endian).
Each record is one `Event` protobuf, encoded here by hand:

  the first     wall_time (1, double), file_version (3) "brain.Event:2";
  one a scalar  wall_time, step (2, int64) and summary (5): one
                Summary.Value (1) with tag (1), metadata (9): plugin_data
                (1) {plugin_name (1) "scalars"} and data_class (4)
                DATA_CLASS_SCALAR (1), and tensor (8): dtype (1) DT_FLOAT
                (1), an empty tensor_shape (2: rank 0) and tensor_content
                (4) the float32's 4 bytes.

`read_scalars` walks such a file back, each record's CRCs checked.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from itertools import count
from typing import Iterator, List, Tuple

from tfssd_torch.utils.ocdbt import crc32c

FILE_VERSION = "brain.Event:2"
SCALARS_PLUGIN = "scalars"
DATA_CLASS_SCALAR = 1
DT_FLOAT = 1


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 as protobuf encodes a negative one
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _masked_crc(data: bytes) -> bytes:
    crc = crc32c(data)
    return struct.pack("<I", ((crc >> 15 | crc << 17) + 0xA282EAD8)
                       & 0xFFFFFFFF)


def record(data: bytes) -> bytes:
    """One TFRecord around `data`."""
    length = struct.pack("<Q", len(data))
    return length + _masked_crc(length) + data + _masked_crc(data)


def file_version_event(wall_time: float) -> bytes:
    return (_varint(1 << 3 | 1) + struct.pack("<d", wall_time)
            + _field(3, FILE_VERSION.encode()))


def scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    metadata = (_field(1, _field(1, SCALARS_PLUGIN.encode()))
                + _varint(4 << 3) + _varint(DATA_CLASS_SCALAR))
    tensor = (_varint(1 << 3) + _varint(DT_FLOAT) + _field(2, b"")
              + _field(4, struct.pack("<f", value)))
    summary_value = (_field(1, tag.encode()) + _field(9, metadata)
                     + _field(8, tensor))
    return (_varint(1 << 3 | 1) + struct.pack("<d", wall_time)
            + _varint(2 << 3) + _varint(step)
            + _field(5, _field(1, summary_value)))


class EventFileWriter:
    """A new event file in `log_dir`, its file_version record written; a
    file name already taken (a second writer in the same second) takes the
    next <n>."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        wall = time.time()
        stem = (f"events.out.tfevents.{int(wall):010d}."
                f"{socket.gethostname()}.{os.getpid()}")
        for n in count():
            self.path = os.path.join(log_dir, f"{stem}.{n}.v2")
            try:
                self._f = open(self.path, "xb")
                break
            except FileExistsError:
                continue
        self._f.write(record(file_version_event(wall)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float) -> None:
        self._f.write(record(scalar_event(tag, value, step, wall_time)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: an int for
    wire types 0, 1 and 5 (the raw bits), bytes for 2."""
    pos = 0

    def varint() -> int:
        nonlocal pos
        value = shift = 0
        while True:
            b = data[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7

    while pos < len(data):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            yield number, wire, varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            yield number, wire, int.from_bytes(data[pos:pos + size],
                                               "little")
            pos += size
        elif wire == 2:
            size = varint()
            yield number, wire, data[pos:pos + size]
            pos += size
        else:
            raise ValueError(f"protobuf wire type {wire}")
        if pos > len(data):
            raise ValueError("protobuf message ends early")


def read_records(path: str) -> List[bytes]:
    """The data of every TFRecord in `path`, both CRCs checked."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        head = data[pos:pos + 12]
        if len(head) < 12 or _masked_crc(head[:8]) != head[8:]:
            raise ValueError(f"{path}: bad record length at {pos}")
        n = struct.unpack("<Q", head[:8])[0]
        body, crc = data[pos + 12:pos + 12 + n], data[pos + 12 + n:
                                                      pos + 16 + n]
        if len(crc) < 4 or _masked_crc(body) != crc:
            raise ValueError(f"{path}: bad record data at {pos}")
        out.append(body)
        pos += 16 + n
    return out


def read_scalars(path: str) -> Tuple[str, List[Tuple[str, int, float]]]:
    """(file_version, [(tag, step, value), ...]) of an event file of
    scalars, as EventFileWriter writes it."""
    version, scalars = "", []
    for data in read_records(path):
        event = {n: v for n, _, v in _fields(data)}
        if 3 in event:
            version = event[3].decode()
            continue
        value = dict((n, v) for n, _, v in _fields(
            dict((n, v) for n, _, v in _fields(event[5]))[1]))
        tensor = {n: v for n, _, v in _fields(value[8])}
        if tensor.get(1) != DT_FLOAT:
            raise ValueError(f"{path}: a tensor of dtype {tensor.get(1)}")
        scalars.append((value[1].decode(), event.get(2, 0),
                        struct.unpack("<f", tensor[4])[0]))
    return version, scalars
