"""TensorBoard event files, written without tensorboardX, tensorboard or
protobuf.

The JAX package's trainers log through tensorboardX's ``SummaryWriter``
into ``<run_dir>/tensorboard``; `EventWriter` writes the same records for
the same ``add_scalar`` and ``add_image`` calls, so whatever reads a JAX
run's log (TensorBoard, its ``EventFileLoader``) reads the port's.

File: ``events.out.tfevents.<unix time>.<host>``, tensorboardX's name
(the first ten characters of ``str(time.time())``).  Records are
TFRecord-framed: the data's length (uint64 little-endian), the masked
CRC-32C of those eight bytes, the data, the masked CRC-32C of the data
(each uint32 little-endian; masked: rotated right by 15 bits, plus
0xa282ead8).  Each record's data is one ``Event`` protobuf, encoded here
by hand: ``wall_time`` (field 1, double), ``step`` (2, varint),
``file_version`` (3, string; ``"brain.Event:2"`` in the first record) and
``summary`` (5), a ``Summary`` of one ``value`` (1): ``tag`` (1),
``simple_value`` (2, float) or ``image`` (4), an ``Image`` of ``height``
(1), ``width`` (2), ``colorspace`` (3, the channel count) and
``encoded_image_string`` (4, a PNG).

Tags are cleaned as tensorboardX cleans them (characters other than
``-/\\w.`` become ``_``, leading slashes go).  An image is what
tensorboardX's ``add_image`` makes of a CHW array: one channel repeated
to three, a non-uint8 array times 255 truncated to uint8, saved as PNG by
Pillow.
"""

from __future__ import annotations

import io
import os
import re
import socket
import struct
import time
from typing import BinaryIO, Optional

import numpy as np

from isosurfacesuperresolution_tpu_torch.train.ocdbt import crc32c

FILE_VERSION = "brain.Event:2"
_INVALID_TAG = re.compile(r"[^-/\w\.]")


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC-32C of ``data``."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, data, the data's masked CRC."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc(head)) + data
            + struct.pack("<I", masked_crc(data)))


# -- protobuf wire format ----------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1              # negative int64s take ten bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _varint_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def encode_event(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 summary: Optional[bytes] = None) -> bytes:
    """An ``Event`` message (fields in number order, as protobuf writes)."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:                                    # proto3: 0 is not written
        out += _varint_field(2, int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def scalar_summary(tag: str, value: float) -> bytes:
    """A ``Summary`` of one ``simple_value``."""
    value_msg = (_bytes_field(1, tag.encode())
                 + _key(2, 5) + struct.pack("<f", float(value)))
    return _bytes_field(1, value_msg)


def image_summary(tag: str, height: int, width: int, colorspace: int,
                  png: bytes) -> bytes:
    """A ``Summary`` of one ``Image``."""
    image_msg = (_varint_field(1, height) + _varint_field(2, width)
                 + _varint_field(3, colorspace) + _bytes_field(4, png))
    return _bytes_field(1, _bytes_field(1, tag.encode())
                        + _bytes_field(4, image_msg))


# -- what tensorboardX makes of its arguments ---------------------------------

def clean_tag(tag: str) -> str:
    return _INVALID_TAG.sub("_", tag).lstrip("/")


def image_hwc_uint8(image) -> np.ndarray:
    """tensorboardX's ``add_image`` pixels of a CHW array: HWC, one
    channel repeated to three, a non-uint8 array times 255.0 truncated to
    uint8."""
    x = np.asarray(image)
    if x.ndim != 3:
        raise ValueError(f"image of shape {x.shape}: CHW expected")
    x = x.transpose(1, 2, 0)
    if x.shape[2] == 1:
        x = np.concatenate([x, x, x], 2)
    if x.dtype != np.uint8:
        x = (x * 255.0).astype(np.uint8)
    return x


def encode_png(hwc: np.ndarray) -> bytes:
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(hwc).save(out, format="PNG")
    return out.getvalue()


class EventWriter:
    """Scalars and images into one event file under ``logdir``, flushed
    after every record."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, "events.out.tfevents." + str(time.time())[:10] + "."
            + socket.gethostname())
        self._f: Optional[BinaryIO] = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version=FILE_VERSION))

    def _write(self, event: bytes) -> None:
        self._f.write(frame_record(event))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step,
                                 summary=scalar_summary(clean_tag(tag),
                                                        value)))

    def add_image(self, tag: str, image, step: int) -> None:
        """A CHW image, as the trainers' panels are."""
        hwc = image_hwc_uint8(image)
        h, w, c = hwc.shape
        self._write(encode_event(time.time(), step, summary=image_summary(
            clean_tag(tag), h, w, c, encode_png(hwc))))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
