"""Minimal self-contained OpenEXR codec (scanline, float/half, none/zip).

Counterpart of the JAX package's `data/exr.py`, the same code: numpy,
struct and zlib only, so `write_exr` writes the same bytes.  The
reference's data interchange is float EXR files written by OpenEXR (the
renderers' 12-channel frames, `CPURenderer.cpp:569-609`,
`GPURenderer.cpp:728-773`; the legacy dataset path,
`datasetVideo.py:172-258`), and neither the OpenEXR bindings nor an
EXR-enabled OpenCV can be counted on.

Scope (covers what the reference writes and nothing more):
  * single-part scanline images, version 2
  * pixel types FLOAT and HALF
  * compression NONE, ZIPS (1 line/block) and ZIP (16 lines/block) -
    zlib + the OpenEXR byte-delta + two-half interleave predictor
  * increasing-y line order, trivial data/display windows
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np

MAGIC = 0x01312f76
PIXEL_HALF, PIXEL_FLOAT = 1, 2
NO_COMPRESSION, ZIPS_COMPRESSION, ZIP_COMPRESSION = 0, 2, 3
_LINES_PER_BLOCK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1,
                    ZIP_COMPRESSION: 16}


def _write_attr(out, name: str, typ: str, data: bytes):
    out += name.encode() + b"\0" + typ.encode() + b"\0"
    out += struct.pack("<i", len(data)) + data
    return out


def write_exr(path: str, channels: Dict[str, np.ndarray],
              compression: int = ZIP_COMPRESSION,
              half: bool = False) -> None:
    """Write named 2-D float arrays as one EXR image.

    All channels must share (H, W).  ``half`` stores 16-bit floats.
    """
    names = sorted(channels)                       # EXR requires sorted
    arrs = [np.asarray(channels[n], np.float32) for n in names]
    h, w = arrs[0].shape
    for a in arrs:
        assert a.shape == (h, w), "channel shapes differ"
    ptype = PIXEL_HALF if half else PIXEL_FLOAT
    dt = np.dtype("<f2") if half else np.dtype("<f4")

    header = bytearray()
    chlist = bytearray()
    for n in names:
        chlist += n.encode() + b"\0"
        chlist += struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chlist += b"\0"
    header = _write_attr(header, "channels", "chlist", bytes(chlist))
    header = _write_attr(header, "compression", "compression",
                         struct.pack("<B", compression))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = _write_attr(header, "dataWindow", "box2i", box)
    header = _write_attr(header, "displayWindow", "box2i", box)
    header = _write_attr(header, "lineOrder", "lineOrder",
                         struct.pack("<B", 0))
    header = _write_attr(header, "pixelAspectRatio", "float",
                         struct.pack("<f", 1.0))
    header = _write_attr(header, "screenWindowCenter", "v2f",
                         struct.pack("<ff", 0.0, 0.0))
    header = _write_attr(header, "screenWindowWidth", "float",
                         struct.pack("<f", 1.0))
    header += b"\0"

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lpb
        ny = min(lpb, h - y0)
        raw = b"".join(
            arrs[ci][y, :].astype(dt).tobytes()
            for y in range(y0, y0 + ny) for ci in range(len(names)))
        if compression == NO_COMPRESSION:
            data = raw
        else:
            data = zlib.compress(_predict_encode(raw))
            if len(data) >= len(raw):
                data = raw                          # stored-raw fallback
        blocks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", MAGIC))
        f.write(struct.pack("<i", 2))               # version, no flags
        f.write(bytes(header))
        offset = f.tell() + 8 * n_blocks
        for y0, data in blocks:
            f.write(struct.pack("<Q", offset))
            offset += 4 + 4 + len(data)
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def _predict_encode(raw: bytes) -> bytes:
    """OpenEXR zip predictor (ImfZip.cpp order): split even/odd bytes into
    two halves FIRST, then byte-delta encode the reordered buffer."""
    b = np.frombuffer(raw, np.uint8)
    reordered = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    delta = reordered.copy()
    delta[1:] = reordered[1:] - reordered[:-1] + (128 + 256)
    return delta.astype(np.uint8).tobytes()


def _predict_decode(data: bytes) -> bytes:
    """Inverse: delta-decode (d[i] = d[i-1] + enc[i] - 128 mod 256), then
    re-interleave the two halves."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    d[1:] -= 128
    rec = np.cumsum(d).astype(np.uint8)
    n = len(rec)
    out = np.empty(n, np.uint8)
    out[0::2] = rec[: (n + 1) // 2]
    out[1::2] = rec[(n + 1) // 2:]
    return out.tobytes()


def _read_attr_stream(buf: memoryview, pos: int):
    attrs = {}
    while True:
        if buf[pos] == 0:
            return attrs, pos + 1
        end = pos
        while buf[end] != 0:
            end += 1
        name = bytes(buf[pos:end]).decode()
        pos = end + 1
        end = pos
        while buf[end] != 0:
            end += 1
        typ = bytes(buf[pos:end]).decode()
        pos = end + 1
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        attrs[name] = (typ, bytes(buf[pos:pos + size]))
        pos += size


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read a (subset-)EXR file -> {channel name: (H, W) float32}."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    magic, = struct.unpack_from("<I", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version, = struct.unpack_from("<i", buf, 4)
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & 0x1800:
        # 0x1000 multi-part / 0x800 deep data: headers are laid out
        # differently; parsing would silently misread chunk offsets
        raise ValueError(f"{path}: multi-part/deep EXR not supported")
    attrs, pos = _read_attr_stream(buf, 8)

    typ, ch_raw = attrs["channels"]
    chans = []                                     # (name, ptype)
    cpos = 0
    while ch_raw[cpos] != 0:
        end = ch_raw.index(b"\0", cpos)
        nm = ch_raw[cpos:end].decode()
        ptype, = struct.unpack_from("<i", ch_raw, end + 1)
        chans.append((nm, ptype))
        cpos = end + 1 + 16
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: compression {comp} not supported "
                         "(only NONE/ZIPS/ZIP)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (h + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    out = {nm: np.empty((h, w), np.float32) for nm, _ in chans}
    sizes = {PIXEL_HALF: 2, PIXEL_FLOAT: 4}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = bytes(buf[off + 8: off + 8 + size])
        ny = min(lpb, y1 - y + 1)
        raw_len = ny * w * sum(sizes[pt] for _, pt in chans)
        if comp != NO_COMPRESSION and size != raw_len:
            data = _predict_decode(zlib.decompress(data))
        p = 0
        for dy in range(ny):
            for nm, pt in chans:
                nbytes = w * sizes[pt]
                line = np.frombuffer(
                    data[p:p + nbytes],
                    np.dtype("<f2") if pt == PIXEL_HALF else np.dtype("<f4"))
                out[nm][y - y0 + dy] = line.astype(np.float32)
                p += nbytes
    return out
