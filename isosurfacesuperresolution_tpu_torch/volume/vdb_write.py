"""OpenVDB `.vdb` writer (float 5-4-3 grids, pure Python).

Counterpart of the JAX package's `volume/vdb_write.py`, the same code, so
it writes the same bytes for the same array (the uuid is fixed).  The
reference converts volumes to `.vdb` (`CPURenderer.cpp:357-407`
``-m convert``); this module serializes a dense float volume to the
OpenVDB file format (version 224 layout: per-grid compression flags, zip
payloads, active-mask value compression, optional half-float storage)
without the OpenVDB library.  Reader (`native/vdbio.cpp`) and writer were
written separately from the format specification.

Format notes (io/Archive.cc, io/Compression.h, tree node serialization):
  header   = magic int64 ' BDV', u32 file version, u32+u32 library
             version, u8 has-grid-offsets, 36-char uuid, u32 grid count,
             grid descriptors (name, type, instance parent, 3 x i64
             stream offsets)
  grid     = u32 compression flags, metadata map, transform map,
             tree topology (root -> internal 32^3 -> internal 16^3 ->
             leaf 8^3 masks), then leaf buffers in depth-first order
  payloads = active-mask compressed: i8 metadata code, optional selection
             mask, active values only; zip chunks are "i64 byte count,
             bytes" with negative count marking incompressible raw data.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_MAGIC = 0x56444220
_FILE_VERSION = 224
_COMPRESS_ZIP = 0x1
_COMPRESS_ACTIVE_MASK = 0x2
_NO_MASK_OR_INACTIVE_VALS = 0
_NO_MASK_AND_ALL_VALS = 6

_LEAF_LOG2 = 3                 # 8^3 leaves
_INT1_LOG2 = 4                 # 16^3 children -> spans 128^3
_INT2_LOG2 = 5                 # 32^3 children -> spans 4096^3


def _wstr(parts, s: str) -> None:
    b = s.encode()
    parts.append(struct.pack("<I", len(b)) + b)


def _pack_mask(flat_bits: np.ndarray) -> bytes:
    """C-order (x, y, z) boolean block -> NodeMask bytes.

    OpenVDB packs offset = x << 2L | y << L | z, which IS the C-order
    flatten; words are little-endian."""
    return np.packbits(flat_bits.reshape(-1).astype(np.uint8),
                       bitorder="little").tobytes()


def _zip_chunk(payload: bytes) -> bytes:
    comp = zlib.compress(payload)
    if len(comp) >= len(payload):
        return struct.pack("<q", -len(payload)) + payload
    return struct.pack("<q", len(comp)) + comp


def _values_payload(vals: np.ndarray, half: bool) -> bytes:
    if half:
        return vals.astype(np.float16).tobytes()
    return vals.astype(np.float32).tobytes()


def _write_compressed(parts, vals: np.ndarray, active: np.ndarray,
                      compression: int, half: bool) -> None:
    """io::writeCompressedValues: vals/active are flat C-order blocks.

    The int8 metadata code is written UNCONDITIONALLY: OpenVDB's
    writeCompressedValues emits it for every stream at file version
    >= 222 - `if (!maskCompress) os.write(&metadata, 1)` with code 6
    (NO_MASK_AND_ALL_VALS) - not only when active-mask compression is
    on."""
    if compression & _COMPRESS_ACTIVE_MASK:
        # our inactive values are always +background -> code 0 stores the
        # active values only (NO_MASK_AND_ALL_VALS covers the rest)
        parts.append(struct.pack("<b", _NO_MASK_OR_INACTIVE_VALS))
        stored = vals.reshape(-1)[active.reshape(-1)]
    else:
        parts.append(struct.pack("<b", _NO_MASK_AND_ALL_VALS))
        stored = vals.reshape(-1)
    payload = _values_payload(stored, half)
    if compression & _COMPRESS_ZIP:
        parts.append(_zip_chunk(payload))
    else:
        parts.append(payload)


def write_vdb(path: str, values: np.ndarray, grid_name: str = "density",
              background: float = 0.0, voxel_size: float = 1.0,
              origin: Tuple[int, int, int] = (0, 0, 0),
              compression: str = "zip", half: bool = False) -> None:
    """Write a dense (X, Y, Z) float array as an OpenVDB float grid.

    Voxels equal to ``background`` become inactive; everything else is
    active.  ``compression``: "zip" (zip + active-mask, the OpenVDB
    default sans blosc) or "none"."""
    values = np.asarray(values, np.float32)
    if values.ndim != 3:
        raise ValueError("values must be (X, Y, Z)")
    comp_flags = 0
    if compression == "zip":
        comp_flags = _COMPRESS_ZIP | _COMPRESS_ACTIVE_MASK
    elif compression != "none":
        raise ValueError("compression must be 'zip' or 'none'")

    # Leaves live on the 8-aligned voxel lattice (leaf key = coord & ~7),
    # so an unaligned origin means front-padding onto that lattice.
    X, Y, Z = values.shape
    data_origin = tuple(origin)
    front = [o & 7 for o in origin]
    origin = tuple(o - f for o, f in zip(origin, front))
    back = [(-(n + f)) % 8 for n, f in zip(values.shape, front)]
    dense = np.pad(values, list(zip(front, back)),
                   constant_values=background)
    active = dense != background
    Xp, Yp, Zp = dense.shape

    # ---- tree assembly: node keys are coordinates floored to node span
    leaf_span, int1_span, int2_span = 8, 128, 4096
    ox, oy, oz = origin

    # leaves: (lx, ly, lz) block index -> arrays
    lx = Xp // 8
    ly = Yp // 8
    lz = Zp // 8
    blocks = dense.reshape(lx, 8, ly, 8, lz, 8).transpose(0, 2, 4, 1, 3, 5)
    ablocks = active.reshape(lx, 8, ly, 8, lz, 8).transpose(0, 2, 4, 1, 3, 5)
    leaf_occupied = ablocks.any(axis=(3, 4, 5))

    # group leaves under internal1 nodes, internal1 under internal2
    int1 = {}
    for i, j, k in zip(*np.nonzero(leaf_occupied)):
        wx, wy, wz = ox + 8 * int(i), oy + 8 * int(j), oz + 8 * int(k)
        k1 = (wx // int1_span * int1_span, wy // int1_span * int1_span,
              wz // int1_span * int1_span)
        int1.setdefault(k1, []).append((wx, wy, wz, int(i), int(j), int(k)))
    int2 = {}
    for k1 in int1:
        k2 = (k1[0] // int2_span * int2_span,
              k1[1] // int2_span * int2_span,
              k1[2] // int2_span * int2_span)
        int2.setdefault(k2, []).append(k1)

    def child_offset(origin_node, world, log2, child_span):
        m = (1 << log2) - 1
        cx = (world[0] - origin_node[0]) // child_span & m
        cy = (world[1] - origin_node[1]) // child_span & m
        cz = (world[2] - origin_node[2]) // child_span & m
        return (cx << (2 * log2)) | (cy << log2) | cz

    topo = []
    leaf_order = []                        # (i, j, k) in depth-first order
    topo.append(struct.pack("<I", 1))      # TreeBase buffer count
    topo.append(struct.pack("<f", background))
    topo.append(struct.pack("<II", 0, len(int2)))  # root tiles, children
    for k2 in sorted(int2):                # root map is Coord-ordered
        topo.append(struct.pack("<iii", *k2))
        # internal2 node
        n2 = 1 << (3 * _INT2_LOG2)
        cmask2 = np.zeros(n2, bool)
        for k1 in int2[k2]:
            cmask2[child_offset(k2, k1, _INT2_LOG2, int1_span)] = True
        topo.append(_pack_mask(cmask2))
        topo.append(_pack_mask(np.zeros(n2, bool)))      # value mask
        _write_compressed(topo, np.full(n2, background, np.float32),
                          np.zeros(n2, bool), comp_flags, half)
        for off2 in np.nonzero(cmask2)[0]:
            # recover which k1 this is
            k1 = next(k for k in int2[k2]
                      if child_offset(k2, k, _INT2_LOG2, int1_span) == off2)
            n1 = 1 << (3 * _INT1_LOG2)
            cmask1 = np.zeros(n1, bool)
            leaves_here = sorted(
                int1[k1],
                key=lambda w: child_offset(k1, w[:3], _INT1_LOG2, leaf_span))
            for w in leaves_here:
                cmask1[child_offset(k1, w[:3], _INT1_LOG2, leaf_span)] = True
            topo.append(_pack_mask(cmask1))
            topo.append(_pack_mask(np.zeros(n1, bool)))
            _write_compressed(topo, np.full(n1, background, np.float32),
                              np.zeros(n1, bool), comp_flags, half)
            for w in leaves_here:
                i, j, k = w[3], w[4], w[5]
                topo.append(_pack_mask(ablocks[i, j, k].reshape(-1)))
                leaf_order.append((i, j, k))
    topo = b"".join(topo)

    buffers = []
    for (i, j, k) in leaf_order:
        # LeafNode::writeBuffers re-serializes the value mask ahead of
        # the compressed values (readBuffers re-loads mValueMask from
        # it); a leaf buffer section is mask + metadata code + payload.
        buffers.append(_pack_mask(ablocks[i, j, k].reshape(-1)))
        _write_compressed(buffers, blocks[i, j, k].reshape(-1),
                          ablocks[i, j, k].reshape(-1), comp_flags, half)
    buffers = b"".join(buffers)

    # ---- grid block: compression, metadata, transform, topology, buffers
    grid = []
    grid.append(struct.pack("<I", comp_flags))
    meta_entries = []

    def add_meta(name, typ, val):
        e = []
        _wstr(e, name)
        _wstr(e, typ)
        e.append(struct.pack("<I", len(val)) + val)
        meta_entries.append(b"".join(e))

    add_meta("class", "string", b"unknown")
    add_meta("name", "string", grid_name.encode())
    bmin = data_origin
    bmax = (data_origin[0] + X - 1, data_origin[1] + Y - 1,
            data_origin[2] + Z - 1)
    add_meta("file_bbox_min", "vec3i", struct.pack("<iii", *bmin))
    add_meta("file_bbox_max", "vec3i", struct.pack("<iii", *bmax))
    grid.append(struct.pack("<I", len(meta_entries)))
    grid.extend(meta_entries)
    # UniformScaleMap: scale, voxel size, 1/scale, 1/scale^2, 1/(2 scale)
    _wstr(grid, "UniformScaleMap")
    s = float(voxel_size)
    for vec in ((s,) * 3, (s,) * 3, (1 / s,) * 3, (1 / s ** 2,) * 3,
                (1 / (2 * s),) * 3):
        grid.append(struct.pack("<ddd", *vec))
    grid = b"".join(grid)

    # ---- archive
    head = [struct.pack("<q", _MAGIC), struct.pack("<I", _FILE_VERSION),
            struct.pack("<II", 8, 1), b"\x01",
            b"0" * 36]                     # uuid (36 ascii chars)
    head.append(struct.pack("<I", 1))      # grid count
    desc = []
    _wstr(desc, grid_name)
    _wstr(desc, "Tree_float_5_4_3" + ("_HalfFloat" if half else ""))
    _wstr(desc, "")                        # instance parent
    desc = b"".join(desc)
    head = b"".join(head)
    # descriptor offsets: grid data starts right after the descriptor
    grid_pos = len(head) + len(desc) + 24
    block_pos = grid_pos + len(grid) + len(topo)
    end_pos = block_pos + len(buffers)
    with open(path, "wb") as f:
        f.write(head)
        f.write(desc)
        f.write(struct.pack("<qqq", grid_pos, block_pos, end_pos))
        f.write(grid)
        f.write(topo)
        f.write(buffers)
