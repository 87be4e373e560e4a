"""Orbax checkpoints read without orbax or tensorstore.

An orbax step directory (``checkpoints/<step>/default``) is an OCDBT
database: a B+tree of byte keys whose top ``manifest.ocdbt`` names the
tree's root node; the keys are zarr arrays' metadata (``<name>/.zarray``
for zarr v2, ``<name>/zarr.json`` for zarr v3) and chunks
(``<name>/0.0.0.0``), one array per leaf of the saved tree, named by its
path joined with "." (``params.params.block0_conv1.kernel``).  This
module decodes that layout in Python, with numpy and a zstd decoder.
It reads the arrays as orbax writes them (C order, little-endian, chunks
compressed by zstd or not at all) and refuses other zarr layouts by name.

Records.  A manifest or a B+tree node is one record: the magic (uint32
big-endian; 0x0cdb3a2a for a manifest, 0x0cdb20de for a node), its length
in bytes (uint64 little-endian, the record's whole size), a format
version (varint, 0), a compression (varint: 0 none, 1 zstd), the body
(compressed as that says) and a CRC-32C of every byte before it (uint32
little-endian), which is checked.  A node may sit at an offset inside a
data file, beside other nodes and values; values stored out of line are
raw bytes in data files (a zarr chunk is itself a zstd frame).

Manifest body: the config (uuid, 16 bytes; manifest kind, varint, 0 for
a single ``manifest.ocdbt``; max inline value bytes and max decoded node
bytes, varints; version-tree arity log2, one byte; compression, varint,
and for zstd its level as int32 little-endian), a data file table, and
the newest versions, column by column: count; generation numbers; root
heights (bytes); the roots' data file ids, offsets and lengths (an offset
of 2^64 - 1 marks an empty tree); key counts, tree bytes and indirect
value bytes; commit times (uint64 little-endian).  Older versions may
follow in version-tree nodes, which a restore of the newest never needs.

Data file table: count n; the lengths of each path's prefix shared with
the one before (n - 1 varints); the lengths of their suffixes (n); the
lengths of their base paths (n); the suffixes' bytes.  A file's path,
base path and relative path joined, is relative to the database's root.

B+tree node body: its height (one byte), a data file table, the entry
count n, the keys' shared-prefix lengths (n - 1) and suffix lengths (n),
and then, in a leaf (height 0): the key bytes, each value's length (n),
each value's kind (n: 0 inline, 1 out of line), the out-of-line values'
data file ids and offsets (one column each), and the inline values'
bytes; in an interior node: each child's subtree common prefix length
(n), the key bytes, and the children's data file ids, offsets, lengths,
key counts, tree bytes and indirect value bytes (one column each).  A
child's keys omit the prefix its parent entry's key shares with the
whole subtree: the first ``subtree common prefix length`` bytes of that
entry's key.

zstd comes from the ``zstandard`` module where it is installed, else from
the system's ``libzstd.so.1`` through ctypes; without either, reading
raises and names both.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_NO_OFFSET = (1 << 64) - 1


class OcdbtError(ValueError):
    """A file that is not the OCDBT or zarr layout this reader knows."""


# -- CRC-32C -----------------------------------------------------------------

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the records' trailers carry it."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# -- zstd --------------------------------------------------------------------

class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _LibZstd:
    """Streaming decode through the system's libzstd (frames need not
    carry their content size; OCDBT's nodes do not)."""

    CHUNK = 1 << 20

    def __init__(self, lib):
        self.lib = lib
        lib.ZSTD_createDStream.argtypes = []
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_freeDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
            ctypes.POINTER(_InBuffer)]
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p

    def _check(self, code: int) -> int:
        if self.lib.ZSTD_isError(code):
            raise OcdbtError("zstd: " + self.lib.ZSTD_getErrorName(code)
                             .decode())
        return code

    def decompress(self, data: bytes, max_size: int) -> bytes:
        src = ctypes.create_string_buffer(data, len(data))
        inb = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk = ctypes.create_string_buffer(self.CHUNK)
        parts, total = [], 0
        stream = self.lib.ZSTD_createDStream()
        if not stream:
            raise MemoryError("ZSTD_createDStream")
        try:
            self._check(self.lib.ZSTD_initDStream(stream))
            while True:
                outb = _OutBuffer(ctypes.cast(chunk, ctypes.c_void_p),
                                  self.CHUNK, 0)
                left = self._check(self.lib.ZSTD_decompressStream(
                    stream, ctypes.byref(outb), ctypes.byref(inb)))
                parts.append(chunk.raw[:outb.pos])
                total += outb.pos
                if total > max_size:
                    raise OcdbtError(f"zstd frame exceeds the {max_size} "
                                     "bytes allowed")
                if left == 0:
                    break
                if inb.pos == inb.size and outb.pos < outb.size:
                    raise OcdbtError("zstd: truncated frame")
        finally:
            self.lib.ZSTD_freeDStream(stream)
        if inb.pos != inb.size:
            raise OcdbtError("zstd: bytes after the frame")
        return b"".join(parts)


def _load_zstd() -> Callable[[bytes, int], bytes]:
    try:
        import zstandard
    except ImportError:
        zstandard = None
    if zstandard is not None:
        dctx = zstandard.ZstdDecompressor()
        return lambda data, max_size: dctx.decompress(
            data, max_output_size=max_size)
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = _LibZstd(ctypes.CDLL(name))
    except OSError as e:
        raise RuntimeError(
            "reading orbax checkpoints needs a zstd decoder: install the "
            "'zstandard' module or the system library libzstd.so.1 "
            f"(loading {name!r} failed: {e})") from e
    return lib.decompress


_ZSTD: List[Callable[[bytes, int], bytes]] = []


def zstd_decompress(data: bytes, max_size: int = 1 << 31) -> bytes:
    """One zstd frame -> its bytes (``max_size`` bounds the output)."""
    if not _ZSTD:
        _ZSTD.append(_load_zstd())
    return _ZSTD[0](bytes(data), max_size)


# -- records -----------------------------------------------------------------

class _Cursor:
    """Little-endian varints and fixed-width fields over a byte string."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def varint(self) -> int:
        data, pos = self.data, self.pos
        result = shift = 0
        while True:
            if pos >= len(data) or shift > 63:
                raise OcdbtError("truncated or overlong varint")
            b = data[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                self.pos = pos
                return result

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("truncated record")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def fixed(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def at_end(self) -> bool:
        return self.pos == len(self.data)


def decode_record(raw: bytes, magic: int, what: str,
                  max_size: int = 1 << 31) -> bytes:
    """Check a record's header and CRC-32C and return its body,
    decompressed."""
    if len(raw) < 18:
        raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack(
        "<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: header says {length} bytes, "
                         f"read {len(raw)}")
    crc = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    cur = _Cursor(raw[:-4])
    cur.pos = 12
    version = cur.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    compression = cur.varint()
    body = raw[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, max_size)
    raise OcdbtError(f"{what}: compression {compression}")


def _file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    if n == 0:
        return []
    prefix = cur.varints(n - 1)
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(prev) or base[i] > shared + suffix[i]:
            raise OcdbtError("bad data file table")
        prev = prev[:shared] + cur.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(cur: _Cursor, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    prefix = cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    subtree = cur.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(prev):
            raise OcdbtError("bad key prefix length")
        prev = prev[:shared] + cur.take(suffix[i])
        keys.append(prev)
    return keys, subtree


class _Location:
    __slots__ = ("path", "offset", "length")

    def __init__(self, path: str, offset: int, length: int):
        self.path, self.offset, self.length = path, offset, length


def _locations(cur: _Cursor, files: List[str], n: int
               ) -> Tuple[List[int], List[int]]:
    ids = cur.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtError("data file id outside the node's table")
    return ids, cur.varints(n)


class OcdbtStore:
    """A read-only OCDBT database in a directory: the newest version's
    keys and values."""

    def __init__(self, root: str):
        self.root = root
        raw = self._read_file("manifest.ocdbt")
        body = decode_record(raw, MANIFEST_MAGIC, "manifest.ocdbt")
        cur = _Cursor(body)
        cur.take(16)                                   # uuid
        kind = cur.varint()
        if kind != 0:
            raise OcdbtError("numbered manifests are not read (manifest "
                             f"kind {kind})")
        cur.varint()                                   # max inline bytes
        self.max_node_bytes = cur.varint()
        cur.byte()                                     # version tree arity
        if cur.varint() == 1:
            cur.fixed("<i")                            # zstd level
        files = _file_table(cur)
        n = cur.varint()
        if n == 0:
            raise OcdbtError("manifest lists no version")
        cur.varints(n)                                 # generations
        heights = [cur.byte() for _ in range(n)]
        ids, offsets = cur.varints(n), cur.varints(n)
        lengths = cur.varints(n)
        self.num_keys = cur.varints(n)[-1]
        cur.varints(n)                                 # tree bytes
        cur.varints(n)                                 # indirect bytes
        [cur.fixed("<Q") for _ in range(n)]            # commit times
        self.root_height = heights[-1]
        self.root_node = None
        if offsets[-1] != _NO_OFFSET:
            if ids[-1] >= len(files):
                raise OcdbtError("root node's data file id outside the "
                                 "manifest's table")
            self.root_node = _Location(files[ids[-1]], offsets[-1],
                                       lengths[-1])
        self._handles: Dict[str, object] = {}

    # -- files -----------------------------------------------------------
    def _read_file(self, rel: str) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            return f.read()

    def _read(self, loc: _Location) -> bytes:
        f = self._handles.get(loc.path)
        if f is None:
            f = self._handles[loc.path] = open(
                os.path.join(self.root, loc.path), "rb")
        f.seek(loc.offset)
        data = f.read(loc.length)
        if len(data) != loc.length:
            raise OcdbtError(f"{loc.path}: {loc.length} bytes at "
                             f"{loc.offset} run past the file's end")
        return data

    def close(self) -> None:
        for f in self._handles.values():
            f.close()
        self._handles.clear()

    def __enter__(self) -> "OcdbtStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- tree ------------------------------------------------------------
    def _node(self, loc: _Location, height: int):
        body = decode_record(self._read(loc), BTREE_MAGIC,
                             f"node {loc.path}@{loc.offset}",
                             self.max_node_bytes)
        cur = _Cursor(body)
        if cur.byte() != height:
            raise OcdbtError(f"node {loc.path}@{loc.offset}: height differs "
                             "from its parent's entry")
        files = _file_table(cur)
        n = cur.varint()
        keys, subtree = _keys(cur, n, height > 0)
        if height > 0:
            ids, offsets = _locations(cur, files, n)
            lengths = cur.varints(n)
            for _ in range(3):                 # keys, tree, indirect bytes
                cur.varints(n)
            children = [(k, p, _Location(files[i], o, l)) for k, p, i, o, l
                        in zip(keys, subtree, ids, offsets, lengths)]
            out = ("interior", children)
        else:
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError("unknown value kind")
            ids, offsets = _locations(cur, files, sum(kinds))
            refs, j = [], 0
            for length, kind in zip(lengths, kinds):
                if kind:
                    refs.append(_Location(files[ids[j]], offsets[j], length))
                    j += 1
                else:
                    refs.append(None)
            values = []
            for ref, length in zip(refs, lengths):
                values.append(ref if ref is not None else cur.take(length))
            out = ("leaf", list(zip(keys, values)))
        if not cur.at_end():
            raise OcdbtError(f"node {loc.path}@{loc.offset}: "
                             f"{len(body) - cur.pos} bytes left over")
        return out

    def _walk(self, loc: _Location, height: int, prefix: bytes
              ) -> Iterator[Tuple[bytes, object]]:
        kind, entries = self._node(loc, height)
        if kind == "leaf":
            for key, value in entries:
                yield prefix + key, value
            return
        for key, shared, child in entries:
            yield from self._walk(child, height - 1, prefix + key[:shared])

    def items(self) -> Iterator[Tuple[bytes, object]]:
        """(key, value) in key order; a value is its bytes when inline,
        else a location for `value`."""
        if self.root_node is not None:
            yield from self._walk(self.root_node, self.root_height, b"")

    def value(self, v) -> bytes:
        return v if isinstance(v, bytes) else self._read(v)

    def read_all(self, want: Optional[Callable[[bytes], bool]] = None
                 ) -> Dict[bytes, bytes]:
        """{key: value bytes} of the keys ``want`` accepts (all by
        default)."""
        return {k: self.value(v) for k, v in self.items()
                if want is None or want(k)}


# -- zarr --------------------------------------------------------------------

def _bfloat16_to_float32(raw: np.ndarray) -> np.ndarray:
    return (raw.astype(np.uint32) << 16).view(np.float32)


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """A zarr dtype name -> (numpy storage dtype, is bfloat16)."""
    if name in ("bfloat16", "<bfloat16", "<V2"):
        return np.dtype("<u2"), True
    dtype = np.dtype(name)
    if dtype.byteorder == ">":
        raise OcdbtError(f"big-endian zarr dtype {name!r} not read")
    return dtype, False


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


class _ArraySpec:
    """A zarr array's layout as orbax writes it: zarr v2 or v3, C order,
    little-endian, compressed by zstd or not at all; anything else is
    refused by name."""

    def __init__(self, meta: dict):
        self.shape = tuple(meta["shape"])
        self.fill = meta.get("fill_value")
        fmt = meta.get("zarr_format")
        if fmt == 2:
            self.chunks = tuple(meta["chunks"])
            self.dtype, self.bf16 = _dtype(meta["dtype"])
            comp = meta.get("compressor")
            self.zstd = comp is not None and comp["id"] == "zstd"
            if comp is not None and not self.zstd:
                raise OcdbtError(f"zarr compressor {comp['id']!r} not read")
            if meta.get("order", "C") != "C":
                raise OcdbtError(f"zarr order {meta['order']!r} not read")
            if meta.get("filters"):
                raise OcdbtError(f"zarr filters {meta['filters']} not read")
            if meta.get("dimension_separator", ".") != ".":
                raise OcdbtError("zarr dimension separator "
                                 f"{meta['dimension_separator']!r} not read")
            self.key = lambda idx: ".".join(map(str, idx)) if idx else "0"
        elif fmt == 3:
            grid = meta["chunk_grid"]
            if grid["name"] != "regular":
                raise OcdbtError(f"zarr3 chunk grid {grid['name']}")
            self.chunks = tuple(grid["configuration"]["chunk_shape"])
            self.dtype, self.bf16 = _dtype(meta["data_type"])
            names = [c["name"] for c in meta["codecs"]]
            self.zstd = names == ["bytes", "zstd"]
            if not self.zstd and names != ["bytes"]:
                raise OcdbtError(f"zarr3 codecs {names} not read")
            endian = meta["codecs"][0].get("configuration", {}).get(
                "endian", "little")
            if endian != "little":
                raise OcdbtError(f"zarr3 {endian}-endian bytes not read")
            enc = meta.get("chunk_key_encoding", {"name": "default"})
            if (enc["name"] != "default" or enc.get("configuration", {}).get(
                    "separator", "/") != "/"):
                raise OcdbtError(f"zarr3 chunk key encoding {enc} not read")
            self.key = lambda idx: "/".join(["c"] + [str(i) for i in idx])
        else:
            raise OcdbtError(f"zarr format {fmt!r}")

    def decode_chunk(self, data: bytes) -> np.ndarray:
        if self.zstd:
            data = zstd_decompress(data)
        want = int(np.prod(self.chunks)) * self.dtype.itemsize
        if len(data) != want:
            raise OcdbtError(f"chunk of {len(data)} bytes, expected {want}")
        return np.frombuffer(data, self.dtype).reshape(self.chunks)

    def assemble(self, chunk: Callable[[str], Optional[bytes]]
                 ) -> np.ndarray:
        out = np.full(self.shape, _fill(self.fill, self.dtype),
                      dtype=self.dtype)
        grid = [-(-s // c) for s, c in zip(self.shape, self.chunks)]
        for idx in np.ndindex(*grid):
            data = chunk(self.key(idx))
            if data is None:
                continue
            block = self.decode_chunk(data)
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, self.chunks, self.shape))
            out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
        return _bfloat16_to_float32(out) if self.bf16 else out


def read_zarr_arrays(values: Dict[bytes, bytes]) -> Dict[str, np.ndarray]:
    """{array name: array} of every zarr array among ``values`` (an OCDBT
    store's keys and values)."""
    out = {}
    for key, raw in values.items():
        name, _, leaf = key.decode().rpartition("/")
        if leaf not in (".zarray", "zarr.json"):
            continue
        meta = json.loads(raw)
        if meta.get("node_type", "array") != "array":
            continue
        spec = _ArraySpec(meta)
        out[name] = spec.assemble(
            lambda k, name=name: values.get(f"{name}/{k}".encode()))
    return out


# -- orbax -------------------------------------------------------------------

def _item_dir(step_dir: str) -> str:
    """A step directory or its ``default`` item -> the OCDBT root."""
    if os.path.exists(os.path.join(step_dir, "manifest.ocdbt")):
        return step_dir
    item = os.path.join(step_dir, "default")
    if os.path.exists(os.path.join(item, "manifest.ocdbt")):
        return item
    raise FileNotFoundError(f"{step_dir}: no manifest.ocdbt (not an orbax "
                            "OCDBT checkpoint)")


def orbax_tree_paths(step_dir: str) -> Dict[str, Tuple[str, ...]]:
    """{param name: key path} of the arrays a step saved, from orbax's
    ``_METADATA`` (leaves that hold no array, such as None, are left
    out); ``step_dir`` as `read_orbax_step` takes it."""
    with open(os.path.join(_item_dir(step_dir), "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    out = {}
    for entry in tree.values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        path = tuple(k["key"] for k in entry["key_metadata"])
        out[".".join(path)] = path
    return out


def read_orbax_step(step_dir: str, prefix: str = ""
                    ) -> Dict[str, np.ndarray]:
    """{param name: array} of the arrays of an orbax step whose names
    start with ``prefix`` (all by default); ``step_dir`` is
    ``checkpoints/<step>`` or its ``default`` item."""
    root = _item_dir(step_dir)
    want = prefix.encode()
    with OcdbtStore(root) as store:
        values = store.read_all(lambda k: k.startswith(want))
    return read_zarr_arrays(values)


def orbax_steps(directory: str) -> List[int]:
    """The digit-named steps under an orbax ``checkpoints/`` directory."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def read_orbax_generator(checkpoints_dir: str, step: Optional[int] = None
                         ) -> Tuple[Dict[str, np.ndarray], int]:
    """The generator's variables of step ``step`` (the newest by default)
    as ``params.npz`` keys (``params/<layer>/kernel``), and the step."""
    steps = orbax_steps(checkpoints_dir)
    if not steps:
        raise FileNotFoundError(f"no orbax steps in {checkpoints_dir}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"{checkpoints_dir}: no step {step} "
                                f"(steps {steps})")
    step_dir = _item_dir(os.path.join(checkpoints_dir, str(step)))
    paths = orbax_tree_paths(step_dir)
    arrays = read_orbax_step(step_dir, "params.")
    out = {}
    for name, arr in arrays.items():
        path = paths.get(name)
        if path is None or path[0] != "params":
            raise OcdbtError(f"{name}: not a leaf of the saved tree")
        out["/".join(path[1:])] = arr
    return out, step
