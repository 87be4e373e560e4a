"""ctypes wrapper over the native OpenVDB `.vdb` decoder.

Counterpart of the JAX package's `native/vdbio.py` (the reference's
OpenVDB ingestion, `CPURenderer.cpp:448-460`, `Vdb2Vbx.cpp:70-324`), with
its signatures; see ``vdbio.cpp`` for the supported format subset (float
5-4-3 grids, none/zip payloads, half floats, active-mask compression).
The library is built at the first call, not at import
(`native/build.py`); a failed build raises OSError.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.native import build

_ERRLEN = 512


def _lib() -> ctypes.CDLL:
    lib = build.load("vdbio")
    lib.vdb_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
    lib.vdb_probe.restype = ctypes.c_int
    lib.vdb_load.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_char_p, ctypes.c_int]
    lib.vdb_load.restype = ctypes.c_int
    lib.vdb_grid_names.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.vdb_grid_names.restype = ctypes.c_int
    return lib


def grid_names(path: str) -> List[str]:
    """Names of the grids stored in a `.vdb` file."""
    buf = ctypes.create_string_buffer(1 << 16)
    n = _lib().vdb_grid_names(path.encode(), buf, len(buf))
    if n < 0:
        raise OSError(f"cannot read {path}")
    s = buf.value.decode()
    return s.split("\n") if s else []


def probe(path: str, grid_name: str = ""
          ) -> Tuple[Tuple[int, int, int, int, int, int],
                     Tuple[float, float, float]]:
    """Active bounding box (inclusive) and voxel size of a grid; leaf
    payloads are never inflated, so probing a large file is cheap."""
    bbox = (ctypes.c_int32 * 6)()
    vox = (ctypes.c_double * 3)()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = _lib().vdb_probe(path.encode(), grid_name.encode(), bbox, vox, err,
                          _ERRLEN)
    if rc != 0:
        raise OSError(f"{path}: {err.value.decode() or f'error {rc}'}")
    return tuple(bbox), tuple(vox)


def load(path: str, grid_name: str = ""
         ) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Decode a float grid into a dense (X, Y, Z) float32 array over the
    active bounding box.  Returns ``(values, voxel_size)``."""
    bbox, vox = probe(path, grid_name)
    shape = (bbox[3] - bbox[0] + 1, bbox[4] - bbox[1] + 1,
             bbox[5] - bbox[2] + 1)
    # corrupt files may claim an absurd active bbox: refuse to densify
    # anything past 2048^3
    if shape[0] * shape[1] * shape[2] > (1 << 33):
        raise OSError(f"{path}: active bbox {shape} too large to "
                      f"densify (corrupt coordinates?)")
    out = np.empty(shape, np.float32)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = _lib().vdb_load(path.encode(), grid_name.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         err, _ERRLEN)
    if rc != 0:
        raise OSError(f"{path}: {err.value.decode() or f'error {rc}'}")
    return out, vox
