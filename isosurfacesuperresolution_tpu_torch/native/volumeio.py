"""ctypes wrapper over the native raw-volume library.

Counterpart of the JAX package's `native/volumeio.py` (the reference's
`ExternalImporter.cpp`), with its signatures; see ``volumeio.cpp`` for the
exported C ABI.  The library is built at the first call, not at import
(`native/build.py`); a failed build raises OSError, on which
`volume.importers.import_raw` takes its numpy path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.native import build

_FMT = {"UCHAR": 0, "BYTE": 0, "USHORT": 1, "FLOAT": 2}
_ITEMSIZE = {"UCHAR": 1, "BYTE": 1, "USHORT": 2, "FLOAT": 4}
_F32P = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    lib = build.load("volumeio")
    lib.load_raw.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _F32P]
    lib.load_raw.restype = ctypes.c_int
    lib.brick_minmax.argtypes = [
        _F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _F32P, _F32P]
    lib.brick_minmax.restype = ctypes.c_int
    return lib


def load_raw(path: str, resolution: Tuple[int, int, int], fmt: str,
             downsampling: int = 1,
             lower_threshold: float = 0.001) -> np.ndarray:
    """Decode + box-filter a raw volume natively -> (X, Y, Z) float32."""
    fmt = fmt.upper()
    rx, ry, rz = resolution
    payload = rx * ry * rz * _ITEMSIZE[fmt]
    header = os.path.getsize(path) - payload
    if header < 0:
        raise ValueError(f"File is too small, {-header} bytes missing")
    ox, oy, oz = rx // downsampling, ry // downsampling, rz // downsampling
    out = np.empty((ox, oy, oz), np.float32)
    rc = _lib().load_raw(
        path.encode(), header, rx, ry, rz, _FMT[fmt], downsampling,
        lower_threshold, out.ctypes.data_as(_F32P))
    if rc != 0:
        raise OSError(f"native load_raw failed with code {rc} for {path}")
    return out


def brick_minmax(values: np.ndarray, brick_size: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Native apron-conservative brick min/max (same contract as
    `volume.grid.compute_brick_minmax`)."""
    values = np.ascontiguousarray(values, np.float32)
    X, Y, Z = values.shape
    b = brick_size
    shape = ((X + b - 1) // b, (Y + b - 1) // b, (Z + b - 1) // b)
    out_min = np.empty(shape, np.float32)
    out_max = np.empty(shape, np.float32)
    rc = _lib().brick_minmax(values.ctypes.data_as(_F32P), X, Y, Z, b,
                             out_min.ctypes.data_as(_F32P),
                             out_max.ctypes.data_as(_F32P))
    if rc != 0:
        raise OSError(f"native brick_minmax failed with code {rc}")
    return out_min, out_max
