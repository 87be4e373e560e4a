"""OpenVDB `.vdb` ingestion.

Counterpart of the JAX package's `volume/vdb.py`.  The reference loads
`.vdb` float grids through the OpenVDB library (`CPURenderer.cpp:448-460`)
and converts them to GVDB bricks (`GPURenderer/Vdb2Vbx.cpp:70-324`).
`load_vdb` decodes with the native from-spec reader first
(`native/vdbio.cpp`: float 5-4-3 trees, none/zip payloads, built at first
use), then with the OpenVDB Python bindings if they are installed, and
builds a dense `BrickGrid` on the requested device, normalized to the unit
box like `CPURenderer.cpp:448-460`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid


def _import_openvdb():
    for mod in ("openvdb", "pyopenvdb"):
        try:
            return __import__(mod)
        except ImportError:
            continue
    raise ImportError(
        "reading .vdb files needs the native reader or the OpenVDB python "
        "bindings (`openvdb` or `pyopenvdb`); convert offline to .npy "
        "(grid.copyToArray over the active bounding box) and load that")


def load_vdb(path: str, grid_name: Optional[str] = None,
             brick_size: int = 8, max_resolution: int = 1024,
             device: DeviceLike = None) -> Tuple[BrickGrid, str]:
    """Load a float grid from a `.vdb` file into a dense `BrickGrid` on
    ``device``; returns the grid and the grid's name.

    The active voxel bounding box is densified (background outside), the
    transform is discarded and the volume normalized to the unit box."""
    dev = resolve_device(device)
    try:
        arr, name = _read_native(path, grid_name, max_resolution)
    except OSError as native_err:
        # a decode failure, or the native build failed
        try:
            vdb = _import_openvdb()
        except ImportError:
            raise OSError(
                f"native .vdb decode failed ({native_err}) and the OpenVDB "
                "python bindings are not installed") from native_err
        arr, name = _read_bindings(vdb, path, grid_name, max_resolution)
    return BrickGrid.from_dense(arr, brick_size=brick_size, device=dev), name


def _pick(names, grid_name, path: str) -> str:
    if not names:
        raise OSError(f"no grids in {path}")
    name = grid_name if grid_name is not None else names[0]
    if name not in names:
        raise ValueError(f"grid {name!r} not in {path} (has {names})")
    return name


def _check_size(shape, path: str, name: str, max_resolution: int) -> None:
    if max(shape) > max_resolution:
        raise ValueError(
            f"{path}:{name} active bbox {shape} exceeds max_resolution="
            f"{max_resolution}; downsample offline first")


def _read_native(path: str, grid_name, max_resolution: int
                 ) -> Tuple[np.ndarray, str]:
    from isosurfacesuperresolution_tpu_torch.native import vdbio
    name = _pick(vdbio.grid_names(path), grid_name, path)
    bbox, _ = vdbio.probe(path, name)
    _check_size(tuple(bbox[3 + i] - bbox[i] + 1 for i in range(3)), path,
                name, max_resolution)
    arr, _ = vdbio.load(path, name)
    return arr, name


def _read_bindings(vdb, path: str, grid_name, max_resolution: int
                   ) -> Tuple[np.ndarray, str]:
    metas = vdb.readAllGridMetadata(path)
    if not metas:
        raise ValueError(f"no grids in {path}")
    name = _pick([g.name for g in metas], grid_name, path)
    grid = vdb.read(path, name)
    (x0, y0, z0), (x1, y1, z1) = grid.evalActiveVoxelBoundingBox()
    shape = (x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1)
    _check_size(shape, path, name, max_resolution)
    arr = np.zeros(shape, np.float32)
    grid.copyToArray(arr, ijk=(x0, y0, z0))
    return arr, name
