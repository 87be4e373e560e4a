"""Volume ingestion: .dat/RAW descriptors, npy/npz volumes, cvol brick files.

Counterpart of the JAX package's `volume/importers.py`
(`CPURenderer/ExternalImporter.cpp:25-232`): a ``.dat`` descriptor
(ObjectFileName / Resolution / Format) pointing at a raw
UCHAR/USHORT/BYTE/FLOAT volume; values normalized to [0, 1], optional
box-filter downsampling, a lower threshold zeroing near-empty voxels
(tolerance 0.001, `ExternalImporter.cpp:181`), and the unit-box world
transform (`CPURenderer.cpp:448-460`).

The decode runs on the host: the native reader (`native/volumeio.cpp`,
built at first use) first, the numpy path if the native one cannot be
built or loaded; both give the same values.  The grid is then built on
the requested device (`BrickGrid.from_dense`), the card unless the
caller asks for the CPU.  A ``.cvol.npz`` written by either package loads
in the other.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid

_DTYPES = {
    "UCHAR": (np.uint8, 255.0),
    "BYTE": (np.uint8, 255.0),
    "USHORT": (np.uint16, 65535.0),
    "FLOAT": (np.float32, 1.0),
}


def parse_dat_descriptor(path: str) -> Tuple[str, Tuple[int, int, int], str]:
    """Parse a ``.dat`` descriptor (`ExternalImporter.cpp:34-84`)."""
    object_file = ""
    resolution = (0, 0, 0)
    fmt = ""
    with open(path) as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == "ObjectFileName:":
                object_file = tokens[1]
            elif key == "Resolution:":
                resolution = (int(tokens[1]), int(tokens[2]), int(tokens[3]))
            elif key == "Format:":
                fmt = tokens[1].upper()
    if not object_file or resolution[0] == 0 or not fmt:
        raise ValueError(
            "Descriptor file does not contain ObjectFileName, Resolution "
            "and Format")
    if fmt not in _DTYPES:
        raise ValueError(f"Unknown format {fmt}")
    return object_file, resolution, fmt


def _load_raw_numpy(bfile: str, resolution: Tuple[int, int, int],
                    fmt: str) -> np.ndarray:
    """Read the raw payload, skipping any leading header
    (`ExternalImporter.cpp:99-110`)."""
    dtype, scale = _DTYPES[fmt]
    rx, ry, rz = resolution
    count = rx * ry * rz
    payload = count * np.dtype(dtype).itemsize
    header = os.path.getsize(bfile) - payload
    if header < 0:
        raise ValueError(f"File is too small, {-header} bytes missing")
    with open(bfile, "rb") as f:
        f.seek(header)
        data = np.fromfile(f, dtype=dtype, count=count)
    vol = data.reshape(rz, ry, rx).astype(np.float32) / scale
    # stored z-major (slice by slice); convert to (X, Y, Z)
    return vol.transpose(2, 1, 0)


def box_downsample(vol: np.ndarray, factor: int) -> np.ndarray:
    """Box-filter downsampling over factor^3 blocks
    (`ExternalImporter.cpp:135-176`)."""
    if factor == 1:
        return vol
    x, y, z = vol.shape
    xs, ys, zs = x // factor, y // factor, z // factor
    v = vol[:xs * factor, :ys * factor, :zs * factor]
    v = v.reshape(xs, factor, ys, factor, zs, factor)
    return v.mean(axis=(1, 3, 5))


def import_raw(path: str, downsampling: int = 1,
               lower_threshold: float = 0.001,
               brick_size: int = 8,
               use_native: bool = True,
               store_dtype: str = "float32",
               device: DeviceLike = None) -> BrickGrid:
    """Import a ``.dat``+raw volume into a BrickGrid on ``device``.

    Values below ``lower_threshold`` are zeroed (the sparsity threshold of
    `CPURenderer.cpp` `--threshold`, `ExternalImporter.cpp:153`)."""
    dev = resolve_device(device)
    if path.endswith(".raw"):
        raise ValueError("pass the .dat descriptor, not the .raw payload "
                         "(parity with the reference CLI)")
    if not path.endswith(".dat"):
        raise ValueError("Filename does not point to the .dat file")
    object_file, resolution, fmt = parse_dat_descriptor(path)
    bfile = os.path.join(os.path.dirname(os.path.abspath(path)), object_file)

    vol = None
    if use_native:
        try:
            from isosurfacesuperresolution_tpu_torch.native import volumeio
            vol = volumeio.load_raw(bfile, resolution, fmt, downsampling,
                                    lower_threshold)
        except (ImportError, OSError):
            vol = None
    if vol is None:
        vol = _load_raw_numpy(bfile, resolution, fmt)
        vol = box_downsample(vol, downsampling)
        vol[vol < lower_threshold] = 0.0
    return BrickGrid.from_dense(vol, brick_size=brick_size,
                                store_dtype=store_dtype, device=dev)


def import_npy(path: str, brick_size: int = 8,
               lower_threshold: float = 0.0,
               store_dtype: str = "float32",
               device: DeviceLike = None) -> BrickGrid:
    """Load a dense (X, Y, Z) volume from .npy/.npz onto ``device``."""
    dev = resolve_device(device)
    if path.endswith(".npz"):
        with np.load(path) as data:
            vol = data[list(data.keys())[0]]
    else:
        vol = np.load(path)
    vol = np.asarray(vol, np.float32)
    if lower_threshold > 0:
        vol = np.where(vol < lower_threshold, 0.0, vol)
    return BrickGrid.from_dense(vol, brick_size=brick_size,
                                store_dtype=store_dtype, device=dev)


# ---------------------------------------------------------------------------
# cvol: the brick-volume interchange format (the analogue of GVDB's .vbx
# produced by `Vdb2Vbx.cpp` / `-m convert`)
# ---------------------------------------------------------------------------

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the JAX package saves: bfloat16 as
    its raw two bytes (numpy has no bfloat16; JAX's arrays save as
    ``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def save_cvol(path: str, grid: BrickGrid) -> None:
    """Save a BrickGrid (incl. any baked AO field) as a compressed npz,
    with the JAX package's keys."""
    payload = dict(
        values=_to_numpy(grid.values),
        brick_min=_to_numpy(grid.brick_min),
        brick_max=_to_numpy(grid.brick_max),
        bbox_min=_to_numpy(grid.bbox_min),
        bbox_max=_to_numpy(grid.bbox_max),
        brick_size=np.asarray(grid.brick_size),
        value_scale=np.asarray(grid.value_scale),
        value_offset=np.asarray(grid.value_offset))
    if grid.ao_sh is not None:
        payload["ao_sh"] = _to_numpy(grid.ao_sh)
    np.savez_compressed(path, **payload)


def load_cvol(path: str, device: DeviceLike = None) -> BrickGrid:
    """A ``.cvol.npz`` as a BrickGrid on ``device`` (the world box on the
    host, as `BrickGrid` keeps it)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        return BrickGrid(
            values=_to_tensor(d["values"], dev),
            brick_min=_to_tensor(d["brick_min"], dev),
            brick_max=_to_tensor(d["brick_max"], dev),
            bbox_min=torch.from_numpy(np.asarray(d["bbox_min"], np.float32)),
            bbox_max=torch.from_numpy(np.asarray(d["bbox_max"], np.float32)),
            brick_size=int(d["brick_size"]),
            ao_sh=_to_tensor(d["ao_sh"], dev) if "ao_sh" in d else None,
            value_scale=(float(d["value_scale"])
                         if "value_scale" in d else 1.0),
            value_offset=(float(d["value_offset"])
                          if "value_offset" in d else 0.0))
