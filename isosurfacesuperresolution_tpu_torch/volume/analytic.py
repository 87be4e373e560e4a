"""Analytic test volumes, built in numpy exactly as the JAX package's
`volume/analytic.py` builds them."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from isosurfacesuperresolution_tpu_torch.device import DeviceLike
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid


def _grid_coords(resolution: int):
    """Cell-centered world coordinates of every voxel of the unit box
    [-0.5, 0.5]^3."""
    c = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution - 0.5
    return np.meshgrid(c, c, c, indexing="ij")


def sphere_volume(resolution: int = 64, radius: float = 0.3,
                  center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                  sharpness: float = 8.0,
                  brick_size: int = 8,
                  store_dtype: str = "float32",
                  device: DeviceLike = None) -> BrickGrid:
    """Radial ramp through 0.5 at ``radius``."""
    x, y, z = _grid_coords(resolution)
    cx, cy, cz = center
    r = np.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
    d = np.clip(0.5 - sharpness * (r - radius), 0.0, 1.0).astype(np.float32)
    return BrickGrid.from_dense(d, brick_size=brick_size,
                                store_dtype=store_dtype, device=device)


def blobs_volume(resolution: int = 64, num_blobs: int = 6, seed: int = 0,
                 brick_size: int = 8, store_dtype: str = "float32",
                 device: DeviceLike = None) -> BrickGrid:
    """Random metaballs from ``seed``."""
    rng = np.random.RandomState(seed)
    x, y, z = _grid_coords(resolution)
    d = np.zeros_like(x)
    for _ in range(num_blobs):
        c = rng.uniform(-0.25, 0.25, size=3)
        rad = rng.uniform(0.08, 0.2)
        r2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        d += np.exp(-r2 / (2 * (rad / 2) ** 2))
    d = np.clip(d, 0.0, 1.0).astype(np.float32)
    return BrickGrid.from_dense(d, brick_size=brick_size,
                                store_dtype=store_dtype, device=device)
