"""Dense volume grid with its world transform.

Counterpart of the JAX package's `volume/grid.py`:

* ``values``: (X, Y, Z) densities on the device, stored as float32,
  bfloat16 or uint8 (physical = stored * ``value_scale`` + ``value_offset``);
* ``brick_min`` / ``brick_max``: (X/b, Y/b, Z/b) float32 bounds of the
  physical values of each ``brick_size``-voxel brick plus a one-voxel
  apron, on the device (`compute_brick_minmax`); the tiled march culls
  slice tiles with them.  None for a grid built without them;
* ``bbox_min`` / ``bbox_max``: (3,) float32 world bounds, kept on the host
  because only camera geometry (computed on the host) and per-axis scalars
  read them;
* ``ao_sh``: an optional baked SH-L1 occlusion field (X, Y, Z, 4) on the
  device (`render/ao_sweep.attach_baked_ao`), stored as float32, bfloat16
  or uint8 (physical = stored * ``ao_scale`` + ``ao_offset``; scale and
  offset are floats or per-channel 4-tuples), at 1/``ao_downsample`` of
  the volume's resolution per axis;
* ``derived``: device tables derived from the fields above and built at
  first use (the tiled renderer's tile tables); not an init argument, so
  `dataclasses.replace` starts a new grid with none.

The march oracle reads a grid through `BrickGrid.sample_trilinear`,
`sample_nearest` and `brick_max_at`.  `GridTransform` holds what
`BrickGrid` shares with the packed `volume/packed.SparseBrickGrid`: the
world transform and the dequant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)


DEFAULT_BRICK_SIZE = 8


class GridTransform:
    """The world transform and dequant of a grid with ``resolution``
    (X, Y, Z), host ``bbox_min`` / ``bbox_max`` and ``value_scale`` /
    ``value_offset``."""

    def dequant(self, stored: torch.Tensor) -> torch.Tensor:
        """Stored-type values -> physical float32 densities."""
        x = stored.to(torch.float32)
        if self.value_scale != 1.0:
            x = x * self.value_scale
        if self.value_offset != 0.0:
            x = x + self.value_offset
        return x

    @property
    def voxel_size(self) -> torch.Tensor:
        """World-space size of one voxel (3,), on the host."""
        res = torch.tensor(self.resolution, dtype=torch.float32)
        return (self.bbox_max - self.bbox_min) / res

    def world_to_voxel(self, p: torch.Tensor) -> torch.Tensor:
        """World positions (..., 3) -> continuous voxel coordinates; the
        sample stored at index i sits at voxel coordinate i + 0.5."""
        lo = self.bbox_min.tolist()
        span = (self.bbox_max - self.bbox_min).tolist()
        return torch.stack([(p[..., i] - lo[i]) / span[i] * float(r)
                            for i, r in enumerate(self.resolution)], -1)

    def voxel_to_world(self, v: torch.Tensor) -> torch.Tensor:
        # per-axis host scalars: no host-to-device copy for device inputs
        lo = self.bbox_min.tolist()
        span = (self.bbox_max - self.bbox_min).tolist()
        return torch.stack([v[..., i] / float(r) * span[i] + lo[i]
                            for i, r in enumerate(self.resolution)], -1)


@dataclasses.dataclass
class BrickGrid(GridTransform):
    values: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    brick_min: Optional[torch.Tensor] = None
    brick_max: Optional[torch.Tensor] = None
    brick_size: int = DEFAULT_BRICK_SIZE
    value_scale: float = 1.0
    value_offset: float = 0.0
    ao_sh: Optional[torch.Tensor] = None
    ao_scale: Union[float, Tuple[float, ...]] = 1.0
    ao_offset: Union[float, Tuple[float, ...]] = 0.0
    ao_downsample: int = 1
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.values.shape)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def brick_max_at(self, vox: torch.Tensor) -> torch.Tensor:
        """Max value of the brick holding voxel coordinate (..., 3); -inf
        outside the volume, so empty space outside is always skippable.
        The pyramid's shape enters as host ints: a call copies nothing
        from the host (the march calls it at every step)."""
        idx = torch.floor(vox.to(self.brick_max.device)
                          / self.brick_size).long()
        v, inside = _take_inside(self.brick_max, idx)
        return torch.where(inside, v, -torch.inf)

    def sample_trilinear(self, vox: torch.Tensor) -> torch.Tensor:
        """Trilinear sample of the physical values at voxel coordinates
        (..., 3); 0 outside the volume (`sample_trilinear`)."""
        return sample_trilinear(self.values, vox, self.value_scale,
                                self.value_offset)

    def sample_nearest(self, vox: torch.Tensor) -> torch.Tensor:
        """The physical value of the voxel holding coordinate (..., 3); 0
        outside the volume."""
        v, inside = _take_inside(self.values, torch.floor(vox).long())
        return torch.where(inside, self.dequant(v), 0.0)

    @classmethod
    def from_dense(cls, values: np.ndarray,
                   brick_size: int = DEFAULT_BRICK_SIZE,
                   normalize_box: bool = True,
                   bbox: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   store_dtype: str = "float32",
                   device: DeviceLike = None) -> "BrickGrid":
        """Build a grid from a dense (X, Y, Z) array.

        ``normalize_box``: scale uniformly so the longest side spans one
        world unit, centered at the origin.  ``store_dtype``: ``float32``,
        ``bfloat16`` (round to nearest even) or ``uint8`` (affine over the
        value range; uint8 input keeps its bytes with scale 1/255).  The
        brick pyramid bounds the dequantized stored values, what the
        renderer samples, so culling stays conservative after rounding."""
        dev = resolve_device(device)
        raw_in = values
        values = np.asarray(values, np.float32)
        if values.ndim != 3:
            raise ValueError(f"expected 3D volume, got shape {values.shape}")
        res = np.asarray(values.shape, np.float32)
        if bbox is not None:
            bbox_min = np.asarray(bbox[0], np.float32)
            bbox_max = np.asarray(bbox[1], np.float32)
        elif normalize_box:
            half = res / float(res.max()) / 2.0
            bbox_min, bbox_max = -half, half
        else:
            bbox_min, bbox_max = np.zeros(3, np.float32), res

        scale, offset = 1.0, 0.0
        if store_dtype == "float32":
            stored = torch.from_numpy(values)
        elif store_dtype == "bfloat16":
            stored = torch.from_numpy(values).to(torch.bfloat16)
        elif store_dtype == "uint8":
            if isinstance(raw_in, np.ndarray) and raw_in.dtype == np.uint8:
                q = raw_in
                scale = 1.0 / 255.0
            else:
                vmin, vmax = float(values.min()), float(values.max())
                span = max(vmax - vmin, 1e-12)
                q = np.clip(np.round((values - vmin) / span * 255.0),
                            0, 255).astype(np.uint8)
                scale, offset = span / 255.0, vmin
            stored = torch.from_numpy(np.ascontiguousarray(q))
        else:
            raise ValueError(f"unknown store_dtype {store_dtype!r}")
        physical = (stored.to(torch.float32).numpy() * np.float32(scale)
                    + np.float32(offset))
        bmin, bmax = compute_brick_minmax(physical, brick_size)
        del physical
        return cls(values=stored.to(dev),
                   bbox_min=torch.from_numpy(np.asarray(bbox_min, np.float32)),
                   bbox_max=torch.from_numpy(np.asarray(bbox_max, np.float32)),
                   brick_min=torch.from_numpy(bmin).to(dev),
                   brick_max=torch.from_numpy(bmax).to(dev),
                   brick_size=brick_size, value_scale=scale,
                   value_offset=offset)


def _take_inside(table: torch.Tensor, idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``table`` (X, Y, Z) at integer indices (..., 3) clamped into it,
    and whether each index lies inside."""
    inside = (idx >= 0).all(-1)
    for a in range(3):
        inside = inside & (idx[..., a] < table.shape[a])
    return table[tuple(idx[..., a].clamp(0, table.shape[a] - 1)
                       for a in range(3))], inside


def sample_trilinear(values: torch.Tensor, vox: torch.Tensor,
                     scale: float = 1.0, offset: float = 0.0
                     ) -> torch.Tensor:
    """Trilinear interpolation of a dense (X, Y, Z) volume at continuous
    voxel coordinates ``vox`` (..., 3), the voxel stored at index i
    centered at i + 0.5.  Each of the 8 corners is dequantized (physical =
    stored * ``scale`` + ``offset``) before the blend, and one that falls
    outside the volume contributes the physical value 0 (empty space).
    The blend runs along x, then y, then z, as the JAX package's."""
    X, Y, Z = values.shape
    flat = values.reshape(-1)
    p = vox - 0.5
    p0 = torch.floor(p)
    frac = p - p0
    i0 = p0.long()
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    ins = [[(i + d >= 0) & (i + d < n) for d in (0, 1)]
           for i, n in ((ix, X), (iy, Y), (iz, Z))]
    cl = [[(i + d).clamp(0, n - 1) for d in (0, 1)]
          for i, n in ((ix, X), (iy, Y), (iz, Z))]

    def corner(dx, dy, dz):
        v = flat[(cl[0][dx] * Y + cl[1][dy]) * Z + cl[2][dz]].to(
            torch.float32)
        if scale != 1.0:
            v = v * scale
        if offset != 0.0:
            v = v + offset
        return torch.where(ins[0][dx] & ins[1][dy] & ins[2][dz], v, 0.0)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz
    c00 = corner(0, 0, 0) * gx + corner(1, 0, 0) * fx
    c10 = corner(0, 1, 0) * gx + corner(1, 1, 0) * fx
    c01 = corner(0, 0, 1) * gx + corner(1, 0, 1) * fx
    c11 = corner(0, 1, 1) * gx + corner(1, 1, 1) * fx
    c0 = c00 * gy + c10 * fy
    c1 = c01 * gy + c11 * fy
    return c0 * gz + c1 * fz


def compute_brick_minmax(values: np.ndarray, brick_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-brick min/max of a (X, Y, Z) array with a one-voxel apron on
    every side, as float32 numpy arrays (X/b, Y/b, Z/b) (sizes rounded up).

    A trilinear sample inside brick B interpolates voxels up to one index
    outside B, so B's bounds include them.  The volume is first padded with
    its edge values to a multiple of b, which never widens the range; the
    pool runs on the host (one-time preprocessing)."""
    b = brick_size
    values = np.asarray(values, np.float32)
    X, Y, Z = values.shape
    v = np.pad(values, ((0, (-X) % b), (0, (-Y) % b), (0, (-Z) % b)),
               mode="edge")

    def pool(op, pad_val):
        # separable sliding window of length b + 2 at stride b (brick core
        # plus apron) along each axis; the apron pad is op's identity
        out = np.pad(v, 1, mode="constant", constant_values=pad_val)
        for ax in range(3):
            nb = v.shape[ax] // b
            acc = None
            sl = [slice(None)] * 3
            for d in range(b + 2):
                sl[ax] = slice(d, d + (nb - 1) * b + 1, b)
                part = out[tuple(sl)]
                if acc is None:
                    acc = part.copy()
                else:
                    op(acc, part, out=acc)
            out = acc
        return out

    return pool(np.minimum, np.inf), pool(np.maximum, -np.inf)
