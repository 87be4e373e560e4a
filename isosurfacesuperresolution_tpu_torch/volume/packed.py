"""Sparse packed-tile volume storage: only occupied slice tiles are kept.

Counterpart of the JAX package's `volume/packed.py`.  The sweep reads the
volume as (Z, X, Y) slice-major planes cut into (TX, TY) tiles, so the
sparse unit is one slice tile:

* every tile that differs from the background is packed into an
  ``atlas`` of shape (N, TX, TY); an int32 ``slots`` table (Z, NTX, NTY)
  names each tile's atlas slot, slot 0 being the all-background tile, and
  slot ids follow the row-major order of the occupied (z, xt, yt);
* the sweep axis follows the camera (three axis orders, `SWEEP_PERMS`),
  so the volume is packed once per order; each atlas is already
  slice-major, so a frame copies no volume;
* a baked SH occlusion field packs the same way (`pack_ao_axis`), into
  (N, 4, TX, TY) tiles of a finer default tile.

Occupancy means "some voxel of the tile differs from the background stored
value" (within ``tolerance`` for float storage), independent of the
isovalue.  `SparseBrickGrid` keeps the brick pyramid, the world transform
and one packed volume (and AO field) per axis order; the tiled march
(`render/sweep_tiled.march_packed`, B3) and the packed AO capture
(`ao_capture_packed`, B4p) read them.  Packing runs in PyTorch on the
grid's device and gives the JAX package's atlases and slots bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.volume.grid import (
    DEFAULT_BRICK_SIZE, BrickGrid, GridTransform)

# the axis orders (volume axes as x, y, sweep) of the renderer's three
# sweep axes, `render/sweep._PERMS`
SWEEP_PERMS = ((1, 2, 0), (0, 2, 1), (0, 1, 2))


def _tiles(x: torch.Tensor, TX: int, TY: int) -> torch.Tensor:
    """A (Z, ..., X, Y) tensor as its (Z, NTX, NTY, ..., TX, TY) tiles
    (a view)."""
    Z, *mid, X, Y = x.shape
    n = len(mid)
    t = x.reshape(Z, *mid, X // TX, TX, Y // TY, TY)
    return t.permute(0, n + 1, n + 3, *range(1, n + 1), n + 2, n + 4)


def _pack(tiles: torch.Tensor, occ: torch.Tensor, background,
          dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contiguous atlas (slot 0 the background tile, then the
    occupied tiles in row-major (z, xt, yt) order) and the int32 slots."""
    n_occ = int(occ.sum())
    atlas = torch.empty((n_occ + 1,) + tuple(tiles.shape[3:]), dtype=dtype,
                        device=tiles.device)
    atlas[0] = background
    atlas[1:] = tiles[occ]
    slots = torch.zeros(occ.shape, dtype=torch.int32, device=occ.device)
    slots[occ] = torch.arange(1, n_occ + 1, dtype=torch.int32,
                              device=occ.device)
    return atlas, slots


@dataclasses.dataclass
class PackedAxisVolume:
    """One axis order's packed tiles.

    atlas: (N, TX, TY) tiles in the stored type, slot 0 all background;
    slots: (Z, NTX, NTY) int32 atlas slot per (z, x tile, y tile);
    slice_max: (Z,) float32 largest stored value of each plane (the
    renderer's per-slice cull); shape: (Z, X, Y) of the slice-major
    volume.  ``derived`` keeps the atlas in a kernel's type, made at first
    use."""

    atlas: torch.Tensor
    slots: torch.Tensor
    slice_max: torch.Tensor
    shape: Tuple[int, int, int]
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return tuple(self.atlas.shape[1:])

    def to_dense_zxy(self) -> torch.Tensor:
        """The dense (Z, X, Y) volume in the stored type."""
        Z, X, Y = self.shape
        TX, TY = self.tile_shape
        return (self.atlas[self.slots.long()]       # (Z, NTX, NTY, TX, TY)
                .permute(0, 1, 3, 2, 4).reshape(Z, X, Y))


def _pick_tile(extent: int, tile: int) -> int:
    # imported here: render/sweep.py imports this module, so importing the
    # render package at this module's top made `volume` unimportable first
    from isosurfacesuperresolution_tpu_torch.render.sweep_tiled import (
        pick_tile)
    return pick_tile(extent, tile)


def pack_axis(vol_zxy: torch.Tensor, tile: int = 256, background=0,
              tolerance: float = 0.0) -> PackedAxisVolume:
    """Pack one slice-major (Z, X, Y) volume in its stored type, on its
    device.  With ``tolerance`` > 0 a float volume drops every tile whose
    values all lie within ``tolerance`` of the background (it then reads
    as exact background); integer volumes ignore it.  0: lossless."""
    Z, X, Y = vol_zxy.shape
    TX, TY = _pick_tile(X, tile), _pick_tile(Y, tile)
    tiles = _tiles(vol_zxy, TX, TY)                   # (Z, NTX, NTY, TX, TY)
    if tolerance > 0.0 and vol_zxy.is_floating_point():
        occ = (torch.abs(tiles.to(torch.float32) - background)
               > tolerance).flatten(3).any(3)
    else:
        occ = (tiles != background).flatten(3).any(3)
    atlas, slots = _pack(tiles, occ, background, vol_zxy.dtype)
    slice_max = torch.amax(vol_zxy, dim=(1, 2)).to(torch.float32)
    return PackedAxisVolume(atlas, slots, slice_max, (Z, X, Y))


@dataclasses.dataclass
class PackedAOAxisVolume:
    """One axis order's packed baked SH occlusion field.

    atlas: (N, 4, TX, TY) tiles, channels [mean, gx, gy, gz], slot 0 all
    zero; slots: (Z, NTX, NTY) int32; shape: (Z, X, Y) of the field.
    ``derived`` keeps the atlas in a kernel's type, made at first use."""

    atlas: torch.Tensor
    slots: torch.Tensor
    shape: Tuple[int, int, int]
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return tuple(self.atlas.shape[2:])

    def to_dense_zcxy(self) -> torch.Tensor:
        """The dense (Z, 4, X, Y) field."""
        Z, X, Y = self.shape
        return (self.atlas[self.slots.long()]    # (Z, NTX, NTY, 4, TX, TY)
                .permute(0, 3, 1, 4, 2, 5).reshape(Z, 4, X, Y))


def pack_ao_axis(ao_zcxy: torch.Tensor, tile: int = 128,
                 tolerance: float = 1e-3,
                 dtype: torch.dtype = torch.float32) -> PackedAOAxisVolume:
    """Pack one slice-major (Z, 4, X, Y) baked SH field into ``dtype``
    tiles: a tile is kept when some channel differs from 0 by more than
    ``tolerance``, so the packing needs no isovalue."""
    Z, C, X, Y = ao_zcxy.shape
    if C != 4:
        raise ValueError(f"expected 4 SH channels, got {C}")
    TX, TY = _pick_tile(X, tile), _pick_tile(Y, tile)
    tiles = _tiles(ao_zcxy, TX, TY)               # (Z, NTX, NTY, 4, TX, TY)
    occ = (torch.abs(tiles.to(torch.float32)) > tolerance).flatten(3).any(3)
    atlas, slots = _pack(tiles, occ, 0, dtype)
    return PackedAOAxisVolume(atlas, slots, (Z, X, Y))


@dataclasses.dataclass
class SparseBrickGrid(GridTransform):
    """Sparse storage in place of `BrickGrid` on the tiled sweep path.

    Keeps the brick pyramid (dense and small: the tile culling), the world
    transform and one `PackedAxisVolume` per axis order of `SWEEP_PERMS`
    in place of the dense values, and optionally one `PackedAOAxisVolume`
    per order.  Only ``renderer="sweep_pallas"`` renders it
    (`to_brick_grid` densifies it for the other paths).  ``derived``:
    the renderer's tile tables, as `BrickGrid.derived`."""

    per_axis: Tuple[PackedAxisVolume, ...]
    brick_min: torch.Tensor
    brick_max: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    resolution: Tuple[int, int, int]
    brick_size: int = DEFAULT_BRICK_SIZE
    value_scale: float = 1.0
    value_offset: float = 0.0
    ao_per_axis: Optional[Tuple[PackedAOAxisVolume, ...]] = None
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.per_axis[0].atlas.device

    def storage_bytes(self) -> int:
        """Bytes of the packed storage: every axis order's atlas and slot
        table, the AO atlases included."""
        return sum(pa.atlas.numel() * pa.atlas.element_size()
                   + pa.slots.numel() * 4
                   for pa in self.per_axis + (self.ao_per_axis or ()))

    def dense_bytes(self) -> int:
        """Bytes of the dense volume in the stored type."""
        X, Y, Z = self.resolution
        return X * Y * Z * self.per_axis[0].atlas.element_size()

    @classmethod
    def from_brick_grid(cls, grid: BrickGrid, tile: int = 256,
                        tolerance: float = 0.0,
                        ao_tile: int = 128) -> "SparseBrickGrid":
        """Pack a dense grid's stored values per axis order, on its
        device.  A baked field (``grid.ao_sh``) is packed too
        (`pack_ao_axis`), as float32 physical values at the volume's
        resolution: a uint8 field is dequantized per channel first, and a
        coarse one upsampled linearly (cell-centered) on the host."""
        stored = grid.values
        ao = grid.ao_sh
        if ao is not None and ao.dtype == torch.uint8:
            ao = (ao.to(torch.float32)
                  * torch.tensor(grid.ao_scale, dtype=torch.float32,
                                 device=ao.device)
                  + torch.tensor(grid.ao_offset, dtype=torch.float32,
                                 device=ao.device))
        if ao is not None and grid.ao_downsample > 1:
            # (imported here: render.ao_sweep imports this package)
            from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
                _upsample1d_linear)
            up = ao.to(torch.float32).cpu().numpy()
            for axis, n in enumerate(stored.shape):
                up = _upsample1d_linear(up, axis, n, grid.ao_downsample)
            ao = torch.from_numpy(np.ascontiguousarray(up)).to(stored.device)
        per_axis, ao_per_axis = [], []
        for perm in SWEEP_PERMS:
            vol_zxy = stored.permute(perm[2], perm[0], perm[1])
            per_axis.append(pack_axis(vol_zxy, tile=tile,
                                      tolerance=tolerance))
            if ao is not None:
                ao_zcxy = ao.permute(perm[2], 3, perm[0], perm[1])
                ao_per_axis.append(pack_ao_axis(ao_zcxy, tile=ao_tile))
        return cls(per_axis=tuple(per_axis), brick_min=grid.brick_min,
                   brick_max=grid.brick_max, bbox_min=grid.bbox_min,
                   bbox_max=grid.bbox_max, resolution=grid.resolution,
                   brick_size=grid.brick_size,
                   value_scale=grid.value_scale,
                   value_offset=grid.value_offset,
                   ao_per_axis=tuple(ao_per_axis) if ao is not None else None)

    @classmethod
    def from_dense(cls, values: np.ndarray, tile: int = 256,
                   tolerance: float = 0.0, **kw) -> "SparseBrickGrid":
        """`BrickGrid.from_dense` (its keyword arguments, ``device``
        included) and then `from_brick_grid`."""
        return cls.from_brick_grid(BrickGrid.from_dense(values, **kw),
                                   tile=tile, tolerance=tolerance)

    def to_brick_grid(self) -> BrickGrid:
        """The dense grid (for the oracle paths and the tests); axis
        order 2 is the identity (Z, X, Y) <- (X, Y, Z)."""
        values = self.per_axis[2].to_dense_zxy().permute(1, 2, 0)
        ao_sh = None
        if self.ao_per_axis is not None:
            ao_sh = self.ao_per_axis[2].to_dense_zcxy().permute(
                2, 3, 0, 1).contiguous()
        return BrickGrid(values=values.contiguous(), bbox_min=self.bbox_min,
                         bbox_max=self.bbox_max, brick_min=self.brick_min,
                         brick_max=self.brick_max,
                         brick_size=self.brick_size,
                         value_scale=self.value_scale,
                         value_offset=self.value_offset, ao_sh=ao_sh)
