"""Dense volume grid with its world transform.

Counterpart of the JAX package's `volume/grid.py`.  The brick min/max
pyramid there serves only the tiled march kernels, which are not ported
yet, so this `BrickGrid` holds the dense values and the transform:

* ``values``: (X, Y, Z) densities on the device, stored as float32,
  bfloat16 or uint8 (physical = stored * ``value_scale`` + ``value_offset``);
* ``bbox_min`` / ``bbox_max``: (3,) float32 world bounds, kept on the host
  because only camera geometry (computed on the host) and per-axis scalars
  read them;
* ``ao_sh``: an optional baked SH-L1 occlusion field (X, Y, Z, 4) on the
  device (`render/ao_sweep.attach_baked_ao`), stored as float32, bfloat16
  or uint8 (physical = stored * ``ao_scale`` + ``ao_offset``; scale and
  offset are floats or per-channel 4-tuples), at 1/``ao_downsample`` of
  the volume's resolution per axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)


@dataclasses.dataclass
class BrickGrid:
    values: torch.Tensor
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    value_scale: float = 1.0
    value_offset: float = 0.0
    ao_sh: Optional[torch.Tensor] = None
    ao_scale: Union[float, Tuple[float, ...]] = 1.0
    ao_offset: Union[float, Tuple[float, ...]] = 0.0
    ao_downsample: int = 1

    def dequant(self, stored: torch.Tensor) -> torch.Tensor:
        """Stored-type values -> physical float32 densities."""
        x = stored.to(torch.float32)
        if self.value_scale != 1.0:
            x = x * self.value_scale
        if self.value_offset != 0.0:
            x = x + self.value_offset
        return x

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.values.shape)

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

    @classmethod
    def from_dense(cls, values: np.ndarray,
                   normalize_box: bool = True,
                   bbox: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   store_dtype: str = "float32",
                   device: DeviceLike = None) -> "BrickGrid":
        """Build a grid from a dense (X, Y, Z) array.

        ``normalize_box``: scale uniformly so the longest side spans one
        world unit, centered at the origin.  ``store_dtype``: ``float32``,
        ``bfloat16`` (round to nearest even) or ``uint8`` (affine over the
        value range; uint8 input keeps its bytes with scale 1/255)."""
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
        return cls(values=stored.to(dev),
                   bbox_min=torch.from_numpy(np.asarray(bbox_min, np.float32)),
                   bbox_max=torch.from_numpy(np.asarray(bbox_max, np.float32)),
                   value_scale=scale, value_offset=offset)
