"""Volumes: the dense grid, its packed sparse form and the analytic test
volumes."""

from isosurfacesuperresolution_tpu_torch.volume.grid import (
    BrickGrid, compute_brick_minmax)
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    PackedAxisVolume, SparseBrickGrid)
from isosurfacesuperresolution_tpu_torch.volume import analytic

__all__ = ["BrickGrid", "PackedAxisVolume", "SparseBrickGrid", "analytic",
           "compute_brick_minmax"]
