"""Grid sampling in NHWC: the exact temporal warp's gather.

Counterpart of the JAX package's `ops/sampling.grid_sample`: bilinear
interpolation, zero outside the image, ``align_corners=False`` by default
(the reference's `warp_upscale`).  `F.grid_sample` computes the same
function (the same source positions, each corner outside the image read
as zero) and is held against JAX's gathers in the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) or (H, W, C) at normalized locations
    ``grid`` (B, Hg, Wg, 2) or (Hg, Wg, 2), [..., 0] = x indexing width
    and [..., 1] = y indexing height, both in [-1, 1]; returns
    (B, Hg, Wg, C) or (Hg, Wg, C)."""
    single = img.dim() == 3
    if single:
        img, grid = img[None], grid[None]
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners).permute(0, 2, 3, 1)
    return out[0] if single else out
