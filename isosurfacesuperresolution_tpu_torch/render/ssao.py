"""Screen-space ambient occlusion post-pass.

Counterpart of the JAX package's `render/ssao.py` (the reference's
``--ao screen``): occlusion is counted over a fixed set of screen-space
offsets, a golden-angle spiral over ``radius_px``; a neighbour occludes
when it is closer to the camera than the centre by more than ``bias`` and
less than ``depth_range`` (the range check drops disconnected geometry).
Each offset is a static image shift.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _shift2d(img: torch.Tensor, dy: int, dx: int, fill: float
             ) -> torch.Tensor:
    """Static 2D shift with constant fill: out[y, x] = img[y+dy, x+dx]."""
    h, w = img.shape[0], img.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = F.pad(img, (px1, px0, py1, py0), value=fill)
    return padded[py0:py0 + h, px0:px0 + w]


def apply_screen_ao(frame: torch.Tensor, samples: int = 16,
                    radius_px: int = 16, strength: float = 1.0,
                    depth_range: float = 0.02,
                    bias: float = 1e-4) -> torch.Tensor:
    """A copy of the (H, W, 12) G-buffer ``frame`` with its AO channel
    computed from its NDC depth (channel 7) and mask (channel 3); the
    background has depth +inf, so it never occludes, and AO 1."""
    depth = frame[..., 7]
    mask = frame[..., 3] > 0.5
    d = torch.where(mask, depth, torch.inf)
    occ = torch.zeros_like(depth)
    golden = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(samples):
        r = radius_px * math.sqrt((i + 0.5) / samples)
        ang = i * golden
        dy = int(round(r * math.sin(ang)))
        dx = int(round(r * math.cos(ang)))
        if dy == 0 and dx == 0:
            dx = 1
        diff = d - _shift2d(d, dy, dx, math.inf)  # > 0: neighbour closer
        occ = occ + ((diff > bias) & (diff < depth_range)).to(occ.dtype)
    ao = torch.clamp(1.0 - strength * occ / samples, 0.0, 1.0)
    out = frame.clone()
    out[..., 10] = torch.where(mask, ao, 1.0)
    return out
