"""Image upsampling, pixel shuffle and unshuffle, NHWC.

Counterpart of the JAX package's `ops/resize.py` for what the fused frame
uses.  Bilinear upsampling follows half-pixel centers with clamped edges,
which is both `jax.image.resize`'s "linear" upsampling and
`F.interpolate(..., align_corners=False)`; downsampling differs between
the two (JAX antialiases), so it is refused here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def interpolate_nchw(x: torch.Tensor, size: Tuple[int, int],
                     method: str) -> torch.Tensor:
    """Upsample (B, C, H, W) to ``size`` by nearest or bilinear."""
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        raise ValueError("only upsampling is ported")
    if method == "nearest":
        # the reference's nearest: src = floor(dst * in / out)
        in_h, in_w = x.shape[-2], x.shape[-1]
        ih = torch.floor(torch.arange(size[0], device=x.device)
                         * (in_h / size[0])).long().clamp(0, in_h - 1)
        iw = torch.floor(torch.arange(size[1], device=x.device)
                         * (in_w / size[1])).long().clamp(0, in_w - 1)
        return x[..., ih[:, None], iw[None, :]]
    if method in ("bilinear", "linear"):
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False)
    raise ValueError(f"unknown or unported resize method {method!r}")


def resize(x: torch.Tensor, *, scale: Optional[float] = None,
           size: Optional[Tuple[int, int]] = None,
           method: str = "bilinear") -> torch.Tensor:
    """Upsample (B, H, W, C) images by ``scale`` or to ``size``."""
    if size is None:
        size = (int(round(x.shape[-3] * scale)),
                int(round(x.shape[-2] * scale)))
    y = interpolate_nchw(x.permute(0, 3, 1, 2), tuple(size), method)
    return y.permute(0, 2, 3, 1)


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r); output channel
    c*r*r + dy*r + dx holds sub-pixel (dy, dx) of input channel c."""
    r = factor
    b, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    y = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return y.reshape(b, h, w, c * r * r)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, C*r*r) -> (..., H*r, W*r, C), torch's PixelShuffle in
    NHWC: input channel c*r*r + dy*r + dx feeds sub-pixel (dy, dx) of
    output channel c."""
    r = factor
    *lead, h, w, c = x.shape
    cout = c // (r * r)
    y = x.reshape(*lead, h, w, cout, r, r)
    n = len(lead)
    y = y.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return y.reshape(*lead, h * r, w * r, cout)
