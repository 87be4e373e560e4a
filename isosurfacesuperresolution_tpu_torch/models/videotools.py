"""Temporal helpers: inverse pixel-shuffle flattening and the first-frame
stand-in for the recurrent input.

Counterpart of `flatten_high` and `initial_image` in the JAX package's
`models/videotools.py`.  NHWC.
"""

from __future__ import annotations

import torch

from isosurfacesuperresolution_tpu_torch.ops.resize import (
    pixel_unshuffle, resize)


def flatten_high(image_high: torch.Tensor, upscale_factor: int
                 ) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r), the reference's channel order."""
    return pixel_unshuffle(image_high, upscale_factor)


def initial_image(current_input: torch.Tensor, channels: int, mode: str,
                  ao_inverted: bool = False, upscaling: int = 4
                  ) -> torch.Tensor:
    """First-frame previous-frame input (B, H*u, W*u, channels) for the
    low-res input (B, H, W, Cin): "zero", "unshaded" defaults or the
    bilinear "input"."""
    b, h, w, cin = current_input.shape
    hh, wh = h * upscaling, w * upscaling
    dtype, dev = current_input.dtype, current_input.device
    if mode == "zero":
        return torch.zeros((b, hh, wh, channels), dtype=dtype, device=dev)
    if mode == "unshaded":
        if channels == 5:
            defaults = [-1.0, 0.0, 0.0, 1.0, 0.5]
        elif channels == 6:
            defaults = [-1.0, 0.0, 0.0, 1.0, 0.5,
                        0.0 if ao_inverted else 1.0]
        else:
            raise ValueError(
                "for mode='unshaded', channels is expected to be 5 or 6")
        out = torch.empty((b, hh, wh, channels), dtype=dtype, device=dev)
        for i, d in enumerate(defaults):
            out[..., i] = d
        return out
    if mode == "input":
        up = resize(current_input, scale=float(upscaling), method="bilinear")
        if channels <= cin:
            return up[..., :channels]
        pad = torch.ones((b, hh, wh, channels - cin), dtype=dtype,
                         device=dev)
        return torch.cat([up, pad], -1)
    raise ValueError("unknown input mode: " + mode)
