"""Temporal helpers: inverse pixel-shuffle flattening, the exact flow
warp and the first-frame stand-in for the recurrent input.

Counterpart of `flatten_high`, `warp_upscale` and `initial_image` in the
JAX package's `models/videotools.py`, with the reference's flow sign
conventions (flow_x scaled by -2, flow_y by +2), its linspace(-1, 1, n)
grid offsets sampled with ``align_corners=False`` (the pairing the
reference networks were trained with, kept on purpose), and the
``special_mask`` shift that makes the zero padding outside the frame read
back as mask = -1.  NHWC.
"""

from __future__ import annotations

import torch

from isosurfacesuperresolution_tpu_torch.ops.resize import (
    pixel_unshuffle, resize)
from isosurfacesuperresolution_tpu_torch.ops.sampling import grid_sample


def flatten_high(image_high: torch.Tensor, upscale_factor: int
                 ) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r), the reference's channel order."""
    return pixel_unshuffle(image_high, upscale_factor)


def _grid_offsets(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) base grid in [-1, 1], [..., 0] = x, [..., 1] = y."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=like.dtype, device=like.device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=like.dtype, device=like.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1)


def warp_upscale(image_high: torch.Tensor, flow_low: torch.Tensor,
                 upscale_factor: int, special_mask: bool = False
                 ) -> torch.Tensor:
    """Warp (B, H*u, W*u, C) by the bilinearly upsampled low-res flow
    (B, H, W, 2) with an exact gather; ``special_mask`` treats channel 0
    as the mask in [-1, 1]."""
    b, h, w, c2 = flow_low.shape
    if c2 != 2:
        raise ValueError(f"flow must have 2 channels, got {c2}")
    flow = torch.stack([flow_low[..., 0] * -2.0, flow_low[..., 1] * 2.0],
                       -1)
    flow_high = resize(flow, scale=float(upscale_factor), method="bilinear")
    grid = _grid_offsets(flow_high.shape[1], flow_high.shape[2],
                         flow_high)[None] + flow_high
    if special_mask:
        image_high = torch.cat([image_high[..., 0:1] * 0.5 + 0.5,
                                image_high[..., 1:]], -1)
    warped = grid_sample(image_high, grid)
    if special_mask:
        warped = torch.cat([warped[..., 0:1] * 2.0 - 1.0, warped[..., 1:]],
                           -1)
    return warped


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
