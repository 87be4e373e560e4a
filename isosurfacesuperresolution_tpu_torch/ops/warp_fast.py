"""Gather-free temporal warp: two-pass shift-blend resampling.

Counterpart of the JAX package's `ops/warp_fast.py`: displacements are
clamped to ``max_disp`` pixels; pass 1 resamples along y as a weighted sum
of (2R+1) shifted, zero-padded copies, pass 2 the same along x.  It
reproduces the reference warp (linspace grid offsets + (-2 fx, +2 fy),
align_corners=False sampling, zero padding, the ``special_mask`` shift)
up to the clamp and the separable approximation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch.ops.resize import resize


def _shift_blend(img: torch.Tensor, disp: torch.Tensor, axis: int,
                 max_disp: int) -> torch.Tensor:
    """out(p) = img(p + disp(p)) along ``axis`` (1 = y, 2 = x) of
    (B, H, W, C); disp (B, H, W, 1) in pixels, zero outside."""
    r = max_disp
    disp = torch.clamp(disp, -r, r)
    pad = [0, 0, 0, 0, 0, 0]                   # (C, W, H) pairs
    pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = r
    img_p = F.pad(img, pad)
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for k in range(-r, r + 1):
        w = torch.clamp(1.0 - torch.abs(disp - k), min=0.0)
        out = out + w * img_p.narrow(axis, r + k, n)
    return out


def warp_upscale_fast(image_high: torch.Tensor, flow_low: torch.Tensor,
                      upscale_factor: int, special_mask: bool = False,
                      max_disp: int = 8) -> torch.Tensor:
    """Warp (B, H*u, W*u, C) by the upsampled low-res flow (B, H, W, 2)."""
    b, h, w, c2 = flow_low.shape
    if c2 != 2:
        raise ValueError(f"flow must have 2 channels, got {c2}")
    u = upscale_factor
    hh, wh = h * u, w * u
    flow = torch.stack([flow_low[..., 0] * -2.0, flow_low[..., 1] * 2.0],
                       -1)
    flow_high = resize(flow, scale=float(u), method="bilinear")
    dev, dt = flow_high.device, flow_high.dtype
    gx0 = torch.linspace(-1.0, 1.0, wh, dtype=dt, device=dev)
    gy0 = torch.linspace(-1.0, 1.0, hh, dtype=dt, device=dev)
    pos_x = ((gx0[None, None, :] + flow_high[..., 0] + 1.0) * wh - 1.0) * 0.5
    pos_y = ((gy0[None, :, None] + flow_high[..., 1] + 1.0) * hh - 1.0) * 0.5
    px_id = torch.arange(wh, dtype=dt, device=dev)[None, None, :]
    py_id = torch.arange(hh, dtype=dt, device=dev)[None, :, None]
    disp_x = (pos_x - px_id)[..., None]
    disp_y = (pos_y - py_id)[..., None]

    if special_mask:
        image_high = torch.cat([image_high[..., 0:1] * 0.5 + 0.5,
                                image_high[..., 1:]], -1)
    out = _shift_blend(image_high, disp_y, axis=1, max_disp=max_disp)
    out = _shift_blend(out, disp_x, axis=2, max_disp=max_disp)
    if special_mask:
        out = torch.cat([out[..., 0:1] * 2.0 - 1.0, out[..., 1:]], -1)
    return out
