"""Image upsampling, pixel shuffle and unshuffle, NHWC.

Counterpart of the JAX package's `ops/resize.py`.  Bilinear upsampling
follows half-pixel centers with clamped edges, which is both
`jax.image.resize`'s "linear" upsampling and `F.interpolate(...,
align_corners=False)`.  Bicubic is `jax.image.resize`'s "cubic": Keys'
kernel with a = -0.5, taps outside the image dropped and the remaining
weights renormalized to sum 1.  `F.interpolate(mode="bicubic")` is
another function (a = -0.75, clamped edges), so the port applies JAX's
per-axis weight matrices.  Downsampling differs between the libraries:
`jax.image.resize` antialiases (its kernel widened by the scale), which
`resize` reproduces for "bilinear" with JAX's weight matrices
(`linear_matrix`); the generators' `interpolate_nchw` only upsamples.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, of |x| (float32)."""
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


@lru_cache(maxsize=None)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a 1-D bicubic upsample, as
    `jax.image.resize(..., "cubic")` computes them: half-pixel sample
    positions, Keys' kernel, each row divided by its sum (which drops the
    taps outside the image)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    w = _keys_cubic(sample[:, None] - np.arange(n_in, dtype=np.float32))
    total = w.sum(axis=1, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


@lru_cache(maxsize=None)
def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a 1-D linear resize as
    `jax.image.resize(..., "linear")` computes them (antialiased: the
    triangle kernel widened by n_in / n_out when downsampling), each row
    divided by its sum."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[:, None] - np.arange(n_in, dtype=np.float32)) \
        / kernel_scale
    w = np.maximum(np.float32(0), np.float32(1) - x).astype(np.float32)
    total = w.sum(axis=1, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0).astype(np.float32)


_MATRICES: Dict[tuple, torch.Tensor] = {}


def _weights(fn, n_in: int, n_out: int, x: torch.Tensor) -> torch.Tensor:
    """``fn(n_in, n_out)`` on ``x``'s device in its type, copied there
    once per (function, size, device, type)."""
    key = (fn.__name__, n_in, n_out, x.device, x.dtype)
    if key not in _MATRICES:
        _MATRICES[key] = torch.as_tensor(fn(n_in, n_out)).to(
            x.device, x.dtype)
    return _MATRICES[key]


def _bicubic_weights(n_in: int, n_out: int, x: torch.Tensor
                     ) -> torch.Tensor:
    return _weights(bicubic_matrix, n_in, n_out, x)


def interpolate_nchw(x: torch.Tensor, size: Tuple[int, int],
                     method: str) -> torch.Tensor:
    """Upsample (B, C, H, W) to ``size`` by nearest, bilinear or
    bicubic."""
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
    if method in ("bicubic", "cubic"):
        wh = _bicubic_weights(x.shape[-2], size[0], x)
        ww = _bicubic_weights(x.shape[-1], size[1], x)
        # two small products: rows, then columns
        return torch.matmul(wh, torch.matmul(x, ww.t()))
    raise ValueError(f"unknown resize method {method!r}")


def resize(x: torch.Tensor, *, scale: Optional[float] = None,
           size: Optional[Tuple[int, int]] = None,
           method: str = "bilinear") -> torch.Tensor:
    """Resize (B, H, W, C) images by ``scale`` or to ``size``: upsampling
    by nearest, bilinear or bicubic, downsampling by JAX's antialiased
    bilinear."""
    if size is None:
        size = (int(round(x.shape[-3] * scale)),
                int(round(x.shape[-2] * scale)))
    if size[0] < x.shape[-3] or size[1] < x.shape[-2]:
        if method not in ("bilinear", "linear"):
            raise ValueError(f"{method}: only upsampling is ported; "
                             "downsampling is bilinear (JAX's antialiased "
                             "linear)")
        wh = _weights(linear_matrix, x.shape[-3], size[0], x)
        ww = _weights(linear_matrix, x.shape[-2], size[1], x)
        return torch.einsum("oh,bhwc,pw->bopc", wh, x, ww)
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
