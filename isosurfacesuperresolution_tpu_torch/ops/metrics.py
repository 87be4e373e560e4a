"""Quality metrics: masked PSNR, SSIM, MS-SSIM, running mean/variance.

Counterpart of the JAX package's `ops/metrics.py` (the reference's
`utils/psnr.py`, `utils/ssim.py` and `utils/mv.py`).  Images are NHWC.
The SSIM window is a separable Gaussian applied per channel in valid mode
by two depthwise `F.conv2d` calls (along H, then W), as JAX's two
grouped convolutions apply it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         epsilon: float = 1e-7) -> torch.Tensor:
    """PSNR over (B, H, W, C) batches -> (B,).  With a mask (B, H, W, 1)
    in [0, 1], zero-mask pixels are ignored and the result is weighted by
    the inverse fill factor (the reference's masked formula)."""
    if mask is None:
        mse = torch.mean((img1 - img2) ** 2, dim=(1, 2, 3))
        return 10.0 * torch.log10(1.0 / (epsilon + mse))
    img1 = img1 * mask
    img2 = img2 * mask
    h, w = mask.shape[1], mask.shape[2]
    factor = (h * w) / torch.sum(mask, dim=(1, 2, 3))
    mse = torch.mean((img1 - img2) ** 2, dim=(1, 2, 3))
    return 10.0 * factor * torch.log10(1.0 / (epsilon + mse))


def _gaussian_window(window_size: int, sigma: float,
                     like: torch.Tensor) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.int64, device=like.device)
    g = torch.exp(-((x - window_size // 2) ** 2).to(like.dtype)
                  / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _window_filter(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable window filter per channel, NHWC: along H,
    then along W."""
    k, c = window.shape[0], x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, window.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    y = F.conv2d(y, window.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return y.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         val_range: Optional[float] = None, size_average: bool = True,
         full: bool = False):
    """SSIM on NHWC batches; ``val_range=None`` infers the dynamic range
    from ``img1`` (255 or 1, offset for [-1, 1] inputs) on its device, a
    float32 tensor as JAX's, without a host sync.  Variances are clamped
    at 0 and the covariance by Cauchy-Schwarz, as in JAX."""
    if val_range is None:
        max_val = torch.where(torch.max(img1) > 128, 255.0, 1.0)
        min_val = torch.where(torch.min(img1) < -0.5, -1.0, 0.0)
        L = max_val - min_val
    else:
        L = val_range
    h, w = img1.shape[1], img1.shape[2]
    window = _gaussian_window(min(window_size, h, w), 1.5, img1)

    mu1 = _window_filter(img1, window)
    mu2 = _window_filter(img2, window)
    mu1_sq = mu1 ** 2
    mu2_sq = mu2 ** 2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = torch.clamp(_window_filter(img1 * img1, window) - mu1_sq,
                            min=0.0)
    sigma2_sq = torch.clamp(_window_filter(img2 * img2, window) - mu2_sq,
                            min=0.0)
    sigma12 = _window_filter(img1 * img2, window) - mu1_mu2
    bound = torch.sqrt(sigma1_sq * sigma2_sq)
    sigma12 = torch.minimum(torch.maximum(sigma12, -bound), bound)

    c1 = (0.01 * L) ** 2
    c2 = (0.03 * L) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    ret = (torch.mean(ssim_map) if size_average
           else torch.mean(ssim_map, dim=(1, 2, 3)))
    if full:
        return ret, cs
    return ret


def msssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           val_range: Optional[float] = None,
           normalize: bool = False) -> torch.Tensor:
    """Multi-scale SSIM over 5 scales, each a 2x average pool of the
    last; negative per-scale means are clamped at 0 (as in JAX)."""
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           device=img1.device)
    levels = weights.shape[0]
    min_side = min(img1.shape[1], img1.shape[2])
    if min_side < 2 ** (levels - 1):
        raise ValueError(
            f"MS-SSIM needs images of at least {2 ** (levels - 1)} px per "
            f"side (got {min_side}); 5 halving levels run out of pixels")
    mssim, mcs = [], []
    for level in range(levels):
        sim, cs = ssim(img1, img2, window_size=window_size,
                       val_range=val_range, full=True)
        mssim.append(sim)
        mcs.append(cs)
        if level + 1 < levels:     # (no pool after the last scale)
            img1, img2 = (F.avg_pool2d(t.permute(0, 3, 1, 2), 2).permute(
                0, 2, 3, 1) for t in (img1, img2))
    mssim = torch.stack(mssim)
    mcs = torch.stack(mcs)
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    mssim = torch.clamp(mssim, min=0.0)
    mcs = torch.clamp(mcs, min=0.0)
    pow1 = mcs ** weights
    pow2 = mssim ** weights
    return torch.prod(pow1[:-1]) * pow2[-1]


class MeanVariance:
    """Welford's online mean/variance."""

    def __init__(self):
        self.n_ = 0
        self.mean_ = 0.0
        self.sn_ = 0.0

    def append(self, x: float):
        self.n_ += 1
        last = self.mean_
        self.mean_ += (x - last) / self.n_
        if self.n_ == 1:
            self.sn_ = 0.0
        else:
            self.sn_ += (x - last) * (x - self.mean_)

    def mean(self) -> float:
        return self.mean_

    def var(self) -> float:
        return self.sn_ / self.n_

    def count(self) -> int:
        return self.n_
