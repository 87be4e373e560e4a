"""Fold `upsample x2 -> conv3x3` into `conv3x3 (4x channels) -> pixel_shuffle`.

Counterpart of the JAX package's `ops/fused_upsample.py` (the parts the
planar engine uses).  Both the upsample U (a fixed 2-tap stencil per output
parity) and the conv K are linear and translation invariant per sub-pixel
parity, so ``K * U x`` equals one 3x3 conv at the low resolution producing
all four sub-pixels at once:

    K'_{a,b}[m, n] = sum_{d,e} W[a,d,m] W[b,e,n] K[d,e],

where ``W[a,d,m]`` is the weight of ``x[i+m]`` in ``U(x)[2i+a+d]``,
extracted numerically from this package's own `ops/resize.resize`.  Exact in
the interior; the 1-px high-res border edge-clamps where a conv after the
upsample would zero-pad.  Kernels are HWIO, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.ops.resize import resize


@lru_cache(maxsize=None)
def _stencil(method: str, factor: int) -> np.ndarray:
    """W[a, d, m]: weight of x[i+m] in U(x)[factor*i + a + d], for a in
    [0, factor) and d, m in {-1, 0, 1}, read off a 1-D resize of an
    identity matrix."""
    H = 9
    c = H // 2
    eye = torch.eye(H, dtype=torch.float32)[None, :, :, None]   # (1,H,H,1)
    # resize along H only: the second H acts as width
    S = resize(eye, size=(H * factor, H), method=method)[0, :, :, 0].numpy()
    W = np.zeros((factor, 3, 3), np.float64)
    for a in range(factor):
        for di, d in enumerate((-1, 0, 1)):
            for mi, m in enumerate((-1, 0, 1)):
                W[a, di, mi] = S[factor * c + a + d, c + m]
    return W


def compose_up2x_conv3x3(kernel: torch.Tensor, method: str) -> torch.Tensor:
    """(3, 3, Cin, Cout) HWIO kernel after a 2x upsample -> (3, 3, Cin,
    Cout*4) low-res kernel whose output channel ``co*4 + a*2 + b`` is
    sub-pixel (a, b) of ``co`` (the `pixel_shuffle` order)."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(kernel.shape)}")
    W = torch.as_tensor(_stencil(method, 2), dtype=kernel.dtype,
                        device=kernel.device)
    kc = torch.einsum("adm,ben,decf->mncfab", W, W, kernel)
    _, _, cin, cout = kernel.shape
    return kc.reshape(3, 3, cin, cout * 4)


def up2x_conv_bias(bias: torch.Tensor) -> torch.Tensor:
    """Per-channel bias repeated over the 4 sub-pixels (order (co, a, b))."""
    return torch.repeat_interleave(bias, 4)


def upsample_stencil_kernel(channels: int, method: str, factor: int,
                            device=None) -> torch.Tensor:
    """A (3, 3, C, C*factor^2) float32 kernel that IS the upsample: run at
    low resolution (edge-padded) and pixel-shuffled it reproduces
    ``resize(x, scale=factor, method=method)`` (edge-clamped on the 1-px
    border)."""
    w0 = torch.as_tensor(_stencil(method, factor)[:, 1, :],
                         dtype=torch.float32, device=device)      # (f, 3)
    eye = torch.eye(channels, dtype=torch.float32, device=device)
    k = torch.einsum("am,bn,cf->mncfab", w0, w0, eye)
    return k.reshape(3, 3, channels, channels * factor * factor)
