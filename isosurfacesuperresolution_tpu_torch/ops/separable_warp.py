"""Dense 2-tap interpolation matrices and the two-pass homography warp.

Counterpart of the JAX package's `ops/separable_warp.py`.  The warp keeps
the two-pass (Catmull-Smith) separable resample of the reference: a
one-pass bilinear `grid_sample` gives different numbers.  Positions are
cell-centered (sample i at coordinate i + 0.5); outside the domain the
weights fade to 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def interp_matrix(positions: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., P) positions -> (..., P, in_size) hat-function weights W with
    W @ f == f(positions)."""
    p = positions - 0.5
    i = torch.arange(in_size, dtype=positions.dtype, device=positions.device)
    return torch.clamp(1.0 - torch.abs(p[..., :, None] - i), min=0.0)


def rowwise_resample(f: torch.Tensor, positions: torch.Tensor,
                     chunk: int = 64) -> torch.Tensor:
    """out[r, j, c] = f[r, :, c](positions[r, j]); f (R, N, C), positions
    (R, P).  Rows go in chunks so the (chunk, P, N) weights stay small."""
    n = f.shape[1]
    outs = []
    for r0 in range(0, f.shape[0], chunk):
        w = interp_matrix(positions[r0:r0 + chunk], n)     # (c, P, N)
        outs.append(torch.bmm(w, f[r0:r0 + chunk]))
    return torch.cat(outs, 0)


def homography_warp(img: torch.Tensor, h: torch.Tensor,
                    out_shape: Tuple[int, int],
                    chunk: int = 64) -> torch.Tensor:
    """Warp (S, T, C) by the homography (u, v) -> (s, t); returns (U, V, C).

    out[u, v] = img(s(u, v), t(u, v)), bilinear, zero outside.  Pass 1
    resamples each t-row along s at s~(u, t), where the iso-t line meets
    the iso-u line; pass 2 resamples each u-column along t at t(u, v).
    ``h`` is a host (3, 3) matrix: its entries enter as scalars.
    """
    S, T = img.shape[0], img.shape[1]
    U, V = out_shape
    (a, b, c), (d, e, f), (g, hh, i_) = h.tolist()
    dev = img.device
    uu = torch.arange(U, dtype=torch.float32, device=dev) + 0.5
    vv = torch.arange(V, dtype=torch.float32, device=dev) + 0.5
    tt = torch.arange(T, dtype=torch.float32, device=dev) + 0.5

    # pass 1: solve v from t on the iso-u line, substitute into s
    den_v = e - tt[None, :] * hh                                  # (1, T)
    v_of_ut = ((tt[None, :] * (g * uu[:, None] + i_)
                - d * uu[:, None] - f) / den_v)                   # (U, T)
    den_s = g * uu[:, None] + hh * v_of_ut + i_
    s_of_ut = (a * uu[:, None] + b * v_of_ut + c) / den_s         # (U, T)
    G = rowwise_resample(img.permute(1, 0, 2), s_of_ut.t().contiguous(),
                         chunk=chunk)                             # (T, U, C)
    G = G.permute(1, 0, 2)                                        # (U, T, C)

    # pass 2: out[u, v] = G[u, :](t(u, v))
    den = g * uu[:, None] + hh * vv[None, :] + i_
    t_of_uv = (d * uu[:, None] + e * vv[None, :] + f) / den       # (U, V)
    return rowwise_resample(G, t_of_uv, chunk=chunk)
