"""Flow inpainting by iterative diffusion.

Counterpart of the JAX package's `ops/inpaint.py`: each pass gives every
still-empty pixel the average of its valid 3x3 neighbours, growing the
filled band by one pixel per pass.  NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over 3x3 neighbourhoods (zero padded) of (B, H, W, C)."""
    y = F.pad(x, (0, 0, 1, 1, 1, 1))
    return (y[:, :-2, 1:-1] + y[:, 1:-1, 1:-1] + y[:, 2:, 1:-1]
            + y[:, :-2, :-2] + y[:, 1:-1, :-2] + y[:, 2:, :-2]
            + y[:, :-2, 2:] + y[:, 1:-1, 2:] + y[:, 2:, 2:])


def inpaint_flow(flow: torch.Tensor, mask: torch.Tensor,
                 iterations: int = 8) -> torch.Tensor:
    """Fill flow (B, H, W, 2) outside ``mask`` (B, H, W, 1; > 0.5 is
    valid) with a band of ``iterations`` pixels; farther pixels stay 0."""
    valid = (mask > 0.5).to(flow.dtype)
    filled = flow * valid
    for _ in range(iterations):
        s = _box_sum(filled)
        c = _box_sum(valid)
        avg = s / torch.clamp(c, min=1.0)
        newly = (valid < 0.5) & (c > 0.5)
        filled = torch.where(newly, avg, filled)
        valid = torch.where(newly, 1.0, valid)
    return filled
