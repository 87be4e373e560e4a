"""Spectral normalization of a generator's weights (``--useSN``).

Counterpart of `spectral_normalize` and `apply_sn_tree` in the JAX
package's `utils/spectral_norm.py`: a stateless power iteration, exactly
5 iterations from ``u = ones(O) / sqrt(O)`` with ``eps = 1e-12`` on the
kernel reshaped (-1, O) in JAX's (HWIO) order.  Five iterations do not
converge, so neither `torch.nn.utils.spectral_norm` (a random persistent
``u``, one step per forward) nor the exact largest singular value gives
the same sigma.  The normalization is a pure function of the weights: the
planar engine applies it once, before composing its kernels.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def spectral_normalize(w: torch.Tensor, iterations: int = 5,
                       eps: float = 1e-12) -> torch.Tensor:
    """Divide a kernel in JAX's layout (..., in, out), e.g. HWIO, by its
    leading singular value from ``iterations`` power-iteration steps."""
    mat = w.reshape(-1, w.shape[-1])
    u = torch.ones((mat.shape[-1],), dtype=w.dtype, device=w.device) \
        / math.sqrt(mat.shape[-1])
    for _ in range(iterations):
        v = mat @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
        u = mat.t() @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    sigma = torch.linalg.vector_norm(mat @ u)
    return w / torch.clamp(sigma, min=eps)


def _jax_order(ndim: int) -> tuple:
    """Permutation of a torch weight (out, in, *spatial) to JAX's
    (*spatial, in, out): OIHW -> HWIO, (out, in) -> (in, out)."""
    return tuple(range(2, ndim)) + (1, 0)


def apply_sn_tree(state: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Spectrally normalize every ``*.weight`` of two or more dimensions
    (conv and linear weights) of a state dict, each in JAX's layout so
    that the sums run in JAX's order; other entries are kept."""
    out = {}
    for name, t in state.items():
        if name.split(".")[-1] == "weight" and t.dim() >= 2:
            perm = _jax_order(t.dim())
            inv = [perm.index(i) for i in range(t.dim())]
            t = spectral_normalize(t.permute(perm)).permute(inv)
        out[name] = t
    return out
