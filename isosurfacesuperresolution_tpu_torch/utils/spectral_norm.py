"""Spectral normalization of a generator's weights (``--useSN``).

Counterpart of `spectral_normalize` and `apply_sn_tree` in the JAX
package's `utils/spectral_norm.py`: a stateless power iteration, exactly
5 iterations from ``u = ones(O) / sqrt(O)`` with ``eps = 1e-12`` on the
kernel reshaped (-1, O) in JAX's (HWIO) order.  Five iterations do not
converge, so neither `torch.nn.utils.spectral_norm` (a random persistent
``u``, one step per forward) nor the exact largest singular value gives
the same sigma.  The normalization is a pure function of the weights: the
planar engine applies it once, before composing its kernels, and
`SpectralNormalizedModule` (what `models.generators.create_network`
returns under ``use_sn``) once per state of its weights, or, where a
gradient is wanted, in every forward with the gradient flowing through
the power iteration (as JAX's does).  `SNConv2d` and `SNLinear` are the
discriminators' layers (JAX's ``SNConv`` / ``SNDense``): the same
stateless normalization in every forward, differentiable, unlike
`torch.nn.utils.spectral_norm`, which keeps a persistent ``u`` and
detaches it.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


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


def normalize_weight(w: torch.Tensor, transposed: bool = False
                     ) -> torch.Tensor:
    """`spectral_normalize` of one torch weight in JAX's layout: a conv's
    (out, in, kh, kw) as HWIO, a linear's (out, in) as (in, out), a
    transposed conv's (in, out, kh, kw) as its Flax kernel (flipped)."""
    if transposed:
        return spectral_normalize(
            w.flip(2, 3).permute(2, 3, 0, 1)).permute(2, 3, 0, 1).flip(2, 3)
    perm = _jax_order(w.dim())
    inv = [perm.index(i) for i in range(w.dim())]
    return spectral_normalize(w.permute(perm)).permute(inv)


def apply_sn_tree(state: Mapping[str, torch.Tensor],
                  transposed: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Spectrally normalize every ``*.weight`` of two or more dimensions
    (conv and linear weights) of a state dict, each in JAX's layout so
    that the sums run in JAX's order; other entries are kept.  The layers
    named in ``transposed`` are transposed convs, whose torch weight
    (in, out, kh, kw) is the Flax kernel flipped in both spatial axes."""
    transposed = set(transposed)
    out = {}
    for name, t in state.items():
        layer, leaf = name.rpartition(".")[::2]
        if leaf == "weight" and t.dim() >= 2:
            t = normalize_weight(t, layer in transposed)
        out[name] = t
    return out


class SpectralNormalizedModule(nn.Module):
    """A generator whose forward runs on its spectrally normalized
    weights, the counterpart of JAX's `SpectralNormalizedModule`.

    The state dict is the inner module's own (raw weights, the same keys),
    so checkpoints load either way.  Without a gradient the normalized
    weights are computed once for each state of the raw weights (again
    after a `load_state_dict`, an optimizer step or a move); with one
    (grad mode on and a weight that requires it) in every forward, from
    the parameters themselves, so that the gradient flows through the
    power iteration.  JAX normalizes per apply: the same function of the
    same weights."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self._transposed = [n for n, m in inner.named_modules()
                            if isinstance(m, nn.ConvTranspose2d)]
        self._key = None
        self._normalized = {}

    def _state(self) -> dict:
        return {**dict(self.inner.named_parameters()),
                **dict(self.inner.named_buffers())}

    def _weights(self) -> dict:
        state = self._state()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in state.values()):
            return apply_sn_tree(state, self._transposed)
        key = tuple((t.data_ptr(), t._version, t.device)
                    for t in state.values())
        if key != self._key:
            with torch.no_grad():
                self._normalized = apply_sn_tree(state, self._transposed)
            self._key = key
        return self._normalized

    def state_dict(self, *args, **kwargs):
        return self.inner.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        out = self.inner.load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self._key = None
        return out

    def forward(self, *args, **kwargs):
        return functional_call(self.inner, self._weights(), args, kwargs)

    def __getattr__(self, name: str):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["inner"], name)


class SNConv2d(nn.Conv2d):
    """A conv whose forward runs on `normalize_weight` of its weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, normalize_weight(self.weight),
                                  self.bias)


class SNLinear(nn.Linear):
    """A linear layer whose forward runs on `normalize_weight` of its
    weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, normalize_weight(self.weight), self.bias)
