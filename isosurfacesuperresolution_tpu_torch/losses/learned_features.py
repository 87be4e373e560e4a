"""Learned texture features: a small trained stand-in for VGG.

Counterpart of the JAX package's `losses/learned_features.py`.  Without
pretrained VGG-19 weights the perceptual and texture losses run on
fixed-seed random features (`losses/vgg.py`); this encoder is trained
self-supervised on the repo's own shaded crops (`apps/train_texenc.py`):
with a decoder it restores clean renders from an SR-shaped degradation
(4x linear down and up, plus noise), so its features respond to the
high-frequency texture a super-resolution net must re-synthesize.  The
trained encoder is committed as `artifacts/texenc/texenc.npz`, in the
JAX package's layout (Flax HWIO kernels keyed ``['conv_1']['kernel']``
...): both packages load the same file.

Usage:
  encoder = TexEncoder()
  encoder.load_state_dict(load_texenc_params(path))  # None: not trained
  feats = encoder(shaded_rgb)        # {"conv_1": (B, H, W, 32), ...}
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "artifacts", "texenc", "texenc.npz")


class TexEncoder(nn.Module):
    """Four 3x3 convs with ReLU, strides (1, 2, 1, 2); NHWC in, the named
    feature maps (after each ReLU, NHWC) out."""

    def __init__(self, features: Tuple[int, ...] = (32, 64, 96, 128),
                 in_channels: int = 3):
        super().__init__()
        self.names = []
        cin = in_channels
        for i, f in enumerate(features):
            name = f"conv_{i + 1}"
            stride = 2 if i % 2 else 1
            setattr(self, name, nn.Conv2d(cin, f, 3, stride, padding=1))
            self.names.append(name)
            cin = f

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = x.permute(0, 3, 1, 2)
        feats = {}
        for name in self.names:
            y = F.relu(getattr(self, name)(y))
            feats[name] = y.permute(0, 2, 3, 1)
        return feats


class TexDecoder(nn.Module):
    """The mirror decoder of the restoration objective (training only):
    a 2x nearest upsample before the first and third conv, ReLUs, and a
    3-channel output conv; NHWC in and out."""

    def __init__(self, features: Tuple[int, ...] = (96, 64, 32),
                 in_channels: int = 128):
        super().__init__()
        self.names = []
        cin = in_channels
        for i, f in enumerate(features):
            name = f"dconv_{i + 1}"
            setattr(self, name, nn.Conv2d(cin, f, 3, padding=1))
            self.names.append(name)
            cin = f
        self.out = nn.Conv2d(cin, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        for i, name in enumerate(self.names):
            if i % 2 == 0:                      # undo the two stride-2s
                y = y.repeat_interleave(2, 2).repeat_interleave(2, 3)
            y = F.relu(getattr(self, name)(y))
        return self.out(y).permute(0, 2, 3, 1)


def degrade(rgb: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    """SR-shaped corruption of (B, H, W, C): 4x linear down (antialiased,
    as `jax.image.resize` shrinks) and up, plus 0.02 x the standard
    normal draw of JAX key ``key`` (`utils/jax_prng.normal`)."""
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng
    b, h, w, c = rgb.shape
    down = resize(rgb, size=(h // 4, w // 4), method="linear")
    up = resize(down, size=(h, w), method="linear")
    noise = torch.from_numpy(jax_prng.normal(key, tuple(rgb.shape)))
    return up + 0.02 * noise.to(rgb.device, rgb.dtype)


def _key(name: str, leaf: str) -> str:
    """The JAX package's npz key (`jax.tree_util.keystr`)."""
    return f"['{name}']['{leaf}']"


def save_texenc_params(state: Dict[str, torch.Tensor],
                       path: str = DEFAULT_PATH) -> None:
    """Write a `TexEncoder` state dict in the JAX package's npz layout
    (HWIO kernels)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    out = {}
    for k, v in state.items():
        name, leaf = k.rsplit(".", 1)
        v = v.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            out[_key(name, "kernel")] = v.transpose(2, 3, 1, 0)
        else:
            out[_key(name, "bias")] = v
    np.savez(path, **out)


def load_texenc_params(path: str = DEFAULT_PATH
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """The committed encoder's `TexEncoder` state dict, or None when the
    file is not there (the callers then say so)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        state = {}
        for name in TexEncoder().names:
            k = np.asarray(z[_key(name, "kernel")], np.float32)
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            state[f"{name}.bias"] = torch.from_numpy(
                np.asarray(z[_key(name, "bias")], np.float32))
    return state
