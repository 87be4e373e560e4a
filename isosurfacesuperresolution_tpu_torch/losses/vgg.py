"""VGG-19 feature extractor for the perceptual and texture losses.

Counterpart of the JAX package's `losses/vgg.py` (the reference's trimmed
torchvision VGG-19 with hooks after named convs): ImageNet normalization,
then the convs of torchvision's ``vgg19().features`` up to ``max_conv``,
each pre-ReLU activation returned as ``conv_<i>`` (NHWC), 2x2 max pools
between the blocks.

Weights come from the same files as in JAX: ``$ISOSR_VGG19_WEIGHTS``,
``~/.cache/isosr/vgg19.npz`` (HWIO kernels ``conv_<i>_kernel``, biases
``conv_<i>_bias``) or ``~/.cache/isosr/vgg19.pth`` (a torchvision
state dict).  Without one the extractor warns, as JAX does, and draws
Flax's default initialisation (lecun-normal kernels, zero biases) from a
fixed-seed `torch.Generator`: random features that still make a usable
perceptual metric, not the paper's pretrained numbers.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isosurfacesuperresolution_tpu_torch.models.generators import (
    LECUN, init_like_flax)

# torchvision vgg19.features layout: conv widths, "M" = max pool
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """``forward(x (B, H, W, 3)) -> {conv_i: pre-ReLU activation (B, h, w,
    C)}`` for i up to ``max_conv``; the layers past it are not built."""

    def __init__(self, max_conv: int = 16):
        super().__init__()
        self.max_conv = max_conv
        # buffers, not tensors made per call: a host-to-card copy waits
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        cin, i = 3, 0
        for v in VGG19_CFG:
            if v == "M":
                continue
            i += 1
            if i > max_conv:
                break
            self.add_module(f"conv_{i}", nn.Conv2d(cin, v, 3, padding=1))
            cin = v

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = ((x - self.mean.to(x.dtype)) / self.std.to(x.dtype)).permute(
            0, 3, 1, 2)
        feats: Dict[str, torch.Tensor] = {}
        i = 0
        for v in VGG19_CFG:
            if v == "M":
                y = F.max_pool2d(y, 2)
                continue
            i += 1
            if i > self.max_conv:
                break
            y = getattr(self, f"conv_{i}")(y)
            feats[f"conv_{i}"] = y.permute(0, 2, 3, 1)
            y = F.relu(y)
        return feats


def default_weight_paths() -> List[str]:
    paths = []
    env = os.environ.get("ISOSR_VGG19_WEIGHTS")
    if env:
        paths.append(env)
    paths.append(os.path.expanduser("~/.cache/isosr/vgg19.npz"))
    paths.append(os.path.expanduser("~/.cache/isosr/vgg19.pth"))
    return paths


def _torchvision_to_state(state: dict, max_conv: int) -> dict:
    """torchvision ``vgg19().features`` state dict -> this module's."""
    conv_keys = sorted(
        {int(k.split(".")[1]) for k in state
         if k.startswith("features.") and k.endswith(".weight")})
    out = {}
    for i, layer in enumerate(conv_keys[:max_conv], start=1):
        out[f"conv_{i}.weight"] = torch.as_tensor(
            np.asarray(state[f"features.{layer}.weight"]), dtype=torch.float32)
        out[f"conv_{i}.bias"] = torch.as_tensor(
            np.asarray(state[f"features.{layer}.bias"]), dtype=torch.float32)
    return out


def load_vgg19_params(max_conv: int = 16,
                      generator: Optional[torch.Generator] = None,
                      paths: Optional[Sequence[str]] = None
                      ) -> Tuple[dict, bool]:
    """(state dict of `VGG19Features(max_conv)`, pretrained): the first
    weight file found, else Flax's default initialisation drawn from
    ``generator`` (None: a generator seeded 0), with a warning."""
    for path in (paths if paths is not None else default_weight_paths()):
        if not os.path.exists(path):
            continue
        if path.endswith(".npz"):
            with np.load(path) as data:
                state = {}
                for i in range(1, max_conv + 1):
                    k = torch.from_numpy(np.asarray(
                        data[f"conv_{i}_kernel"], np.float32))
                    state[f"conv_{i}.weight"] = k.permute(3, 2, 0, 1)
                    state[f"conv_{i}.bias"] = torch.from_numpy(np.asarray(
                        data[f"conv_{i}_bias"], np.float32))
            return state, True
        if path.endswith((".pth", ".pt")):
            state = torch.load(path, map_location="cpu", weights_only=True)
            if hasattr(state, "state_dict"):
                state = state.state_dict()
            return _torchvision_to_state(
                {k: v.numpy() for k, v in state.items()}, max_conv), True

    warnings.warn(
        "No pretrained VGG-19 weights found (checked ISOSR_VGG19_WEIGHTS and "
        "~/.cache/isosr/). Falling back to fixed-seed random features: "
        "perceptual/texture losses remain usable but do not match the "
        "paper's pretrained-VGG numbers.", stacklevel=2)
    module = VGG19Features(max_conv=max_conv)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_like_flax(module, lambda name: LECUN, generator)
    return module.state_dict(), False


def max_conv_needed(layer_weights: Sequence[Tuple[str, float]]) -> int:
    """Deepest conv index needed for the given (name, weight) layer list."""
    mx = 0
    for name, _ in layer_weights:
        if name.startswith("conv_"):
            mx = max(mx, int(name.split("_")[1]))
        else:
            raise ValueError(f"unsupported VGG layer name {name!r}; "
                             "expected conv_<i>")
    return mx
