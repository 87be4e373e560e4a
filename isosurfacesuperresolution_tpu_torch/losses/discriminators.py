"""Discriminators for adversarial training, NHWC in and one logit out.

Counterpart of the JAX package's `losses/discriminators.py` (the
reference's `losses/enhancenetlarge.py`, `enhancenetsmall.py` and
`tecogan.py`): strided-conv pyramids from a power-of-two resolution down
to 4x4 (TecoGAN: 4x4 stride-2 convs to 256 channels), then the dense
head.  Layer names are the Flax ones (``conv<i>``, ``pre<i>``, ``c128``,
``c256a``, ``c256b``, ``fc1``, ``fc2``, ``fc``), so
`models.generators.params_from_flax` maps a JAX tree one to one; the head
flattens the NHWC activation as Flax does.

Initialisation as in JAX: conv kernels normal with variance 2 / (k*k*out)
(He fan-out), dense kernels N(0, 0.01), biases zero.  With
``use_spectral_norm`` every conv and dense layer runs on its spectrally
normalized weight in every forward (`utils.spectral_norm.SNConv2d` /
`SNLinear`), with the gradient through the power iteration.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.models.generators import (
    init_like_flax)
from isosurfacesuperresolution_tpu_torch.utils.spectral_norm import (
    SNConv2d, SNLinear)

_CONV_INIT = ("fan_out_normal", 2.0)
_LINEAR_INIT = ("normal", 0.01)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """Flax's ``where(x >= 0, x, slope * x)``: its derivative at 0 is 1
    (`F.leaky_relu`'s is ``slope``), which matters at the zeroed loss
    border, where the first conv's pre-activations are exactly 0."""
    return torch.where(x >= 0, x, slope * x)


class _Discriminator(nn.Module):
    """Shared plumbing: the layer classes and the Flax initialisation."""

    def __init__(self, resolution: int, input_channels: int,
                 use_spectral_norm: bool):
        super().__init__()
        if resolution & (resolution - 1):
            raise ValueError(
                f"resolution is not a power of two: {resolution}")
        self.resolution = resolution
        self.input_channels = input_channels
        self.conv_cls = SNConv2d if use_spectral_norm else nn.Conv2d
        self.linear_cls = SNLinear if use_spectral_norm else nn.Linear

    def _init(self, generator: Optional[torch.Generator]) -> None:
        init_like_flax(self, lambda name: _LINEAR_INIT if name.startswith(
            "fc") else _CONV_INIT, generator)

    def _check(self, x: torch.Tensor) -> None:
        if (x.shape[-1] != self.input_channels
                or x.shape[-3] != self.resolution
                or x.shape[-2] != self.resolution):
            raise ValueError(
                f"discriminator input {tuple(x.shape)}, expected (B, "
                f"{self.resolution}, {self.resolution}, "
                f"{self.input_channels})")


class _PyramidDiscriminator(_Discriminator):
    """Per halving ``strides`` 3x3 convs (channels doubling from 16),
    LeakyReLU 0.01 after each, then fc1 (1024) -> LeakyReLU -> fc2 (1)."""

    strides = ()

    def __init__(self, resolution: int, input_channels: int,
                 use_spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(resolution, input_channels, use_spectral_norm)
        res, c, cin, i = resolution, 8, input_channels, 0
        self._convs = []
        while res > 4:
            c *= 2
            res //= 2
            for stride in self.strides:
                self.add_module(f"conv{i}", self.conv_cls(
                    cin, c, 3, stride=stride, padding=1))
                self._convs.append(f"conv{i}")
                cin = c
                i += 1
        self.fc1 = self.linear_cls(res * res * cin, 1024)
        self.fc2 = self.linear_cls(1024, 1)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        y = x.permute(0, 3, 1, 2)
        for name in self._convs:
            y = leaky_relu(getattr(self, name)(y), 0.01)
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
        return self.fc2(leaky_relu(self.fc1(y), 0.01))


class EnhanceNetLargeDiscriminator(_PyramidDiscriminator):
    """Per halving two stride-1 convs and one stride-2 conv."""

    strides = (1, 1, 2)


class EnhanceNetSmallDiscriminator(_PyramidDiscriminator):
    """Per halving one stride-1 conv and one stride-2 conv."""

    strides = (1, 2)


class TecoGANDiscriminator(_Discriminator):
    """4x4 stride-2 convs without bias (64 channels while the resolution
    exceeds 32, then 128, 256, 256), LeakyReLU 0.2, then one dense
    logit."""

    def __init__(self, resolution: int, input_channels: int,
                 use_spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(resolution, input_channels, use_spectral_norm)
        res, cin = resolution, input_channels
        self._convs = []
        while res > 32:
            res //= 2
            name = f"pre{len(self._convs)}"
            self.add_module(name, self.conv_cls(cin, 64, 4, stride=2,
                                                padding=1, bias=False))
            self._convs.append(name)
            cin = 64
        for c, name in ((128, "c128"), (256, "c256a"), (256, "c256b")):
            self.add_module(name, self.conv_cls(cin, c, 4, stride=2,
                                                padding=1, bias=False))
            self._convs.append(name)
            cin, res = c, res // 2
        self.fc = self.linear_cls(res * res * cin, 1)
        self._init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        y = x.permute(0, 3, 1, 2)
        for name in self._convs:
            y = leaky_relu(getattr(self, name)(y), 0.2)
        return self.fc(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1))


def build_discriminator(model: str, resolution: int, input_channels: int,
                        use_spectral_norm: bool = False,
                        generator: Optional[torch.Generator] = None
                        ) -> nn.Module:
    """Name -> discriminator."""
    key = model.lower()
    classes = {"enhancenetsmall": EnhanceNetSmallDiscriminator,
               "enhancenetlarge": EnhanceNetLargeDiscriminator,
               "tecogan": TecoGANDiscriminator}
    if key not in classes:
        raise ValueError(f"Unsupported discriminator model: {model}")
    return classes[key](resolution, input_channels, use_spectral_norm,
                        generator)
