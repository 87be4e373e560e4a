"""Generator zoo as PyTorch modules: EnhanceNet, RCAN, TecoGAN, SubpixelNet.

Counterpart of the JAX package's `models/generators.py`.  Every generator
maps a low-res input (B, H, W, Cin) to ``(output (B, rH, rW, Cout),
residual)``, both float32, where Cin includes the flattened warped
previous frame (`network_input_channels`).  Layer names are the Flax
ones (``pre``, ``block{i}_conv1``, ``block{i}_bn1``, ``up{j}``,
``post{j}``, ``out``, ``g{g}_b{b}_down`` ...), so `params_from_flax` maps
a checkpoint one to one.  Inputs and outputs are NHWC; the convs run
NCHW in ``cfg.compute_dtype``.

EnhanceNet's options: ``use_bn`` (inference from the running statistics,
as Flax's ``BatchNorm(use_running_average=True)``, epsilon 1e-5 as in
Flax and in `nn.BatchNorm2d`), ``upsample`` nearest, bilinear, bicubic
or pixelShuffle, and ``fused_upsample`` (nearest and bilinear only, as
in JAX): each ``upsample x2 -> post{j}`` pair runs as one low-res conv
with the composed kernel on the edge-padded input, then a pixel shuffle;
it equals the unfused pair in the interior and differs on the high-res
conv's 1-px border.  ``use_sn``: `create_network` wraps the module in
`utils.spectral_norm.SpectralNormalizedModule`.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import ModelConfig
from isosurfacesuperresolution_tpu_torch.ops.fused_upsample import (
    compose_up2x_conv3x3, up2x_conv_bias)
from isosurfacesuperresolution_tpu_torch.ops.resize import (
    interpolate_nchw, resize)

# Flax's BatchNorm epsilon, which is also nn.BatchNorm2d's
BN_EPS = 1e-5


def network_input_channels(cfg: ModelConfig, temporal: bool = True) -> int:
    """Low-res channels, plus (temporal) the flattened warped previous
    high-res frame."""
    if not temporal:
        return cfg.input_channels
    return cfg.input_channels + cfg.output_channels * cfg.upscale_factor ** 2


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # contiguous NCHW: cuDNN's float32 convs are NCHW kernels, and a
    # permuted NHWC view costs a layout conversion around every conv
    return x.permute(0, 3, 1, 2).contiguous().to(dtype)


def _recon_image(inputs: torch.Tensor, outputs: torch.Tensor,
                 cfg: ModelConfig, upsample: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual reconstruction: the first ``len(channel_mask)`` input
    channels upsampled and added to the leading output channels; the
    extra output channels pass through.  NHWC float32."""
    if cfg.recon_type != "residual":
        return outputs, outputs
    n = len(cfg.channel_mask)
    if n > cfg.output_channels:
        raise ValueError("number of output channels must be at least "
                         "the number of masked input channels")
    method = upsample if upsample != "pixelShuffle" else "bilinear"
    up = resize(inputs[..., :n].to(torch.float32),
                size=(outputs.shape[1], outputs.shape[2]), method=method)
    recon = torch.cat([up + outputs[..., :n], outputs[..., n:]], -1)
    return recon, outputs


class _BatchNorm(nn.Module):
    """Inference batch norm with Flax's four arrays: ``weight`` (scale),
    ``bias``, ``running_mean`` and ``running_var``; computed in float32
    and cast back, as Flax promotes."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.to(torch.float32), self.running_mean,
                            self.running_var, self.weight, self.bias,
                            False, 0.0, BN_EPS).to(x.dtype)


class _Generator(nn.Module):
    """Shared plumbing: the config, the compute type and the convs."""

    def __init__(self, cfg: ModelConfig, in_channels: Optional[int]):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.in_channels = (network_input_channels(cfg)
                            if in_channels is None else in_channels)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.conv2d(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype), padding=layer.padding)

    def _linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class EnhanceNet(_Generator):
    """``forward(inputs (B, H, W, Cin)) -> (recon, outputs)``, both
    (B, uH, uW, Cout) float32: 3x3 conv -> ReLU, residual blocks
    (conv-[BN]-ReLU-conv-[BN] with additive skips), per factor of two an
    upsample x2 + conv + ReLU, one more conv + ReLU, the output conv, then
    the residual reconstruction against the upsampled masked input."""

    def __init__(self, cfg: ModelConfig, in_channels: Optional[int] = None):
        super().__init__(cfg, in_channels)
        stages = int(math.log2(cfg.upscale_factor))
        if 2 ** stages != cfg.upscale_factor:
            raise ValueError("upscale factor must be a power of 2")
        if cfg.upsample not in ("nearest", "bilinear", "bicubic",
                                "pixelShuffle"):
            raise ValueError(f"unknown upsample {cfg.upsample!r}")
        self.stages = stages
        # bicubic's 4-tap stencil exceeds the composed 3x3 support
        self.fuse = cfg.fused_upsample and cfg.upsample in ("nearest",
                                                            "bilinear")
        self._fused: dict = {}          # post{j} -> (key, kernel, bias)
        f = cfg.num_features
        self.pre = _conv3(self.in_channels, f)
        for i in range(cfg.num_residual_blocks):
            self.add_module(f"block{i}_conv1", _conv3(f, f))
            self.add_module(f"block{i}_conv2", _conv3(f, f))
            if cfg.use_bn:
                self.add_module(f"block{i}_bn1", _BatchNorm(f))
                self.add_module(f"block{i}_bn2", _BatchNorm(f))
        for j in range(stages):
            if cfg.upsample == "pixelShuffle" and not self.fuse:
                self.add_module(f"up{j + 1}", _conv3(f, 4 * f))
            self.add_module(f"post{j + 1}", _conv3(f, f))
        self.add_module(f"post{stages + 1}", _conv3(f, f))
        self.out = _conv3(f, cfg.output_channels)

    def _composed(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fused stage's low-res OIHW kernel and bias in the compute
        type, composed at the first forward and again only when the
        layer's weights change (another tensor, or written in place)."""
        w, b = getattr(self, name).weight, getattr(self, name).bias
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version,
               w.device)
        hit = self._fused.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                kc = compose_up2x_conv3x3(w.permute(2, 3, 1, 0),
                                          self.cfg.upsample)
                hit = self._fused[name] = (
                    key, kc.permute(3, 2, 0, 1).to(self.dtype).contiguous(),
                    up2x_conv_bias(b).to(self.dtype))
        return hit[1], hit[2]

    def _upsample_conv(self, j: int, y: torch.Tensor) -> torch.Tensor:
        """Stage ``j``: upsample x2, conv post{j+1}, ReLU."""
        name = f"post{j + 1}"
        if self.fuse:
            kc, bc = self._composed(name)
            y = F.conv2d(F.pad(y, (1, 1, 1, 1), mode="replicate"), kc, bc)
            return F.relu(F.pixel_shuffle(y, 2))
        if self.cfg.upsample == "pixelShuffle":
            y = F.pixel_shuffle(self._conv(f"up{j + 1}", y), 2)
        else:
            y = interpolate_nchw(y, (2 * y.shape[-2], 2 * y.shape[-1]),
                                 self.cfg.upsample)
        return F.relu(self._conv(name, y))

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = _nchw(inputs, self.dtype)
        feat = F.relu(self._conv("pre", x))
        for i in range(cfg.num_residual_blocks):
            y = self._conv(f"block{i}_conv1", feat)
            if cfg.use_bn:
                y = getattr(self, f"block{i}_bn1")(y)
            y = self._conv(f"block{i}_conv2", F.relu(y))
            if cfg.use_bn:
                y = getattr(self, f"block{i}_bn2")(y)
            feat = feat + y
        y = feat
        for j in range(self.stages):
            y = self._upsample_conv(j, y)
        y = F.relu(self._conv(f"post{self.stages + 1}", y))
        outputs = self._conv("out", y).to(torch.float32).permute(0, 2, 3, 1)
        return _recon_image(inputs, outputs, cfg, cfg.upsample)


class RCAN(_Generator):
    """Residual channel attention network: ``num_groups`` residual groups
    of ``num_blocks`` RCABs (conv, LeakyReLU 0.01, conv, channel attention
    by mean -> Dense -> LeakyReLU -> Dense -> sigmoid), a pre-shuffle
    expansion conv, PixelShuffle, the output conv; the output is clamped
    to [0, 1] and the residual is the unclamped output minus the bilinear
    upsampled masked input (extra channels pass through)."""

    def __init__(self, cfg: ModelConfig, num_groups: int = 10,
                 num_blocks: int = 20, reduction: int = 16,
                 in_channels: Optional[int] = None):
        super().__init__(cfg, in_channels)
        self.num_groups, self.num_blocks = num_groups, num_blocks
        c, r = cfg.num_features, cfg.upscale_factor
        self.pre = _conv3(self.in_channels, c)
        for g in range(num_groups):
            for b in range(num_blocks):
                name = f"g{g}_b{b}"
                self.add_module(f"{name}_conv1", _conv3(c, c))
                self.add_module(f"{name}_conv2", _conv3(c, c))
                self.add_module(f"{name}_down", nn.Linear(c, c // reduction))
                self.add_module(f"{name}_up", nn.Linear(c // reduction, c))
            self.add_module(f"g{g}_post", _conv3(c, c))
        self.rir_post = _conv3(c, c)
        self.up = _conv3(c, c * r * r)
        self.post = _conv3(c, cfg.output_channels)

    def _rcab(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = F.leaky_relu(self._conv(f"{name}_conv1", x))
        y = self._conv(f"{name}_conv2", y)
        s = F.leaky_relu(self._linear(f"{name}_down", y.mean((2, 3))))
        s = torch.sigmoid(self._linear(f"{name}_up", s))[:, :, None, None]
        return x + y * s

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        feat = self._conv("pre", _nchw(inputs, self.dtype))
        rir_in = feat
        for g in range(self.num_groups):
            group_in = feat
            for b in range(self.num_blocks):
                feat = self._rcab(feat, f"g{g}_b{b}")
            feat = self._conv(f"g{g}_post", feat) + group_in
        feat = self._conv("rir_post", feat) + rir_in
        y = F.pixel_shuffle(self._conv("up", feat), cfg.upscale_factor)
        outputs = self._conv("post", y).to(torch.float32).permute(0, 2, 3, 1)
        cm = len(cfg.channel_mask)
        resized = resize(inputs[..., :cm].to(torch.float32),
                         size=(outputs.shape[1], outputs.shape[2]),
                         method="bilinear")
        residual = torch.cat([outputs[..., :cm] - resized,
                              outputs[..., cm:]], -1)
        return torch.clamp(outputs, 0.0, 1.0), residual


class TecoGAN(_Generator):
    """EnhanceNet's body with LeakyReLU activations and two learned x2
    stages.  Each stage is Flax's ``ConvTranspose(3x3, stride 2, padding
    ((1, 2), (1, 2)))``, which correlates with its kernel; here it is
    ``nn.ConvTranspose2d(3, stride=2, padding=1, output_padding=1)``, the
    conv adjoint, whose weight is the Flax kernel flipped in both spatial
    axes (the reference's own layer and layout)."""

    def __init__(self, cfg: ModelConfig, in_channels: Optional[int] = None):
        super().__init__(cfg, in_channels)
        c = cfg.num_features
        self.pre = _conv3(self.in_channels, c)
        for i in range(cfg.num_residual_blocks):
            self.add_module(f"block{i}_conv1", _conv3(c, c))
            self.add_module(f"block{i}_conv2", _conv3(c, c))
        self.up1 = nn.ConvTranspose2d(c, c, 3, stride=2, padding=1,
                                      output_padding=1)
        self.up2 = nn.ConvTranspose2d(c, c, 3, stride=2, padding=1,
                                      output_padding=1)
        self.out = _conv3(c, cfg.output_channels)

    def _conv_t(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.conv_transpose2d(x, layer.weight.to(self.dtype),
                                  layer.bias.to(self.dtype), stride=2,
                                  padding=1, output_padding=1)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        feat = F.leaky_relu(self._conv("pre", _nchw(inputs, self.dtype)))
        for i in range(cfg.num_residual_blocks):
            y = F.leaky_relu(self._conv(f"block{i}_conv1", feat))
            feat = feat + self._conv(f"block{i}_conv2", y)
        y = F.leaky_relu(self._conv_t("up1", feat))
        y = F.leaky_relu(self._conv_t("up2", y))
        outputs = F.leaky_relu(self._conv("out", y)).to(
            torch.float32).permute(0, 2, 3, 1)
        return _recon_image(inputs, outputs, cfg, "bilinear")


class SubpixelNet(_Generator):
    """ESPCN-style net: two 5x5 and three 3x3 convs (64, 64, 64, 32,
    Cout*r*r features), ReLU between, then PixelShuffle.  Returns
    ``(output, None)``."""

    def __init__(self, cfg: ModelConfig, in_channels: Optional[int] = None):
        super().__init__(cfg, in_channels)
        r = cfg.upscale_factor
        self.conv1 = nn.Conv2d(self.in_channels, 64, 5, padding=2)
        self.conv2 = nn.Conv2d(64, 64, 5, padding=2)
        self.conv3 = _conv3(64, 64)
        self.conv4 = _conv3(64, 32)
        self.conv5 = _conv3(32, cfg.output_channels * r * r)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, None]:
        x = _nchw(inputs, self.dtype)
        for i in range(1, 5):
            x = F.relu(self._conv(f"conv{i}", x))
        x = F.pixel_shuffle(self._conv("conv5", x), self.cfg.upscale_factor)
        return x.to(torch.float32).permute(0, 2, 3, 1), None


_MODELS = {
    "enhancenet": EnhanceNet,
    "rcan": RCAN,
    "tecogan": TecoGAN,
    "subpixelnet": SubpixelNet,
}


def create_network(cfg: ModelConfig, in_channels: Optional[int] = None
                   ) -> nn.Module:
    """Name -> generator module (RCAN with its defaults: 10 groups of 20
    blocks, reduction 16).  ``in_channels`` defaults to the temporal
    `network_input_channels`.  With ``cfg.use_sn`` the module is wrapped
    so its forward runs on spectrally normalized weights; the state dict
    is unchanged."""
    key = cfg.model.lower()
    if key not in _MODELS:
        raise ValueError(f"Unknown model {cfg.model}")
    module = _MODELS[key](cfg, in_channels=in_channels)
    if cfg.use_sn:
        from isosurfacesuperresolution_tpu_torch.utils.spectral_norm import (
            SpectralNormalizedModule)
        return SpectralNormalizedModule(module)
    return module


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def params_from_flax(tree_or_npz: Union[str, Mapping],
                     cfg: Optional[ModelConfig] = None) -> dict:
    """Flax variables of a generator -> its module's ``state_dict``.

    Accepts a ``params.npz`` path, its loaded mapping of flat keys, or the
    nested variables dict.  ``params/<layer>/kernel`` goes from HWIO to
    OIHW (a Dense kernel (in, out) to a Linear weight (out, in); TecoGAN's
    ``up1``/``up2``, with ``cfg`` naming the model, flipped in both
    spatial axes to (in, out, kh, kw)), ``bias`` stays, a BatchNorm's
    ``scale`` becomes its ``weight``, and ``batch_stats/<layer>/{mean,
    var}`` its ``running_mean``/``running_var``.  The pixel-shuffle
    stage's ``up{j}/Conv_0`` is the port's ``up{j}``."""
    if isinstance(tree_or_npz, str):
        with np.load(tree_or_npz) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = _flatten(tree_or_npz)
    transposed = (("up1", "up2") if cfg is not None
                  and cfg.model.lower() == "tecogan" else ())
    names = {("params", "kernel"): "weight", ("params", "bias"): "bias",
             ("params", "scale"): "weight",
             ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}
    state = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if len(parts) == 4 and parts[2] == "Conv_0":
            del parts[2]        # `_Upsample2x`'s conv: up{j}/Conv_0
        if len(parts) != 3 or (parts[0], parts[2]) not in names:
            raise ValueError(f"unexpected parameter key {key!r}")
        coll, layer, leaf = parts
        a = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel" and a.dim() == 4:
            a = (a.flip(0, 1).permute(2, 3, 0, 1) if layer in transposed
                 else a.permute(3, 2, 0, 1))
        elif leaf == "kernel" and a.dim() == 2:
            a = a.t()
        state[f"{layer}.{names[coll, leaf]}"] = a.contiguous()
    return state
