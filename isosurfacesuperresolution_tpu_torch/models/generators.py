"""EnhanceNet generator as a PyTorch module.

Counterpart of `EnhanceNet` in the JAX package's `models/generators.py`
(with ``fused_upsample=False``): 3x3 conv -> ReLU, residual blocks
(conv-ReLU-conv with additive skips), per factor of two an upsample x2 +
conv + ReLU, one more conv + ReLU, the output conv, then the residual
reconstruction against the bilinear-upsampled masked input.  Layer names
are the Flax ones (``pre``, ``block{i}_conv1``, ``post{j}``, ``out``), so
`params_from_flax` maps a checkpoint one to one.  Inputs and outputs are
NHWC; the convs run NCHW.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import ModelConfig
from isosurfacesuperresolution_tpu_torch.ops.resize import interpolate_nchw


def network_input_channels(cfg: ModelConfig) -> int:
    """Low-res channels + the flattened warped previous high-res frame."""
    return cfg.input_channels + cfg.output_channels * cfg.upscale_factor ** 2


class EnhanceNet(nn.Module):
    """``forward(inputs (B, H, W, Cin)) -> (recon, outputs)``, both
    (B, uH, uW, Cout) float32.  A ``use_sn`` configuration has the same
    weights (the normalization is a function of them, applied by the
    planar engine's frame); its interleaved forward raises."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.model.lower() != "enhancenet":
            raise NotImplementedError(f"model {cfg.model!r} is not ported")
        if cfg.use_bn or cfg.fused_upsample:
            raise NotImplementedError(
                "use_bn and fused_upsample are not ported")
        if cfg.upsample not in ("nearest", "bilinear"):
            raise NotImplementedError(f"upsample {cfg.upsample!r}")
        stages = int(math.log2(cfg.upscale_factor))
        if 2 ** stages != cfg.upscale_factor:
            raise ValueError("upscale factor must be a power of 2")
        self.cfg = cfg
        self.stages = stages
        self.dtype = getattr(torch, cfg.compute_dtype)
        f = cfg.num_features

        def conv(cin, cout):
            return nn.Conv2d(cin, cout, 3, padding=1)

        self.pre = conv(network_input_channels(cfg), f)
        for i in range(cfg.num_residual_blocks):
            self.add_module(f"block{i}_conv1", conv(f, f))
            self.add_module(f"block{i}_conv2", conv(f, f))
        for j in range(stages + 1):
            self.add_module(f"post{j + 1}", conv(f, f))
        self.out = conv(f, cfg.output_channels)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = getattr(self, name)
        return F.conv2d(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype), padding=1)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.use_sn:
            raise NotImplementedError(
                "use_sn in the interleaved forward is not ported; the "
                "planar engine takes it (ROADMAP.md, queue A)")
        # contiguous NCHW: cuDNN's float32 convs are NCHW kernels, and a
        # permuted NHWC view costs a layout conversion around every conv
        x = inputs.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        feat = F.relu(self._conv("pre", x))
        for i in range(cfg.num_residual_blocks):
            y = F.relu(self._conv(f"block{i}_conv1", feat))
            feat = feat + self._conv(f"block{i}_conv2", y)
        y = feat
        for j in range(self.stages):
            y = interpolate_nchw(y, (2 * y.shape[-2], 2 * y.shape[-1]),
                                 cfg.upsample)
            y = F.relu(self._conv(f"post{j + 1}", y))
        y = F.relu(self._conv(f"post{self.stages + 1}", y))
        outputs = self._conv("out", y).to(torch.float32).permute(0, 2, 3, 1)

        if cfg.recon_type != "residual":
            return outputs, outputs
        n = len(cfg.channel_mask)
        if n > cfg.output_channels:
            raise ValueError("number of output channels must be at least "
                             "the number of masked input channels")
        up = interpolate_nchw(
            inputs[..., :n].to(torch.float32).permute(0, 3, 1, 2),
            (outputs.shape[1], outputs.shape[2]), cfg.upsample
        ).permute(0, 2, 3, 1)
        recon = torch.cat([up + outputs[..., :n], outputs[..., n:]], -1)
        return recon, outputs


def params_from_flax(tree_or_npz: Union[str, Mapping]) -> dict:
    """Flax EnhanceNet parameters -> this module's ``state_dict``.

    Accepts a ``params.npz`` path, its loaded mapping of flat keys
    (``params/<layer>/kernel`` HWIO, ``params/<layer>/bias``), or the
    nested variables dict (``{"params": {layer: {"kernel", "bias"}}}``).
    Kernels go from HWIO to OIHW."""
    if isinstance(tree_or_npz, str):
        with np.load(tree_or_npz) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(v, Mapping):
                    walk(v, key)
                else:
                    flat[key] = v
        walk(tree_or_npz, "")
    state = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if len(parts) != 3 or parts[0] != "params":
            raise ValueError(f"unexpected parameter key {key!r}")
        _, layer, leaf = parts
        a = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            state[f"{layer}.weight"] = a.permute(3, 2, 0, 1).contiguous()
        elif leaf == "bias":
            state[f"{layer}.bias"] = a
        else:
            raise ValueError(f"unexpected parameter key {key!r}")
    return state
