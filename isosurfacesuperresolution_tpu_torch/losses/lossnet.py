"""The loss stack of the shaded networks (RGB out).

Counterpart of the JAX package's `losses/lossnet.py` (the criterion of
the reference's `mainVideo.py`).  The loss DSL is ``<loss>:<weight>`` per
entry, no per-channel targets: mse / l1 / fft_mse / gdl / perceptual /
texture on the RGB output, one adversarial term (adv / gan / wgan /
wgan-gp, and their temporal forms tadv / tgan / twgan / twgan-gp, whose
discriminator also sees the warped previous output), and temp-l2, gated
on the mask channel (index 3) of prediction-with-mask stacks.  Two of
JAX's rules are kept as they are: ``inverse_mse`` is accepted into the
weights but never computed, and every name that starts with ``t`` (tadv,
tgan, twgan, twgan-gp) sets ``use_previous_image``.

The module owns its one discriminator (``discriminators["adv"]``) and the
frozen VGG (``vgg``), as `LossNetUnshaded` does, so the trainers'
`create_train_state` serves both stacks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import (
    LossConfig, parse_layer_weights)
from isosurfacesuperresolution_tpu_torch.losses import builder
from isosurfacesuperresolution_tpu_torch.losses.discriminators import (
    build_discriminator)
from isosurfacesuperresolution_tpu_torch.losses.vgg import (
    VGG19Features, load_vgg19_params, max_conv_needed)
from isosurfacesuperresolution_tpu_torch.ops.resize import resize

GAN_KINDS = {"adv": "bce", "gan": "bce", "tadv": "bce", "tgan": "bce",
             "wgan": "wgan", "twgan": "wgan", "wgan-gp": "wgan-gp",
             "twgan-gp": "wgan-gp"}


def parse_shaded_loss_list(spec: str) -> Dict[str, float]:
    """``"l1:1,adv:0.5"`` -> {name: weight}; a name without a weight
    weighs 1."""
    out: Dict[str, float] = {}
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        out[parts[0]] = float(parts[1]) if len(parts) > 1 else 1.0
    return out


class LossNet(nn.Module):
    """Loss stack for shaded networks.  ``init(generator)`` draws the
    discriminator's parameters and loads (or draws) the VGG's."""

    def __init__(self, cfg: LossConfig, high_res: int, input_channels: int,
                 output_channels: int, losses: Optional[str] = None,
                 upsample: str = "bilinear"):
        super().__init__()
        self.cfg = cfg
        self.padding = cfg.padding
        self.upsample = upsample
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.high_res = high_res

        raw = parse_shaded_loss_list(losses if losses is not None
                                     else cfg.losses)
        self.weights: Dict[str, float] = {}
        self.gan_kind: Optional[str] = None
        self.use_previous_image = False
        for name, w in raw.items():
            if name in ("l2", "l2_loss", "mse"):
                self.weights["mse"] = w
            elif name in ("l1", "l1_loss"):
                self.weights["l1"] = w
            elif name in ("tl2", "temp-l2"):
                self.weights["temp-l2"] = w
            elif name in ("inverse_mse", "fft_mse", "perceptual", "texture",
                          "gdl"):
                self.weights[name] = w
            elif name in GAN_KINDS:
                self.weights["adv"] = w
                self.gan_kind = GAN_KINDS[name]
                self.use_previous_image = name.startswith("t")
            else:
                raise ValueError(f"unknown loss {name}")
        self.weights.setdefault("mse", 0.0)

        self.discriminators = nn.ModuleDict()
        self.discr_channels = 0
        if self.gan_kind is not None:
            extra = ((output_channels + 1) * 2 if self.use_previous_image
                     else output_channels + 1)
            self.discr_channels = input_channels + extra
            self.discriminators["adv"] = build_discriminator(
                cfg.discriminator, high_res, self.discr_channels)
        self.has_discriminator = self.gan_kind is not None

        self.content_layers = (parse_layer_weights(cfg.perceptual_loss_layers)
                               if "perceptual" in self.weights else [])
        self.style_layers = (parse_layer_weights(cfg.texture_loss_layers)
                             if "texture" in self.weights else [])
        self.vgg: Optional[VGG19Features] = None
        self.vgg_pretrained = False
        if self.content_layers or self.style_layers:
            self.vgg = VGG19Features(max_conv=max_conv_needed(
                self.content_layers + self.style_layers))
            self.vgg.requires_grad_(False)

    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw fresh discriminator parameters from ``generator`` and load
        (or draw) the VGG's."""
        if self.has_discriminator:
            device = next(self.discriminators["adv"].parameters()).device
            self.discriminators["adv"] = build_discriminator(
                self.cfg.discriminator, self.high_res, self.discr_channels,
                generator=generator).to(device)
        if self.vgg is not None:
            state, self.vgg_pretrained = load_vgg19_params(
                self.vgg.max_conv, generator)
            with torch.no_grad():
                for k, v in self.vgg.state_dict().items():
                    v.copy_(state[k])

    def _pad(self, img: torch.Tensor) -> torch.Tensor:
        return builder.pad_border_zero(img, self.padding)

    def _input_high(self, input_low: torch.Tensor, hh: int, ww: int
                    ) -> torch.Tensor:
        return resize(input_low, size=(hh, ww), method=self.upsample)

    def forward(self, gt: torch.Tensor, pred: torch.Tensor,
                input_low: Optional[torch.Tensor],
                prev_pred_warped: Optional[torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generator loss -> (total, {name: value}).

        gt / pred : (B, H, W, Cout) high-res shaded frames.
        input_low : (B, h, w, Cin) low-res input (mask at channel 3).
        prev_pred_warped : (B, H, W, Cout + 1) warped previous output and
            the interpolated mask."""
        w = self.weights
        gt = self._pad(gt)
        pred = self._pad(pred)
        if prev_pred_warped is not None:
            prev_pred_warped = self._pad(prev_pred_warped)

        total = torch.zeros((), dtype=pred.dtype, device=pred.device)
        values: Dict[str, torch.Tensor] = {}
        simple = {"mse": builder.mse, "l1": builder.l1,
                  "fft_mse": builder.fft_mse,
                  "gdl": builder.gradient_difference}
        for name, fn in simple.items():
            if name in w:
                loss = fn(gt, pred)
                values[name] = loss
                total = total + w[name] * loss

        if self.vgg is not None:
            content, style = builder.style_and_content_scores(
                self.vgg, gt[..., :3], pred[..., :3], self.content_layers,
                self.style_layers)
            if "perceptual" in w:
                values["perceptual"] = content
                total = total + w["perceptual"] * content
            if "texture" in w:
                values["texture"] = style
                total = total + w["texture"] * style

        hh, ww = gt.shape[1], gt.shape[2]
        if self.has_discriminator and "adv" in w:
            input_high = self._input_high(input_low, hh, ww)
            parts = [input_high, pred, input_high[..., 3:4]]
            if self.use_previous_image:
                parts.append(prev_pred_warped)
            x = self._pad(torch.cat(parts, -1))
            logits = self.discriminators["adv"](x)
            g = (builder.gan_generator_loss(logits) if self.gan_kind == "bce"
                 else builder.wgan_generator_loss(logits))
            values["discr_pred"] = g
            total = total + w["adv"] * g

        if "temp-l2" in w and prev_pred_warped is not None:
            mask_high = self._input_high(input_low[..., 3:4], hh, ww)
            loss = builder.temporal_l2_masked(
                torch.cat([pred, mask_high], -1), prev_pred_warped)
            values["temp-l2"] = loss
            total = total + w["temp-l2"] * loss
        return total, values

    def train_discriminator(self, input_low: torch.Tensor,
                            gt_high: torch.Tensor,
                            gt_prev_warped: torch.Tensor,
                            pred_high: torch.Tensor,
                            pred_prev_warped: torch.Tensor,
                            rng: Optional[Tuple[int, int]] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Discriminator loss -> (loss, real score, fake score); the
        high-res stacks carry Cout + 1 channels (output and interpolated
        mask).  ``rng`` (a JAX key, `utils.jax_prng`) draws the WGAN-GP
        interpolates."""
        if not self.has_discriminator:
            raise ValueError("no adversarial loss in the loss list")
        input_high = self._input_high(input_low, gt_high.shape[1],
                                      gt_high.shape[2])
        if self.use_previous_image:
            gt_in = torch.cat([input_high, gt_high, gt_prev_warped], -1)
            pred_in = torch.cat([input_high, pred_high, pred_prev_warped],
                                -1)
        else:
            gt_in = torch.cat([input_high, gt_high], -1)
            pred_in = torch.cat([input_high, pred_high], -1)
        gt_in, pred_in = self._pad(gt_in), self._pad(pred_in)
        discr = self.discriminators["adv"]
        if self.gan_kind == "bce":
            return builder.gan_discriminator_loss(discr(gt_in),
                                                  discr(pred_in))
        return builder.wgan_discriminator_loss(
            discr, gt_in, pred_in,
            gradient_penalty=(self.gan_kind == "wgan-gp"),
            lambda_=self.cfg.wgan_lambda, rng=rng)
