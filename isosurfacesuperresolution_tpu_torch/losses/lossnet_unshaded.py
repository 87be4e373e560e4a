"""The loss stack of the unshaded networks (5 channels in, 6 out).

Counterpart of the JAX package's `losses/lossnet_unshaded.py` (the
criterion of the reference's `mainVideoUnshaded.py`).  Colour losses are
taken on the output shaded by the loss-time screen-space shading (ambient
``loss_ambient``, diffuse ``loss_diffuse``, no specular, light along +z,
AO strength ``loss_ao``), per-channel losses are gated by the clamped
ground-truth mask, everything is zeroed on a ``padding``-pixel border, and
up to three discriminators see colourized 8-channel stacks: "adv" 26
channels (input, warped previous input, prediction, warped previous
prediction), "tgan" 16 (prediction, previous), "sgan" 13 (input,
prediction).

The module owns the discriminators (``discriminators``, an
`nn.ModuleDict`) and the VGG (``vgg``) whose parameters the JAX version
takes as explicit trees; the trainer differentiates the generator loss
w.r.t. the generator's parameters only and the discriminator loss w.r.t.
the discriminators' only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import (
    LossConfig, ShadingConfig, parse_layer_weights)
from isosurfacesuperresolution_tpu_torch.losses import builder
from isosurfacesuperresolution_tpu_torch.losses.discriminators import (
    build_discriminator)
from isosurfacesuperresolution_tpu_torch.losses.vgg import (
    VGG19Features, load_vgg19_params, max_conv_needed)
from isosurfacesuperresolution_tpu_torch.render.shading import (
    safe_normalize, screen_space_shading)

# input channels of each discriminator
DISCR_CHANNELS = {"adv": 26, "tgan": 16, "sgan": 13}


class LossNetUnshaded(nn.Module):
    """Loss stack for 5-in/6-out unshaded networks.  ``init(generator)``
    draws the discriminators' and the VGG's parameters (the VGG from a
    weight file where one is found); the VGG is frozen."""

    def __init__(self, cfg: LossConfig, high_res: int,
                 input_channels: int = 5, output_channels: int = 6,
                 upscale_factor: int = 4,
                 use_spectral_norm: bool = False):
        super().__init__()
        if input_channels != 5 or output_channels != 6:
            raise ValueError("LossNetUnshaded takes 5 channels in (mask, "
                             "normalXYZ, depth) and 6 out (+ AO)")
        self.cfg = cfg
        self.upscale_factor = upscale_factor
        self.padding = cfg.padding
        self.weights = cfg.weight_dict()
        self.high_res = high_res
        self.use_spectral_norm = use_spectral_norm
        self.shading_cfg = ShadingConfig(
            ambient_color=(cfg.loss_ambient,) * 3,
            diffuse_color=(cfg.loss_diffuse,) * 3,
            specular_color=(cfg.loss_specular,) * 3,
            specular_exponent=16,
            enable_specular=False,
            light_direction=(0.0, 0.0, 1.0),
            material_color=(1.0, 1.0, 1.0),
            ao_strength=cfg.loss_ao,
        )
        names = {k for k, _ in self.weights}
        self.has_temporal_l2 = "temp-l2" in names
        self.has_adv = ("adv", "all") in self.weights
        self.has_tgan = ("tgan", "all") in self.weights
        self.has_sgan = ("sgan", "all") in self.weights
        self.has_discriminator = self.has_adv or self.has_tgan or self.has_sgan
        self.has_perceptual = "perceptual" in names
        self.has_texture = "texture" in names

        self.discriminators = nn.ModuleDict()
        for name, on in (("adv", self.has_adv), ("tgan", self.has_tgan),
                         ("sgan", self.has_sgan)):
            if on:
                self.discriminators[name] = build_discriminator(
                    cfg.discriminator, high_res, DISCR_CHANNELS[name],
                    use_spectral_norm)
        self.content_layers = (parse_layer_weights(cfg.perceptual_loss_layers)
                               if self.has_perceptual else [])
        self.style_layers = (parse_layer_weights(cfg.texture_loss_layers)
                             if self.has_texture else [])
        self.vgg: Optional[VGG19Features] = None
        self.vgg_pretrained = False
        if self.has_perceptual or self.has_texture:
            self.vgg = VGG19Features(max_conv=max_conv_needed(
                self.content_layers + self.style_layers))
            self.vgg.requires_grad_(False)

    # -- parameters ----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw fresh discriminator parameters from ``generator`` and load
        (or draw) the VGG's."""
        for name in list(self.discriminators):
            old = self.discriminators[name]
            device = next(old.parameters()).device
            self.discriminators[name] = build_discriminator(
                self.cfg.discriminator, self.high_res, DISCR_CHANNELS[name],
                self.use_spectral_norm, generator).to(device)
        if self.vgg is not None:
            state, self.vgg_pretrained = load_vgg19_params(
                self.vgg.max_conv, generator)
            with torch.no_grad():
                for k, v in self.vgg.state_dict().items():
                    v.copy_(state[k])

    # -- helpers -------------------------------------------------------------
    def _pad(self, img: torch.Tensor) -> torch.Tensor:
        return builder.pad_border_zero(img, self.padding)

    def _shade(self, buf: torch.Tensor) -> torch.Tensor:
        return screen_space_shading(buf, self.shading_cfg)

    def _colorize(self, t: torch.Tensor) -> torch.Tensor:
        """6 unshaded channels -> 8 (mask, normalized normal, colour, AO)."""
        mask = t[..., 0:1]
        normal = safe_normalize(t[..., 1:4])
        color = self._shade(torch.cat([mask, normal, t[..., 4:6]], -1))
        return torch.cat([mask, normal, color, t[..., 5:6]], -1)

    def _gen_adv_loss(self, logits: torch.Tensor) -> torch.Tensor:
        if self.cfg.gan_type == "bce":
            return builder.gan_generator_loss(logits)
        return builder.wgan_generator_loss(logits)

    # -- generator loss ------------------------------------------------------
    def forward(self, gt: torch.Tensor, pred: torch.Tensor,
                input_high: torch.Tensor,
                prev_input_warped: Optional[torch.Tensor],
                prev_pred_warped: Optional[torch.Tensor],
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generator-side loss -> (total, {"<loss>:<target>": value}).

        gt / pred : (B, H, W, 6) high-res target and prediction.
        input_high : (B, H, W, 5) upsampled low-res input.
        prev_input_warped : (B, H, W, 5) warped upsampled previous input
            (discriminators only).
        prev_pred_warped : (B, H, W, 6) warped previous prediction (the
            GT on the first frame)."""
        w = self.weights
        gt = self._pad(gt)
        pred = self._pad(pred)
        if prev_pred_warped is not None:
            prev_pred_warped = self._pad(prev_pred_warped)

        gt_mask = gt[..., 0:1]
        gt_mask_clamp = torch.clamp(gt_mask * 0.5 + 0.5, 0.0, 1.0)
        gt_normal = safe_normalize(gt[..., 1:4])
        gt_depth = gt[..., 4:5]
        gt_ao = gt[..., 5:6]
        pred_mask = pred[..., 0:1]
        pred_normal = safe_normalize(pred[..., 1:4])
        pred_depth = pred[..., 4:5]
        pred_ao = pred[..., 5:6]
        in_mask = input_high[..., 0:1]
        in_mask_clamp = torch.clamp(in_mask * 0.5 + 0.5, 0.0, 1.0)
        in_normal = safe_normalize(input_high[..., 1:4])
        in_depth = input_high[..., 4:5]

        gt_color = self._shade(gt)
        pred_color = self._shade(pred)
        input_color = self._shade(input_high)

        total = torch.zeros((), dtype=pred.dtype, device=pred.device)
        values: Dict[str, torch.Tensor] = {}
        # mse:color is always tracked (the test pass's PSNR)
        values["mse:color"] = builder.mse(gt_color, pred_color)

        pairs = {
            "mask": (gt_mask, pred_mask),
            "normal": (gt_normal * gt_mask_clamp, pred_normal * gt_mask_clamp),
            "ao": (gt_ao * gt_mask_clamp, pred_ao * gt_mask_clamp),
            "depth": (gt_depth * gt_mask_clamp, pred_depth * gt_mask_clamp),
            "color": (gt_color, pred_color),
        }
        for name, fn in (("mse", builder.mse), ("l1", builder.l1),
                         ("gdl", builder.gradient_difference)):
            for target, (a, b) in pairs.items():
                if (name, target) in w and w[(name, target)] != 0.0:
                    loss = fn(a, b)
                    values[f"{name}:{target}"] = loss
                    total = total + w[(name, target)] * loss

        ds_pairs = {
            "mask": (in_mask, pred_mask),
            "normal": (in_normal * in_mask_clamp, pred_normal * in_mask_clamp),
            "depth": (in_depth * in_mask_clamp, pred_depth * in_mask_clamp),
            "color": (input_color, pred_color),
        }
        for name, lkind in (("l2-ds", "l2"), ("l1-ds", "l1")):
            for target, (a, b) in ds_pairs.items():
                if (name, target) in w:
                    loss = builder.downsample_loss(
                        a, b, loss=lkind, factor=self.upscale_factor)
                    values[f"{name}:{target}"] = loss
                    total = total + w[(name, target)] * loss

        if self.vgg is not None:
            encodings = {
                "mask": (gt_mask.repeat(1, 1, 1, 3) * 0.5 + 0.5,
                         pred_mask.repeat(1, 1, 1, 3) * 0.5 + 0.5),
                "normal": ((gt_normal * gt_mask_clamp) * 0.5 + 0.5,
                           (pred_normal * gt_mask_clamp) * 0.5 + 0.5),
                "color": (gt_color, pred_color),
                "ao": (gt_ao.repeat(1, 1, 1, 3), pred_ao.repeat(1, 1, 1, 3)),
                "depth": (gt_depth.repeat(1, 1, 1, 3),
                          pred_depth.repeat(1, 1, 1, 3)),
            }
            for target, (a, b) in encodings.items():
                cw = w.get(("perceptual", target), 0.0)
                sw = w.get(("texture", target), 0.0)
                if cw == 0.0 and sw == 0.0:
                    continue
                content, style = builder.style_and_content_scores(
                    self.vgg, a, b, self.content_layers, self.style_layers)
                if cw:
                    values[f"perceptual:{target}"] = content
                if sw:
                    values[f"texture:{target}"] = style
                total = total + cw * content + sw * style

        if self.has_discriminator:
            pred_with_color = self._pad(torch.cat(
                [pred_mask, pred_normal, pred_color, pred_ao], -1))
            prev_pred_pad = self._pad(self._colorize(prev_pred_warped))
            input_pad = self._pad(input_high)
            prev_input_pad = self._pad(prev_input_warped)
            stacks = {
                "adv": ([input_pad, prev_input_pad, pred_with_color,
                         prev_pred_pad], "discr_pred"),
                "tgan": ([pred_with_color, prev_pred_pad],
                         "temp_discr_pred"),
                "sgan": ([input_pad, pred_with_color], "spatial_discr_pred"),
            }
            for name, (parts, key) in stacks.items():
                if name in self.discriminators:
                    logits = self.discriminators[name](torch.cat(parts, -1))
                    g = self._gen_adv_loss(logits)
                    values[key] = g
                    total = total + w[(name, "all")] * g

        if self.has_temporal_l2 and prev_pred_warped is not None:
            prev_mask = prev_pred_warped[..., 0:1]
            prev_normal = safe_normalize(prev_pred_warped[..., 1:4])
            tpairs = {
                "mask": (pred_mask, prev_mask),
                "normal": (pred_normal * gt_mask_clamp,
                           prev_normal * gt_mask_clamp),
                "ao": (pred_ao * gt_mask_clamp,
                       prev_pred_warped[..., 5:6] * gt_mask_clamp),
                "depth": (pred_depth * gt_mask_clamp,
                          prev_pred_warped[..., 4:5] * gt_mask_clamp),
                "color": (pred_color, self._shade(prev_pred_warped)),
            }
            for target, (a, b) in tpairs.items():
                if ("temp-l2", target) in w:
                    loss = builder.mse(a, b)
                    values[f"temp-l2:{target}"] = loss
                    total = total + w[("temp-l2", target)] * loss

        return total, values

    # -- discriminator loss --------------------------------------------------
    def train_discriminator(self, input_high: torch.Tensor,
                            gt_high: torch.Tensor,
                            prev_input_warped: torch.Tensor,
                            gt_prev_warped: torch.Tensor,
                            pred_high: torch.Tensor,
                            pred_prev_warped: torch.Tensor,
                            rng: Optional[Tuple[int, int]] = None,
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Discriminator-side loss -> (loss, real score, fake score), each
        summed over the discriminators with their weights.  ``rng`` (a JAX
        key, `utils.jax_prng`) draws the WGAN-GP interpolates; every
        discriminator gets the same key, as in JAX."""
        if not self.has_discriminator:
            raise ValueError("no discriminator in the loss list")
        w = self.weights

        def colorize_and_pad(t):
            return self._pad(self._colorize(t))

        input_p = self._pad(input_high)
        gt_p = colorize_and_pad(gt_high)
        pred_p = colorize_and_pad(pred_high)
        prev_input_p = self._pad(prev_input_warped)
        gt_prev_p = colorize_and_pad(gt_prev_warped)
        pred_prev_p = colorize_and_pad(pred_prev_warped)

        zero = torch.zeros((), dtype=gt_p.dtype, device=gt_p.device)
        total, gt_score, pred_score = zero, zero, zero
        stacks = {
            "adv": ([input_p, prev_input_p, gt_p, gt_prev_p],
                    [input_p, prev_input_p, pred_p, pred_prev_p]),
            "tgan": ([gt_p, gt_prev_p], [pred_p, pred_prev_p]),
            "sgan": ([input_p, gt_p], [input_p, pred_p]),
        }
        for name, (gt_parts, pred_parts) in stacks.items():
            if name not in self.discriminators:
                continue
            discr = self.discriminators[name]
            gt_in, pred_in = torch.cat(gt_parts, -1), torch.cat(pred_parts,
                                                                -1)
            if self.cfg.gan_type == "bce":
                l, gs, ps = builder.gan_discriminator_loss(discr(gt_in),
                                                           discr(pred_in))
            else:
                l, gs, ps = builder.wgan_discriminator_loss(
                    discr, gt_in, pred_in,
                    gradient_penalty=(self.cfg.gan_type == "wgan-gp"),
                    lambda_=self.cfg.wgan_lambda, rng=rng)
            ww = w[(name, "all")]
            total = total + ww * l
            gt_score = gt_score + ww * gs
            pred_score = pred_score + ww * ps
        return total, gt_score, pred_score
