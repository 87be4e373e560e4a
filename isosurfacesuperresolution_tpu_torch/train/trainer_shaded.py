"""Frame-recurrent training of the shaded (RGB-output) networks.

Counterpart of the JAX package's `train/trainer_shaded.py` (the
reference's ``mainVideo.py``): the network takes the shaded low-res frame
(RGB, mask in [0, 1], normal, depth: 8 channels) and the flattened warped
previous RGB prediction, outputs RGB, and trains with `losses/lossnet.py`.
The shaded clips come from the unshaded G-buffer clips
(`data/generation.py`) by screen-space shading of the low and high
buffers (`shade_clip`), as in JAX.

JAX's rules kept: frame 0's warped previous output, as the loss sees it,
is the ground truth and the resized mask; each frame's prediction is
clamped to [0, 1] before it is warped into the next; only frame 0's loss
terms are returned; with one frame or ``disable_temporal`` the loss is
frame 0's alone; and there is no discriminator step, so an adversarial
term scores with the critic as initialised.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import Config, ShadingConfig
from isosurfacesuperresolution_tpu_torch.infer.pipeline import fp32_convs
from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
from isosurfacesuperresolution_tpu_torch.models.videotools import (
    flatten_high, initial_image, warp_upscale)
from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.render.shading import (
    screen_space_shading)
from isosurfacesuperresolution_tpu_torch.train.optim import OptimizerSpec
from isosurfacesuperresolution_tpu_torch.train.trainer import (
    TrainState, create_train_state, optimizer_step)

SHADED_INPUT_CHANNELS = 8   # rgb, mask (0..1), normal, depth
SHADED_OUTPUT_CHANNELS = 3
# the shading the shaded trainer trains on (`apps/main_video_shaded.py`):
# ambient 0.1, diffuse 1, no specular, white material
TRAINING_SHADING = ShadingConfig(
    ambient_color=(0.1,) * 3, diffuse_color=(1.0,) * 3,
    specular_color=(0.0,) * 3, enable_specular=False,
    material_color=(1.0, 1.0, 1.0))


def shade_clip(low: torch.Tensor, high: torch.Tensor,
               shading_cfg: ShadingConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unshaded clips -> shaded training tensors: low (B, T, h, w, 5)
    [mask (-1, 1), normal, depth] -> (B, T, h, w, 8) [rgb, mask (0, 1),
    normal, depth]; high (B, T, H, W, 6) -> (B, T, H, W, 3) rgb."""
    b, t = low.shape[0], low.shape[1]
    lo = low.reshape((b * t,) + tuple(low.shape[2:]))
    hi = high.reshape((b * t,) + tuple(high.shape[2:]))
    lo_rgb = screen_space_shading(lo, shading_cfg)
    hi_rgb = screen_space_shading(hi, shading_cfg)
    mask01 = lo[..., 0:1] * 0.5 + 0.5
    lo_shaded = torch.cat([lo_rgb, mask01, lo[..., 1:5]], -1)
    return (lo_shaded.reshape((b, t) + tuple(lo_shaded.shape[1:])),
            hi_rgb.reshape((b, t) + tuple(hi_rgb.shape[1:])))


def make_shaded_clip_loss(cfg: Config, model: nn.Module,
                          criterion: LossNet) -> Callable:
    """``clip_loss(low, flow, high_rgb) -> (total, values0)``: the summed
    loss of a shaded clip, low (B, T, h, w, 8), flow (B, T, h, w, 2),
    high_rgb (B, T, H, W, 3), and frame 0's loss terms."""
    t = cfg.train
    m = cfg.model
    u = m.upscale_factor

    def clip_loss(low, flow, high_rgb):
        hh, ww = high_rgb.shape[2], high_rgb.shape[3]

        def run_frame(prev_output, low_t, flow_t, high_t, first):
            mask_high = resize(low_t[..., 3:4], size=(hh, ww),
                               method=m.upsample)
            if first:
                previous = initial_image(low_t, SHADED_OUTPUT_CHANNELS,
                                         t.initial_image_mode, False, u)
                prev_warped_loss = torch.cat([high_t, mask_high], -1)
            else:
                previous = warp_upscale(prev_output, flow_t, u)
                prev_warped_loss = torch.cat([previous, mask_high], -1)
            net_in = torch.cat([low_t, flatten_high(previous, u)], -1)
            pred, _ = model(net_in)
            loss, values = criterion(high_t, pred, low_t, prev_warped_loss)
            return loss, values, torch.clamp(pred, 0.0, 1.0)

        total, values0, prev = run_frame(None, low[:, 0], flow[:, 0],
                                         high_rgb[:, 0], True)
        if low.shape[1] == 1 or t.disable_temporal:
            return total, values0
        for j in range(1, low.shape[1]):
            loss, _, prev = run_frame(prev, low[:, j], flow[:, j],
                                      high_rgb[:, j], False)
            total = total + loss
        return total, values0

    return clip_loss


def make_shaded_train_step(cfg: Config, model: nn.Module,
                           criterion: LossNet) -> Callable:
    """``train_step(state, low, flow, high_rgb, accept=None, reduce=None)
    -> (state, loss)``: one BPTT step over a shaded clip, in place; the
    keywords as `train.trainer.make_train_step`'s."""
    clip_loss = make_shaded_clip_loss(cfg, model, criterion)

    def train_step(state: TrainState, low, flow, high_rgb,
                   accept: Optional[Callable] = None,
                   reduce: Optional[Callable] = None):
        with fp32_convs():
            loss, _ = clip_loss(low, flow, high_rgb)
            grads = torch.autograd.grad(loss, state.optimizer.params)
        return optimizer_step(state, loss.detach(), grads, accept, reduce)

    return train_step


def create_shaded_train_state(cfg: Config, model: nn.Module,
                              criterion: LossNet, optimizer: OptimizerSpec,
                              generator: Optional[torch.Generator] = None
                              ) -> TrainState:
    """The state of a fresh shaded run: ``model`` takes 8 + 3 u^2
    channels; the criterion's discriminator and VGG drawn from
    ``generator``; no discriminator optimizer (the shaded trainer has no
    discriminator step)."""
    want = (SHADED_INPUT_CHANNELS
            + SHADED_OUTPUT_CHANNELS * cfg.model.upscale_factor ** 2)
    got = getattr(model, "in_channels", want)
    if got != want:
        raise ValueError(f"a shaded network takes {want} input channels, "
                         f"this one {got}")
    return create_train_state(cfg, model, criterion, optimizer, generator)
