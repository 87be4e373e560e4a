"""Frame-recurrent training: BPTT over a clip, plain and adversarial.

Counterpart of the JAX package's `train/trainer.py` (the reference's
``trainNormal`` and ``trainAdv_v2``).  A clip's loss is the sum of its
frames' losses; each frame's network input is the low-res frame and the
flattened previous prediction (clamped, warped by the frame's flow), the
first frame's the initial image.  The frame loop is a Python loop, and the
backward pass is autograd through it (BPTT), as JAX differentiates its
``lax.scan``; with ``remat`` frames 1.. are each recomputed in the
backward (`torch.utils.checkpoint`, as ``jax.checkpoint`` wraps the scan
body).  The float32 steps run under `infer.pipeline.fp32_convs` (cuDNN's
TF32 off, whatever the global flag), so the card computes what the CPU
does.

Flow convention: frame j warps with flow[:, j], its flow w.r.t. frame
j-1's camera.

The adversarial discriminator phase runs the generator without gradient
(JAX's ``stop_gradient``) and differentiates the discriminators' loss
w.r.t. their parameters only; the generator phase is the plain step with
the discriminators' current parameters in the loss, differentiated w.r.t.
the generator's only.  The WGAN-GP interpolates take JAX's draws from
the same key (`utils.jax_prng`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from isosurfacesuperresolution_tpu_torch.config import Config
from isosurfacesuperresolution_tpu_torch.infer.pipeline import fp32_convs
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.videotools import (
    flatten_high, initial_image, warp_upscale)
from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.render.shading import safe_normalize
from isosurfacesuperresolution_tpu_torch.train.optim import (
    RULES, Optimizer, OptimizerSpec, set_learning_rate)
from isosurfacesuperresolution_tpu_torch.utils import jax_prng

__all__ = ["TrainState", "clamp_output", "make_optimizer",
           "set_learning_rate", "epoch_learning_rate", "make_clip_loss",
           "optimizer_step", "make_train_step", "make_predict_clip",
           "make_eval_step", "make_adv_train_steps", "create_train_state"]


@dataclass
class TrainState:
    """The generator and its optimizer, the discriminators and theirs
    (an empty `nn.ModuleDict` and None without adversarial losses), the
    frozen VGG of the perceptual losses (or None), and the step count."""

    model: nn.Module
    optimizer: Optimizer
    discriminators: nn.ModuleDict
    discr_optimizer: Optional[Optimizer]
    vgg: Optional[nn.Module]
    step: int = 0


def clamp_output(prediction: torch.Tensor) -> torch.Tensor:
    """The recurrent state: mask in [-1, 1], normal normalized, depth and
    AO in [0, 1]."""
    return torch.cat([
        torch.clamp(prediction[..., 0:1], -1.0, 1.0),
        safe_normalize(prediction[..., 1:4]),
        torch.clamp(prediction[..., 4:5], 0.0, 1.0),
        torch.clamp(prediction[..., 5:6], 0.0, 1.0),
    ], -1)


def make_optimizer(cfg: Config) -> OptimizerSpec:
    """The optax rule of ``cfg.train.optimizer`` (adam | rmsprop | rprop)
    with the learning rate, Adam's betas and the global-norm clip."""
    t = cfg.train
    name = t.optimizer.lower()
    if name not in RULES:
        raise ValueError(f"unknown optimizer {t.optimizer!r} "
                         "(adam | rmsprop | rprop)")
    return OptimizerSpec(rule=name, learning_rate=t.learning_rate,
                         b1=t.beta1, b2=t.beta2,
                         grad_clip=t.grad_clip if t.grad_clip > 0 else 0.0)


def epoch_learning_rate(cfg: Config, epoch: int) -> float:
    t = cfg.train
    return t.learning_rate * (t.lr_gamma ** (epoch // max(t.lr_step, 1)))


def _frame_inputs(low_t, flow_t, prev_output, prev_low, high0, low0, cfg,
                  is_first: bool):
    """(net_input, previous_warped, previous_warped_loss, previous_input)
    of one frame."""
    t = cfg.train
    m = cfg.model
    u = m.upscale_factor
    hh = low_t.shape[1] * u
    ww = low_t.shape[2] * u
    if is_first:
        previous_warped = initial_image(low_t, m.output_channels,
                                        t.initial_image_mode,
                                        t.ao_inverted, u)
        previous_warped_loss = high0
        previous_input = resize(low0, size=(hh, ww), method=m.upsample)
    else:
        previous_warped = warp_upscale(prev_output, flow_t, u,
                                       special_mask=True)
        previous_warped_loss = previous_warped
        prev_in_high = resize(prev_low, size=(hh, ww), method=m.upsample)
        previous_input = warp_upscale(prev_in_high, flow_t, u,
                                      special_mask=True)
    net_in = torch.cat([low_t, flatten_high(previous_warped, u)], -1)
    return net_in, previous_warped, previous_warped_loss, previous_input


def make_clip_loss(cfg: Config, model: nn.Module,
                   criterion: LossNetUnshaded) -> Callable:
    """``clip_loss(low, flow, high) -> (total, (frame_values, values0))``:
    the summed loss of a clip, low (B, T, h, w, 5), flow (B, T, h, w, 2),
    high (B, T, H, W, 6); ``frame_values`` the loss terms of frames 1..
    (with ``disable_temporal``, of the last frame), ``values0`` frame 0's."""
    t = cfg.train
    m = cfg.model

    def clip_loss(low, flow, high):
        hh, ww = high.shape[2], high.shape[3]

        def run_frame(prev_output, prev_low, low_t, flow_t, high_t,
                      is_first):
            net_in, _, prev_warped_loss, prev_input = _frame_inputs(
                low_t, flow_t, prev_output, prev_low, high[:, 0], low[:, 0],
                cfg, is_first)
            prediction, _ = model(net_in)
            input_high = resize(low_t, size=(hh, ww), method=m.upsample)
            loss, values = criterion(high_t, prediction, input_high,
                                     prev_input, prev_warped_loss)
            return loss, values, clamp_output(prediction)

        loss0, values0, prev_out = run_frame(
            None, None, low[:, 0], flow[:, 0], high[:, 0], True)
        T = low.shape[1]
        if t.num_frames == 1 or t.disable_temporal:
            total, values_last = loss0, values0
            for j in range(1, T):
                loss_t, values_last, _ = run_frame(
                    None, None, low[:, j], flow[:, j], high[:, j], True)
                total = total + loss_t
            return total, (values_last, values0)

        def body(prev_out, prev_low, low_t, flow_t, high_t):
            return run_frame(prev_out, prev_low, low_t, flow_t, high_t,
                             False)

        total, frame_values = loss0, []
        prev_low = low[:, 0]
        for j in range(1, T):
            args = (prev_out, prev_low, low[:, j], flow[:, j], high[:, j])
            if t.remat:
                loss_t, values_t, prev_out = checkpoint(
                    body, *args, use_reentrant=False)
            else:
                loss_t, values_t, prev_out = body(*args)
            total = total + loss_t
            frame_values.append(values_t)
            prev_low = low[:, j]
        return total, (frame_values, values0)

    return clip_loss


def _generator_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def optimizer_step(state: TrainState, loss: torch.Tensor, grads,
                   accept: Optional[Callable] = None,
                   reduce: Optional[Callable] = None):
    """The update of a train step from its loss and gradients: ``reduce``
    (the data-parallel all-reduce, `parallel.mesh`) first, then the
    spike guard ``accept(loss)``, then ``state.optimizer``'s step ->
    (state, loss)."""
    if reduce is not None:
        loss, grads = reduce(loss, grads)
    if accept is not None and not accept(loss):
        return state, loss
    state.optimizer.step(grads)
    state.step += 1
    return state, loss


def make_train_step(cfg: Config, model: nn.Module,
                    criterion: LossNetUnshaded) -> Callable:
    """``train_step(state, low, flow, high, accept=None, reduce=None) ->
    (state, loss)``: one BPTT step of the generator (in place), by
    ``state.optimizer``.  ``reduce(loss, grads) -> (loss, grads)``, when
    given, combines the step's loss and gradients with other processes'
    before anything reads them (`parallel.mesh.make_sharded_train_step`).
    ``accept(loss)``, when given, is asked before the optimizer step (the
    trainer's spike guard); on False the parameters stay as they were.
    ``loss`` is a 0-dim tensor on the clip's device."""
    clip_loss = make_clip_loss(cfg, model, criterion)

    def train_step(state: TrainState, low, flow, high,
                   accept: Optional[Callable] = None,
                   reduce: Optional[Callable] = None):
        with fp32_convs():
            loss, _ = clip_loss(low, flow, high)
            grads = torch.autograd.grad(loss, state.optimizer.params)
        return optimizer_step(state, loss.detach(), grads, accept, reduce)

    return train_step


def make_predict_clip(cfg: Config, model: nn.Module) -> Callable:
    """``predict(low, flow) -> (B, T, H*u, W*u, Cout)``: the clamped
    predictions of a recurrent rollout over a clip (no losses)."""

    @torch.no_grad()
    def predict(low, flow):
        outs = []
        prev, prev_low = None, None
        with fp32_convs():
            for j in range(low.shape[1]):
                net_in, _, _, _ = _frame_inputs(
                    low[:, j], flow[:, j], prev, prev_low, None, low[:, 0],
                    cfg, j == 0)
                prev = clamp_output(model(net_in)[0])
                prev_low = low[:, j]
                outs.append(prev)
        return torch.stack(outs, 1)

    return predict


def make_eval_step(cfg: Config, model: nn.Module,
                   criterion: LossNetUnshaded) -> Callable:
    """``eval_step(low, flow, high) -> (mean loss a frame, PSNR)``: a clip
    without gradient, the PSNR from the frames' mean ``mse:color``; both
    0-dim tensors on the clip's device."""
    m = cfg.model

    @torch.no_grad()
    def eval_step(low, flow, high):
        hh, ww = high.shape[2], high.shape[3]
        T = low.shape[1]
        total, mse_acc = 0.0, 0.0
        prev, prev_low = None, None
        with fp32_convs():
            for j in range(T):
                net_in, _, prev_warped_loss, prev_input = _frame_inputs(
                    low[:, j], flow[:, j], prev, prev_low, high[:, 0],
                    low[:, 0], cfg, j == 0)
                prediction, _ = model(net_in)
                input_high = resize(low[:, j], size=(hh, ww),
                                    method=m.upsample)
                loss, values = criterion(high[:, j], prediction, input_high,
                                         prev_input, prev_warped_loss)
                total = total + loss
                mse_acc = mse_acc + values["mse:color"]
                prev, prev_low = clamp_output(prediction), low[:, j]
        mean_mse = mse_acc / T
        psnr = 10.0 * torch.log10(1.0 / torch.clamp(mean_mse, min=1e-10))
        return total / T, psnr

    return eval_step


def make_adv_train_steps(cfg: Config, model: nn.Module,
                         criterion: LossNetUnshaded
                         ) -> Tuple[Callable, Callable]:
    """``(discr_step, gen_step)``: ``discr_step(state, low, flow, high,
    rng) -> (state, loss, real score, fake score)`` updates the
    discriminators by ``state.discr_optimizer`` over the clip's frames
    (``rng`` a JAX key, split into one key a frame as JAX splits it);
    ``gen_step`` is the plain train step, whose loss holds the
    adversarial terms."""
    m = cfg.model
    u = m.upscale_factor

    @torch.no_grad()
    def rollout(low, flow, high):
        """Per frame: raw prediction, upsampled input, warped previous
        input, the loss's warped previous prediction and the warped
        previous ground truth (frame 0: the ground truth)."""
        hh, ww = high.shape[2], high.shape[3]
        frames = []
        prev, prev_low = None, None
        for j in range(low.shape[1]):
            net_in, _, pwl, prev_in = _frame_inputs(
                low[:, j], flow[:, j], prev, prev_low, high[:, 0], low[:, 0],
                cfg, j == 0)
            pred, _ = model(net_in)
            in_high = resize(low[:, j], size=(hh, ww), method=m.upsample)
            gt_prev = (high[:, 0] if j == 0 else warp_upscale(
                high[:, j - 1], flow[:, j], u, special_mask=True))
            frames.append((pred, in_high, prev_in, pwl, gt_prev))
            prev, prev_low = clamp_output(pred), low[:, j]
        return frames

    def discr_step(state: TrainState, low, flow, high, rng):
        opt = state.discr_optimizer
        with fp32_convs():
            frames = rollout(low, flow, high)
            keys = jax_prng.split(rng, len(frames))
            total = gts = prs = 0.0
            for j, (pred, in_high, prev_in, pwl, gt_prev) in enumerate(
                    frames):
                l, gs, ps = criterion.train_discriminator(
                    in_high, high[:, j], prev_in, gt_prev, pred, pwl,
                    rng=keys[j])
                total, gts, prs = total + l, gts + gs, prs + ps
            grads = torch.autograd.grad(total, opt.params)
        opt.step(grads)
        return state, total.detach(), gts.detach(), prs.detach()

    return discr_step, make_train_step(cfg, model, criterion)


def create_train_state(cfg: Config, model: nn.Module,
                       criterion: LossNetUnshaded,
                       optimizer: OptimizerSpec,
                       generator: Optional[torch.Generator] = None,
                       discr_optimizer: Optional[OptimizerSpec] = None
                       ) -> TrainState:
    """The state of a fresh run: the generator as built (its weights drawn
    by `models.generators.create_network`), ``criterion.init(generator)``
    for the discriminators and the VGG, the optimizers' states on the
    parameters' devices."""
    criterion.init(generator)
    device = next(model.parameters()).device
    criterion.to(device)
    discr = criterion.discriminators
    d_opt = None
    if discr_optimizer is not None and criterion.has_discriminator:
        d_opt = discr_optimizer.init(dict(discr.named_parameters()))
    return TrainState(model=model,
                      optimizer=optimizer.init(_generator_params(model)),
                      discriminators=discr, discr_optimizer=d_opt,
                      vgg=criterion.vgg, step=0)
