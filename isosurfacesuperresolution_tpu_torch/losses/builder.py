"""Loss primitives over NHWC tensors.

Counterpart of the JAX package's `losses/builder.py` (the reference's
`losses/lossbuilder.py`): pixel losses, the gradient-difference loss,
downsample consistency (JAX's antialiased bilinear downsampling,
`ops.resize.resize`), Fourier MSE, gram/texture and perceptual losses over
VGG features, BCE and WGAN(-GP) adversarial losses, border zeroing.

The WGAN-GP interpolation weight is JAX's ``jax.random.uniform`` draw from
the same key, reproduced by `utils.jax_prng`, so both packages mix the
same interpolates.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.utils import jax_prng


def mse(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return torch.mean((gt - pred) ** 2)


def l1(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(gt - pred))


def gradient_difference(gt: torch.Tensor, pred: torch.Tensor
                        ) -> torch.Tensor:
    """L1 between the absolute finite-difference gradients of gt and pred
    along W and along H."""
    def dx(t):
        return t[:, :, 1:, :] - t[:, :, :-1, :]

    def dy(t):
        return t[:, 1:, :, :] - t[:, :-1, :, :]

    return (torch.mean(torch.abs(torch.abs(dx(gt)) - torch.abs(dx(pred))))
            + torch.mean(torch.abs(torch.abs(dy(gt)) - torch.abs(dy(pred)))))


def temporal_l2_masked(pred_with_mask: torch.Tensor,
                       prev_warped_with_mask: torch.Tensor,
                       threshold: float = 0.5) -> torch.Tensor:
    """Temporal L2 on RGB (channels 0:3) gated by both masks (channel 3)
    at or above ``threshold``; the gate carries no gradient."""
    m = ((pred_with_mask[..., 3:4] >= threshold)
         & (prev_warped_with_mask[..., 3:4] >= threshold)).to(
             pred_with_mask.dtype)
    return mse(pred_with_mask[..., 0:3] * m,
               prev_warped_with_mask[..., 0:3] * m)


def downsample_loss(gt: torch.Tensor, pred: torch.Tensor, *,
                    loss: str = "l2", factor: int = 4,
                    mode: str = "bilinear",
                    gt_low_res: bool = False) -> torch.Tensor:
    """Downsample-consistency loss: ``pred`` downsampled by ``factor``
    against ``gt`` (downsampled too unless ``gt_low_res``)."""
    fn = mse if loss == "l2" else l1
    pred_lo = resize(pred, scale=1.0 / factor, method=mode)
    if gt_low_res:
        return fn(gt, pred_lo)
    return fn(resize(gt, scale=1.0 / factor, method=mode), pred_lo)


def fft_mse(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """MSE in the Fourier domain of the images mapped to [-1, 1]."""
    g = gt * 2.0 - 1.0
    p = pred * 2.0 - 1.0
    d = (torch.fft.rfftn(g, dim=(-3, -2, -1))
         - torch.fft.rfftn(p, dim=(-3, -2, -1)))
    return torch.mean(d.real ** 2 + d.imag ** 2)


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, C) gram matrix normalized by C*H*W."""
    b, h, w, c = features.shape
    f = features.reshape(b, h * w, c)
    return torch.einsum("bnc,bnd->bcd", f, f) / (c * h * w)


def texture_loss(feat_gt: torch.Tensor, feat_pred: torch.Tensor,
                 patch_size: int = 16) -> torch.Tensor:
    """Gram-matrix MSE over ``patch_size`` tiles (zero-padded to whole
    tiles), each tile its own gram matrix."""
    def to_patches(f):
        b, h, w, c = f.shape
        f = F.pad(f, (0, 0, 0, -w % patch_size, 0, -h % patch_size))
        hp, wp = f.shape[1], f.shape[2]
        f = f.reshape(b, hp // patch_size, patch_size,
                      wp // patch_size, patch_size, c)
        f = f.permute(0, 1, 3, 2, 4, 5)
        return f.reshape(-1, patch_size, patch_size, c)

    g_gt = gram_matrix(to_patches(feat_gt))
    g_pred = gram_matrix(to_patches(feat_pred))
    return torch.mean((g_gt - g_pred) ** 2)


def perceptual_loss(feat_gt: torch.Tensor, feat_pred: torch.Tensor
                    ) -> torch.Tensor:
    """Feature-space MSE."""
    return torch.mean((feat_gt - feat_pred) ** 2)


def style_and_content_scores(
        vgg_apply: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
        gt_img: torch.Tensor, pred_img: torch.Tensor,
        content_layers: Sequence[Tuple[str, float]],
        style_layers: Sequence[Tuple[str, float]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One VGG pass over cat([gt, pred]) -> (content score, style score),
    each layer's score times its weight."""
    feats = vgg_apply(torch.cat([gt_img, pred_img], 0))
    b = gt_img.shape[0]
    content = torch.zeros((), dtype=gt_img.dtype, device=gt_img.device)
    style = torch.zeros((), dtype=gt_img.dtype, device=gt_img.device)
    for name, w in content_layers:
        f = feats[name]
        content = content + w * perceptual_loss(f[:b], f[b:])
    for name, w in style_layers:
        f = feats[name]
        style = style + w * texture_loss(f[:b], f[b:])
    return content, style


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    t = torch.full_like(logits, target)
    # maximum, not clamp: JAX's derivative at 0 splits the tie
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def gan_generator_loss(pred_logits: torch.Tensor) -> torch.Tensor:
    """Generator side of the BCE GAN."""
    return bce_with_logits(pred_logits, 1.0)


def gan_discriminator_loss(gt_logits: torch.Tensor,
                           pred_logits: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Discriminator BCE, real vs fake: (loss, mean sigmoid of the real
    logits, mean sigmoid of the fake ones)."""
    loss = (bce_with_logits(gt_logits, 1.0)
            + bce_with_logits(pred_logits, 0.0))
    return (loss, torch.mean(torch.sigmoid(gt_logits)),
            torch.mean(torch.sigmoid(pred_logits)))


def wgan_generator_loss(pred_logits: torch.Tensor) -> torch.Tensor:
    return -torch.mean(pred_logits)


def wgan_discriminator_loss(
        discr_apply: Callable[[torch.Tensor], torch.Tensor],
        gt_input: torch.Tensor, pred_input: torch.Tensor,
        gradient_penalty: bool = False, lambda_: float = 10.0,
        rng: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """WGAN critic loss E[D(fake)] - E[D(real)], with the gradient penalty
    lambda * E[(|grad D(x)| - 1)^2] on straight-line interpolates x under
    ``gradient_penalty``.  ``rng`` is a JAX key (`utils.jax_prng`): the
    interpolation weight is ``jax.random.uniform(rng, (B, 1, 1, 1))``.
    The penalty's gradient w.r.t. the critic's parameters flows through
    the input gradient (``create_graph``)."""
    disc_gt = discr_apply(gt_input)
    disc_pred = discr_apply(pred_input)
    loss = torch.mean(disc_pred) - torch.mean(disc_gt)
    if gradient_penalty:
        if rng is None:
            raise ValueError("wgan-gp needs an rng for the interpolates")
        b = gt_input.shape[0]
        alpha = torch.from_numpy(jax_prng.uniform(rng, (b, 1, 1, 1)))
        if gt_input.is_cuda:    # pinned, so that the copy does not wait
            alpha = alpha.pin_memory()
        alpha = alpha.to(gt_input.device, gt_input.dtype, non_blocking=True)
        inter = (gt_input + alpha * (pred_input - gt_input)).detach()
        inter.requires_grad_(True)
        grads, = torch.autograd.grad(torch.sum(discr_apply(inter)), inter,
                                     create_graph=True)
        slopes = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2, 3)) + 1e-12)
        loss = loss + lambda_ * torch.mean((slopes - 1.0) ** 2)
    return loss, torch.mean(disc_gt), torch.mean(disc_pred)


def pad_border_zero(img: torch.Tensor, border: int) -> torch.Tensor:
    """Zero a ``border``-pixel frame of (..., H, W, C), keeping the
    size."""
    if border == 0:
        return img
    h, w = img.shape[-3], img.shape[-2]
    mask = torch.zeros((h, w, 1), dtype=img.dtype, device=img.device)
    mask[border:h - border, border:w - border] = 1.0
    return img * mask
