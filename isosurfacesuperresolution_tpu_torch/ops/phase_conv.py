"""Phase conv: `conv3x3 after pixel_shuffle(2)` on planar tensors.

Counterpart of the JAX package's `ops/phase_conv.py`.  The planar SR tail
needs ``z = conv3x3(PS(y))`` on the planar (low-res, 4x-channel) tensor
without materialising the shuffle: the input is read in the A-MAJOR layout
(channel ``(a'*2+b')*64 + c`` is sub-pixel (a', b') of channel c) and the
output written B-MAJOR (channel ``(b*2+a)*64 + co``); the consumers fold
both layouts into their own kernels.  Scope as in the JAX package: factor-2
shuffle, 4 x 64 = 256 planar channels, batch 1, bias and optional ReLU
fused, bf16 inputs and weights, float32 sums, bf16 or float32 output.

`phase_conv` runs the hand-written CUDA kernel (the ``phase_conv`` entry
of ``csrc/conv3x3.cu``, launched by `phase_conv_kernel`) on CUDA tensors
and `phase_conv_plain` on CPU tensors; on any other device it raises, and
it never falls back from the card to the plain version.

The kernel works in the low-res domain.  With ``(di, a') = divmod(a + d -
1, 2)`` and ``(dj, b') = divmod(b + e - 1, 2)``, output phase (a, b)'s tap
(d, e) reads input chunk ``a'*2+b'`` at the whole low-res shift (di, dj),
so the 36 (phase, tap) products are 16 views of the input, each feeding
one, two or four phases; the kernel keeps the nine taps resident and
reads them in k3's own order.  `kernel_operands` makes its bf16 taps and
per-channel bias once per weight pair.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch.ops.pallas_conv import (
    aligned16, check_kernel_inputs, kernel_fn, raw_stream)

F_BLOCK = 64            # channels per sub-pixel block
C4 = 4 * F_BLOCK
_OPERANDS: list = []    # [(k3, bias, versions, operands)], newest first


def kernel_operands(k3: torch.Tensor, bias: torch.Tensor) -> tuple:
    """k3 (3, 3, 64, 64) and bias (64,) as the kernel reads them: the bf16
    taps, contiguous HWIO; and the float32 bias of each B-major output
    channel, (256,).  Made once per (k3, bias) pair and reused while
    neither tensor changes (the last four pairs are kept)."""
    versions = None
    if not (k3.is_inference() or bias.is_inference()):
        versions = (k3._version, bias._version)
        for k, b, v, ops in _OPERANDS:
            if k is k3 and b is bias and v == versions:
                return ops
    ops = (k3.to(torch.bfloat16).contiguous(),
           bias.to(torch.float32).repeat(4))
    if versions is not None:
        _OPERANDS.insert(0, (k3, bias, versions, ops))
        del _OPERANDS[4:]
    return ops


def bmajor_from_amajor_cols() -> np.ndarray:
    """perm with x_B = x_A[..., perm] for 4 x 64 planar blocks."""
    perm = np.empty(C4, np.int64)
    for a in range(2):
        for b in range(2):
            src = (a * 2 + b) * F_BLOCK
            dst = (b * 2 + a) * F_BLOCK
            perm[dst:dst + F_BLOCK] = np.arange(src, src + F_BLOCK)
    return perm


def _check(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[0] != 1 or x.shape[-1] != C4:
        raise ValueError(f"x must be (1, H, W, {C4}), got {tuple(x.shape)}")
    if tuple(k3.shape) != (3, 3, F_BLOCK, F_BLOCK):
        raise ValueError(f"k3 must be (3, 3, 64, 64), got "
                         f"{tuple(k3.shape)}")
    if tuple(bias.shape) != (F_BLOCK,):
        raise ValueError(f"bias must be (64,), got {tuple(bias.shape)}")


def phase_conv_plain(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor,
                     relu: bool = False,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The function of the kernel in plain PyTorch: A-major -> shuffled
    NCHW, a float32 SAME conv of the bf16-rounded input and weights, bias,
    ReLU, -> B-major, cast to ``out_dtype``."""
    _check(x, k3, bias)
    _, H, W, _ = x.shape
    f32 = torch.float32
    xf = x.to(torch.bfloat16).to(f32)[0]
    # x[i, j, (a*2+b)*64 + c] -> X[c, 2i+a, 2j+b]
    X = xf.reshape(H, W, 2, 2, F_BLOCK).permute(4, 0, 2, 1, 3)
    X = X.reshape(1, F_BLOCK, 2 * H, 2 * W)
    w = k3.to(torch.bfloat16).to(f32).permute(3, 2, 0, 1)      # OIHW
    Y = F.conv2d(X, w, padding=1) + bias.to(f32)[:, None, None]
    if relu:
        Y = torch.relu(Y)
    # Y[co, 2i+a, 2j+b] -> y[i, j, (b*2+a)*64 + co]
    y = Y.reshape(F_BLOCK, H, 2, W, 2).permute(1, 3, 4, 2, 0)
    return y.reshape(1, H, W, C4).to(out_dtype)


def phase_conv_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B5 on operands `phase_conv` prepared: bf16 ``x`` (1, H, W,
    256) and ``w, b`` from `kernel_operands`.  ``phase_conv.launches``
    counts launches."""
    fn = kernel_fn("phase_conv")
    dev = x.device
    check_kernel_inputs(dev, out_dtype, x, w, b)
    _, H, W, _ = x.shape
    y = torch.empty((1, H, W, C4), dtype=out_dtype, device=dev)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), H, W,
             int(relu), int(out_dtype == torch.bfloat16), raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"phase_conv launch failed: CUDA error {err}")
    phase_conv.launches += 1
    return y


def phase_conv(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor,
               relu: bool = False,
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (1, H, W, 256) A-major, k3 (3, 3, 64, 64) HWIO, bias (64,) ->
    (1, H, W, 256) B-major in ``out_dtype``: the CUDA kernel for CUDA
    tensors, `phase_conv_plain` for CPU tensors."""
    _check(x, k3, bias)
    dev = x.device
    if dev.type == "cpu":
        return phase_conv_plain(x, k3, bias, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"phase_conv runs on cuda or cpu tensors, not {dev}")
    for name, t in (("k3", k3), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    kernel_fn("phase_conv")     # raises when the library cannot be built
    w, b = kernel_operands(k3, bias)
    return phase_conv_kernel(aligned16(x, torch.bfloat16), w, b, relu,
                             out_dtype)


phase_conv.launches = 0


def phase_conv3x3_amajor(x: torch.Tensor, k3: torch.Tensor,
                         bias: torch.Tensor, relu: bool = False,
                         th: int = 16,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """The JAX package's row-band phase conv: `phase_conv`.  ``th`` is the
    TPU kernel's band height; the CUDA kernel tiles itself, so it is
    accepted and ignored."""
    return phase_conv(x, k3, bias, relu=relu, out_dtype=out_dtype)


def phase_conv3x3_amajor_blocked(x: torch.Tensor, k3: torch.Tensor,
                                 bias: torch.Tensor, relu: bool = False,
                                 th: int = 8, wb: int = 160,
                                 out_dtype: torch.dtype = torch.bfloat16
                                 ) -> torch.Tensor:
    """The JAX package's 2-D-blocked phase conv (same function as
    `phase_conv3x3_amajor`): `phase_conv`.  ``th`` and ``wb`` are the TPU
    kernel's block sizes; accepted and ignored."""
    return phase_conv(x, k3, bias, relu=relu, out_dtype=out_dtype)
