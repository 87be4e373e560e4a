"""Sub-pixel-planar inference engine: the 4x SR frame without interleaves.

Counterpart of the JAX package's `infer/planar.py`, int8 post-training
quantization included (`ModelConfig.planar_int8`, `_conv_int8`).
Every tensor of the frame stays at the renderer's resolution (or 2x), with
the 4 x 4 = 16 high-res sub-pixels in the channel dimension, through the
network tail, the residual reconstruction, clamping, shading, the recurrent
state and the temporal warp; the one full-resolution materialisation is
the final RGB plane transpose, channel-first.  Layout permutations are
folded into the neighbouring convolution kernels, never applied to
activations.

Layouts (NHWC at every public function, HWIO kernels, as in JAX):

* ``state`` (B, h, w, 96), "nested" channel order
  ``c*16 + a2*8 + b2*4 + a1*2 + b1`` for high-res pixel
  (4i + 2*a1 + a2, 4j + 2*b1 + b2); semantic channels stay contiguous
  16-blocks.
* singly planar (B, 2h, 2w, 4F): F2 / post3 at twice the low resolution,
  c-major ``c*4 + a*2 + b``, or A-major ``(a*2+b)*F + c`` into the phase
  conv (`ops/phase_conv.py`), whose output is B-major.

Borders use resize-clamp semantics (`_edge_conv` replicates the edge), so
the engine equals the interleaved network in the interior only; the tail
convs and the phase conv zero-pad (SAME), as in JAX.

`PlanarNet` composes every kernel once, on the device, when it is built
(and with ``planar_int8`` quantizes the trunk's and post1-post3's weights
once: a pure function of the weights, which JAX recomputes per frame), and
keeps its activations in the layout its convolutions read: NHWC memory
(channels-last) in bf16, where the phase conv's input and output are then
views, NCHW in float32.  `planar_apply` is the JAX package's one-call form
(it composes per call); like JAX's it convolves the weights it is given,
and `FusedFrame` spectrally normalizes them first under ``use_sn``.
`PlanarTables` holds a frame's index tensors and constant grids;
`FusedFrame` builds them once, so a frame copies nothing from the host.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import (
    ModelConfig, ShadingConfig)
from isosurfacesuperresolution_tpu_torch.ops.fused_upsample import (
    compose_up2x_conv3x3, up2x_conv_bias, upsample_stencil_kernel)
from isosurfacesuperresolution_tpu_torch.ops.phase_conv import (
    bmajor_from_amajor_cols, phase_conv3x3_amajor_blocked)
from isosurfacesuperresolution_tpu_torch.ops.resize import (
    pixel_shuffle, pixel_unshuffle)

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Channel-order bookkeeping (static numpy, folded into kernels)
# ---------------------------------------------------------------------------

def _nested_coords():
    """(dy, dx) of each slot of one nested 16-block."""
    n = np.arange(16)
    a2, b2 = (n >> 3) & 1, (n >> 2) & 1
    a1, b1 = (n >> 1) & 1, n & 1
    return 2 * a1 + a2, 2 * b1 + b2


@lru_cache(maxsize=None)
def nested_from_flat_perm(channels: int = 6) -> np.ndarray:
    """perm with x_nested = x_flat[..., perm]; flat is the `flatten_high`
    order (c, dy, dx) c-major."""
    dy, dx = _nested_coords()
    sub_flat = dy * 4 + dx
    return (np.arange(channels)[:, None] * 16 + sub_flat[None, :]).reshape(-1)


@lru_cache(maxsize=None)
def flat_from_nested_perm(channels: int = 6) -> np.ndarray:
    p = nested_from_flat_perm(channels)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.size)
    return inv


def state_to_flat(x: torch.Tensor, channels: int = 6) -> torch.Tensor:
    """Nested-order planar state -> `flatten_high` order."""
    return x[..., torch.as_tensor(flat_from_nested_perm(channels),
                                  device=x.device)]


def state_from_flat(x: torch.Tensor, channels: int = 6) -> torch.Tensor:
    return x[..., torch.as_tensor(nested_from_flat_perm(channels),
                                  device=x.device)]


def supports_planar(cfg: ModelConfig) -> bool:
    """The planar engine covers the flagship configuration."""
    return (cfg.model == "EnhanceNet" and cfg.upscale_factor == 4
            and not cfg.use_bn and cfg.recon_type == "residual"
            and cfg.upsample in ("nearest", "bilinear")
            and tuple(cfg.channel_mask) == (0, 1, 2, 3, 4)
            and cfg.output_channels == 6)


# ---------------------------------------------------------------------------
# Convolutions (NHWC activations, HWIO kernels; NCHW inside)
# ---------------------------------------------------------------------------

def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(3, 2, 0, 1)


def _channels_last(x: torch.Tensor) -> bool:
    """Whether NCHW-shaped ``x`` lies in NHWC memory (and not also NCHW)."""
    return (x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous())


def _conv_nchw(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor], pad, dtype: torch.dtype
               ) -> torch.Tensor:
    """Conv of NCHW ``x`` with OIHW ``w`` in ``dtype``; the output keeps
    the memory format of ``x`` and ``w``.  ``pad``: an int (zero padding
    on every side) or (left, right, top, bottom).  A float32 conv adds the
    bias inside; a bf16 one adds it in bf16 after the conv, as the JAX
    package does."""
    x = x.to(dtype)
    if not isinstance(pad, int):
        x = F.pad(x, pad)
        pad = 0
    if dtype == _F32:
        return F.conv2d(x, w.to(dtype), bias, padding=pad)
    y = F.conv2d(x, w.to(dtype), padding=pad)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


def _edge_pad(x: torch.Tensor) -> torch.Tensor:
    """Replicate-pad NCHW-shaped ``x`` by one pixel, keeping its memory
    format: a channels-last ``x`` pads its NHWC view as an unbatched
    (H, W, C) volume, H and W by one and C by none."""
    if _channels_last(x):
        xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1),
                   mode="replicate")
        return xp.permute(0, 3, 1, 2)
    return F.pad(x, (1, 1, 1, 1), mode="replicate")


def _edge_conv_nchw(x, w, bias, dtype):
    """3x3 VALID conv over an edge-replicated input (resize-clamp
    semantics)."""
    return _conv_nchw(_edge_pad(x.to(dtype)), w, bias, 0, dtype)


def _shuffle_nchw(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """`F.pixel_shuffle(x, 2)` (or unshuffle) keeping the memory format of
    ``x``: a channels-last ``x`` goes through the NHWC functions on its
    NHWC view, one copy either way."""
    if _channels_last(x):
        fn = pixel_unshuffle if inverse else pixel_shuffle
        return fn(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
    return (F.pixel_unshuffle if inverse else F.pixel_shuffle)(x, 2)


def _nchw_pad(padding):
    if padding == "SAME":
        return 1
    if padding == "VALID":
        return 0
    (t, b), (l, r) = padding
    return (l, r, t, b)


def _conv(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor] = None, padding="SAME",
          dtype: Optional[torch.dtype] = None,
          quant: bool = False) -> torch.Tensor:
    """NHWC conv with an HWIO kernel (the JAX package's `_conv`); with
    ``quant`` the int8 `_conv_int8`."""
    dtype = dtype or x.dtype
    if quant:
        return _conv_int8(x, kernel, bias, padding, dtype)
    y = _conv_nchw(x.permute(0, 3, 1, 2), _oihw(kernel), bias,
                   _nchw_pad(padding), dtype)
    return y.permute(0, 2, 3, 1)


def _edge_conv(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               dtype: Optional[torch.dtype] = None,
               quant: bool = False) -> torch.Tensor:
    """NHWC 3x3 VALID conv over an edge-padded input; with ``quant`` the
    int8 `_conv_int8` of the padded input."""
    dtype = dtype or x.dtype
    if quant:
        xp = _edge_pad(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return _conv_int8(xp, kernel, bias, "VALID", dtype)
    y = _edge_conv_nchw(x.permute(0, 3, 1, 2), _oihw(kernel), bias, dtype)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# int8 post-training quantization (the JAX package's `_conv_int8`)
# ---------------------------------------------------------------------------

_I8 = torch.int8
# channel padding of the int8 matmuls: zero rows and columns keep the sums
# exact, and the card's int8 matmul wants multiples of 8 and 16-byte
# aligned rows
_CH_ALIGN = 16


def quantize_kernel(kernel: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``kernel`` -> (int8 ``kq``, float32 per-output-channel scales
    ``sw``): sw = max(max |k| over (0, 1, 2) / 127, 1e-12), kq =
    round(k / sw), half to even."""
    kf = kernel.to(_F32)
    sw = torch.clamp(kf.abs().amax(dim=(0, 1, 2)) / 127.0, min=1e-12)
    return torch.round(kf / sw).to(_I8), sw


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 ``xq``, 0-d float32 scale ``sx``), one scale per
    call: sx = max(max |x| / 127, 1e-12), xq = round(x / sx).  ``sx``
    stays on the device: no host sync."""
    xf = x.to(_F32)
    sx = torch.clamp(xf.abs().amax() / 127.0, min=1e-12)
    return torch.round(xf / sx).to(_I8), sx


class Int8Conv(NamedTuple):
    """A conv's quantized weights: ``taps`` (KH, KW, N, K) int8, tap
    (dy, dx) an (N, K) row-major matrix of output by input channels
    zero-padded to multiples of 16; ``sw`` the (Cout,) weight scales,
    ``bias`` (Cout,) float32 or None, ``cout`` the real output width."""

    taps: torch.Tensor
    sw: torch.Tensor
    bias: Optional[torch.Tensor]
    cout: int


def int8_conv(kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> Int8Conv:
    """Quantize an HWIO kernel once (`quantize_kernel`) into `Int8Conv`."""
    kq, sw = quantize_kernel(kernel)
    cin, cout = kq.shape[2], kq.shape[3]
    taps = F.pad(kq.permute(0, 1, 3, 2),
                 (0, -cin % _CH_ALIGN, 0, -cout % _CH_ALIGN))
    return Int8Conv(taps.contiguous(), sw,
                    None if bias is None else bias.to(_F32), cout)


def int8_conv_sums(xq: torch.Tensor, taps: torch.Tensor,
                   pad) -> torch.Tensor:
    """The exact int32 sums of an int8 conv: ``xq`` (B, H, W, Cin) int8
    NHWC, ``taps`` of `Int8Conv`, ``pad`` zeros as `_conv_nchw` takes
    them (an int for every side, or (left, right, top, bottom)) ->
    (B, Ho, Wo, N) int32.  Each tap is one `torch._int_mm` over a shifted
    row window of the flattened padded input (its rows span the padded
    width; the last columns, which wrap, are cut), the nine summed in
    int32: at most 9 * 256 * 127^2 (3.7e7), far from 2^31."""
    b, h, w, cin = xq.shape
    kh, kw, _, k = taps.shape
    left, right, top, bottom = (pad,) * 4 if isinstance(pad, int) else pad
    hp, wp = h + top + bottom, w + left + right
    m = b * hp * wp
    xp = F.pad(xq, (0, k - cin, left, right, top, bottom)).reshape(m, k)
    flat = F.pad(xp, (0, 0, 0, (kh - 1) * wp + kw - 1))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            off = dy * wp + dx
            y = torch._int_mm(flat[off:off + m], taps[dy, dx].t())
            acc = y if acc is None else acc.add_(y)
    return acc.reshape(b, hp, wp, -1)[:, :hp - kh + 1, :wp - kw + 1]


def int8_apply(x: torch.Tensor, q: Int8Conv, pad,
               dtype: torch.dtype) -> torch.Tensor:
    """`_conv_int8` on pre-quantized weights: NHWC ``x`` quantized per
    call, exact int32 sums, then ``sums * (sx * sw) + bias`` in float32,
    in that order, cast to ``dtype``."""
    xq, sx = quantize_activation(x)
    y = int8_conv_sums(xq.contiguous(), q.taps, pad)[..., :q.cout]
    y = y.to(_F32) * (sx * q.sw)
    if q.bias is not None:
        y = y + q.bias
    return y.to(dtype)


def _conv_int8(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor], padding,
               dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's `_conv_int8`: post-training-quantized conv of
    NHWC ``x`` with an HWIO ``kernel`` (per-output-channel weight scales,
    one activation scale per call, s8 x s8 -> s32 sums)."""
    return int8_apply(x, int8_conv(kernel, bias), _nchw_pad(padding), dtype)


def _conv_int8_nchw(x: torch.Tensor, q: Int8Conv, pad, dtype: torch.dtype,
                    memory_format: torch.memory_format) -> torch.Tensor:
    """`int8_apply` on NCHW-shaped ``x`` in any memory format; the output
    in ``memory_format``."""
    y = int8_apply(x.permute(0, 2, 3, 1), q, pad, dtype)
    return y.permute(0, 3, 1, 2).contiguous(memory_format=memory_format)


# ---------------------------------------------------------------------------
# Kernel composition
# ---------------------------------------------------------------------------

def _amajor_cols(cout: int) -> np.ndarray:
    """Column perm taking c-major planar channels (c, a, b) to A-major
    (a, b, c): idx_A = (a*2+b)*cout + c."""
    c = np.arange(cout)
    cols = np.empty(cout * 4, np.int64)
    for a in range(2):
        for b in range(2):
            cols[(a * 2 + b) * cout:(a * 2 + b + 1) * cout] = c * 4 + a * 2 + b
    return cols


@lru_cache(maxsize=None)
def _phase_selector() -> np.ndarray:
    """T[m, a', a, d] = 1 iff the planar tap (low-res offset m-1, input
    sub-pixel a') contributes kernel row d-1 to output sub-pixel a."""
    T = np.zeros((3, 2, 2, 3), np.float32)
    for mi in range(3):
        for ap in range(2):
            for a in range(2):
                d = 2 * (mi - 1) + ap - a
                if -1 <= d <= 1:
                    T[mi, ap, a, d + 1] = 1.0
    return T


def _compose_tail(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> the (3, 3, 4Cin, 4Cout) planar kernel of
    conv3x3-after-shuffle, c-major in and out."""
    T = torch.as_tensor(_phase_selector(), dtype=kernel.dtype,
                        device=kernel.device)
    kc = torch.einsum("muad,nvbe,decf->mncuvfab", T, T, kernel)
    cin, cout = kernel.shape[2], kernel.shape[3]
    return kc.reshape(3, 3, 4 * cin, 4 * cout)


def _tail_kernel(kernel: torch.Tensor, bias: torch.Tensor,
                 in_perm: Optional[np.ndarray] = None):
    kc = _compose_tail(kernel)
    if in_perm is not None:
        # the input arrives channel-permuted: re-index the kernel rows
        kc = kc[:, :, torch.as_tensor(np.asarray(in_perm),
                                      device=kc.device), :]
    return kc, torch.repeat_interleave(bias, 4)


def planar_tail_conv(z: torch.Tensor, kernel: torch.Tensor,
                     bias: torch.Tensor, dtype: torch.dtype,
                     in_perm: Optional[np.ndarray] = None,
                     quant: bool = False) -> torch.Tensor:
    """conv3x3-after-shuffle as one dense planar conv, c-major in and out.
    z (..., H, W, 4*Cin); kernel (3, 3, Cin, Cout).  SAME zero padding;
    ``quant``: int8 `_conv_int8`."""
    kc, b4 = _tail_kernel(kernel, bias, in_perm)
    return _conv(z, kc, b4, padding="SAME", dtype=dtype, quant=quant)


def _split_kernels(kernel: torch.Tensor, bias: torch.Tensor):
    """The two row-phase kernels of `planar_tail_conv_split`, their zero
    paddings ((top, bottom), (left, right)) and the output order."""
    kc, b4 = _tail_kernel(kernel, bias)
    ch = np.arange(kc.shape[-1])
    cols_a = [np.nonzero((ch % 4) // 2 == a)[0] for a in (0, 1)]
    parts = []
    for a, (rows, pad_h) in enumerate((((0, 2), (1, 0)),
                                       ((1, 3), (0, 1)))):
        cols = torch.as_tensor(cols_a[a], device=kc.device)
        parts.append((kc[rows[0]:rows[1]][:, :, :, cols], b4[cols],
                      (pad_h, (1, 1))))
    return parts, np.concatenate(cols_a)


def planar_tail_conv_split(z: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, dtype: torch.dtype,
                           quant: bool = False
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """conv3x3-after-shuffle as two row-phase convs (output sub-pixel row
    a only receives low-res row offsets {a-1, a}).  Returns ``(out,
    order)``: ``out`` holds the a=0 block then the a=1 block, and
    ``order[j]`` is the c-major channel at position j, for the consumer to
    fold into its kernel rows (`planar_tail_conv(..., in_perm=order)`)."""
    parts, order = _split_kernels(kernel, bias)
    outs = [_conv(z, ka, ba, padding=pad, dtype=dtype, quant=quant)
            for ka, ba, pad in parts]
    return torch.cat(outs, -1), order


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

PHASE_INT8_MESSAGE = (
    "planar_phase_tail and planar_int8 are mutually exclusive: the Pallas "
    "phase kernel has no int8 path, so post3 would run unquantized and the "
    "A/B would measure a mislabeled mixed configuration")


class PlanarNet:
    """EnhanceNet's forward in planar form, its kernels composed once.

    ``params``: an `models.generators.EnhanceNet` or its ``state_dict``
    (OIHW weights named as the Flax layers).  ``__call__(net_in)`` takes
    (B, h, w, 101) NHWC, channels [0:5] the low G-buffer and [5:101] the
    warped previous state in nested order, and returns the planar
    reconstruction (B, h, w, 96) in nested order.  With
    ``cfg.planar_int8`` the trunk blocks and post1-post3 run as int8
    post-training-quantized convs (``pre`` and ``out`` stay in the compute
    type, as in JAX); with the phase tail as well it raises JAX's
    ValueError."""

    def __init__(self, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: ModelConfig, device=None):
        if not supports_planar(cfg):
            raise ValueError("planar engine: unsupported model configuration")
        sd = params.state_dict() if isinstance(params, nn.Module) else params
        dev = torch.device(device) if device is not None else \
            next(iter(sd.values())).device
        sd = {k: v.detach().to(dev, _F32) for k, v in sd.items()}
        self.dtype = dt = getattr(torch, cfg.compute_dtype)
        # cuDNN runs bf16 convs on tensor-core kernels that read NHWC, and
        # float32 ones (TF32 off) on kernels that read NCHW, converting any
        # other layout around each call: the activations and weights take
        # the layout of their convs, channels-last for bf16
        self.memory_format = fmt = (torch.contiguous_format if dt == _F32
                                    else torch.channels_last)
        nf = cfg.num_features

        def hwio(name):
            return sd[f"{name}.weight"].permute(2, 3, 1, 0)

        def prep(w_oihw, b):
            # stored in the compute type, as `_conv` would cast them, and
            # in the activations' layout
            return w_oihw.to(dt).contiguous(memory_format=fmt), b.to(dt)

        # int8 PTQ covers the trunk blocks and post1-post3, as in JAX
        self.int8 = q8 = cfg.planar_int8

        def layer(k_hwio, b):
            """A quantized layer: its weights as `Int8Conv` under
            planar_int8, else as `prep` stores them."""
            return int8_conv(k_hwio, b) if q8 else prep(_oihw(k_hwio), b)

        n2f = np.concatenate([np.arange(5),
                              5 + nested_from_flat_perm(cfg.output_channels)])
        self.pre = prep(sd["pre.weight"][:, torch.as_tensor(n2f, device=dev)],
                        sd["pre.bias"])
        self.blocks = [(layer(hwio(f"block{i}_conv1"),
                              sd[f"block{i}_conv1.bias"]),
                        layer(hwio(f"block{i}_conv2"),
                              sd[f"block{i}_conv2.bias"]))
                       for i in range(cfg.num_residual_blocks)]
        self.f1 = layer(compose_up2x_conv3x3(hwio("post1"), cfg.upsample),
                        up2x_conv_bias(sd["post1.bias"]))
        k2 = compose_up2x_conv3x3(hwio("post2"), cfg.upsample)
        b2 = up2x_conv_bias(sd["post2.bias"])
        # the phase kernel is 4 x 64 wide: other widths keep the dense tail
        self.phase_tail = cfg.planar_phase_tail and nf == 64
        self.split_tail = cfg.planar_split_tail and not self.phase_tail
        if self.phase_tail and q8:
            raise ValueError(PHASE_INT8_MESSAGE)
        if self.phase_tail:
            # F2's output columns go A-major, the phase conv's input layout
            amaj = _amajor_cols(nf)
            amaj_t = torch.as_tensor(amaj, device=dev)
            k2, b2 = k2[..., amaj_t], b2[amaj_t]
            self.post3 = (hwio("post3").to(torch.bfloat16).contiguous(),
                          sd["post3.bias"])
            # the phase conv writes B-major: fold that into out's rows
            comp = amaj[bmajor_from_amajor_cols()]
            ko, bo = _tail_kernel(hwio("out"), sd["out.bias"], comp)
            self.out = prep(_oihw(ko), bo)
        elif self.split_tail:
            parts, order = _split_kernels(hwio("post3"), sd["post3.bias"])
            self.post3 = [(layer(k, b), _nchw_pad(pad))
                          for k, b, pad in parts]
            ko, bo = _tail_kernel(hwio("out"), sd["out.bias"], order)
            self.out = prep(_oihw(ko), bo)
        else:
            self.post3 = layer(*_tail_kernel(hwio("post3"),
                                             sd["post3.bias"]))
            ko, bo = _tail_kernel(hwio("out"), sd["out.bias"])
            self.out = prep(_oihw(ko), bo)
        self.f2 = layer(k2, b2)
        kr = upsample_stencil_kernel(5, cfg.upsample, 4, device=dev)
        kr = kr[..., torch.as_tensor(nested_from_flat_perm(5), device=dev)]
        self.recon = _oihw(kr).contiguous()         # float32, NCHW input

    def _conv(self, x: torch.Tensor, layer, pad) -> torch.Tensor:
        """One conv of NCHW-shaped ``x``: ``layer`` an `Int8Conv` or the
        (weight, bias) pair `prep` made; ``pad`` as `_conv_nchw` takes
        it."""
        if isinstance(layer, Int8Conv):
            return _conv_int8_nchw(x, layer, pad, self.dtype,
                                   self.memory_format)
        return _conv_nchw(x, *layer, pad, self.dtype)

    def _edge_conv(self, x: torch.Tensor, layer) -> torch.Tensor:
        """3x3 VALID conv over an edge-replicated input."""
        return self._conv(_edge_pad(x.to(self.dtype)), layer, 0)

    def __call__(self, net_in: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        conv = self._conv
        x = net_in.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=self.memory_format)
        feat = torch.relu(conv(x, self.pre, 1))
        for conv1, conv2 in self.blocks:
            y = torch.relu(conv(feat, conv1, 1))
            feat = feat + conv(y, conv2, 1)
        # F1: upsample x2 + post1 composed, then the one mid-network shuffle
        z = torch.relu(self._edge_conv(feat, self.f1))
        z = _shuffle_nchw(z)                               # (B, F, 2h, 2w)
        # F2: upsample x2 + post2 composed, planar output at 2x
        z = torch.relu(self._edge_conv(z, self.f2))
        if self.phase_tail:
            # A-major NHWC in, B-major NHWC out: views of channels-last z
            k3, b3 = self.post3
            zb = phase_conv3x3_amajor_blocked(
                z.permute(0, 2, 3, 1).to(torch.bfloat16), k3, b3,
                relu=True, out_dtype=dt)
            z = conv(zb.permute(0, 3, 1, 2).contiguous(
                memory_format=self.memory_format), self.out, 1)
        elif self.split_tail:
            z = torch.relu(torch.cat([conv(z, part, pad)
                                      for part, pad in self.post3], 1))
            z = conv(z, self.out, 1)
        else:
            z = torch.relu(conv(z, self.post3, 1))
            z = conv(z, self.out, 1)
        # one unshuffle: c-major planar at 2x -> nested planar at 1x
        z = _shuffle_nchw(z.to(_F32), inverse=True)       # (B, 96, h, w)
        # residual reconstruction as a fixed stencil conv, nested columns
        low = net_in[..., :5].permute(0, 3, 1, 2).to(_F32)
        recon = _edge_conv_nchw(low, self.recon, None, _F32)
        out = torch.cat([z[:, :80] + recon, z[:, 80:]], 1)
        return out.permute(0, 2, 3, 1)


def planar_apply(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                 cfg: ModelConfig, net_in: torch.Tensor) -> torch.Tensor:
    """EnhanceNet forward returning the planar reconstruction (nested
    order): `PlanarNet` built and run once on ``net_in``'s device."""
    return PlanarNet(params, cfg, device=net_in.device)(net_in)


# ---------------------------------------------------------------------------
# Planar post-processing (nested order; c-blocks are contiguous)
# ---------------------------------------------------------------------------

def clamp_output_planar(pred: torch.Tensor) -> torch.Tensor:
    """The trainer's `clamp_output` on a planar (..., 96) buffer."""
    mask = torch.clamp(pred[..., 0:16], -1.0, 1.0)
    nx, ny, nz = pred[..., 16:32], pred[..., 32:48], pred[..., 48:64]
    eps = 1e-7   # as render.shading.safe_normalize
    inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                       min=eps * eps))
    depth = torch.clamp(pred[..., 64:80], 0.0, 1.0)
    ao = torch.clamp(pred[..., 80:96], 0.0, 1.0)
    return torch.cat([mask, nx * inv, ny * inv, nz * inv, depth, ao], -1)


def screen_space_shading_planar(buf: torch.Tensor, cfg: ShadingConfig
                                ) -> torch.Tensor:
    """`render.shading.screen_space_shading` on planar (..., 96) buffers
    -> planar RGB (..., 48), same sub-pixel order as the input."""
    mask = buf[..., 0:16]
    nx, ny, nz = buf[..., 16:32], buf[..., 32:48], buf[..., 48:64]
    ao_raw = torch.clamp(buf[..., 80:96], 0.0, 1.0)
    if cfg.inverse_ao:
        ao_raw = torch.clamp(1.0 - buf[..., 80:96], 0.0, 1.0)
    ao = cfg.ao_strength * ao_raw + (1.0 - cfg.ao_strength)

    light = np.asarray(cfg.light_direction, np.float32)
    light = [float(v) for v in light / np.linalg.norm(light)]
    ldotn = light[0] * nx + light[1] * ny + light[2] * nz

    t = torch.clamp(mask * 0.5 + 0.5, 0.0, 1.0)
    if cfg.enable_specular:
        reflect_z = 2.0 * ldotn * nz - light[2]
        spec_factor = ((cfg.specular_exponent + 2) / (2.0 * math.pi)) * (
            torch.clamp(reflect_z, 0.0, 1.0) ** cfg.specular_exponent)
    chans = []
    for ch in range(3):
        color = (cfg.ambient_color[ch] * cfg.material_color[ch]
                 + cfg.diffuse_color[ch] * cfg.material_color[ch]
                 * torch.abs(ldotn))
        if cfg.enable_specular:
            color = color + spec_factor * cfg.specular_color[ch]
        color = color * ao
        bg = cfg.background[ch]
        color = bg + t * (color - bg)
        chans.append(torch.clamp(color, 0.0, 1.0))
    return torch.cat(chans, -1)


@lru_cache(maxsize=None)
def _planes_perm(channels: int) -> np.ndarray:
    """Nested (c, a2, b2, a1, b1) -> (b1, b2, c, a1, a2) channel order."""
    idx = np.arange(channels * 16)
    c, rem = idx // 16, idx % 16
    a2, b2 = (rem >> 3) & 1, (rem >> 2) & 1
    a1, b1 = (rem >> 1) & 1, rem & 1
    tgt = (((b1 * 2 + b2) * channels + c) * 2 + a1) * 2 + a2
    perm = np.empty(idx.size, np.int64)
    perm[tgt] = idx
    return perm


def planar_rgb_to_planes(rgb_planar: torch.Tensor,
                         tables: Optional["PlanarTables"] = None
                         ) -> torch.Tensor:
    """Planar nested RGB (B, h, w, 48) -> channel-first full-res planes
    (B, 3, 4h, 4w): a channel permutation puts the column sub-pixel bits
    first, so merging them into W is a pure reshape; one transpose does
    the row interleave.  ``tables``: the frame's `PlanarTables`, whose
    permutation is already on the device."""
    b, h, w, C = rgb_planar.shape
    c = C // 16
    perm = (tables.rgb_planes if tables is not None else
            torch.as_tensor(_planes_perm(c), device=rgb_planar.device))
    y = rgb_planar[..., perm]
    y = y.reshape(b, h, w * 4, c, 4)               # (w, b1, b2) merged
    y = y.permute(0, 3, 1, 4, 2)                   # (b, c, h, a1a2, 4w)
    return y.reshape(b, c, 4 * h, 4 * w)


def _stencil_nested(channels: int) -> torch.Tensor:
    """Bilinear x4 upsample stencil kernel with nested output columns."""
    k = upsample_stencil_kernel(channels, "bilinear", 4)
    return k[..., torch.as_tensor(nested_from_flat_perm(channels))]


def _unshaded_values(ao_inverted: bool) -> np.ndarray:
    return np.asarray([-1.0] * 16 + [0.0] * 16 + [0.0] * 16 + [1.0] * 16
                      + [0.5] * 16 + [0.0 if ao_inverted else 1.0] * 16,
                      np.float32)


def initial_image_planar(low: torch.Tensor, output_channels: int, mode: str,
                         ao_inverted: bool = False,
                         tables: Optional["PlanarTables"] = None
                         ) -> torch.Tensor:
    """`videotools.initial_image` directly in planar (nested) form."""
    b, h, w, _ = low.shape
    if output_channels != 6:
        raise ValueError("the planar state has 6 channels")
    dev = low.device
    if mode == "zero":
        return torch.zeros((b, h, w, 96), dtype=_F32, device=dev)
    if mode == "unshaded":
        vals = (tables.unshaded[ao_inverted] if tables is not None else
                torch.as_tensor(_unshaded_values(ao_inverted), device=dev))
        return vals.expand(b, h, w, 96)
    if mode == "input":
        stencil = (tables.stencil_low if tables is not None else
                   _stencil_nested(5).to(dev))
        up = _edge_conv(low[..., :5].to(_F32), stencil, dtype=_F32)
        ao = torch.full((b, h, w, 16), 0.0 if ao_inverted else 1.0,
                        dtype=_F32, device=dev)
        return torch.cat([up, ao], -1)
    raise ValueError(f"unknown initial image mode {mode!r}")


# ---------------------------------------------------------------------------
# Planar temporal warp
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _warp_maps(axis_is_x: bool, channels: int):
    """Per shift phase r in 0..3: (perm, inv, carry) where perm maps each
    output channel to the source channel whose sub-pixel index is shifted
    by +r along the axis, inv is its inverse, and carry marks the SOURCE
    channels whose shift wraps into the next low-res pixel."""
    dy, dx = _nested_coords()
    sub = dx if axis_is_x else dy
    oth = dy if axis_is_x else dx
    maps = []
    for r in range(4):
        perm16 = np.empty(16, np.int64)
        for i in range(16):
            perm16[i] = np.where((sub == (sub[i] + r) % 4)
                                 & (oth == oth[i]))[0][0]
        perm = (np.arange(channels)[:, None] * 16
                + perm16[None, :]).reshape(-1)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        carry = np.tile((sub + r) // 4, channels)[inv] == 1
        maps.append((perm, inv, carry))
    return maps


def _planar_linspace(nh: int, nl: int, axis_is_x: bool):
    """linspace(-1, 1, nh) and arange(nh) in nested planar order: (nl, 16)
    each."""
    dy, dx = _nested_coords()
    sub = dx if axis_is_x else dy
    g = np.linspace(-1.0, 1.0, nh, dtype=np.float32).reshape(nl, 4)
    i = np.arange(nh, dtype=np.float32).reshape(nl, 4)
    return g[:, sub], i[:, sub]


class PlanarTables:
    """The planar frame's index tensors and constant grids, for low-res
    (h, w) and ``channels`` state channels, made on ``device`` once.
    `FusedFrame` builds them with the engine, so that a frame copies
    nothing from the host; the functions that take ``tables`` make what
    they need themselves when given None."""

    def __init__(self, h: int, w: int, channels: int = 6, device=None):
        dev = torch.device(device if device is not None else "cpu")

        def put(a):
            return torch.as_tensor(a).to(dev)

        self.h, self.w, self.channels = h, w, channels
        self.stencil_low = put(_stencil_nested(5))
        self.stencil_flow = put(_stencil_nested(2))
        self.unshaded = {inv: put(_unshaded_values(inv))
                         for inv in (False, True)}
        self.rgb_planes = put(_planes_perm(3))
        # per axis (1 = y, 2 = x) and shift phase: (perm, inv, carry, any)
        self.warp = {axis: [(put(p), put(i), put(c), bool(c.any()))
                            for p, i, c in _warp_maps(axis == 2, channels)]
                     for axis in (1, 2)}
        gx, ix = _planar_linspace(4 * w, w, True)
        gy, iy = _planar_linspace(4 * h, h, False)
        self.gx, self.ix = (put(a.reshape(1, 1, w, 16)) for a in (gx, ix))
        self.gy, self.iy = (put(a.reshape(1, h, 1, 16)) for a in (gy, iy))


def _axis_warp_flat(img: torch.Tensor, disp: torch.Tensor, axis: int,
                    max_disp: int, maps) -> torch.Tensor:
    """Shift-blend along one axis (1 = y, 2 = x) of a nested planar buffer
    (B, h, w, C*16) by per-channel displacements in high-res pixels: a
    shift k splits into a sub-pixel rotation k % 4 and a low-res slice
    k // 4; accumulation runs in source-channel space and each of the four
    rotation groups is permuted back once.  ``maps``: the axis's entry of
    `PlanarTables.warp`."""
    r = max_disp
    disp = torch.clamp(disp, -r, r)
    n = img.shape[axis]
    lo_pad = r // 4 + 1
    pad = [0] * 6                                 # (C, W, H) pairs
    pad[2 * (3 - axis)] = pad[2 * (3 - axis) + 1] = lo_pad
    imgp = F.pad(img, pad)

    def lo_slice(t):
        return imgp.narrow(axis, lo_pad + t, n)

    out = None
    for r4, (perm, inv, carry, any_carry) in enumerate(maps):
        dispP = disp if r4 == 0 else disp[..., inv]
        acc = None
        for t in range(-(r // 4) - 1, r // 4 + 1):
            k = 4 * t + r4
            if k < -r or k > r:
                continue
            wgt = torch.clamp(1.0 - torch.abs(dispP - k), min=0.0)
            shifted = (torch.where(carry, lo_slice(t + 1), lo_slice(t))
                       if any_carry else lo_slice(t))
            term = wgt * shifted
            acc = term if acc is None else acc + term
        accP = acc if r4 == 0 else acc[..., perm]
        out = accP if out is None else out + accP
    return out


def warp_planar(prev_planar: torch.Tensor, flow_low: torch.Tensor,
                special_mask: bool = False, max_disp: int = 8,
                compute_dtype: Optional[torch.dtype] = None,
                tables: Optional[PlanarTables] = None) -> torch.Tensor:
    """`ops/warp_fast.warp_upscale_fast` on the planar (nested) state.

    prev_planar (B, h, w, 96), flow_low (B, h, w, 2) screen flow.  Returns
    the warped planar buffer, which is the network's temporal input.
    ``compute_dtype`` (e.g. bf16) is the type of the shift-blend;
    ``tables`` the frame's `PlanarTables` (made here when None)."""
    b, h, w, c96 = prev_planar.shape
    C = c96 // 16
    hh, wh = h * 4, w * 4
    if tables is None:
        tables = PlanarTables(h, w, C, prev_planar.device)

    flow = torch.stack([flow_low[..., 0] * -2.0, flow_low[..., 1] * 2.0], -1)
    flow_p = _edge_conv(flow.to(_F32), tables.stencil_flow, dtype=_F32)
    fx, fy = flow_p[..., 0:16], flow_p[..., 16:32]

    pos_x = ((tables.gx + fx + 1.0) * wh - 1.0) * 0.5
    pos_y = ((tables.gy + fy + 1.0) * hh - 1.0) * 0.5
    dt = compute_dtype or prev_planar.dtype
    disp_x = (pos_x - tables.ix).repeat(1, 1, 1, C).to(dt)
    disp_y = (pos_y - tables.iy).repeat(1, 1, 1, C).to(dt)

    img = prev_planar.to(dt)
    if special_mask:
        img = torch.cat([img[..., 0:16] * 0.5 + 0.5, img[..., 16:]], -1)
    out = _axis_warp_flat(img, disp_y, 1, max_disp, tables.warp[1])
    out = _axis_warp_flat(out, disp_x, 2, max_disp, tables.warp[2])
    if special_mask:
        out = torch.cat([out[..., 0:16] * 2.0 - 1.0, out[..., 16:]], -1)
    return out.to(prev_planar.dtype)
