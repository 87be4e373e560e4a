"""3x3 SAME convolution over 128-lane channel blocks (NHWC, batch 1).

Counterpart of the JAX package's `ops/pallas_conv.py`.  The kernel
computes, for x (1, H, W, 128k), w (3, 3, 128k, 128m) and b (128m,),

    y[0, i, j, co] = act(b[co] + sum_{dy, dx, c} bf16(x)[i+dy-1, j+dx-1, c]
                                                 * bf16(w)[dy, dx, c, co])

with zero padding, float32 sums, act = ReLU or identity, cast to
``out_dtype``.  `conv3x3_pallas_p128` launches the hand-written CUDA
kernel (``csrc/conv3x3.cu``, `conv3x3_p128_kernel`) on CUDA tensors and
runs `conv3x3_p128_plain` on CPU tensors; it raises on any other device
and never falls back from the card to the plain version.  JAX's ``th`` is
the TPU kernel's band height and does not change the result (padded rows
are cut); the port has no such argument.

`conv3x3` dispatches as JAX does: the kernel where JAX runs it (here
CUDA tensors, there the TPU) when ``W % 8 == 0``, over channels zero-padded
to 128 lanes, and otherwise a stock convolution in ``x.dtype`` with float32
sums.  The kernel rounds its input to bf16 (as the TPU kernel does), so the
two branches differ by that rounding in JAX too.  A kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch import kernels

LANE = 128
_F32 = torch.float32
_BF16 = torch.bfloat16
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_FNS: dict = {}


def pad_lanes(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Zero-pad a channel axis up to the next multiple of 128."""
    pad = -a.shape[axis] % LANE
    if pad == 0:
        return a
    widths = [0, 0] * a.dim()
    widths[2 * (a.dim() - 1 - axis % a.dim()) + 1] = pad
    return F.pad(a, widths)


def pack_pairs(x: torch.Tensor) -> torch.Tensor:
    """(1, H, W, 64) -> (1, H, W/2, 128): two adjacent pixels per row."""
    _, H, W, C = x.shape
    return x.reshape(1, H, W // 2, 2 * C)


def unpack_pairs(x: torch.Tensor, c_logical: int) -> torch.Tensor:
    """(1, H, W/2, 2*Cp) -> (1, H, W, c_logical) (drops per-pixel
    padding)."""
    _, H, W2, C2 = x.shape
    return x.reshape(1, H, W2 * 2, C2 // 2)[..., :c_logical]


def pack_weights_pairs(w: torch.Tensor, cin_p: int, cout_p: int
                       ) -> torch.Tensor:
    """(3, 3, Cin, Cout) conv weights for the packed-pairs layout: a pixel
    pair (even, odd) lives in one 2*cin_p row, and the x-offsets -1/0/+1
    of the original conv become pair offsets with block matrices:
    even output <- w0 @ previous pair's odd, w1 @ even, w2 @ odd;
    odd output <- w0 @ even, w1 @ odd, w2 @ next pair's even."""
    cin, cout = w.shape[2], w.shape[3]
    out = torch.zeros((3, 3, 2 * cin_p, 2 * cout_p), dtype=w.dtype,
                      device=w.device)
    for dy in range(3):
        w0, w1, w2 = w[dy, 0], w[dy, 1], w[dy, 2]
        out[dy, 0, cin_p:cin_p + cin, :cout] = w0
        out[dy, 1, :cin, :cout] = w1
        out[dy, 1, cin_p:cin_p + cin, :cout] = w2
        out[dy, 1, :cin, cout_p:cout_p + cout] = w0
        out[dy, 1, cin_p:cin_p + cin, cout_p:cout_p + cout] = w1
        out[dy, 2, :cin, cout_p:cout_p + cout] = w2
    return out


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(H, W, C) and (3, 3, C, Cout) float32 -> (H, W, Cout): a SAME
    zero-padded 3x3 conv as nine shifted matmuls summed in float32."""
    H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    z = None
    for dy in range(3):
        for dx in range(3):
            t = xp[dy:dy + H, dx:dx + W].reshape(H * W, C) @ w[dy, dx]
            z = t if z is None else z + t
    return z.reshape(H, W, -1)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"x must be (1, H, W, C), got {tuple(x.shape)}")
    _, _, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, Cout), got "
                         f"{tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be ({w.shape[3]},), got {tuple(b.shape)}")
    if C % LANE or w.shape[3] % LANE:
        raise ValueError(f"channels must be multiples of {LANE}, got "
                         f"{C} -> {w.shape[3]}")
    if W % 8:
        raise ValueError(f"W must be a multiple of 8, got {W}")


def conv3x3_p128_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       relu: bool = False,
                       out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float32 conv of the
    bf16-rounded input and weights, bias, ReLU, cast to ``out_dtype``."""
    _check(x, w, b)
    z = conv3x3_f32(x[0].to(_BF16).to(_F32), w.to(_BF16).to(_F32))
    z = z + b.to(_F32)
    if relu:
        z = torch.relu(z)
    return z[None].to(out_dtype)


def aligned16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous, with a 16-byte aligned start (the
    tensor maps' requirement), converted or copied only where it is not."""
    if t.dtype != dtype:
        t = t.to(dtype)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def raw_stream(dev: torch.device) -> int:
    """``dev``'s current CUDA stream as the C entries take it.  PyTorch's
    raw-stream query takes a fraction of a microsecond; building a
    `torch.cuda.Stream` to read its ``cuda_stream`` takes several, which
    a chain of short convs pays on every call."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def kernel_fn(name: str):
    """The C entry ``name`` of ``csrc/conv3x3.cu`` (built at first use)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(kernels.load("conv3x3"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] * 6 + [p] if name == "conv3x3_p128"
                       else [p] * 4 + [i] * 4 + [p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check_kernel_inputs(dev: torch.device, out_dtype: torch.dtype,
                        *tensors) -> None:
    """The kernels take contiguous, 16-byte aligned tensors on ``dev``:
    bf16 input and weights, float32 bias; bf16 or float32 output."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got "
                         f"{out_dtype}")
    for t, dtype in zip(tensors, (_BF16, _BF16, _F32)):
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"kernel inputs must be contiguous, 16-byte "
                             f"aligned {dtype} tensors on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def conv3x3_p128_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B6 on inputs `conv3x3_pallas_p128` prepared: bf16 ``x``
    (1, H, W, C) and ``w`` (3, 3, C, Cout), float32 ``b``.
    ``conv3x3_p128_kernel.launches`` counts launches."""
    fn = kernel_fn("conv3x3_p128")
    dev = x.device
    check_kernel_inputs(dev, out_dtype, x, w, b)
    _, H, W, C = x.shape
    cout = w.shape[3]
    y = torch.empty((1, H, W, cout), dtype=out_dtype, device=dev)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), H, W,
             C, cout, int(relu), int(out_dtype == _BF16),
             raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"conv3x3_p128 launch failed: CUDA error {err}")
    conv3x3_p128_kernel.launches += 1
    return y


conv3x3_p128_kernel.launches = 0


def conv3x3_pallas_p128(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        relu: bool = False, out_dtype: torch.dtype = _BF16
                        ) -> torch.Tensor:
    """Padded-channel conv: x (1, H, W, 128k), w (3, 3, 128k, 128m),
    b (128m,) -> (1, H, W, 128m) in ``out_dtype``; W a multiple of 8.
    The CUDA kernel for CUDA tensors, `conv3x3_p128_plain` for CPU
    tensors."""
    _check(x, w, b)
    dev = x.device
    if dev.type == "cpu":
        return conv3x3_p128_plain(x, w, b, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"conv3x3_pallas_p128 runs on cuda or cpu tensors, "
                         f"not {dev}")
    kernel_fn("conv3x3_p128")   # raises when the library cannot be built
    return conv3x3_p128_kernel(aligned16(x, _BF16), aligned16(w, _BF16),
                               aligned16(b, _F32), relu, out_dtype)


def conv3x3_packed(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None,
                   relu: bool = False) -> torch.Tensor:
    """3x3 SAME conv of 64-channel activations through packed pixel pairs
    and `conv3x3_pallas_p128` on pair-packed weights: x (1, H, W, 64), W
    even, w (3, 3, 64, Cout) -> (1, H, W, Cout) in ``x.dtype``."""
    _, H, W, C = x.shape
    cout = w.shape[3]
    if C != 64 or W % 2:
        raise ValueError(f"conv3x3_packed needs 64 channels and an even "
                         f"width, got {tuple(x.shape)}")
    cin_p, cout_p = 64, max(64, cout)
    wp = pack_weights_pairs(w, cin_p, cout_p)
    bp = torch.zeros((2 * cout_p,), dtype=_F32, device=x.device)
    if b is not None:
        bp[:cout] = b
        bp[cout_p:cout_p + cout] = b
    y = conv3x3_pallas_p128(pack_pairs(x), wp, bp, relu=relu,
                            out_dtype=x.dtype)
    return unpack_pairs(y, cout_p)[..., :cout]


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None,
            relu: bool = False) -> torch.Tensor:
    """3x3 SAME conv over logical channel counts, NHWC x (1, H, W, C),
    HWIO w, in ``x.dtype``.  On CUDA tensors with ``W % 8 == 0``: channels
    zero-padded to 128 lanes and the CUDA kernel (bf16 operands, float32
    sums).  Otherwise the stock conv of JAX's fallback: operands in
    ``x.dtype``, products and sums in float32, bias and ReLU, cast to
    ``x.dtype``."""
    cout = w.shape[3]
    if x.device.type == "cuda" and x.shape[2] % 8 == 0:
        bias = b if b is not None else torch.zeros(
            (cout,), dtype=_F32, device=x.device)
        y = conv3x3_pallas_p128(pad_lanes(x),
                                pad_lanes(pad_lanes(w, axis=2), axis=3),
                                pad_lanes(bias), relu=relu,
                                out_dtype=x.dtype)
        return y[..., :cout]
    xf = x.permute(0, 3, 1, 2).to(_F32)
    wf = w.to(x.dtype).to(_F32).permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, padding=1).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)
