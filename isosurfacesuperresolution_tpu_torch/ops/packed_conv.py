"""3x3 SAME 64 -> 64 conv on pixel-pair-packed tensors (batch 1).

Counterpart of the JAX package's `ops/packed_conv.py`.  Packing horizontal
pixel pairs into channels, (1, H, W, 64) -> (1, H, W/2, 128), keeps the
memory order (channel ``p*64 + c`` of packed column j2 is channel c of
pixel 2*j2 + p), so the packed tensor IS the memory of the unpacked one,
and the kernel computes

    pack(act(bias + conv3x3(bf16(unpack(xp)), bf16(k3))))

directly on it: zero padding at the unpacked width, float32 sums, act =
ReLU or identity, cast to ``out_dtype``.  `packed_conv3x3` launches the
hand-written CUDA kernel (``csrc/conv3x3.cu``, `packed_conv3x3_kernel`)
on CUDA tensors and runs `packed_conv3x3_plain` on CPU tensors; it raises
on any other device and never falls back from the card to the plain
version.  JAX's ``th`` (band height) and ``interpret`` (debug mode) do not
change the result; the port has neither.

`pack_weights` is JAX's phase-matrix form of the kernel (the TPU kernel's
operands, 1.33x the MACs); the plain version computes through it, the
CUDA kernel does not.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as nnf

from isosurfacesuperresolution_tpu_torch.ops import pallas_conv

F = 64
_F32 = torch.float32
_BF16 = torch.bfloat16


def pack_pairs(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 64) -> (B, H, W/2, 128), channel p*64 + c (a view)."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w // 2, 2 * c)


def unpack_pairs(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W2, 128) -> (B, H, W2*2, 64): inverse of `pack_pairs`."""
    b, h, w2, c2 = x.shape
    return x.reshape(b, h, w2 * 2, c2 // 2)


def pack_weights(k3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 (3, 3, 64, 64) -> (Wc (3, 128, 128), We (3, 2, 128, 128)) bf16
    phase matrices.  Wc[dy], the centre packed column, rows (p', c') ->
    columns (p, c): column block p=0 takes K3[dy, 1] from p'=0 and
    K3[dy, 2] from p'=1, block p=1 takes K3[dy, 0] and K3[dy, 1].
    We[dy, 0], packed column j-1: only output p=0 from p'=1 (K3[dy, 0]);
    We[dy, 1], packed column j+1: only output p=1 from p'=0 (K3[dy, 2])."""
    k3 = k3.to(_F32)
    z = torch.zeros((F, F), dtype=_F32, device=k3.device)
    wc, we = [], []
    for dy in range(3):
        c0 = torch.cat([k3[dy, 1], k3[dy, 2]], 0)
        c1 = torch.cat([k3[dy, 0], k3[dy, 1]], 0)
        wc.append(torch.cat([c0, c1], 1))
        left = torch.cat([torch.cat([z, z], 1),
                          torch.cat([k3[dy, 0], z], 1)], 0)
        right = torch.cat([torch.cat([z, k3[dy, 2]], 1),
                           torch.cat([z, z], 1)], 0)
        we.append(torch.stack([left, right]))
    return torch.stack(wc).to(_BF16), torch.stack(we).to(_BF16)


def _check(xp: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor) -> None:
    if xp.dim() != 4 or xp.shape[0] != 1 or xp.shape[3] != 2 * F:
        raise ValueError(f"xp must be (1, H, W2, {2 * F}), got "
                         f"{tuple(xp.shape)}")
    if tuple(k3.shape) != (3, 3, F, F):
        raise ValueError(f"k3 must be (3, 3, {F}, {F}), got "
                         f"{tuple(k3.shape)}")
    if tuple(bias.shape) != (F,):
        raise ValueError(f"bias must be ({F},), got {tuple(bias.shape)}")


def packed_conv3x3_plain(xp: torch.Tensor, k3: torch.Tensor,
                         bias: torch.Tensor, relu: bool = False,
                         out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """The kernel's function in plain PyTorch, through JAX's phase
    matrices: per row tap, the packed columns j-1, j, j+1 of the
    bf16-rounded input times We[dy, 0], Wc[dy], We[dy, 1], summed in
    float32, plus the bias of both pixels, ReLU, cast."""
    _check(xp, k3, bias)
    _, H, W2, C2 = xp.shape
    wc, we = pack_weights(k3)
    x = nnf.pad(xp[0].to(_BF16).to(_F32), (0, 0, 1, 1, 1, 1))
    z = None
    for dy in range(3):
        for dx, m in enumerate((we[dy, 0], wc[dy], we[dy, 1])):
            t = x[dy:dy + H, dx:dx + W2].reshape(H * W2, C2) @ m.to(_F32)
            z = t if z is None else z + t
    z = z.reshape(1, H, W2, C2) + bias.to(_F32).repeat(2)
    if relu:
        z = torch.relu(z)
    return z.to(out_dtype)


def packed_conv3x3_kernel(xp: torch.Tensor, k3: torch.Tensor,
                          bias: torch.Tensor, relu: bool,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B7 on inputs `packed_conv3x3` prepared: bf16 ``xp``
    (1, H, W2, 128) and ``k3`` (3, 3, 64, 64), float32 ``bias`` (64,).
    ``packed_conv3x3_kernel.launches`` counts launches."""
    fn = pallas_conv.kernel_fn("packed_conv3x3")
    dev = xp.device
    pallas_conv.check_kernel_inputs(dev, out_dtype, xp, k3, bias)
    _, H, W2, C2 = xp.shape
    y = torch.empty((1, H, W2, C2), dtype=out_dtype, device=dev)
    err = fn(xp.data_ptr(), k3.data_ptr(), bias.data_ptr(), y.data_ptr(),
             H, W2, int(relu), int(out_dtype == _BF16),
             pallas_conv.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"packed_conv3x3 launch failed: CUDA error {err}")
    packed_conv3x3_kernel.launches += 1
    return y


packed_conv3x3_kernel.launches = 0


def packed_conv3x3(xp: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor,
                   relu: bool = False,
                   out_dtype: torch.dtype = _BF16) -> torch.Tensor:
    """3x3 SAME conv on a pixel-pair-packed (1, H, W2, 128) tensor, equal
    to ``pack(conv3x3(unpack(xp)))`` of the 64 -> 64 kernel ``k3`` with
    ``bias`` (64,): the CUDA kernel for CUDA tensors,
    `packed_conv3x3_plain` for CPU tensors."""
    _check(xp, k3, bias)
    dev = xp.device
    if dev.type == "cpu":
        return packed_conv3x3_plain(xp, k3, bias, relu, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"packed_conv3x3 runs on cuda or cpu tensors, not "
                         f"{dev}")
    pallas_conv.kernel_fn("packed_conv3x3")   # raises without a library
    return packed_conv3x3_kernel(pallas_conv.aligned16(xp, _BF16),
                                 pallas_conv.aligned16(k3, _BF16),
                                 pallas_conv.aligned16(bias, _F32), relu,
                                 out_dtype)
