"""The sweep march: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of the JAX package's `render/sweep_pallas.py` (`march_pallas`,
with and without a baked AO field).  `march` runs the hand-written kernel
``csrc/sweep_march.cu`` on CUDA tensors and `march_plain` on CPU tensors;
on any other device it raises.  It never falls back from the card to the
plain version.

Contract (the TPU kernel's): ``vol_zxy`` (Z, X, Y) slice-major volume,
``meta`` (K, 8) float32 rows [zc, lam, zf, fz, do-flag, iso, eye_s, eye_t],
``s_grid`` (Sn,), ``t_grid`` (Tn,).  ``dtype`` is the resample type
(``RenderConfig.sweep_dtype``): a float volume is stored in it, a uint8
volume stays uint8 and is dequantized (``* scale + offset``) after the
z-lerp; sums are float32.  Returns ``m_hit, frac, g_s, g_t, g_z``, each
(Sn, Tn) float32.  With ``ao_zcxy``, a (Z, 4, X, Y) baked SH occlusion
field (already dequantized; stored in ``dtype`` as the TPU kernel stores
it), the return gains ``sh`` (4, Sn, Tn): the field resampled like the
density at the crossing slice (no scale or offset), 0 where no crossing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from isosurfacesuperresolution_tpu_torch import kernels

_STORE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_FN = None


def _store_dtype(vol: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"resample dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    return torch.uint8 if vol.dtype == torch.uint8 else dtype


def kernel_volume(vol_zxy: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The volume as the kernel reads it: slice-major contiguous, in its
    storage type, made with one copy at most.  (``Tensor.to`` with a
    memory format would alias a permuted view whose type already fits.)"""
    store = _store_dtype(vol_zxy, dtype)
    if vol_zxy.dtype == store and vol_zxy.is_contiguous():
        return vol_zxy
    return torch.empty(vol_zxy.shape, dtype=store,
                       device=vol_zxy.device).copy_(vol_zxy)


def kernel_ao_field(ao_zcxy: torch.Tensor, dtype: torch.dtype
                    ) -> torch.Tensor:
    """The AO field as the kernel reads it: (Z, 4, X, Y) contiguous in the
    resample type, with one copy at most (a permuted view is copied even
    when its type already fits)."""
    if ao_zcxy.dtype == dtype and ao_zcxy.is_contiguous():
        return ao_zcxy
    return torch.empty(ao_zcxy.shape, dtype=dtype,
                       device=ao_zcxy.device).copy_(ao_zcxy)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to the resample type and back to float32 (the plain version
    multiplies in float32, so bf16 products are exact as on the card)."""
    return x.to(dtype).to(torch.float32)


def march_plain(vol_zxy: torch.Tensor, meta: torch.Tensor,
                s_grid: torch.Tensor, t_grid: torch.Tensor,
                Sn: int, Tn: int, dtype: torch.dtype = torch.bfloat16,
                scale: float = 1.0, offset: float = 0.0,
                ao_zcxy: Optional[torch.Tensor] = None,
                occ: Optional[torch.Tensor] = None,
                tile: Tuple[int, int] = (1, 1)
                ) -> Tuple[torch.Tensor, ...]:
    """The march as a Python loop over slices with dense interpolation
    matrices: F = wx @ slice @ wy^T, operands rounded to ``dtype``.

    ``occ`` (K, NTX, NTY) bool, with ``tile`` = (TX, TY): the tiled
    march's tap mask; on slice k the values of tiles not set in occ[k]
    are zeroed before the first factor (`sweep_tiled.march_tiled_plain`)."""
    vol = vol_zxy.to(_store_dtype(vol_zxy, dtype))
    ao = None if ao_zcxy is None else ao_zcxy.to(dtype)
    Z, X, Y = vol.shape
    dev = vol.device
    # the do-flags steer the loop on the host: one copy, not one per slice
    rows = meta.cpu().tolist()
    jx = torch.arange(X, dtype=torch.float32, device=dev) + 0.5
    jy = torch.arange(Y, dtype=torch.float32, device=dev) + 0.5
    zero = torch.zeros((Sn, Tn), dtype=torch.float32, device=dev)
    m_hit = zero - 1.0
    frac, g_s, g_t, g_z, fm1 = (zero.clone() for _ in range(5))
    sh = torch.zeros((4, Sn, Tn), dtype=torch.float32, device=dev)
    for k, (_, lam, zf, fz, flag, iso, eye_s, eye_t) in enumerate(rows):
        if not flag > 0.5:
            fm1 = zero
            continue
        # the row's float32 values enter as exact scalars of f32 ops
        zf = int(zf)
        sl = ((1.0 - fz) * vol[zf].to(torch.float32)
              + fz * vol[zf + 1].to(torch.float32))
        sl = _round(sl * scale + offset, dtype)
        if occ is not None:
            keep = occ[k].repeat_interleave(tile[0], 0).repeat_interleave(
                tile[1], 1)
            sl = torch.where(keep, sl, 0.0)
        s_pos = eye_s + lam * (s_grid - eye_s)
        t_pos = eye_t + lam * (t_grid - eye_t)
        wx = torch.clamp(1.0 - torch.abs(s_pos[:, None] - jx), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(t_pos[:, None] - jy), min=0.0)
        tmp = _round(wx, dtype) @ sl
        F = _round(tmp, dtype) @ _round(wy, dtype).t()
        crossing = (m_hit < 0.0) & (F >= iso)
        d = F - fm1
        denom = torch.where(torch.abs(d) > 1e-12, d, 1e-12)
        new_frac = torch.clamp((iso - fm1) / denom, 0.0, 1.0)
        m_hit = torch.where(crossing, float(k), m_hit)
        frac = torch.where(crossing, new_frac, frac)
        g_s = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 0)
                                           - torch.roll(fm1, 1, 0)), g_s)
        g_t = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 1)
                                           - torch.roll(fm1, 1, 1)), g_t)
        g_z = torch.where(crossing, d, g_z)
        fm1 = F
        if ao is not None and bool(crossing.any()):
            # the SH channels at the hit plane, resampled like F
            asl = ((1.0 - fz) * ao[zf].to(torch.float32)
                   + fz * ao[zf + 1].to(torch.float32))       # (4, X, Y)
            Fc = (_round(_round(wx, dtype) @ _round(asl, dtype), dtype)
                  @ _round(wy, dtype).t())
            sh = torch.where(crossing, Fc, sh)
    if ao is not None:
        return m_hit, frac, g_s, g_t, g_z, sh
    return m_hit, frac, g_s, g_t, g_z


def check_tables(dev: torch.device, meta: torch.Tensor,
                 s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int,
                 Tn: int) -> Tuple[torch.Tensor, ...]:
    """Check the slice table and the grids a march kernel reads (float32,
    their shapes, on ``dev``); returns them contiguous."""
    K = meta.shape[0]
    checks = ((meta, (K, 8)), (s_grid, (Sn,)), (t_grid, (Tn,)))
    for name, (x, shape) in zip(("meta", "s_grid", "t_grid"), checks):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the volume on {dev}")
    return tuple(x.contiguous() for x in (meta, s_grid, t_grid))


def _kernel():
    global _FN
    if _FN is None:
        fn = kernels.load("sweep_march").sweep_march
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, i, p, p, p, p, i, i, i, i, i, i, f, f,
                       p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def march(vol_zxy: torch.Tensor, meta: torch.Tensor,
          s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int, Tn: int,
          dtype: torch.dtype = torch.bfloat16,
          scale: float = 1.0, offset: float = 0.0,
          ao_zcxy: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, ...]:
    """Run the march: the CUDA kernel for CUDA tensors, `march_plain` for
    CPU tensors.  ``march.launches`` counts kernel launches without the
    AO field, ``march.ao_launches`` those that also capture it."""
    dev = vol_zxy.device
    if dev.type == "cpu":
        return march_plain(vol_zxy, meta, s_grid, t_grid, Sn, Tn, dtype,
                           scale, offset, ao_zcxy)
    if dev.type != "cuda":
        raise ValueError(f"march runs on cuda or cpu tensors, not {dev}")
    fn = _kernel()              # raises when the library cannot be built
    vol = kernel_volume(vol_zxy, dtype)
    if vol.dim() != 3 or vol.shape[0] < 2:
        raise ValueError(f"vol_zxy must be (Z >= 2, X, Y), got "
                         f"{tuple(vol.shape)}")
    meta, s_grid, t_grid = check_tables(dev, meta, s_grid, t_grid, Sn, Tn)
    K = meta.shape[0]
    Z, X, Y = vol.shape
    outs = [torch.empty((Sn, Tn), dtype=torch.float32, device=dev)
            for _ in range(5)]
    ao_ptr = sh_ptr = None
    if ao_zcxy is not None:
        if tuple(ao_zcxy.shape) != (Z, 4, X, Y):
            raise ValueError(f"ao_zcxy must be {(Z, 4, X, Y)}, got "
                             f"{tuple(ao_zcxy.shape)}")
        if ao_zcxy.device != dev:
            raise ValueError(f"ao_zcxy is on {ao_zcxy.device}, the volume "
                             f"on {dev}")
        ao = kernel_ao_field(ao_zcxy, dtype)
        outs.append(torch.empty((4, Sn, Tn), dtype=torch.float32,
                                device=dev))
        ao_ptr, sh_ptr = ao.data_ptr(), outs[5].data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(vol.data_ptr(), _STORE_CODES[vol.dtype],
             int(dtype == torch.bfloat16), ao_ptr, meta.data_ptr(),
             s_grid.data_ptr(), t_grid.data_ptr(), K, Z, X, Y, Sn, Tn,
             float(scale), float(offset), *(o.data_ptr() for o in outs[:5]),
             sh_ptr, stream)
    if err != 0:
        raise RuntimeError(f"sweep_march launch failed: CUDA error {err}")
    if ao_zcxy is None:
        march.launches += 1
    else:
        march.ao_launches += 1
    return tuple(outs)


march.launches = 0
march.ao_launches = 0
