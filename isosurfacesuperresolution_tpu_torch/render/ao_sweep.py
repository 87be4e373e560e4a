"""Baked directional-occlusion ambient occlusion (SH-L1 field).

Counterpart of the JAX package's `render/ao_sweep.py`.  The occlusion is
baked once per (volume, isovalue) into a spherical-harmonics-L1 field that
the sweep renderer samples like a second density channel:

1.  For D Fibonacci-sphere directions d, the per-voxel occlusion along d is
    ``occ_d(v) = max_k inside(v + t_k d) * (1 - f(t_k))`` with
    ``f(t) = smoothstep(1, 0, radius / t)``; each step is a global trilinear
    translation of the volume (three axis lerps of zero-filled shifts).
2.  The D fields project onto SH-L1: ``mean = E_d[occ_d]``,
    ``g = 3 E_d[occ_d d]``.
3.  The cosine-weighted hemisphere integral around a normal n is
    ``AO(n) = 1 - mean - (2/3) g . n`` (`ao_from_sh`).

The bake runs on the grid's device; the host parts (pooling for a coarse
bake, the linear upsample back, uint8 quantization) stay numpy, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid

_F32 = torch.float32


def fibonacci_sphere(n: int) -> np.ndarray:
    """n roughly uniform unit directions (n, 3) float32."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], -1).astype(np.float32)


def _shift_int(a: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """out[i] = a[i + k] along ``axis``, zero where i + k is outside."""
    n = a.shape[axis]
    out = torch.zeros_like(a)
    lo, hi = max(0, -k), min(n, n - k)
    if lo < hi:
        out.narrow(axis, lo, hi - lo).copy_(a.narrow(axis, lo + k, hi - lo))
    return out


def _shift_volume(v: torch.Tensor, offset) -> torch.Tensor:
    """Trilinear sample of v at (grid + offset): value(p) = v(p + offset).

    ``offset`` (3,) float32 in voxels, on the host; three axis lerps of
    zero-filled integer shifts.  Out-of-range reads are 0."""
    off = torch.as_tensor(offset, dtype=_F32).cpu()
    out = v
    for axis in range(3):
        o = off[axis]
        i0 = torch.floor(o)
        frac = float(o - i0)                  # a float32 value
        k = int(i0)
        out = ((1.0 - frac) * _shift_int(out, k, axis)
               + frac * _shift_int(out, k + 1, axis))
    return out


def _smoothstep_1_0(x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(1.0 - x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def bake_occlusion_sh(values: torch.Tensor, isovalue: float,
                      ao_radius_voxels: float, num_dirs: int = 32,
                      num_steps: int = 16,
                      max_range_factor: float = 8.0) -> torch.Tensor:
    """SH-L1 occlusion fields (X, Y, Z, 4) = [mean, gx, gy, gz], float32 on
    the device of ``values`` (a dense (X, Y, Z) volume; radius in voxels).

    Sample distances are log-spaced from the contact range
    (max(2 voxels, radius/16)) to ``max_range_factor * radius / 2``; the
    per-step scalars are float32 host values, as the JAX package computes
    them on the device in float32."""
    values = values.to(_F32)
    dirs = torch.from_numpy(fibonacci_sphere(num_dirs))
    iso = float(torch.tensor(isovalue, dtype=_F32))
    radius = torch.tensor(ao_radius_voxels, dtype=_F32)
    t0 = torch.maximum(torch.tensor(2.0, dtype=_F32), radius / 16.0)
    t1 = torch.maximum(radius * max_range_factor / 2.0, t0 * 1.5)
    ks = torch.arange(1, num_steps + 1, dtype=_F32) / num_steps
    ts = t0 * (t1 / t0) ** ks
    weights = 1.0 - _smoothstep_1_0(radius / torch.clamp(ts, min=1e-6))

    mean = torch.zeros_like(values)
    g = torch.zeros(values.shape + (3,), dtype=_F32, device=values.device)
    for d in dirs:
        occ = torch.zeros_like(values)
        for t, w in zip(ts, weights.tolist()):
            shifted = _shift_volume(values, d * t)
            inside = (shifted >= iso).to(_F32)
            occ = torch.maximum(occ, inside * w)
        mean = mean + occ / num_dirs
        g = g + 3.0 * occ[..., None] * d.to(values.device) / num_dirs
    return torch.cat([mean[..., None], g], -1)


def ao_from_sh(sh: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """AO from captured SH fields (..., 4) and normals (..., 3):
    ``clip(1 - mean - (2/3) g . n, 0, 1)``."""
    ao = 1.0 - sh[..., 0] - (2.0 / 3.0) * torch.sum(sh[..., 1:4] * normal,
                                                    -1)
    return torch.clamp(ao, 0.0, 1.0)


def _upsample1d_linear(a: np.ndarray, axis: int, n_out: int,
                       factor: int) -> np.ndarray:
    """Host-side linear upsampling along one axis (cell-center aligned:
    coarse center j + 0.5 maps to fine (j + 0.5) * factor), constant
    extrapolation at both edges."""
    if factor == 2 and n_out == 2 * a.shape[axis]:
        # fixed 0.25 / 0.75 weights as contiguous slice arithmetic
        def ax(s):
            t = [slice(None)] * a.ndim
            t[axis] = s
            return tuple(t)

        prev = np.concatenate([a[ax(slice(0, 1))], a[ax(slice(None, -1))]],
                              axis=axis)
        nxt = np.concatenate([a[ax(slice(1, None))], a[ax(slice(-1, None))]],
                             axis=axis)
        out_shape = list(a.shape)
        out_shape[axis] = n_out
        out = np.empty(out_shape, np.float32)
        out[ax(slice(0, None, 2))] = 0.25 * prev + 0.75 * a
        out[ax(slice(1, None, 2))] = 0.75 * a + 0.25 * nxt
        return out
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) / factor - 0.5
    pos = np.clip(pos, 0.0, a.shape[axis] - 1.0)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, a.shape[axis] - 1)
    w = (pos - i0).astype(np.float32)
    shape = [1] * a.ndim
    shape[axis] = n_out
    w = w.reshape(shape)
    return np.take(a, i0, axis) * (1.0 - w) + np.take(a, i1, axis) * w


def _quantize_u8(sh_np: np.ndarray):
    """Per-channel affine uint8 quantization: physical[..., c] =
    q[..., c] * scale[c] + offset[c]."""
    lo = sh_np.min(axis=(0, 1, 2))
    hi = sh_np.max(axis=(0, 1, 2))
    scale = np.maximum((hi - lo) / 255.0, 1e-8)
    q = np.clip(np.round((sh_np - lo) / scale), 0, 255).astype(np.uint8)
    return q, tuple(float(s) for s in scale), tuple(float(v) for v in lo)


def attach_baked_ao(grid: BrickGrid, isovalue: float, ao_radius_world: float,
                    num_dirs: int = 32, num_steps: int = 12,
                    downsample: int = 1,
                    out_dtype: Optional[Union[torch.dtype, str]] = None,
                    keep_coarse: bool = False) -> BrickGrid:
    """A copy of ``grid`` carrying the baked SH occlusion field.

    ``ao_radius_world`` is the renderer's world-space AO radius; it
    converts to voxels via the grid transform.  ``downsample`` > 1 bakes
    at reduced resolution from a host-pooled volume and upsamples the field
    back on the host, or with ``keep_coarse`` attaches the coarse field
    itself (``ao_downsample`` = the factor).  ``out_dtype``: None keeps
    float32; ``torch.uint8`` quantizes per channel (tuple scale/offset);
    another torch type (e.g. ``torch.bfloat16``) casts."""
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    dev = grid.values.device
    radius_vox = float(ao_radius_world) / float(grid.voxel_size[0])
    f = int(downsample)

    def attach(sh: torch.Tensor, fd: int) -> BrickGrid:
        if out_dtype == torch.uint8:
            q, scale, lo = _quantize_u8(sh.cpu().numpy().astype(np.float32))
            return dataclasses.replace(grid, ao_sh=torch.from_numpy(q).to(dev),
                                       ao_scale=scale, ao_offset=lo,
                                       ao_downsample=fd)
        if out_dtype is not None:
            sh = sh.to(out_dtype)
        return dataclasses.replace(grid, ao_sh=sh.to(dev), ao_scale=1.0,
                                   ao_offset=0.0, ao_downsample=fd)

    if f <= 1:
        return attach(bake_occlusion_sh(grid.dequant(grid.values), isovalue,
                                        radius_vox, num_dirs=num_dirs,
                                        num_steps=num_steps), 1)

    X, Y, Z = grid.values.shape
    if X % f or Y % f or Z % f:
        raise ValueError(f"downsample {f} must divide the volume shape "
                         f"{(X, Y, Z)}")
    # pool on the host in slabs; the affine dequant commutes with the mean
    v_np = grid.values.cpu()
    if v_np.dtype == torch.bfloat16:
        v_np = v_np.to(_F32)
    v_np = v_np.numpy()
    Xc, Yc, Zc = X // f, Y // f, Z // f
    ds_np = np.empty((Xc, Yc, Zc), np.float32)
    slab = max(1, 128 // f)
    for x0 in range(0, Xc, slab):
        x1 = min(Xc, x0 + slab)
        blk = v_np[x0 * f:x1 * f].astype(np.float32)
        ds_np[x0:x1] = blk.reshape(x1 - x0, f, Yc, f, Zc, f).mean((1, 3, 5))
    if grid.value_scale != 1.0:
        ds_np *= np.float32(grid.value_scale)
    if grid.value_offset != 0.0:
        ds_np += np.float32(grid.value_offset)
    sh = bake_occlusion_sh(torch.from_numpy(ds_np).to(dev), isovalue,
                           radius_vox / f, num_dirs=num_dirs,
                           num_steps=num_steps)
    if keep_coarse:
        return attach(sh, f)
    sh_np = sh.cpu().numpy()
    for axis, n in ((0, X), (1, Y), (2, Z)):
        sh_np = _upsample1d_linear(sh_np, axis, n, f)
    return attach(torch.from_numpy(np.ascontiguousarray(sh_np, np.float32)),
                  1)
