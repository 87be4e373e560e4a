"""Direct volume rendering: emission-absorption through a transfer function.

Counterpart of the JAX package's `render/volume_render.py` (the
reference's ``-m volume`` mode): the density goes through a
piecewise-linear transfer function to premultiplied RGBA and composites
front to back.

* `render_volume_sweep`: the shear-warp sweep's geometry
  (`render/sweep.plan_sweep`: major axis, base plane, intermediate grid,
  per-slice scale and translate, final homography), with the slice loop
  carrying premultiplied RGB and transmittance instead of hit state;
* `render_volume_march`: the per-ray oracle, one sample every
  ``step_voxels`` along each pixel's ray.

Both return (H, W, 4) premultiplied RGBA on the grid's device.  The
camera is concrete, so the sweep's axis is chosen on the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.ops.separable_warp import (
    homography_warp, interp_matrix)
from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, norm3)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.raycast import (
    _ray_box_range)
from isosurfacesuperresolution_tpu_torch.render.sweep import plan_sweep
from isosurfacesuperresolution_tpu_torch.render.sweep_march import _round
from isosurfacesuperresolution_tpu_torch.volume.grid import (
    BrickGrid, sample_trilinear)

_F32 = torch.float32
# density -> RGBA nodes: the reference GPU renderer's 4-segment ramp
DEFAULT_TF = ((0.00, 0.0, 0.0, 0.0, 0.00),
              (0.25, 1.0, 0.0, 0.0, 0.05),
              (0.50, 1.0, 0.5, 0.0, 0.10),
              (0.75, 1.0, 1.0, 0.0, 0.15),
              (1.00, 1.0, 1.0, 1.0, 0.20))
# samples of one batch of the march (rays x steps)
MARCH_LANES = 1 << 23


def _tf_tables(tf, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nodes (N,) and their RGBA values (N, 4), float32 on
    ``device``."""
    t = torch.tensor(tf, dtype=_F32)
    return t[:, 0].contiguous().to(device), t[:, 1:].contiguous().to(device)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp(x, xp, fp[:, c])`` for each column c of fp: linear
    between the nodes, the end values beyond them; (..., C)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    x_lo, x_hi = xp[i - 1], xp[i]
    f_lo, f_hi = fp[i - 1], fp[i]
    dx = x_hi - x_lo
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    frac = (x - x_lo) / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0[..., None], f_lo,
                    f_lo + frac[..., None] * (f_hi - f_lo))
    f = torch.where((x < xp[0])[..., None], fp[0], f)
    return torch.where((x > xp[-1])[..., None], fp[-1], f)


def apply_transfer(density: torch.Tensor, tf=DEFAULT_TF) -> torch.Tensor:
    """Piecewise-linear transfer function: density (...) -> RGBA (..., 4),
    clamped to the end nodes outside them."""
    return _interp(density, *_tf_tables(tf, density.device))


def _composite_step(rgba: torch.Tensor, alpha_scale: float,
                    C: torch.Tensor, T: torch.Tensor):
    """One front-to-back emission-absorption step (premultiplied)."""
    a = torch.clamp(rgba[..., 3] * alpha_scale, 0.0, 1.0)
    C = C + (T * a)[..., None] * rgba[..., :3]
    T = T * (1.0 - a)
    return C, T


def _zero_is_clear(tf) -> bool:
    """Whether density 0 maps to opacity 0: then a sample outside the
    volume (or on a culled slice) changes nothing."""
    return float(apply_transfer(torch.zeros(1), tf)[0, 3]) == 0.0


def render_volume_sweep(grid: BrickGrid, cam: CameraParams,
                        cfg: RenderConfig, tf: Tuple = DEFAULT_TF
                        ) -> torch.Tensor:
    """Sweep DVR: (H, W, 4) premultiplied RGBA on the grid's device.

    Slices whose densities all map to zero opacity (at or below the end of
    the transfer function's leading zero-alpha plateau) skip their
    resample; the opacity of a slice plane is the function's alpha times
    ``volume_alpha_scale / sweep_z_supersample`` (alpha is per voxel)."""
    dev = grid.values.device
    W, H = cfg.width, cfg.height
    plan = plan_sweep(grid, cam, cfg, RenderParams.from_config(cfg))
    perm, Sn, Tn = plan.perm, plan.Sn, plan.Tn
    values = grid.dequant(grid.values).permute(perm[2], perm[0], perm[1])
    _, X, Y = values.shape
    vmax_z = torch.amax(values, dim=(1, 2)).cpu().tolist()
    cut = -1.0
    for node in tf:
        if node[4] != 0.0:
            break
        cut = node[0]
    cut = float(np.float32(cut))
    dtype = getattr(torch, cfg.sweep_dtype)
    alpha_scale = float(cfg.volume_alpha_scale) / plan.zss
    xp, fp = _tf_tables(tf, dev)
    s_grid, t_grid = plan.s_grid.to(dev), plan.t_grid.to(dev)
    C = torch.zeros((Sn, Tn, 3), dtype=_F32, device=dev)
    T = torch.ones((Sn, Tn), dtype=_F32, device=dev)
    zero = torch.zeros((Sn, Tn), dtype=_F32, device=dev)
    for _, lam, zf, fz, valid, _, e0, e1 in plan.meta.tolist():
        if valid < 0.5:
            continue                 # rgba 0: no change
        zf = int(zf)
        if max(vmax_z[zf], vmax_z[zf + 1]) > cut:
            sl = (1.0 - fz) * values[zf] + fz * values[zf + 1]
            wx = interp_matrix(e0 + lam * (s_grid - e0), X)
            wy = interp_matrix(e1 + lam * (t_grid - e1), Y)
            F = (_round(_round(wx, dtype) @ _round(sl, dtype), dtype)
                 @ _round(wy, dtype).t())
        else:
            F = zero
        C, T = _composite_step(_interp(F, xp, fp), alpha_scale, C, T)
    inter = torch.cat([C, (1.0 - T)[..., None]], -1)
    if plan.swap:
        out = homography_warp(inter.permute(1, 0, 2), plan.hmat[[1, 0, 2]],
                              (W, H))
    else:
        out = homography_warp(inter, plan.hmat, (W, H))
    return out.permute(1, 0, 2)


def render_volume_march(grid: BrickGrid, cam: CameraParams,
                        cfg: RenderConfig, tf: Tuple = DEFAULT_TF
                        ) -> torch.Tensor:
    """Per-ray DVR oracle: (H, W, 4) premultiplied RGBA, one sample every
    ``step_voxels`` from the eye for ``ceil(5 * max(shape) / step) + 4``
    steps (a sample outside the volume's voxel centres has density 0),
    opacity alpha * ``volume_alpha_scale * step_voxels``.  With a transfer
    function clear at 0, only the steps that some ray takes inside the
    volume are sampled: the others change nothing."""
    dev = grid.values.device
    W, H = cfg.width, cfg.height
    _, d = cam.pixel_rays(W, H, device=dev)
    d = d.reshape(-1, 3)
    vsize = np.float32(grid.voxel_size[0])
    dv = d / float(vsize + np.float32(1e-30))
    dv = dv / norm3(dv)[:, None]
    eye = grid.world_to_voxel(cam.eye).tolist()
    res = grid.resolution
    step = float(np.float32(cfg.step_voxels))
    n_steps = int(np.ceil(5.0 * max(res) / cfg.step_voxels)) + 4
    alpha_scale = float(cfg.volume_alpha_scale) * cfg.step_voxels
    xp, fp = _tf_tables(tf, dev)

    i0, i1 = 0, n_steps
    if _zero_is_clear(tf):
        # the steps between the first entry into and the last exit from
        # the box of voxel centres, one step of margin each side
        o = torch.tensor(eye, dtype=_F32, device=dev) - 0.5
        t0, t1 = _ray_box_range(o, dv, tuple(r - 1 for r in res))
        live = t1 >= torch.clamp(t0, min=0.0)
        if not bool(live.any()):
            i1 = 0
        else:
            i0 = max(0, int(math.floor(float(t0[live].min()) / step)) - 1)
            i1 = min(n_steps,
                     int(math.ceil(float(t1[live].max()) / step)) + 2)
    n = dv.shape[0]
    C = torch.zeros((n, 3), dtype=_F32, device=dev)
    T = torch.ones(n, dtype=_F32, device=dev)
    block = max(1, MARCH_LANES // n)
    for b0 in range(i0, i1, block):
        ii = torch.arange(b0, min(i1, b0 + block), device=dev)
        tt = ii.to(_F32) * step                                # (S,)
        p = torch.stack([eye[a] + dv[None, :, a] * tt[:, None]
                         for a in range(3)], -1)               # (S, n, 3)
        inside = ((p >= 0.5).all(-1) & (p[..., 0] <= res[0] - 0.5)
                  & (p[..., 1] <= res[1] - 0.5)
                  & (p[..., 2] <= res[2] - 0.5))
        dens = torch.where(inside, sample_trilinear(
            grid.values, p, grid.value_scale, grid.value_offset), 0.0)
        rgba = _interp(dens, xp, fp)
        a = torch.clamp(rgba[..., 3] * alpha_scale, 0.0, 1.0)
        for s in range(ii.shape[0]):
            C = C + (T * a[s])[:, None] * rgba[s, :, :3]
            T = T * (1.0 - a[s])
    return torch.cat([C, (1.0 - T)[:, None]], -1).reshape(H, W, 4)
