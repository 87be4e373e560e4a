"""Perspective shear-warp sweep renderer: the isosurface G-buffer.

Counterpart of the JAX package's `render/sweep.py` (dense volumes).  The
volume axis most parallel to the view is the sweep axis; rays through the
eye and a regular (s, t) grid on the entry-side base plane cross every
slice plane in an axis-aligned scale + translate of that grid, so each
slice is resampled with two 2-tap tent filters, the first crossing is
refined by inverse lerp and frustum-space gradients are captured; the
chain rule through the shear turns them into volume normals, and one
homography maps the intermediate G-buffer to the image with a two-pass
separable resample.  With a baked SH occlusion field
(`render/ao_sweep.attach_baked_ao`) the field is captured at the hit
plane and the AO channel is ``ao_from_sh(sh, normal)``; without one (or
with ``ao_mode="ray"``) AO comes from hemisphere rays marched from the
hits of the intermediate grid (`render/raycast.compute_ao`), an oracle
path whatever the march.

Four marches, chosen as in the JAX package:

* ``renderer="sweep"``: the reference's slice scan (`scan_march`), in
  stock PyTorch ops, rounding where the scan rounds; an oracle path;
* ``renderer="sweep_pallas"``, small slice planes: the flat march kernel
  (`render/sweep_march.py`, B1), with the AO field captured in the march;
* ``renderer="sweep_pallas"`` with ``sweep_tile`` > 0, or 0 and a slice
  plane of at least 512 on an axis: the occupancy-gated tiled march (B2)
  and a second pass for the AO field (B4) (`render/sweep_tiled.py`);
* a `volume/packed.SparseBrickGrid` (``renderer="sweep_pallas"`` only,
  whatever the size or ``sweep_tile``): the tiled march over the packed
  volume of the view's axis order (B3), on the atlas's tiles, and a
  second pass over its packed AO field when it has one (B4p).

A coarse AO field (``ao_downsample`` > 1) is sampled natively by B4; the
flat march and the scan get it dequantized and upsampled linearly first,
and packing upsamples it before it packs (`SparseBrickGrid`).

All geometry that depends on the camera alone (major axis and flip, base
plane, s/t grids, the per-slice table except its cull flag, the homography
and the choice of warp order) is computed on the host in float32 and goes
to the device in one copy; the cull flag and the tile occupancy read only
device data.  Nothing in a frame of the kernel paths waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.ops.separable_warp import (
    homography_warp)
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import ao_from_sh
from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, norm3)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.raycast import (
    compute_ao, shade_hits)
from isosurfacesuperresolution_tpu_torch.render.sweep_march import (
    _round, march)
from isosurfacesuperresolution_tpu_torch.render.sweep_tiled import (
    ao_capture_packed, ao_capture_tiled, march_packed, march_tiled,
    per_channel, pick_tile, tile_table)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    SparseBrickGrid)

AnyGrid = Union[BrickGrid, SparseBrickGrid]

_PERMS = ((1, 2, 0), (0, 2, 1), (0, 1, 2))  # axis 0 / 1 / 2 as major (last)
_F32 = torch.float32


def upload(device: torch.device, *arrays: torch.Tensor
           ) -> Tuple[torch.Tensor, ...]:
    """Host float32 tensors -> views of one device buffer, moved in one
    non-blocking copy from pinned memory (no host sync)."""
    flat = torch.cat([a.reshape(-1).to(_F32) for a in arrays])
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    out, i = [], 0
    for a in arrays:
        out.append(flat[i:i + a.numel()].view(a.shape))
        i += a.numel()
    return tuple(out)


class SweepPlan(NamedTuple):
    """Host geometry of one view: everything the march and the warp need
    that depends on the camera alone (float32 CPU tensors)."""

    perm: Tuple[int, int, int]     # volume axes as (x, y, sweep)
    flip: bool                     # march toward -z along the sweep axis
    Z: int                         # volume size along the sweep axis
    zss: int                       # slice planes per voxel
    Sn: int
    Tn: int
    eye_p: torch.Tensor            # (3,) permuted voxel-space eye
    kk: torch.Tensor               # base-plane distance from the eye
    ds: torch.Tensor               # intermediate pixel size along s
    dt: torch.Tensor
    meta: torch.Tensor             # (K, 8), column 4 = validity only
    s_grid: torch.Tensor           # (Sn,)
    t_grid: torch.Tensor           # (Tn,)
    hmat: torch.Tensor             # (3, 3) image -> intermediate pixels
    swap: bool                     # warp the transposed intermediate


def plan_sweep(grid: AnyGrid, cam: CameraParams, cfg: RenderConfig,
               rp: RenderParams) -> SweepPlan:
    """Major axis and flip, base plane, s/t grids, per-slice table and
    homography for ``cam``, in float32 on the host."""
    W, H = cfg.width, cfg.height
    f = cam.look_at_pt - cam.eye
    f = f / torch.linalg.norm(f)
    axis = int(torch.argmax(torch.abs(f)))
    flip = bool(f[axis] < 0)
    tan_half = math.tan(math.radians(cam.fov_y_degrees) / 2.0)
    aspect = W / H
    B = torch.tensor([[2.0 * tan_half * aspect / W, 0.0, -tan_half * aspect],
                      [0.0, -2.0 * tan_half / H, tan_half],
                      [0.0, 0.0, -1.0]], dtype=_F32)
    M = cam.view_matrix()[:3, :3].t() @ B       # (u, v, 1) -> world dirs
    perm = _PERMS[axis]
    eye_p = grid.world_to_voxel(cam.eye)[list(perm)]
    ray_mat = M[list(perm), :]

    res = grid.resolution
    Z = res[perm[2]]
    zss = cfg.sweep_z_supersample
    K = Z * zss
    Sn = int(round(W * cfg.sweep_oversample))
    Tn = int(round(H * cfg.sweep_oversample))
    sigma = -1.0 if flip else 1.0
    iso = torch.tensor(rp.isovalue, dtype=_F32)

    def z_c(m):
        zc = (m + 0.5) / zss
        return Z - zc if flip else zc

    # base plane: entry side, at least half a voxel in front of the eye
    k_min = 0.5
    ez = eye_p[2]
    z_entry = z_c(torch.tensor(0.0, dtype=_F32))
    z_b = ez + sigma * torch.clamp(sigma * (z_entry - ez), min=k_min)
    kk = z_b - ez
    # image corners -> base-plane bounding box of the intermediate grid
    corners = torch.tensor([[0.5, 0.5, 1.0], [W - 0.5, 0.5, 1.0],
                            [0.5, H - 0.5, 1.0], [W - 0.5, H - 0.5, 1.0]],
                           dtype=_F32)
    d_c = corners @ ray_mat.t()
    lam_c = kk / d_c[:, 2]
    s_c = eye_p[0] + d_c[:, 0] * lam_c
    t_c = eye_p[1] + d_c[:, 1] * lam_c
    margin = 2.0
    s_min, s_max = s_c.min() - margin, s_c.max() + margin
    t_min, t_max = t_c.min() - margin, t_c.max() + margin
    ds = (s_max - s_min) / Sn
    dt = (t_max - t_min) / Tn
    s_grid = s_min + (torch.arange(Sn, dtype=_F32) + 0.5) * ds
    t_grid = t_min + (torch.arange(Tn, dtype=_F32) + 0.5) * dt

    zc = z_c(torch.arange(K, dtype=_F32))
    lam = (zc - ez) / kk
    zf = torch.clamp(torch.floor(zc - 0.5), 0, Z - 2)
    fz = torch.clamp(zc - 0.5 - zf, 0.0, 1.0)
    valid = sigma * (zc - ez) > (k_min - 1e-3)
    meta = torch.stack([zc, lam, zf, fz, valid.to(_F32),
                        iso.expand(K), eye_p[0].expand(K),
                        eye_p[1].expand(K)], 1)

    # homography (u_c, v_c, 1) -> intermediate pixel coordinates
    Hs = kk * ray_mat[0] + eye_p[0] * ray_mat[2]
    Ht = kk * ray_mat[1] + eye_p[1] * ray_mat[2]
    Hw = ray_mat[2]
    hmat = torch.stack([(Hs - s_min * Hw) / ds, (Ht - t_min * Hw) / dt, Hw])
    # the two-pass warp degenerates near an axis swap (u driving t): pick
    # the pass order from the center Jacobian
    uc = torch.tensor([W / 2.0, H / 2.0, 1.0], dtype=_F32)
    wgt = hmat[2] @ uc
    s_ctr = (hmat[0] @ uc) / wgt
    t_ctr = (hmat[1] @ uc) / wgt
    dsdu = (hmat[0, 0] - s_ctr * hmat[2, 0]) / wgt
    dsdv = (hmat[0, 1] - s_ctr * hmat[2, 1]) / wgt
    dtdu = (hmat[1, 0] - t_ctr * hmat[2, 0]) / wgt
    dtdv = (hmat[1, 1] - t_ctr * hmat[2, 1]) / wgt
    swap = bool(torch.abs(dsdu * dtdv) < torch.abs(dsdv * dtdu))
    return SweepPlan(perm, flip, Z, zss, Sn, Tn, eye_p, kk, ds, dt, meta,
                     s_grid, t_grid, hmat, swap)


def _dequant_field(ao: torch.Tensor, scale, offset) -> torch.Tensor:
    """Stored (..., 4) SH field -> float32 physical values, per channel."""
    # host scalars per channel: no host-to-device copy in the frame
    scale, offset = per_channel(scale), per_channel(offset)
    return torch.stack([ao[..., c].to(_F32) * scale[c] + offset[c]
                        for c in range(4)], -1)


def fine_ao_field(grid: BrickGrid):
    """The baked field at the volume's resolution as (field, scale,
    offset): a coarse field (``ao_downsample`` > 1) is dequantized and
    upsampled linearly with cell-centered samples (the JAX package's
    ``jax.image.resize(..., "linear")``), with scale 1 and offset 0."""
    if grid.ao_downsample <= 1:
        return grid.ao_sh, grid.ao_scale, grid.ao_offset
    deq = _dequant_field(grid.ao_sh, grid.ao_scale, grid.ao_offset)
    up = F.interpolate(deq.permute(3, 0, 1, 2)[None], size=grid.resolution,
                       mode="trilinear", align_corners=False)
    return up[0].permute(1, 2, 3, 0), 1.0, 0.0


def field_zcxy(ao: torch.Tensor, perm: Tuple[int, int, int]
               ) -> torch.Tensor:
    """An (X, Y, Z, 4) field as a (Z, 4, X, Y) view in the march's order."""
    return ao.permute(perm[2], 3, perm[0], perm[1])


def ao_field_zcxy(grid: BrickGrid, perm: Tuple[int, int, int]
                  ) -> torch.Tensor:
    """The grid's baked SH field for the flat march: at the volume's
    resolution (`fine_ao_field`), a uint8 field dequantized (float32,
    per-channel scale and offset), as a (Z, 4, X, Y) view in the march's
    axis order, as the JAX package's flat path does.  The march copies
    the view into its own contiguous storage."""
    ao, scale, offset = fine_ao_field(grid)
    if ao.dtype == torch.uint8:
        ao = _dequant_field(ao, scale, offset)
    return field_zcxy(ao, perm)


def use_tiled(cfg: RenderConfig, plan: SweepPlan, grid: BrickGrid) -> bool:
    """The JAX package's rule: the tiled march under "sweep_pallas" when
    ``sweep_tile`` > 0, or 0 and the slice plane spans 512 on an axis."""
    X, Y = grid.resolution[plan.perm[0]], grid.resolution[plan.perm[1]]
    tile = cfg.sweep_tile
    return cfg.renderer == "sweep_pallas" and (
        tile > 0 or (tile == 0 and max(X, Y) >= 512))


def _iso_stored(grid: AnyGrid, rp: RenderParams) -> float:
    """The isovalue in the volume's stored units (float32)."""
    iso = torch.tensor(rp.isovalue, dtype=_F32)
    if grid.value_scale != 1.0 or grid.value_offset != 0.0:
        iso = (iso - grid.value_offset) / grid.value_scale
    return iso.item()


def slice_tables(grid: AnyGrid, plan: SweepPlan, rp: RenderParams,
                 vmax_z: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The march's meta, s_grid and t_grid on the grid's device: one copy
    of the host geometry, and the cull flag, the only slice metadata that
    reads the device: ``vmax_z``, the (Z,) per-plane max of the stored
    values, against the isovalue in stored units (uint8 volumes would
    never cull against the physical one)."""
    meta, s_grid, t_grid = upload(grid.device, plan.meta, plan.s_grid,
                                  plan.t_grid)
    zf = meta[:, 2].long()
    smax = torch.maximum(vmax_z[zf], vmax_z[zf + 1]).to(_F32)
    meta[:, 4] *= (smax >= _iso_stored(grid, rp)).to(_F32)
    return meta, s_grid, t_grid


def march_inputs(grid: BrickGrid, plan: SweepPlan, cfg: RenderConfig,
                 rp: RenderParams, use_ao_field: bool = False) -> dict:
    """The keyword arguments of `sweep_march.march` for this view, on the
    grid's device: the `slice_tables`, and with ``use_ao_field`` the
    baked SH field in the march's order."""
    perm = plan.perm
    vmax_z = torch.amax(grid.values,
                        dim=tuple(a for a in range(3) if a != perm[2]))
    meta, s_grid, t_grid = slice_tables(grid, plan, rp, vmax_z)
    return dict(vol_zxy=grid.values.permute(perm[2], perm[0], perm[1]),
                meta=meta, s_grid=s_grid, t_grid=t_grid, Sn=plan.Sn,
                Tn=plan.Tn, dtype=getattr(torch, cfg.sweep_dtype),
                scale=grid.value_scale, offset=grid.value_offset,
                ao_zcxy=ao_field_zcxy(grid, perm) if use_ao_field else None)


def tiled_inputs(grid: BrickGrid, plan: SweepPlan, cfg: RenderConfig,
                 rp: RenderParams) -> dict:
    """The keyword arguments of `sweep_tiled.march_tiled` for this view:
    the flat march's (no AO field) plus the brick pyramid's max in the
    march's axis order, the physical isovalue, the tile and the tile table
    the kernel reads (`grid_tile_table`)."""
    if grid.brick_max is None:
        raise ValueError("the tiled march needs the grid's brick pyramid "
                         "(BrickGrid.from_dense builds it)")
    args = march_inputs(grid, plan, cfg, rp)
    del args["ao_zcxy"]
    tile = cfg.sweep_tile if cfg.sweep_tile > 0 else 256
    X, Y = args["vol_zxy"].shape[1:]
    table = grid_tile_table(grid, plan.perm, X, Y, pick_tile(X, tile),
                            pick_tile(Y, tile), False)
    return dict(args, brick_max_p=grid.brick_max.permute(plan.perm),
                brick_size=grid.brick_size, iso=rp.isovalue, tile=tile,
                table=table)


def packed_inputs(grid: SparseBrickGrid, plan: SweepPlan,
                  cfg: RenderConfig, rp: RenderParams) -> dict:
    """The keyword arguments of `sweep_tiled.march_packed` for this view:
    the packed volume of its axis order, the `slice_tables` (the cull
    reads the packed per-plane max), the brick pyramid's max in the
    march's order, the physical isovalue and the tile table of the
    atlas's tiles (`grid_tile_table`)."""
    pa = grid.per_axis[_PERMS.index(plan.perm)]
    meta, s_grid, t_grid = slice_tables(grid, plan, rp, pa.slice_max)
    _, X, Y = pa.shape
    table = grid_tile_table(grid, plan.perm, X, Y, *pa.tile_shape, False)
    return dict(packed_axis=pa, meta=meta, s_grid=s_grid, t_grid=t_grid,
                Sn=plan.Sn, Tn=plan.Tn,
                brick_max_p=grid.brick_max.permute(plan.perm),
                brick_size=grid.brick_size, iso=rp.isovalue,
                dtype=getattr(torch, cfg.sweep_dtype),
                scale=grid.value_scale, offset=grid.value_offset,
                table=table)


def grid_tile_table(grid: AnyGrid, perm: Tuple[int, int, int], X: int,
                    Y: int, TX: int, TY: int, dilate: bool) -> torch.Tensor:
    """`sweep_tiled.tile_table` of the grid's brick pyramid in the axis
    order ``perm``, built at first use and kept in ``grid.derived``: it
    does not depend on the camera, so a frame makes no table."""
    key = ("tile_table", perm, X, Y, TX, TY, dilate)
    table = grid.derived.get(key)
    if table is None:
        table = grid.derived[key] = tile_table(
            grid.brick_max.permute(perm), grid.brick_size, X, Y, TX, TY,
            dilate)
    return table


def ao_tile_table(grid: BrickGrid, perm: Tuple[int, int, int]
                  ) -> torch.Tensor:
    """The dilated tile table the tiled AO capture reads for the grid's
    field (`grid_tile_table`): tiles of 128 field voxels, the capture's
    default, taken in fine voxels."""
    fd = grid.ao_downsample
    X2, Y2 = (grid.ao_sh.shape[a] for a in perm[:2])
    return grid_tile_table(grid, perm, X2 * fd, Y2 * fd,
                           pick_tile(X2, 128) * fd, pick_tile(Y2, 128) * fd,
                           True)


def scan_march(vol_zxy: torch.Tensor, meta: torch.Tensor,
               s_grid: torch.Tensor, t_grid: torch.Tensor, Sn: int, Tn: int,
               dtype: torch.dtype, scale: float, offset: float,
               iso_stored: float, ao_zcxy: "torch.Tensor | None" = None,
               ao_scale=1.0, ao_offset=0.0, first: int = 0,
               entry: "torch.Tensor | None" = None
               ) -> Tuple[torch.Tensor, ...]:
    """The JAX package's slice scan (``renderer="sweep"``) over the K
    slice planes, in stock PyTorch ops on the tensors' device.

    The march's inputs, except that ``meta`` column 4 holds the validity
    alone: the scan culls a slice itself when its stored max is under
    ``iso_stored``.  Its own rules, where they differ from the kernels':
    a culled slice has F = 0 and an invalid one too, and the crossing test
    runs on every valid slice; the volume is lerped in float32 from its
    stored type and rounded to ``dtype`` after; the AO field (stored type,
    any ``ao_scale``/``ao_offset``) is lerped and resampled in float32
    with the dequant after the lerp.  Returns the march's five outputs and
    sh (4, Sn, Tn) (zeros without a field).  An oracle path: the loop is
    steered from the host.

    A slab of the planes (`parallel.sharded_sweep`): ``first`` is the
    global index of ``meta``'s first row (hits report global indices) and
    ``entry`` the (8,) row of the plane before it, whose F the scan
    starts from (zeros without one, as at the volume's first plane)."""
    Z, X, Y = vol_zxy.shape
    dev = vol_zxy.device
    rows = meta.cpu().tolist()
    vmax = torch.amax(vol_zxy, dim=(1, 2)).to(_F32).cpu().tolist()
    ix = torch.arange(X, dtype=_F32, device=dev)
    iy = torch.arange(Y, dtype=_F32, device=dev)
    zero = torch.zeros((Sn, Tn), dtype=_F32, device=dev)
    m_hit = zero - 1.0
    frac, fm1, g_s, g_t, g_z = (zero.clone() for _ in range(5))
    zero4 = torch.zeros((4, Sn, Tn), dtype=_F32, device=dev)
    sh = zero4
    if ao_zcxy is not None:
        a_scale = torch.tensor(per_channel(ao_scale), device=dev)
        a_off = torch.tensor(per_channel(ao_offset), device=dev)
    def plane(row):
        """(F, sh, valid, iso) of one slice plane."""
        _, lam, zf, fz, valid, iso, eye_s, eye_t = row
        zf = int(zf)
        valid = valid > 0.5
        F_k, sh_k = zero, zero4
        if valid and max(vmax[zf], vmax[zf + 1]) >= iso_stored:
            # interpolation matrices as `ops.separable_warp.interp_matrix`
            p_x = (eye_s + lam * (s_grid - eye_s)) - 0.5
            p_y = (eye_t + lam * (t_grid - eye_t)) - 0.5
            wx = torch.clamp(1.0 - torch.abs(p_x[:, None] - ix), min=0.0)
            wy = torch.clamp(1.0 - torch.abs(p_y[:, None] - iy), min=0.0)
            sl = ((1.0 - fz) * vol_zxy[zf].to(_F32)
                  + fz * vol_zxy[zf + 1].to(_F32)) * scale + offset
            tmp = _round(wx, dtype) @ _round(sl, dtype)
            F_k = _round(tmp, dtype) @ _round(wy, dtype).t()
            if ao_zcxy is not None:
                asl = ((1.0 - fz) * ao_zcxy[zf].to(_F32)
                       + fz * ao_zcxy[zf + 1].to(_F32))
                asl = asl * a_scale[:, None, None] + a_off[:, None, None]
                sh_k = (wx @ asl) @ wy.t()                  # (4, Sn, Tn)
        return F_k, sh_k, valid, iso

    if entry is not None:
        fm1 = plane(entry.tolist())[0]
    for k, row in enumerate(rows):
        F_k, sh_k, valid, iso = plane(row)
        crossing = (m_hit < 0.0) & (F_k >= iso) & valid
        d = F_k - fm1
        denom = torch.where(torch.abs(d) > 1e-12, d, 1e-12)
        new_frac = torch.clamp((iso - fm1) / denom, 0.0, 1.0)
        m_hit = torch.where(crossing, float(first + k), m_hit)
        frac = torch.where(crossing, new_frac, frac)
        g_s = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 0)
                                           - torch.roll(fm1, 1, 0)), g_s)
        g_t = torch.where(crossing, 0.5 * (torch.roll(fm1, -1, 1)
                                           - torch.roll(fm1, 1, 1)), g_t)
        g_z = torch.where(crossing, d, g_z)
        if ao_zcxy is not None:
            sh = torch.where(crossing, sh_k, sh)
        fm1 = F_k
    return m_hit, frac, g_s, g_t, g_z, sh


def _march(grid: AnyGrid, plan: SweepPlan, cfg: RenderConfig,
           rp: RenderParams, use_ao_field: bool):
    """The view's march by the renderer's rule: (m_hit, frac, g_s, g_t,
    g_z, sh or None, s_grid, t_grid) on the grid's device."""
    dtype = getattr(torch, cfg.sweep_dtype)
    perm = plan.perm
    if isinstance(grid, SparseBrickGrid):
        args = packed_inputs(grid, plan, cfg, rp)
        outs = march_packed(**args)
        sh = None
        if use_ao_field:
            sh = ao_capture_packed(
                grid.ao_per_axis[_PERMS.index(perm)], args["meta"],
                args["s_grid"], args["t_grid"], plan.Sn, plan.Tn, outs[0],
                dtype=dtype)
        return (*outs, sh, args["s_grid"], args["t_grid"])
    if cfg.renderer == "sweep":
        meta, s_dev, t_dev = upload(grid.device, plan.meta,
                                    plan.s_grid, plan.t_grid)
        ao, ao_scale, ao_offset = (fine_ao_field(grid) if use_ao_field
                                   else (None, 1.0, 0.0))
        *outs, sh = scan_march(
            grid.values.permute(perm[2], perm[0], perm[1]), meta, s_dev,
            t_dev, plan.Sn, plan.Tn, dtype, grid.value_scale,
            grid.value_offset, _iso_stored(grid, rp),
            None if ao is None else field_zcxy(ao, perm), ao_scale,
            ao_offset)
        return (*outs, sh if use_ao_field else None, s_dev, t_dev)
    if use_tiled(cfg, plan, grid):
        args = tiled_inputs(grid, plan, cfg, rp)
        outs = march_tiled(**args)
        sh = None
        if use_ao_field:
            sh = ao_capture_tiled(
                field_zcxy(grid.ao_sh, perm), args["meta"], args["s_grid"],
                args["t_grid"], plan.Sn, plan.Tn, outs[0],
                args["brick_max_p"], grid.brick_size, rp.isovalue,
                dtype=dtype, ao_scale=grid.ao_scale,
                ao_offset=grid.ao_offset,
                field_downsample=grid.ao_downsample,
                table=ao_tile_table(grid, perm))
        return (*outs, sh, args["s_grid"], args["t_grid"])
    args = march_inputs(grid, plan, cfg, rp, use_ao_field)
    outs = march(**args)
    sh = outs[5] if use_ao_field else None
    return (*outs[:5], sh, args["s_grid"], args["t_grid"])


def finish_sweep(grid: AnyGrid, plan: SweepPlan, cam: CameraParams,
                 cam_flow: CameraParams, cfg: RenderConfig,
                 rp: RenderParams, use_ao_field: bool, marched
                 ) -> torch.Tensor:
    """The G-buffer from a march's outputs ``marched`` = (m_hit, frac,
    g_s, g_t, g_z, sh, s_grid, t_grid): hit points and normals by the
    chain rule through the shear, AO, shading, the homography warp and
    the post-warp fixups, on the march's device."""
    W, H = cfg.width, cfg.height
    m_hit, frac, g_s, g_t, g_z, sh, s_dev, t_dev = marched
    dev = m_hit.device
    found = m_hit >= 0.0
    perm, zss, Z, flip = plan.perm, plan.zss, plan.Z, plan.flip
    sigma = -1.0 if flip else 1.0

    # ---- hit positions and normals (chain rule through the shear) -----
    e0, e1, e2 = plan.eye_p.tolist()
    kk_, ds_, dt_ = plan.kk.item(), plan.ds.item(), plan.dt.item()
    zc_star = (m_hit - 1.0 + frac + 0.5) / zss
    if flip:
        zc_star = Z - zc_star
    lam_star = (zc_star - e2) / kk_
    xs = e0 + lam_star * (s_dev[:, None] - e0)
    ys = e1 + lam_star * (t_dev[None, :] - e1)
    lam_safe = torch.where(torch.abs(lam_star) > 1e-6, lam_star, 1e-6)
    dz_dm = (torch.tensor(sigma, dtype=_F32)
             * torch.tensor(1.0 / zss, dtype=_F32)).item()
    Vx = g_s / (lam_safe * ds_)
    Vy = g_t / (lam_safe * dt_)
    rel_z = zc_star - e2
    rel_z = torch.where(torch.abs(rel_z) > 1e-6, rel_z, 1e-6)
    Vz = g_z / dz_dm - Vx * (xs - e0) / rel_z - Vy * (ys - e1) / rel_z

    inv = [0, 0, 0]
    for i, a in enumerate(perm):
        inv[a] = i
    hit_p = (xs, ys, zc_star.expand_as(xs))
    grad_p = (Vx, Vy, Vz)
    hit_vox = torch.stack([hit_p[inv[a]] for a in range(3)], -1)
    grad = torch.stack([grad_p[inv[a]] for a in range(3)], -1)
    gnorm = torch.sqrt(torch.clamp(torch.sum(grad * grad, -1, keepdim=True),
                                   min=1e-12))
    normal_w = -grad / gnorm
    hit_world = grid.voxel_to_world(hit_vox)
    flat_hit = found.reshape(-1)
    if use_ao_field:
        # baked SH-L1 occlusion captured at the hit plane
        ao = ao_from_sh(sh.permute(1, 2, 0), normal_w).reshape(-1)
    elif cfg.ao_samples > 0:
        # hemisphere rays from the hits (`raycast.compute_ao`), the
        # rotation noise indexed by the intermediate grid's (t, s)
        sn, tn = torch.meshgrid(torch.arange(plan.Sn, device=dev),
                                torch.arange(plan.Tn, device=dev),
                                indexing="ij")
        pix = torch.stack([tn.reshape(-1), sn.reshape(-1)], -1)
        eye = cam.eye.tolist()
        flat_world = hit_world.reshape(-1, 3)
        dirs = torch.stack([flat_world[:, i] - eye[i] for i in range(3)],
                           -1)
        dirs = dirs / torch.clamp(norm3(dirs)[:, None], min=1e-12)
        ao = compute_ao(grid, hit_vox.reshape(-1, 3), normal_w.reshape(-1, 3),
                        dirs, flat_hit, pix, cfg, float(grid.voxel_size[0]),
                        isovalue=rp.isovalue)
    else:
        ao = torch.ones_like(flat_hit, dtype=_F32)
    inter = shade_hits(hit_world.reshape(-1, 3), normal_w.reshape(-1, 3),
                       flat_hit, ao, cam, cam_flow, cfg, W, H,
                       rp=rp).reshape(plan.Sn, plan.Tn, 12)

    if plan.swap:
        out = homography_warp(inter.permute(1, 0, 2), plan.hmat[[1, 0, 2]],
                              (W, H))
    else:
        out = homography_warp(inter, plan.hmat, (W, H))     # (W, H, 12)
    out = out.permute(1, 0, 2)                               # (H, W, 12)

    # post-warp fixups: binarize the mask, re-mask the silhouette blend,
    # renormalize normals, ao = 1 outside
    m_bin = out[..., 3:4] > 0.5
    mvec = m_bin.to(_F32)
    msafe = torch.clamp(out[..., 3:4], min=0.5)
    nrm = out[..., 4:7] / msafe
    nlen = torch.sqrt(torch.clamp(torch.sum(nrm * nrm, -1, keepdim=True),
                                  min=1e-12))
    nrm = torch.where(m_bin, nrm / nlen, 0.0)
    frame = torch.cat([
        out[..., 0:3] / msafe * mvec,
        mvec,
        nrm,
        out[..., 7:8] / msafe * mvec,
        out[..., 8:10] / msafe * mvec,
        torch.where(m_bin, torch.clamp(out[..., 10:11], 0.0, 1.0), 1.0),
        torch.ones_like(mvec),
    ], -1)

    if cfg.viewport is not None:
        x0, y0, x1, y1 = cfg.viewport
        xx = torch.arange(W, device=dev)[None, :, None]
        yy = torch.arange(H, device=dev)[:, None, None]
        in_vp = ((xx >= x0) & (yy >= y0) & (xx < x1) & (yy < y1)).to(_F32)
        keep_ao = torch.where(in_vp > 0, frame[..., 10:11], 1.0)
        frame = torch.cat([frame[..., :10] * in_vp, keep_ao,
                           frame[..., 11:12]], -1)
    return frame


def render_gbuffer_sweep(grid: AnyGrid, cam: CameraParams,
                         cam_flow: CameraParams, cfg: RenderConfig,
                         rp: "RenderParams | None" = None) -> torch.Tensor:
    """Sweep-rendered (H, W, 12) G-buffer on the grid's device; the
    channel contract of the JAX package's `render_gbuffer`.  A
    `SparseBrickGrid` is refused where the JAX package refuses it: by any
    renderer but "sweep_pallas", and with AO but from its packed field."""
    if cfg.renderer not in ("sweep", "sweep_pallas"):
        raise ValueError(f"unknown or unported renderer {cfg.renderer!r}")
    packed = isinstance(grid, SparseBrickGrid)
    has_baked = (grid.ao_per_axis is not None if packed
                 else grid.ao_sh is not None)
    use_ao_field = (cfg.ao_samples > 0 and has_baked
                    and cfg.ao_mode in ("auto", "volume"))
    if cfg.ao_mode == "volume" and cfg.ao_samples > 0 and not has_baked:
        raise ValueError("ao_mode='volume' needs a baked occlusion field; "
                         "call render.ao_sweep.attach_baked_ao(grid, "
                         "isovalue, ao_radius)"
                         + (" before packing (SparseBrickGrid.from_brick_"
                            "grid packs it per axis)" if packed else ""))
    if packed and cfg.renderer != "sweep_pallas":
        raise ValueError("SparseBrickGrid requires renderer='sweep_pallas' "
                         "(the tiled atlas kernel); densify with "
                         "grid.to_brick_grid() for the scan/march paths")
    if packed and cfg.ao_samples > 0 and not use_ao_field:
        raise ValueError("hemisphere-ray AO needs dense values; set "
                         "ao_samples=0, bake AO before packing "
                         "(attach_baked_ao + from_brick_grid), or densify "
                         "with grid.to_brick_grid()")
    if rp is None:
        rp = RenderParams.from_config(cfg)
    plan = plan_sweep(grid, cam, cfg, rp)
    return finish_sweep(grid, plan, cam, cam_flow, cfg, rp, use_ao_field,
                        _march(grid, plan, cfg, rp, use_ao_field))
