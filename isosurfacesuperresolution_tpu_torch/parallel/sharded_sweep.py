"""Volume-sharded sweep rendering: slab decomposition and halo exchange.

Counterpart of the JAX package's `parallel/sharded_sweep.py`.  A volume
too large to replicate is cut into slabs along the view's sweep axis, one
slab a rank (zero-padded when the axis does not divide).  The grid may
stay on the host: each rank copies only its slab (and its slab of a baked
occlusion field) to its own device, so a rank's device holds about 1/D of
the volume, as JAX's slab-sharded ``device_put`` leaves it.  Each rank
scans only its slab's slice planes (`render.sweep.scan_march`, the JAX
package's slice scan in stock ops, started from the plane before its
slab), after an exchange of ``HALO`` boundary slices with each neighbour
by point-to-point sends (JAX's ``ppermute``; the ends of the volume get
zeros).  Slice indices stay global, so the first hit is the minimum over
the slabs: one all-reduce MIN of the hit index, then one all-reduce SUM
of the winner-masked payload (fraction, the three gradients and the SH
occlusion sample) gives every rank the winning slab's values, and no rank
holds a buffer that grows with the number of ranks (JAX's rule: no
all-gather).  A baked occlusion field is cut in the same slabs.  The
shading, homography and fixups then run on every rank on image-sized
buffers (`render.sweep.finish_sweep`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.parallel.mesh import local_device
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    _dequant_field, field_zcxy, fine_ao_field, finish_sweep, plan_sweep,
    scan_march, upload)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid

HALO = 2          # slices each side: the resample reads floor(zc - 0.5) + 1
_F32 = torch.float32


def exchange_halo(local: torch.Tensor, group, d: int, D: int
                  ) -> torch.Tensor:
    """(Zl, ...) slab -> (Zl + 2 HALO, ...): ``HALO`` slices from the
    previous rank before it and from the next one after it, by
    point-to-point sends; zeros at the ends of the volume."""
    if local.shape[0] < HALO:
        raise ValueError(f"slabs of {local.shape[0]} slices are thinner "
                         f"than the halo ({HALO})")
    from_prev = torch.zeros_like(local[:HALO])
    from_next = torch.zeros_like(local[:HALO])
    ops = []
    if d > 0:
        prev = dist.get_global_rank(group, d - 1)
        ops += [dist.P2POp(dist.isend, local[:HALO].contiguous(), prev,
                           group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    if d < D - 1:
        nxt = dist.get_global_rank(group, d + 1)
        ops += [dist.P2POp(dist.isend, local[-HALO:].contiguous(), nxt,
                           group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_prev, local, from_next])


def _slab_rows(plan, z0: int, Zl: int, iso: float) -> Tuple[torch.Tensor,
                                                             int]:
    """The scan's (K, 8) table for the slab's planes, one row before
    them first (the entry plane), z indices local to the halo'd slab;
    and the slab's first global plane index."""
    Z, zss = plan.Z, plan.zss
    K_global = Z * zss
    m_start = ((Z - z0 - Zl) if plan.flip else z0) * zss
    m = torch.arange(m_start - 1, m_start + Zl * zss, dtype=_F32)
    zc = (m + 0.5) / zss
    if plan.flip:
        zc = Z - zc
    ez = plan.eye_p[2]
    sigma = -1.0 if plan.flip else 1.0
    lam = (zc - ez) / plan.kk
    zf_g = torch.clamp(torch.floor(zc - 0.5), 0, Z - 2)
    zf = torch.clamp(zf_g - z0 + HALO, 0, Zl + 2 * HALO - 2)
    fz = torch.clamp(zc - 0.5 - zf_g, 0.0, 1.0)
    valid = ((sigma * (zc - ez) > (0.5 - 1e-3)) & (m > -1e-3)
             & (m < K_global - 1 + 1e-3))
    n = m.shape[0]
    rows = torch.stack([zc, lam, zf, fz, valid.to(_F32),
                        torch.full((n,), iso, dtype=_F32),
                        plan.eye_p[0].expand(n), plan.eye_p[1].expand(n)], 1)
    return rows, m_start


def render_gbuffer_sweep_sharded(grid: BrickGrid, cam: CameraParams,
                                 cam_flow: CameraParams, cfg: RenderConfig,
                                 mesh, axis_name: str = "z"
                                 ) -> torch.Tensor:
    """Slab-sharded sweep -> the (H, W, 12) G-buffer on every rank of
    ``mesh``'s ``axis_name`` dimension, on the rank's device
    (`parallel.mesh.local_device`).  ``grid`` may lie on the host or on
    that device; only the rank's slab of it is copied to the device.

    With ``cfg.ao_samples`` > 0 the grid must carry a baked occlusion
    field (`render.ao_sweep.attach_baked_ao`), cut in the same slabs."""
    use_ao = cfg.ao_samples > 0
    if use_ao and grid.ao_sh is None:
        raise ValueError("sharded sweep with AO needs a baked occlusion "
                         "field; call render.ao_sweep.attach_baked_ao")
    group = mesh.get_group(axis_name)
    D, d = dist.get_world_size(group), dist.get_rank(group)
    rp = RenderParams.from_config(cfg)
    plan = plan_sweep(grid, cam, cfg, rp)
    perm, Z = plan.perm, plan.Z
    Zl = -(-Z // D)                    # slabs zero-padded past Z
    z0 = d * Zl

    dev = local_device()

    def slab(zxy: torch.Tensor) -> torch.Tensor:
        """This rank's Zl planes of a (Z, ...) view, on its device."""
        part = zxy[min(z0, Z):min(z0 + Zl, Z)].to(dev)
        pad = Zl - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
        return part.contiguous()

    values = grid.dequant(slab(grid.values.permute(perm[2], perm[0],
                                                   perm[1])))
    values_halo = exchange_halo(values, group, d, D)
    ao_halo = None
    if use_ao:
        ao, scale, offset = fine_ao_field(grid)
        ao = _dequant_field(slab(field_zcxy(ao, perm)).permute(0, 2, 3, 1),
                            scale, offset).permute(0, 3, 1, 2)
        ao_halo = exchange_halo(ao.contiguous(), group, d, D)

    rows, m_start = _slab_rows(plan, z0, Zl, rp.isovalue)
    rows, s_grid, t_grid = upload(dev, rows, plan.s_grid,
                                  plan.t_grid)
    # the plane before the slab starts the scan; at the volume's first
    # plane there is none, and the scan starts from zeros
    m_hit, frac, g_s, g_t, g_z, sh = scan_march(
        values_halo, rows[1:], s_grid, t_grid, plan.Sn, plan.Tn,
        getattr(torch, cfg.sweep_dtype), 1.0, 0.0, rp.isovalue,
        ao_zcxy=ao_halo, first=m_start,
        entry=rows[0] if m_start > 0 else None)

    # first-hit combine: the slabs' plane ranges are disjoint, so the
    # smallest hit index is unique; its slab's payload survives the mask
    m_inf = torch.where(m_hit < 0.0, torch.inf, m_hit)
    dist.all_reduce(m_inf, op=dist.ReduceOp.MIN, group=group)
    hit = torch.isfinite(m_inf)
    win = ((m_hit == m_inf) & hit).to(_F32)
    payload = torch.cat([torch.stack([frac, g_s, g_t, g_z]), sh]) * win
    dist.all_reduce(payload, op=dist.ReduceOp.SUM, group=group)
    m_hit = torch.where(hit, m_inf, -1.0)
    frac, g_s, g_t, g_z = payload[:4]
    return finish_sweep(grid, plan, cam, cam_flow, cfg, rp, use_ao,
                        (m_hit, frac, g_s, g_t, g_z, payload[4:], s_grid,
                         t_grid))
