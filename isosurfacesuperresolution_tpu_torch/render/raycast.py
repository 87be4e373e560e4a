"""The per-ray march oracle, hemisphere-ray AO and the G-buffer assembly.

Counterpart of the JAX package's `render/raycast.py`:

* `march_rays`: rays march on the lattice t = step * k from the snapped
  box entry, skipping bricks whose max (the grid's brick pyramid) cannot
  reach the isovalue, and a hit is refined by a binary search to the
  sample just outside the surface;
* `gradient_normal`, `compute_ao` (the reference's world-space ray AO: a
  cosine-weighted hemisphere of rays from each hit, with a per-pixel
  rotation from a 4x4 table) and `ao_tables`, drawn as the JAX package
  draws them (`utils/jax_prng`);
* `render_gbuffer`, the whole march-rendered G-buffer (``renderer=
  "march"``); `shade_hits` (Phong shading, screen-space flow, NDC depth
  and view-space normals from hit records), shared with the sweep
  renderer; `gbuffer_to_low_input`, `gbuffer_to_high_target` and
  `gbuffer_flow`, the training tensors.

All rays march together as tensor lanes in stock PyTorch ops on the
grid's device.  A dead ray never changes state, so the host checks for
live rays only every few chunks of steps: that gives the JAX package's
loop's result.  An oracle path, steered from the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    _smoothstep_1_0)
from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, norm3, project)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.utils import jax_prng
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid

_F32 = torch.float32
# chunks of ``unroll`` steps between two host checks for live rays
CHECK_EVERY = 4
# lanes of one batch of AO rays (hits x samples)
AO_LANES = 1 << 22


def _unit(v) -> list:
    n = math.sqrt(sum(float(x) * float(x) for x in v))
    n = max(n, 1e-12)
    return [float(x) / n for x in v]


def shade_hits(hit_world: torch.Tensor, normal_w: torch.Tensor,
               hit: torch.Tensor, ao: torch.Tensor,
               cam: CameraParams, cam_flow: CameraParams,
               cfg: RenderConfig, width: int, height: int,
               rp: "RenderParams | None" = None) -> torch.Tensor:
    """(N, 12) G-buffer rows from hit_world (N, 3), normal_w (N, 3),
    hit (N,) bool and ao (N,): [0:3] Phong RGB, [3] mask, [4:7] view-space
    normal, [7] NDC depth, [8:10] flow w.r.t. ``cam_flow``, [10] ao,
    [11] shadow (1)."""
    if rp is None:
        rp = RenderParams.from_config(cfg)
    if cfg.camera_light:
        light = (cam.look_at_pt - cam.eye)
        light = (light / torch.clamp(torch.linalg.norm(light), min=1e-12)
                 ).tolist()
    else:
        light = _unit(rp.light_direction)
    eye = cam.eye.tolist()

    eyedir = torch.stack([eye[i] - hit_world[:, i] for i in range(3)], -1)
    eyedir = eyedir / torch.clamp(
        torch.linalg.norm(eyedir, dim=-1, keepdim=True), min=1e-12)
    ndotl = (normal_w[:, 0:1] * light[0] + normal_w[:, 1:2] * light[1]
             + normal_w[:, 2:3] * light[2])
    # reflect(light, n) = light - 2 n (n . light)
    refl = torch.stack([light[i] - 2.0 * normal_w[:, i] * ndotl[:, 0]
                        for i in range(3)], -1)
    refl = refl / torch.clamp(
        torch.linalg.norm(refl, dim=-1, keepdim=True), min=1e-12)
    rdotv = torch.clamp(torch.sum(refl * eyedir, -1, keepdim=True), min=0.0)
    # the reference's data-generation kernel uses 3.41 where pi is meant;
    # kept for numeric parity with its data
    spec_norm = (rp.specular_exponent + 2) / (2 * 3.41)
    amb, dif, spc = rp.ambient_color, rp.diffuse_color, rp.specular_color
    abs_ndotl = torch.abs(ndotl)
    spec = torch.pow(rdotv, rp.specular_exponent)
    color = torch.cat([amb[i] + dif[i] * abs_ndotl
                       + (spc[i] * spec_norm) * spec for i in range(3)], -1)

    ndc_cur = project(cam.mvp(width, height), hit_world)
    ndc_flow = project(cam_flow.mvp(width, height), hit_world)
    # hits near a camera's w=0 plane would emit inf/NaN flow: clamp
    flow = torch.nan_to_num(torch.clamp(
        0.5 * (ndc_cur[:, :2] - ndc_flow[:, :2]), -4.0, 4.0))
    depth = torch.nan_to_num(torch.clamp(ndc_cur[:, 2], -10.0, 10.0))
    nm = cam.normal_matrix().tolist()
    normal_vs = torch.stack([normal_w[:, 0] * r[0] + normal_w[:, 1] * r[1]
                             + normal_w[:, 2] * r[2] for r in nm], -1)

    m = hit.to(torch.float32)
    mc = m[:, None]
    return torch.cat([
        color * mc,
        mc,
        normal_vs * mc,
        (depth * m)[:, None],
        flow * mc,
        torch.where(hit, ao, 1.0)[:, None],
        torch.ones_like(mc),
    ], -1)


def gbuffer_to_low_input(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 12) G-buffer -> (H, W, 5) network input
    [mask in [-1, 1], nx, ny, nz, depth]."""
    mask = frame[..., 3:4] * 2.0 - 1.0
    return torch.cat([mask, frame[..., 4:7], frame[..., 7:8]], -1)


def gbuffer_to_high_target(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 12) G-buffer -> (H, W, 6) training target
    [mask in [-1, 1], nx, ny, nz, depth, ao]."""
    mask = frame[..., 3:4] * 2.0 - 1.0
    return torch.cat([mask, frame[..., 4:7], frame[..., 7:8],
                      frame[..., 10:11]], -1)


def gbuffer_flow(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 12) G-buffer -> its (H, W, 2) screen-space flow."""
    return frame[..., 8:10]


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------

def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with components under 1e-12 in size taken as +-1e-12."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12), d)


def _ray_box_range(origin_vox: torch.Tensor, dirs_vox: torch.Tensor,
                   res: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entry and exit distances (voxel units) of rays (origin (3,) or
    (N, 3), normalized dirs (N, 3)) against the box [0, res]."""
    inv = _safe_inv(dirs_vox)
    t_lo = (0.0 - origin_vox) * inv
    t_hi = torch.stack([float(res[a]) - origin_vox[..., a]
                        for a in range(3)], -1) * inv
    t0 = torch.amax(torch.minimum(t_lo, t_hi), -1)
    t1 = torch.amin(torch.maximum(t_lo, t_hi), -1)
    return t0, t1


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a host number."""
    return float(np.float32(x))


def _march_chunk(grid: BrickGrid, st: dict, iso: float, step: float,
                 unroll: int) -> None:
    """``unroll`` lattice steps of the lanes in ``st`` (in place): sample,
    test, skip empty bricks.  Reads nothing back to the host."""
    bsize = float(grid.brick_size)
    o, d, inv, pos = st["o"], st["d"], st["inv"], st["pos"]
    t, t1, alive, hit, t_hit = (st[k] for k in
                                ("t", "t1", "alive", "hit", "t_hit"))
    for _ in range(unroll):
        p = o + t[:, None] * d
        brick_active = grid.brick_max_at(p) >= iso
        value = grid.sample_trilinear(p)
        new_hit = alive & brick_active & (value >= iso)
        # empty-brick skip: the first lattice point beyond the brick exit
        boundary = (torch.floor(p / bsize) + pos) * bsize
        t_exit = torch.amin((boundary - o) * inv, -1)
        n_skip = torch.clamp(torch.ceil((t_exit + 1e-4 - t) / step),
                             min=1.0)
        dt = torch.where(brick_active, step, n_skip * step)
        t_hit = torch.where(new_hit, t, t_hit)
        hit = hit | new_hit
        t_next = t + dt
        alive = alive & ~new_hit & (t_next <= t1)
        t = torch.where(alive, t_next, t)
    st.update(t=t, alive=alive, hit=hit, t_hit=t_hit)


def march_rays(grid: BrickGrid, origin_vox: torch.Tensor,
               dirs_vox: torch.Tensor, isovalue: float, step: float,
               max_steps: int, binary_search_steps: int = 10,
               unroll: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """March rays through the volume: (hit (N,) bool, t_hit (N,)) in
    voxel units, on the grid's device.

    ``origin_vox`` (3,) or (N, 3), ``dirs_vox`` (N, 3) normalized.  The
    first sample is snapped onto the lattice, ``step * ceil(t_start /
    step)``; the loop runs at most ``(max_steps // unroll + 1) * unroll``
    steps (a ray still alive then is a miss).  t_hit is the refined
    distance of the closest sample just outside the surface
    (``binary_search_steps`` halvings of the last lattice step; 0 keeps
    the lattice hit, as AO rays do), or the box exit for a miss."""
    dev = grid.values.device
    iso = _f32(isovalue)
    step = _f32(step)
    dirs = dirs_vox.to(dev)
    n = dirs.shape[0]
    o = origin_vox.to(dev).expand(n, 3)
    t0, t1 = _ray_box_range(o, dirs, grid.resolution)
    t_start = torch.clamp(t0, min=0.0)
    t_init = step * torch.ceil(t_start / step)
    st = dict(o=o, d=dirs, inv=_safe_inv(dirs), pos=(dirs > 0).to(_F32),
              t=t_init, t1=t1, alive=(t1 > t_start) & (t_init <= t1),
              hit=torch.zeros(n, dtype=torch.bool, device=dev),
              t_hit=t1.clone())
    cap = max_steps // unroll + 1
    done = 0
    while done < cap:
        chunks = min(CHECK_EVERY, cap - done)
        for _ in range(chunks):
            _march_chunk(grid, st, iso, step, unroll)
        done += chunks
        if not bool(st["alive"].any()):
            break
    hit, t_hit = st["hit"], st["t_hit"]

    if binary_search_steps > 0:
        # bracket: the sample one lattice step before the hit is outside
        # (sampled < iso, or in a skipped brick whose max < iso)
        idx = torch.nonzero(hit)[:, 0]
        oh = o[idx] if origin_vox.dim() > 1 else o[:1]
        dh = dirs[idx]
        t_up = t_hit[idx]
        t_lo = t_up - step
        for _ in range(binary_search_steps):
            t_mid = 0.5 * (t_lo + t_up)
            inside = grid.sample_trilinear(oh + t_mid[:, None] * dh) >= iso
            t_up = torch.where(inside, t_mid, t_up)
            t_lo = torch.where(inside, t_lo, t_mid)
        t_hit = t_hit.clone()
        t_hit[idx] = t_lo
    return hit, t_hit


def gradient_normal(grid: BrickGrid, vox: torch.Tensor,
                    offset: float = 0.5) -> torch.Tensor:
    """Central-difference surface normal at voxel coordinates (..., 3):
    the negated gradient (from high density to low), normalized, with
    samples at +-``offset`` voxels; 0 where its norm is 1e-6 or less."""
    def diff(axis):
        lo, hi = vox.clone(), vox.clone()
        lo[..., axis] -= offset
        hi[..., axis] += offset
        return grid.sample_trilinear(lo) - grid.sample_trilinear(hi)

    g = torch.stack([diff(0), diff(1), diff(2)], -1)
    norm = norm3(g)[..., None]
    return torch.where(norm > 1e-6, g / torch.clamp(norm, min=1e-12), 0.0)


# ---------------------------------------------------------------------------
# Ambient occlusion (the reference's ray-sampled mode)
# ---------------------------------------------------------------------------

def ao_tables(num_samples: int, rotations: int, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-weighted hemisphere directions (num_samples, 3) and 2D
    random rotation vectors (rotations^2, 3), float32 on the host, equal
    bit for bit to the JAX package's (its ``jax.random`` draws, its
    float32 maths; `utils/jax_prng`)."""
    k1, k2, k3 = jax_prng.split(jax_prng.prng_key(seed), 3)
    u1 = jax_prng.uniform(k1, (num_samples,))
    u2 = jax_prng.uniform(k2, (num_samples,))
    f = np.float32
    r = np.sqrt(u1)
    theta = f(2.0 * math.pi) * u2
    hemi = np.stack([r * jax_prng.cosf(theta), r * jax_prng.sinf(theta),
                     np.sqrt(f(1.0) - u1)], -1)
    hemi = hemi / _np_norm(hemi)
    xy = jax_prng.uniform(k3, (rotations * rotations, 2)) * f(2.0) - f(1.0)
    xy = xy / np.maximum(_np_norm(xy), f(1e-6))
    rot = np.concatenate([xy, np.zeros((rotations * rotations, 1), f)], -1)
    return hemi, rot


def _np_norm(v: np.ndarray) -> np.ndarray:
    """float32 length over the last axis, summed in order, (..., 1)."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i] * v[..., i]
    return np.sqrt(acc)[..., None]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def compute_ao(grid: BrickGrid, hit_pos_vox: torch.Tensor,
               normals: torch.Tensor, ray_dirs: torch.Tensor,
               hit_mask: torch.Tensor, pixel_xy: torch.Tensor,
               cfg: RenderConfig, voxel_size: float,
               isovalue: "float | None" = None) -> torch.Tensor:
    """World-space hemisphere-ray AO (N,) of hits at ``hit_pos_vox``
    (N, 3) with world normals (N, 3), primary ray directions (N, 3),
    ``hit_mask`` (N,) and integer pixel coordinates ``pixel_xy`` (N, 2)
    (the rotation noise is ``rots[x % R + R * (y % R)]``); 1 where
    ``hit_mask`` is false.  Each sample ray starts ``ao_bias`` (world)
    back along the primary ray and marches ``ao_ray_steps`` lattice steps
    without refinement; a secondary hit at world distance d contributes
    smoothstep(1, 0, ao_radius / d), a miss 1, summed in table order.
    Only the lanes of ``hit_mask`` march (the others' AO is 1 anyway)."""
    dev = grid.values.device
    n_all = hit_pos_vox.shape[0]
    ones = torch.ones(n_all, dtype=_F32, device=dev)
    if cfg.ao_samples <= 0:
        return ones
    isovalue = cfg.isovalue if isovalue is None else isovalue
    R = cfg.ao_rotations
    hemi, rots = ao_tables(cfg.ao_samples, R)
    idx = torch.nonzero(hit_mask.to(dev))[:, 0]
    if idx.numel() == 0:
        return ones
    px = pixel_xy.to(dev)[idx]
    noise = torch.from_numpy(rots).to(dev)[px[:, 0] % R + R * (px[:, 1] % R)]
    nrm = normals.to(dev)[idx]
    tangent = noise - nrm * _dot3(noise, nrm)[:, None]
    tlen = norm3(tangent)[:, None]
    # a rotation vector parallel to the normal: project x instead
    fallback = torch.stack([1.0 - nrm[:, 0] * nrm[:, 0],
                            0.0 - nrm[:, 1] * nrm[:, 0],
                            0.0 - nrm[:, 2] * nrm[:, 0]], -1)
    tangent = torch.where(
        tlen > 1e-6, tangent / torch.clamp(tlen, min=1e-12),
        fallback / torch.clamp(norm3(fallback)[:, None], min=1e-12))
    bitangent = _cross(nrm, tangent)

    vsize = np.float32(voxel_size)
    bias_vox = float(np.float32(cfg.ao_bias) / vsize)
    origin = hit_pos_vox.to(dev)[idx] - bias_vox * ray_dirs.to(dev)[idx]
    n = idx.numel()
    acc = torch.zeros(n, dtype=_F32, device=dev)
    batch = max(1, AO_LANES // n)
    for s0 in range(0, cfg.ao_samples, batch):
        s = hemi[s0:s0 + batch]
        # world direction = [tangent | bitangent | normal] @ s, per sample
        d = torch.cat([tangent * float(a) + bitangent * float(b)
                       + nrm * float(c) for a, b, c in s.tolist()])
        d = d / torch.clamp(norm3(d)[:, None], min=1e-12)
        hit2, t2 = march_rays(grid, origin.repeat(len(s), 1), d, isovalue,
                              cfg.step_voxels, cfg.ao_ray_steps,
                              binary_search_steps=0)
        dist = torch.clamp(t2 * float(vsize), min=1e-12)
        contrib = torch.where(
            hit2, _smoothstep_1_0(torch.full_like(dist, _f32(cfg.ao_radius))
                                  / dist), 1.0).reshape(len(s), n)
        for row in contrib:
            acc = acc + row
    ones[idx] = acc / cfg.ao_samples
    return ones


# ---------------------------------------------------------------------------
# The march-rendered G-buffer
# ---------------------------------------------------------------------------

def render_gbuffer(grid: BrickGrid, cam: CameraParams,
                   cam_flow: CameraParams, cfg: RenderConfig,
                   rp: "RenderParams | None" = None) -> torch.Tensor:
    """The (H, W, 12) G-buffer of ``renderer="march"`` on the grid's
    device: one ray per pixel centre, the binary-search-refined hit,
    central-difference normals, hemisphere-ray AO (``ao_samples`` > 0)
    and viewport clipping (hits outside ``cfg.viewport`` are background).
    ``cam_flow`` is the camera the flow refers to (the previous one in
    the interactive app)."""
    if rp is None:
        rp = RenderParams.from_config(cfg)
    dev = grid.values.device
    H, W = cfg.height, cfg.width
    eye, dirs = cam.pixel_rays(W, H, device=dev)
    dirs = dirs.reshape(-1, 3)
    vsize = float(grid.voxel_size[0])
    origin_vox = grid.world_to_voxel(eye)
    hit, t_hit = march_rays(grid, origin_vox, dirs, rp.isovalue,
                            cfg.step_voxels, cfg.max_march_steps,
                            cfg.binary_search_steps)
    hit_vox = origin_vox.to(dev) + t_hit[:, None] * dirs
    hit_world = grid.voxel_to_world(hit_vox)
    normal_w = gradient_normal(grid, hit_vox)

    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    xx, yy = xx.reshape(-1), yy.reshape(-1)
    if cfg.viewport is not None:
        x0, y0, x1, y1 = cfg.viewport
        hit = hit & (xx >= x0) & (yy >= y0) & (xx < x1) & (yy < y1)
    ao = compute_ao(grid, hit_vox, normal_w, dirs, hit,
                    torch.stack([xx, yy], -1), cfg, vsize,
                    isovalue=rp.isovalue)
    return shade_hits(hit_world, normal_w, hit, ao, cam, cam_flow, cfg, W,
                      H, rp=rp).reshape(H, W, 12)
