"""G-buffer assembly shared by the renderers.

Counterpart of two functions of the JAX package's `render/raycast.py`:
`shade_hits` (Phong shading, screen-space flow, NDC depth and view-space
normals from hit records) and `gbuffer_to_low_input`.  The per-ray march
and the ray-AO path wait for a later slice.
"""

from __future__ import annotations

import math

import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render.camera import (
    CameraParams, project)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams


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
