"""Renderer entry point: one G-buffer for a concrete camera.

Counterpart of the JAX package's `render/api.py`: ``renderer`` "sweep" or
"sweep_pallas" renders with the shear-warp sweep (`render/sweep.py`),
"march" with the per-ray march oracle (`render/raycast.render_gbuffer`).
"""

from __future__ import annotations

import math

import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.raycast import render_gbuffer
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid


def adaptive_sweep_cfg(cam: CameraParams, cfg: RenderConfig
                       ) -> RenderConfig:
    """View-adaptive intermediate-grid oversampling: scale the grid by the
    view's obliquity to the sweep axis (1/max|f_hat|), bucketed to 0.5
    steps and capped at ``sweep_max_oversample``."""
    if not cfg.sweep_adaptive_oversample:
        return cfg
    f = (cam.look_at_pt.to(torch.float64) - cam.eye.to(torch.float64))
    n = float(torch.linalg.norm(f))
    if n == 0.0:
        return cfg
    c = float(torch.max(torch.abs(f))) / n
    ov = cfg.sweep_oversample + 2.7 * (1.0 / max(c, 1e-6) - 1.0)
    ov = min(ov, cfg.sweep_max_oversample)
    ov = float(math.ceil(ov / 0.5) * 0.5)
    if ov <= cfg.sweep_oversample:
        return cfg
    return cfg.replace(sweep_oversample=ov)


def render_frame_gbuffer(grid: BrickGrid, cam: CameraParams,
                         cam_flow: CameraParams, cfg: RenderConfig,
                         rp: "RenderParams | None" = None) -> torch.Tensor:
    """Render one (H, W, 12) G-buffer with the backend ``cfg.renderer``;
    the sweep view-adaptively oversampled as the JAX package does for a
    concrete camera.  (The fused frame calls `render_gbuffer_sweep`
    directly: in the JAX package its camera is traced, so the adaptive
    factor never applies there.)"""
    if cfg.renderer in ("sweep", "sweep_pallas"):
        return render_gbuffer_sweep(grid, cam, cam_flow,
                                    adaptive_sweep_cfg(cam, cfg), rp)
    if cfg.renderer == "march":
        return render_gbuffer(grid, cam, cam_flow, cfg, rp)
    raise ValueError(f"unknown renderer {cfg.renderer!r}")
