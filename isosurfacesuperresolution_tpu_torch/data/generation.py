"""Training-clip generation: the renderer in the loop.

Counterpart of the JAX package's `data/generation.py` (the reference's
video data generator): a random camera path between two nearby points
of a sphere, a random isovalue in the volume's range, a random material
and light; high-res frames with AO, low-res frames re-rendered (not
filtered) at 1/``downscaling``, and the low-res flow inpainted over the
background.  With a sweep renderer the AO is a baked SH field, baked once
per clip (the isovalue is fixed within a clip).  The numpy draws come in
the JAX package's order, so a seed gives its cameras and settings.

Flow convention: frame t holds flow w.r.t. frame t-1's camera (frame 0:
zero flow); the trainer warps with the current frame's flow.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.ops.inpaint import inpaint_flow
from isosurfacesuperresolution_tpu_torch.render.api import (
    render_frame_gbuffer)
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.raycast import (
    gbuffer_flow, gbuffer_to_high_target, gbuffer_to_low_input)
from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid


@dataclass
class SequenceConfig:
    """Randomization ranges of a clip."""

    num_frames: int = 10
    high_res: int = 512
    downscaling: int = 4
    max_dist: float = 0.3              # max camera movement over the clip
    distance_range: Tuple[float, float] = (0.6, 1.0)
    look_at_jitter: float = 0.1
    iso_range: Tuple[float, float] = (0.36, 0.36)
    ao_samples: int = 256
    ao_radius: float = 0.2             # world-space AO falloff radius
    fov_y_degrees: float = 45.0
    camera_light_prob: float = 0.7
    inpaint_iterations: int = 8


def _random_point_on_sphere(rng: np.random.RandomState,
                            lower_hemisphere: bool = True) -> np.ndarray:
    v = rng.randn(3)
    v /= np.linalg.norm(v)
    if lower_hemisphere:
        v[2] = -abs(v[2])
    return v


def random_camera_path(rng: np.random.RandomState, cfg: SequenceConfig
                       ) -> List[CameraParams]:
    """``num_frames`` cameras interpolated between two random sphere
    points less than ``max_dist`` apart, each looking at a jittered
    point near the origin, up (0, 0, -1)."""
    d0 = rng.uniform(*cfg.distance_range)
    origin_start = _random_point_on_sphere(rng) * d0
    look_start = _random_point_on_sphere(rng) * cfg.look_at_jitter
    while True:
        origin_end = _random_point_on_sphere(rng) * rng.uniform(
            *cfg.distance_range)
        if np.linalg.norm(origin_end - origin_start) < cfg.max_dist:
            break
    look_end = _random_point_on_sphere(rng) * cfg.look_at_jitter
    up = np.array([0.0, 0.0, -1.0])
    cams = []
    n = cfg.num_frames
    for t in range(n):
        a = t / (n - 1) if n > 1 else 0.0
        eye = origin_start * (1 - a) + origin_end * a
        look = look_start * (1 - a) + look_end * a
        cams.append(CameraParams.create(eye, look, up, cfg.fov_y_degrees))
    return cams


def random_render_settings(rng: np.random.RandomState, cfg: SequenceConfig,
                           base: RenderConfig
                           ) -> Tuple[RenderConfig, RenderParams]:
    """A random isovalue, diffuse and specular colour, specular exponent,
    light choice and direction: ``(cfg, rp)``, the camera-light choice in
    the config and the numbers in the `RenderParams`."""
    iso = rng.uniform(*cfg.iso_range)
    diffuse = tuple(rng.uniform(0.2, 1.0, 3).tolist())
    spec = float(rng.uniform(0, 1) ** 3 * 0.3)
    exponent = float(rng.randint(4, 65))
    camera_light = bool(rng.uniform(0, 1) < cfg.camera_light_prob)
    light_dir = tuple(_random_point_on_sphere(rng).tolist())
    static_cfg = base.replace(camera_light=camera_light)
    rp = RenderParams.from_config(static_cfg).replace(
        isovalue=iso, diffuse_color=diffuse,
        specular_color=(spec, spec, spec),
        specular_exponent=exponent, light_direction=light_dir)
    return static_cfg, rp


def render_sequence(grid: BrickGrid, cams: Sequence[CameraParams],
                    render_cfg: RenderConfig, seq_cfg: SequenceConfig,
                    rp: Optional[RenderParams] = None
                    ) -> Dict[str, np.ndarray]:
    """Render one clip on the grid's device; numpy arrays

    - ``low``  (T, h, w, 5)  [mask in [-1, 1], normal, depth]
    - ``high`` (T, H, W, 6)  [mask in [-1, 1], normal, depth, ao]
    - ``flow`` (T, h, w, 2)  inpainted, w.r.t. the previous frame's camera

    High-res frames carry AO (a sweep renderer bakes the SH field once,
    unless the grid has one); low-res frames are rendered without."""
    H = seq_cfg.high_res
    h = H // seq_cfg.downscaling
    cfg_high = render_cfg.replace(width=H, height=H,
                                  ao_samples=seq_cfg.ao_samples,
                                  ao_radius=seq_cfg.ao_radius)
    cfg_low = render_cfg.replace(width=h, height=h, ao_samples=0)
    if (seq_cfg.ao_samples > 0
            and cfg_high.renderer in ("sweep", "sweep_pallas")
            and cfg_high.ao_mode in ("auto", "volume")
            and isinstance(grid, BrickGrid) and grid.ao_sh is None):
        iso_bake = cfg_high.isovalue if rp is None else rp.isovalue
        grid = attach_baked_ao(grid, iso_bake, cfg_high.ao_radius)

    lows, highs, flows = [], [], []
    for t, cam in enumerate(cams):
        cam_prev = cams[t - 1] if t > 0 else cam
        fr_hi = render_frame_gbuffer(grid, cam, cam_prev, cfg_high, rp)
        fr_lo = render_frame_gbuffer(grid, cam, cam_prev, cfg_low, rp)
        highs.append(gbuffer_to_high_target(fr_hi))
        lows.append(gbuffer_to_low_input(fr_lo))
        flows.append(inpaint_flow(gbuffer_flow(fr_lo)[None],
                                  fr_lo[None, ..., 3:4],
                                  iterations=seq_cfg.inpaint_iterations)[0])
    return {k: torch.stack(v).cpu().numpy()
            for k, v in (("low", lows), ("high", highs), ("flow", flows))}


def generate_sequences(grids: Sequence[Tuple[BrickGrid, Tuple[float, float]]],
                       num_sequences: int,
                       seq_cfg: SequenceConfig,
                       base_render_cfg: Optional[RenderConfig] = None,
                       seed: int = 0,
                       out_dir: Optional[str] = None,
                       ) -> List[Dict[str, np.ndarray]]:
    """``num_sequences`` random clips over ``grids``, a list of (volume,
    (min_iso, max_iso)); each clip renders on its volume's device.  With
    ``out_dir`` each clip is also saved as ``low_%05d.npy``,
    ``high_%05d.npy`` and ``flow_%05d.npy`` in the reference's NCHW
    layout, (T, C, H, W)."""
    rng = np.random.RandomState(seed)
    base = base_render_cfg or RenderConfig()
    out = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for i in range(num_sequences):
        grid, iso_range = grids[rng.randint(len(grids))]
        cfg = dataclass_replace_iso(seq_cfg, iso_range)
        cams = random_camera_path(rng, cfg)
        rcfg, rp = random_render_settings(rng, cfg, base)
        seq = render_sequence(grid, cams, rcfg, cfg, rp)
        out.append(seq)
        if out_dir:
            for key in ("low", "high", "flow"):
                np.save(os.path.join(out_dir, f"{key}_{i:05d}.npy"),
                        seq[key].transpose(0, 3, 1, 2))
    return out


def dataclass_replace_iso(cfg: SequenceConfig,
                          iso_range: Tuple[float, float]) -> SequenceConfig:
    return dataclasses.replace(cfg, iso_range=tuple(iso_range))
