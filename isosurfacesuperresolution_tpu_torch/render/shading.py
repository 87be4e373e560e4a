"""Screen-space deferred shading of an unshaded buffer.

Counterpart of the JAX package's `render/shading.py`: ambient + two-sided
diffuse + optional Phong specular with the constant screen-space eye
direction [0, 0, 1], AO strength lerp with optional inversion, background
blend by the [-1, 1] mask.  NHWC.
"""

from __future__ import annotations

import math

import torch

from isosurfacesuperresolution_tpu_torch.config import ShadingConfig


def safe_normalize(v: torch.Tensor, dim: int = -1,
                   epsilon: float = 1e-7) -> torch.Tensor:
    """Zero-safe normalization: the max is taken under the square root."""
    sq = torch.sum(v * v, dim=dim, keepdim=True)
    return v / torch.sqrt(torch.clamp(sq, min=epsilon * epsilon))


def screen_space_shading(buf: torch.Tensor, cfg: ShadingConfig
                         ) -> torch.Tensor:
    """(B, H, W, C >= 5) [mask, normal(3), depth, (ao)] -> RGB (B, H, W, 3)."""
    c = buf.shape[-1]
    if c < 5:
        raise ValueError(f"shading needs >= 5 channels, got {c}")
    mask = buf[..., 0:1]
    normal = buf[..., 1:4]
    if c >= 6:
        ao_raw = torch.clamp(buf[..., 5:6], 0.0, 1.0)
        if cfg.inverse_ao:
            ao_raw = torch.clamp(1.0 - buf[..., 5:6], 0.0, 1.0)
        ao = cfg.ao_strength * ao_raw + (1.0 - cfg.ao_strength)
    else:
        ao = torch.ones_like(mask)

    def vec(v):
        return torch.tensor(v, dtype=torch.float32)

    light = vec(cfg.light_direction)
    light = (light / torch.linalg.norm(light)).tolist()
    amb_mat = (vec(cfg.ambient_color) * vec(cfg.material_color)).tolist()
    dif_mat = (vec(cfg.diffuse_color) * vec(cfg.material_color)).tolist()
    spc = cfg.specular_color
    bg = cfg.background

    ldotn = (light[0] * normal[..., 0:1] + light[1] * normal[..., 1:2]
             + light[2] * normal[..., 2:3])
    abs_ldotn = torch.abs(ldotn)
    if cfg.enable_specular:
        # constant screen-space eye direction [0, 0, 1]
        reflect_z = 2.0 * ldotn * normal[..., 2:3] - light[2]
        spec_factor = ((cfg.specular_exponent + 2) / (2.0 * math.pi)) * (
            torch.clamp(reflect_z, 0.0, 1.0) ** cfg.specular_exponent)
    t = torch.clamp(mask * 0.5 + 0.5, 0.0, 1.0)
    out = []
    for i in range(3):
        color = amb_mat[i] + dif_mat[i] * abs_ldotn
        if cfg.enable_specular:
            color = color + spec_factor * spc[i]
        color = color * ao
        out.append(bg[i] + t * (color - bg[i]))
    return torch.clamp(torch.cat(out, -1), 0.0, 1.0)
