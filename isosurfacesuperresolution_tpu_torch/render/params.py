"""Per-frame render parameters.

Counterpart of the JAX package's `render/params.py`.  There the knobs are
traced arrays so that changing them does not recompile; PyTorch runs
eagerly, so here they are plain host numbers that enter the device work as
scalars.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from isosurfacesuperresolution_tpu_torch.config import RenderConfig


class RenderParams(NamedTuple):
    isovalue: float
    light_direction: Tuple[float, float, float]
    ambient_color: Tuple[float, float, float]
    diffuse_color: Tuple[float, float, float]
    specular_color: Tuple[float, float, float]
    specular_exponent: float

    @classmethod
    def from_config(cls, cfg: RenderConfig) -> "RenderParams":
        return cls(
            isovalue=float(cfg.isovalue),
            light_direction=tuple(float(v) for v in cfg.light_direction),
            ambient_color=tuple(float(v) for v in cfg.ambient_color),
            diffuse_color=tuple(float(v) for v in cfg.diffuse_color),
            specular_color=tuple(float(v) for v in cfg.specular_color),
            specular_exponent=float(cfg.specular_exponent),
        )
