"""Configuration dataclasses of the port.

Own copies of the JAX package's `config.py` dataclasses, holding the fields
that the ported path reads; field names, defaults and meanings are the
reference's.  `config_from_json` is the counterpart of
`infer/loadedmodel.config_from_json` and reads a run directory's flattened
``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RenderConfig:
    """Sweep-renderer and G-buffer shading settings."""

    width: int = 320
    height: int = 240
    # "sweep": the reference's slice scan in stock PyTorch ops (an oracle
    # path); "sweep_pallas": the march kernels (CUDA on the card, their
    # plain versions on the CPU)
    renderer: str = "sweep"
    sweep_oversample: float = 1.5      # intermediate grid resolution factor
    sweep_z_supersample: int = 2       # slice planes per voxel along the axis
    # view-adaptive oversampling for concrete-camera callers of
    # `render.api.render_frame_gbuffer`; the fused frame never applies it
    sweep_adaptive_oversample: bool = True
    sweep_max_oversample: float = 3.5
    # occupancy-gated tiled march (render/sweep_tiled.py) under
    # "sweep_pallas": 0 = tile 256 when the permuted slice plane reaches
    # 512 on an axis, < 0 = never, > 0 = always, with this tile
    sweep_tile: int = 0
    # storage/multiply type of the per-slice resample (accumulation f32)
    sweep_dtype: str = "float32"
    isovalue: float = 0.36
    # ambient occlusion: 0 disables it (ao channel = 1).  The port renders
    # AO from a baked SH field (`render/ao_sweep.attach_baked_ao`) only;
    # hemisphere-ray AO is not ported
    ao_samples: int = 0
    ao_mode: str = "auto"              # auto | volume (baked field) | ray
    ao_radius: float = 0.1             # world-space falloff radius
    ao_bias: float = 1e-3              # ray-AO surface offset (unported)
    light_direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    camera_light: bool = True
    ambient_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    specular_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    specular_exponent: int = 16
    viewport: Optional[Tuple[int, int, int, int]] = None

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShadingConfig:
    """Screen-space deferred shading."""

    ambient_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    diffuse_color: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    specular_color: Tuple[float, float, float] = (0.02, 0.02, 0.02)
    specular_exponent: int = 16
    enable_specular: bool = False
    light_direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    material_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ao_strength: float = 1.0
    inverse_ao: bool = False
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class ModelConfig:
    """Generator configuration (EnhanceNet is the one ported model)."""

    model: str = "EnhanceNet"
    upscale_factor: int = 4
    input_channels: int = 5
    output_channels: int = 6
    channel_mask: Tuple[int, ...] = (0, 1, 2, 3, 4)
    upsample: str = "bilinear"         # nearest | bilinear
    recon_type: str = "residual"       # residual | direct
    use_bn: bool = False
    use_sn: bool = False
    num_residual_blocks: int = 10
    num_features: int = 64
    compute_dtype: str = "float32"     # or "bfloat16"
    fused_upsample: bool = False
    # planar engine (`infer/planar.py`): post3 as two row-phase convs
    planar_split_tail: bool = False
    # planar engine: post3 through the phase-conv kernel
    # (`ops/phase_conv.py`); 64-feature nets only, others keep the dense tail
    planar_phase_tail: bool = False
    # planar engine: int8 post-training quantization of the trunk blocks
    # and post1-post3 (not with the phase tail)
    planar_int8: bool = False


@dataclass(frozen=True)
class Config:
    render: RenderConfig = field(default_factory=RenderConfig)
    shading: ShadingConfig = field(default_factory=ShadingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)


def config_from_json(path: str) -> Config:
    """Rebuild a Config from the flattened ``config.json`` of a run dir.

    Like the reference, only the ``model.*`` section is restored; render
    and shading keep their defaults (the caller passes its own)."""
    with open(path) as f:
        flat = json.load(f)
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {}
    for k, v in flat.items():
        if k.startswith("model."):
            name = k[len("model."):]
            if name in names:
                kw[name] = tuple(v) if isinstance(v, list) else v
    return Config(model=ModelConfig(**kw))
