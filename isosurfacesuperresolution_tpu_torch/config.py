"""Configuration dataclasses of the port.

Own copies of the JAX package's `config.py` dataclasses, holding the fields
that the ported path reads (`TrainConfig` whole); field names, defaults
and meanings are the reference's.  `config_from_json` is the counterpart
of `infer/loadedmodel.config_from_json` and reads a run directory's
flattened ``config.json``.
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
    """Generator configuration."""

    model: str = "EnhanceNet"          # EnhanceNet | RCAN | TecoGAN | SubpixelNet
    upscale_factor: int = 4
    input_channels: int = 5
    output_channels: int = 6
    channel_mask: Tuple[int, ...] = (0, 1, 2, 3, 4)
    upsample: str = "bilinear"         # nearest | bilinear | bicubic | pixelShuffle
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
class TrainConfig:
    """Training operating point (reference: README.md:50-71,
    mainVideoUnshaded.py).  Inference reads ``initial_image_mode``,
    ``disable_temporal`` and ``ao_inverted``; the rest waits for the
    trainer."""

    batch_size: int = 16
    crop_size: int = 32                # low-res crop; high-res = 4x
    num_frames: int = 10               # frames per clip (BPTT length)
    samples: int = 500                 # crops sampled per epoch
    test_fraction: float = 0.2
    epochs: int = 1000
    learning_rate: float = 1e-4
    optimizer: str = "adam"            # adam | rmsprop | rprop (reference --optim)
    lr_gamma: float = 0.5
    lr_step: int = 500
    beta1: float = 0.9
    beta2: float = 0.999
    # global-norm gradient clipping (0 = off)
    grad_clip: float = 1.0
    seed: int = 42
    initial_image_mode: str = "zero"   # zero | unshaded | input
    disable_temporal: bool = False
    ao_inverted: bool = False
    min_fill_rate: float = 0.5         # crop acceptance (datasetVideo.py:266-301)
    augment: bool = False
    # adversarial training
    adv_training: bool = False
    discr_steps: int = 1
    gen_steps: int = 1
    discr_lr: float = 1e-4
    # checkpointing / logging
    run_dir_base: str = "runs"
    checkpoint_every: int = 1
    remat: bool = False                # recompute each frame in the backward


@dataclass(frozen=True)
class Config:
    render: RenderConfig = field(default_factory=RenderConfig)
    shading: ShadingConfig = field(default_factory=ShadingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def config_from_json(path: str) -> Config:
    """Rebuild a Config from the flattened ``config.json`` of a run dir.

    Like the reference, the ``model.*`` and ``train.*`` sections are
    restored (keys the dataclasses do not know are skipped); render and
    shading keep their defaults (the caller passes its own)."""
    with open(path) as f:
        flat = json.load(f)

    def section(prefix, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in flat.items():
            if k.startswith(prefix + ".") and k[len(prefix) + 1:] in names:
                kw[k[len(prefix) + 1:]] = tuple(v) if isinstance(v, list) \
                    else v
        return cls(**kw)

    return Config(model=section("model", ModelConfig),
                  train=section("train", TrainConfig))
