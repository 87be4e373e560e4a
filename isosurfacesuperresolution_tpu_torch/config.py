"""Configuration dataclasses of the port.

Own copies of the JAX package's `config.py` dataclasses, holding the fields
that the ported path reads (`LossConfig`, `TrainConfig` and
`ParallelConfig` whole), the loss DSL parsers and `flatten_config`; field
names, defaults, meanings and error messages are the reference's.
`config_from_json` is the counterpart of
`infer/loadedmodel.config_from_json` and reads a run directory's flattened
``config.json``, the file `train/checkpoint.write_info` writes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# G-buffer channel layout: 12 channels per pixel
CH_RGB = slice(0, 3)       # shaded color
CH_MASK = 3                # 1 = hit, 0 = background
CH_NORMAL = slice(4, 7)    # view-space normal
CH_DEPTH = 7               # NDC depth of the hit
CH_FLOW = slice(8, 10)     # screen-space flow w.r.t. the flow camera
CH_AO = 10                 # ambient occlusion (1 = unoccluded)
CH_SHADOW = 11             # unused, always 1
NUM_RENDER_CHANNELS = 12

# training tensors: low-res input [mask in [-1, 1], nx, ny, nz, depth],
# high-res target [mask, nx, ny, nz, depth, ao]
LOW_CHANNELS = 5
HIGH_CHANNELS = 6


@dataclass(frozen=True)
class RenderConfig:
    """Renderer and G-buffer shading settings."""

    width: int = 320
    height: int = 240
    fov_degrees: float = 45.0          # vertical field of view
    z_near: float = 0.1
    z_far: float = 10.0
    # "sweep": the reference's slice scan in stock PyTorch ops (an oracle
    # path); "sweep_pallas": the march kernels (CUDA on the card, their
    # plain versions on the CPU); "march": per-ray lattice marching
    # (`render/raycast.render_gbuffer`), the reference-faithful oracle
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
    # direct volume rendering (`render/volume_render.py`): transfer-function
    # opacity multiplier per unit voxel of path length
    volume_alpha_scale: float = 1.0
    isovalue: float = 0.36
    step_voxels: float = 0.25          # march step in voxel units
    binary_search_steps: int = 10      # hit refinement of the march
    max_march_steps: int = 4096        # bound on fine steps of a ray
    # ambient occlusion: 0 disables it (ao channel = 1).  "auto" samples a
    # baked SH field when the grid carries one
    # (`render/ao_sweep.attach_baked_ao`), hemisphere rays otherwise;
    # "volume" | "ray" force one
    ao_samples: int = 0
    ao_mode: str = "auto"
    ao_radius: float = 0.1             # world-space falloff radius
    ao_bias: float = 1e-3              # backtrack along the ray (acne)
    ao_rotations: int = 4              # 4x4 grid of random rotations
    ao_ray_steps: int = 128            # fine-step budget of each AO ray
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

    def replace(self, **kw) -> "ShadingConfig":
        return dataclasses.replace(self, **kw)


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


VALID_LOSS_NAMES = (
    "mse", "l2", "l2_loss", "l1", "l1_loss", "tl2", "temp-l2",
    "l2-ds", "l1-ds", "perceptual", "texture", "adv", "gan", "tgan", "sgan",
    "gdl",
)
VALID_LOSS_TARGETS = ("mask", "normal", "color", "ao", "depth", "all")

_CANONICAL = {"l2": "mse", "l2_loss": "mse", "l1_loss": "l1",
              "tl2": "temp-l2", "gan": "adv"}


def parse_loss_dsl(spec: str) -> Dict[Tuple[str, str], float]:
    """Parse the loss DSL ``"<loss>:<target>:<weight>,..."`` into a dict
    ``(canonical_name, target) -> weight`` (weight 1 when left out)."""
    weights: Dict[Tuple[str, str], float] = {}
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        if len(parts) < 2:
            raise ValueError(f"illegal format for loss list entry: {token!r}")
        name, target = parts[0], parts[1]
        weight = float(parts[2]) if len(parts) > 2 else 1.0
        if name not in VALID_LOSS_NAMES:
            raise ValueError(f"unknown loss {name!r}")
        if target not in VALID_LOSS_TARGETS:
            raise ValueError(f"Unknown target: {target}")
        name = _CANONICAL.get(name, name)
        if name in ("adv", "tgan", "sgan") and target != "all":
            raise ValueError(f"{name} loss requires target 'all'")
        weights[(name, target)] = weight
    return weights


def parse_layer_weights(spec: str) -> List[Tuple[str, float]]:
    """Parse VGG layer lists like ``"conv_1:0.03,conv_5:1.0"`` (weight 1
    when left out)."""
    out: List[Tuple[str, float]] = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        if ":" in token:
            name, w = token.split(":")
            out.append((name, float(w)))
        else:
            out.append((token, 1.0))
    return out


@dataclass(frozen=True)
class LossConfig:
    """Loss-stack configuration (reference: mainVideoUnshaded.py:70-90)."""

    losses: str = "l1:mask:1,l1:ao:1,l1:normal:10,l1:depth:10,temp-l2:color:0.1"
    # per-layer inverse-response weights over all 16 convs of the trimmed
    # VGG-19 (the reference's VGGAnalysis defaults)
    perceptual_loss_layers: str = (
        "conv_1:0.026423,conv_2:0.009285,conv_3:0.006710,conv_4:0.004898,"
        "conv_5:0.003910,conv_6:0.003956,conv_7:0.003813,conv_8:0.002968,"
        "conv_9:0.002997,conv_10:0.003631,conv_11:0.004147,conv_12:0.005765,"
        "conv_13:0.007442,conv_14:0.009666,conv_15:0.012586,conv_16:0.013377")
    texture_loss_layers: str = "conv_1:1,conv_3:1,conv_5:1"
    discriminator: str = "enhanceNetLarge"
    # shading constants used inside the loss
    loss_ambient: float = 0.1
    loss_diffuse: float = 1.0
    loss_specular: float = 0.0
    loss_ao: float = 1.0
    padding: int = 16                  # border zeroing in pixels
    gan_type: str = "bce"              # bce | wgan | wgan-gp
    wgan_lambda: float = 10.0

    def weight_dict(self) -> Dict[Tuple[str, str], float]:
        return parse_loss_dsl(self.losses)


@dataclass(frozen=True)
class TrainConfig:
    """Training operating point (reference: README.md:50-71,
    mainVideoUnshaded.py)."""

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
class ParallelConfig:
    """Device layout of multi-device runs: devices on the batch axis."""

    data_axis: str = "data"
    data_parallel: int = 1             # number of devices on the batch axis


@dataclass(frozen=True)
class Config:
    render: RenderConfig = field(default_factory=RenderConfig)
    shading: ShadingConfig = field(default_factory=ShadingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def flatten_config(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a (nested) config dataclass into dotted keys for logging."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(flatten_config(v, prefix=key + "."))
        else:
            out[key] = v
    return out


def config_from_json(path: str) -> Config:
    """Rebuild a Config from the flattened ``config.json`` of a run dir.

    Like the reference, the ``model.*``, ``loss.*`` and ``train.*``
    sections are restored (keys the dataclasses do not know are skipped);
    render, shading and parallel keep their defaults (the caller passes
    its own)."""
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
                  loss=section("loss", LossConfig),
                  train=section("train", TrainConfig))
