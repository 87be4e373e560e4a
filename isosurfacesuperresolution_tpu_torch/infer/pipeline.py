"""Fused interactive inference: sweep render -> inpaint -> warp -> network
-> clamp -> shade.

Counterpart of `make_fused_frame`, `resolve_planar`, `initial_state` and
`InferencePipeline` in the JAX package's `infer/pipeline.py`.  One frame
runs on the grid's device without waiting for it: camera geometry is host
math, the G-buffer never leaves the device, and the recurrent state is a
device tensor handed from frame to frame.  The first frame (``has_prev``
False, a host bool) starts from the "unshaded" initial image.

``planar``: "auto" runs the sub-pixel-planar engine (`infer/planar.py`)
whenever the model configuration supports it, as in JAX; "on" requires it
and "off" runs the interleaved network.  The planar frame returns
channel-first RGB (3, Hh, Wh) and carries a (1, h, w, 96) nested state;
`InferencePipeline.frame` returns (Hh, Wh, 3) either way.  The grid is a
dense `BrickGrid` or a packed `SparseBrickGrid`, as in JAX.  A frame runs
its float32 convolutions in full float32 on the card (`fp32_convs`).
`InferencePipeline.set_render_params` changes the isovalue, light and
material of the next frame and rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from isosurfacesuperresolution_tpu_torch.config import (
    Config, RenderConfig, ShadingConfig)
from isosurfacesuperresolution_tpu_torch.device import (
    DeviceLike, resolve_device)
from isosurfacesuperresolution_tpu_torch.infer import planar as planar_mod
from isosurfacesuperresolution_tpu_torch.models.videotools import (
    flatten_high, initial_image, warp_upscale)
from isosurfacesuperresolution_tpu_torch.ops.inpaint import inpaint_flow
from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.ops.warp_fast import (
    warp_upscale_fast)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.raycast import (
    gbuffer_to_low_input)
from isosurfacesuperresolution_tpu_torch.render.shading import (
    safe_normalize, screen_space_shading)
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    AnyGrid, render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.utils.spectral_norm import (
    SpectralNormalizedModule, apply_sn_tree)


class FrameState(NamedTuple):
    """Recurrent state carried between frames."""

    # (1, H, W, 6) previous prediction, or (1, h, w, 96) planar (nested)
    prev_high: torch.Tensor
    has_prev: bool                # False: first frame, use the initial image


def clamp_output(prediction: torch.Tensor) -> torch.Tensor:
    """Clamp the recurrent state as the reference trainer does
    (`train/trainer.clamp_output`): mask to [-1, 1], normal normalized,
    depth and AO to [0, 1]."""
    return torch.cat([
        torch.clamp(prediction[..., 0:1], -1.0, 1.0),
        safe_normalize(prediction[..., 1:4]),
        torch.clamp(prediction[..., 4:5], 0.0, 1.0),
        torch.clamp(prediction[..., 5:6], 0.0, 1.0),
    ], -1)


def resolve_planar(cfg: Config, upscale_mode: str, planar: str) -> bool:
    """Whether the planar engine runs: "off" or a resize upscale mode never,
    "auto" when `infer.planar.supports_planar` holds, "on" likewise but a
    configuration it does not support raises ValueError."""
    if planar not in ("auto", "on", "off"):
        raise ValueError(f"planar must be auto, on or off, not {planar!r}")
    if planar == "off" or upscale_mode != "network":
        return False
    ok = planar_mod.supports_planar(cfg.model)
    if planar == "on" and not ok:
        raise ValueError("planar engine does not support this model config")
    return ok


def initial_state(cfg: Config, render_cfg: RenderConfig,
                  upscale_mode: str = "network", planar: str = "auto",
                  device: DeviceLike = None) -> FrameState:
    m = cfg.model
    u = m.upscale_factor
    h, w = render_cfg.height, render_cfg.width
    if resolve_planar(cfg, upscale_mode, planar):
        shape = (1, h, w, m.output_channels * u * u)
    else:
        shape = (1, h * u, w * u, m.output_channels)
    prev = torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(device))
    return FrameState(prev_high=prev, has_prev=False)


def fp32_convs():
    """The context a frame runs in: cuDNN's float32 convolutions in full
    float32, TF32 off, whatever the global ``torch.backends.cudnn.
    allow_tf32`` says (PyTorch's default is True); cuDNN's other flags
    keep their values.  The CPU path, and so the tests against the JAX
    package, computes in float32."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=cd.enabled, benchmark=cd.benchmark,
                    benchmark_limit=cd.benchmark_limit,
                    deterministic=cd.deterministic, allow_tf32=False)


class FusedFrame:
    """The fused frame: ``frame(grid, cam, cam_prev, state, rp=None) ->
    (rgb, low G-buffer (h, w, 12), new_state)``, rgb (Hh, Wh, 3), or
    channel-first (3, Hh, Wh) from the planar engine.

    upscale_mode: "network" (the model), or "nearest" / "bilinear" /
    "bicubic" resizes of the low-res input.  ``fast_warp`` (the default,
    as in JAX) warps the previous state of the interleaved network with
    the shift-blend warp clamped to 8 px, ``False`` with the exact gather
    warp of training (`models.videotools.warp_upscale`); the planar engine
    has its own warp.  The planar engine's kernels, index tensors and
    constants are built here, once, on the frame's device, from the
    model's weights spectrally normalized first under ``use_sn``; the
    interleaved network then runs through `SpectralNormalizedModule`."""

    def __init__(self, model: Optional[nn.Module], cfg: Config,
                 render_cfg: RenderConfig, upscale_mode: str = "network",
                 shading_cfg: Optional[ShadingConfig] = None,
                 planar: str = "auto", device: DeviceLike = None,
                 fast_warp: bool = True):
        self.use_planar = resolve_planar(cfg, upscale_mode, planar)
        if upscale_mode not in ("network", "nearest", "bilinear",
                                "bicubic"):
            raise ValueError(f"unknown upscale mode {upscale_mode!r}")
        if upscale_mode == "network" and model is None:
            raise ValueError("upscale_mode='network' needs a model")
        if render_cfg.renderer not in ("sweep", "sweep_pallas"):
            raise ValueError(
                f"unknown or unported renderer {render_cfg.renderer!r}")
        self.device = resolve_device(device)
        if (cfg.model.use_sn and model is not None
                and not isinstance(model, SpectralNormalizedModule)):
            model = SpectralNormalizedModule(model)
        self.model = model
        self.fast_warp = fast_warp
        self.cfg = cfg
        self.render_cfg = render_cfg
        self.upscale_mode = upscale_mode
        self.shading_cfg = (shading_cfg if shading_cfg is not None
                            else cfg.shading)
        self.planar_net = self.planar_tables = None
        if self.use_planar:
            params = model.state_dict()         # the raw weights
            if cfg.model.use_sn:
                # the --useSN transform, a pure function of the weights,
                # which JAX's fused frame applies before `planar_apply`
                params = apply_sn_tree(params)
            self.planar_net = planar_mod.PlanarNet(params, cfg.model,
                                                   device=self.device)
            self.planar_tables = planar_mod.PlanarTables(
                render_cfg.height, render_cfg.width,
                cfg.model.output_channels, self.device)

    @torch.no_grad()
    def __call__(self, grid: AnyGrid, cam: CameraParams,
                 cam_prev: CameraParams, state: FrameState,
                 rp: Optional[RenderParams] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, FrameState]:
        if grid.device.type != self.device.type:
            raise ValueError(f"grid is on {grid.device}, the frame "
                             f"runs on {self.device}")
        with fp32_convs():
            return self._frame(grid, cam, cam_prev, state, rp)

    def _frame(self, grid: AnyGrid, cam: CameraParams,
               cam_prev: CameraParams, state: FrameState,
               rp: Optional[RenderParams]
               ) -> Tuple[torch.Tensor, torch.Tensor, FrameState]:
        m = self.cfg.model
        u = m.upscale_factor
        # no view-adaptive oversampling: the JAX fused frame renders with a
        # traced camera, for which `adaptive_sweep_cfg` changes nothing
        fr = render_gbuffer_sweep(grid, cam, cam_prev, self.render_cfg, rp)
        low = gbuffer_to_low_input(fr)[None]                  # (1,h,w,5)
        flow = inpaint_flow(fr[None, ..., 8:10], fr[None, ..., 3:4],
                            iterations=8)
        if self.use_planar:
            tables = self.planar_tables
            prev = (state.prev_high if state.has_prev else
                    planar_mod.initial_image_planar(
                        low, m.output_channels, "unshaded", False, tables))
            # the shift-blend runs in the network's type: its only consumer
            # is the network input
            warped = planar_mod.warp_planar(
                prev, flow, special_mask=True, max_disp=8,
                compute_dtype=getattr(torch, m.compute_dtype), tables=tables)
            pred = self.planar_net(torch.cat([low, warped], -1))
            out_planar = planar_mod.clamp_output_planar(pred)
            rgb = planar_mod.planar_rgb_to_planes(
                planar_mod.screen_space_shading_planar(
                    out_planar, self.shading_cfg), tables)[0]
            return rgb, fr, FrameState(prev_high=out_planar, has_prev=True)
        if self.upscale_mode == "network":
            prev = (state.prev_high if state.has_prev else
                    initial_image(low, m.output_channels, "unshaded",
                                  False, u))
            warped = (warp_upscale_fast(prev, flow, u, special_mask=True,
                                        max_disp=8) if self.fast_warp
                      else warp_upscale(prev, flow, u, special_mask=True))
            net_in = torch.cat([low, flatten_high(warped, u)], -1)
            pred, _ = self.model(net_in)
            out_high = clamp_output(pred)
        else:
            out_high = resize(low, scale=float(u), method=self.upscale_mode)
            out_high = torch.cat([out_high,
                                  torch.ones_like(out_high[..., :1])], -1)
        rgb = screen_space_shading(out_high, self.shading_cfg)[0]
        return rgb, fr, FrameState(prev_high=out_high, has_prev=True)


@dataclasses.dataclass
class InferencePipeline:
    """Stateful wrapper around `FusedFrame` that tracks the previous camera,
    so each frame's flow is taken against it."""

    model: Optional[nn.Module]
    cfg: Config
    render_cfg: RenderConfig
    upscale_mode: str = "network"
    shading_cfg: Optional[ShadingConfig] = None
    render_params: Optional[RenderParams] = None
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._frame = FusedFrame(self.model, self.cfg, self.render_cfg,
                                 self.upscale_mode, self.shading_cfg,
                                 device=self.device)
        self.reset()

    @property
    def use_planar(self) -> bool:
        return self._frame.use_planar

    def reset(self):
        self.state = initial_state(self.cfg, self.render_cfg,
                                   self.upscale_mode, device=self.device)
        self._last_cam: Optional[CameraParams] = None

    def set_render_params(self, **kw) -> None:
        """Replace the isovalue, light or material knobs of the next
        frames (the GUI sliders' path): a new `RenderParams`, the
        `FusedFrame`, its planar tables and weights, and every table kept
        with the grid stay as they are, as in JAX, where the knobs are
        traced and nothing recompiles.  A baked AO field stays the one
        baked at its own isovalue, as in JAX."""
        rp = (self.render_params if self.render_params is not None
              else RenderParams.from_config(self.render_cfg))
        self.render_params = rp.replace(**kw)

    def frame(self, grid: AnyGrid, cam: CameraParams) -> torch.Tensor:
        """Render + super-resolve + shade one frame; (Hh, Wh, 3) on the
        device."""
        cam_prev = self._last_cam if self._last_cam is not None else cam
        rgb, _, self.state = self._frame(grid, cam, cam_prev, self.state,
                                          self.render_params)
        self._last_cam = cam
        if self.use_planar:        # the planar frame emits (3, Hh, Wh)
            rgb = rgb.permute(1, 2, 0)
        return rgb
