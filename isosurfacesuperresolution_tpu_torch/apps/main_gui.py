"""Interactive viewer: live render + super-resolution + shading.

Counterpart of the JAX package's `apps/main_gui.py` (`mainGUI.py`): orbit
camera, isovalue control, render modes (trained models, nearest,
bilinear, bicubic, ground truth), channel selection (color, mask, normal,
depth, AO, flow), AO controls, focus of context (the ground truth
re-rendered in a viewport around the cursor and blended in with a radial
mask), temporal post-smoothing by warping the previous RGB frame, rolling
FPS and screenshots with a JSON sidecar.

Each frame is the port's fused frame (`infer/pipeline.FusedFrame`, the
planar engine for the trained EnhanceNets), on the grid's device: with
``renderer="sweep_pallas"`` its G-buffer comes from the march kernel (B1)
and the ground truth and focus of context from `render/api.
render_frame_gbuffer`.  The state stays on the device; `render_frame`
returns a host array.  :class:`Viewer` is scriptable without a display;
``--tk`` attaches the Tk front end, ``--frames N`` renders an orbit to
PNG files (Pillow).

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_gui \\
      --volume analytic:blobs --models artifacts/run00017 \\
      --renderer sweep_pallas --frames 8 --output gui_out
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import deque
from typing import Dict, Tuple

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import (
    RenderConfig, ShadingConfig)
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    InferencePipeline)
from isosurfacesuperresolution_tpu_torch.render.camera import OrbitCamera
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams

MODES = ("nearest", "bilinear", "bicubic", "gt")


def to_uint8(rgb: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] -> uint8, truncating as the JAX package's
    ``(rgb * 255).astype(np.uint8)``."""
    return (np.asarray(rgb) * 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """A uint8 (H, W, 3) image to a PNG file (Pillow)."""
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(img)).save(path)


class Viewer:
    """The viewer's core, scriptable without a display.  Its pipelines,
    renders and state live on the grid's device."""

    CHANNELS = ("color", "mask", "normal", "depth", "ao", "flow")

    def __init__(self, grid, models: Dict[str, "LoadedModel"],
                 res_x: int = 320, res_y: int = 240, upscale: int = 4,
                 isovalue: float = 0.5, step_voxels: float = 0.5,
                 renderer: str = "sweep"):
        self.grid = grid
        self.device = grid.device
        self.models = models
        self.upscale = upscale
        self.camera = OrbitCamera(res_x, res_y)
        self.render_cfg = RenderConfig(width=res_x, height=res_y,
                                       isovalue=isovalue,
                                       step_voxels=step_voxels,
                                       ao_samples=0, renderer=renderer)
        self.shading_cfg = ShadingConfig(
            ambient_color=(0.1, 0.1, 0.1), diffuse_color=(1.0, 1.0, 1.0),
            specular_color=(0.0, 0.0, 0.0), enable_specular=True,
            light_direction=(0.0, 0.0, 1.0), material_color=(1.0, 0.3, 0.0))
        self.mode = next(iter(models)) if models else "bilinear"
        self.channel = "color"
        self.ao_samples = 0
        self.ao_radius = 0.1
        self.temporal_smoothing = 0.0      # 0..1 blend with warped prev RGB
        self.foc_enabled = False
        self.foc_center = (res_x * upscale // 2, res_y * upscale // 2)
        self.foc_window_size = 96          # half-width in high-res pixels
        self.foc_blur_radius = 32
        self._frame_times = deque(maxlen=10)
        self._pipelines: Dict[str, InferencePipeline] = {}
        self._extra_render_params: Dict[str, object] = {}
        self._last_cam = None
        self._prev_rgb = None
        self.last_frame_ms = 0.0
        self.input_name = "volume"

    # -- controls ------------------------------------------------------------
    def set_isovalue(self, v: float, reset_temporal: bool = True):
        """A new isovalue for every pipeline, rebuilding nothing.  The
        slider clears the temporal state; a scripted sweep passes
        ``reset_temporal=False`` to keep the recurrence."""
        self.render_cfg = self.render_cfg.replace(isovalue=float(v))
        for p in self._pipelines.values():
            p.set_render_params(isovalue=float(v))
        if reset_temporal:
            self.reset_temporal()

    def set_material(self, **kw):
        """Material and light knobs (diffuse_color, ambient_color,
        specular_color, light_direction, ...) for every pipeline's
        `set_render_params`, remembered for pipelines made later.  The
        frames take the viewer's `_render_params`, built from
        ``render_cfg`` alone, as in JAX."""
        self._extra_render_params.update(kw)
        for p in self._pipelines.values():
            p.set_render_params(**kw)
        self.reset_temporal()

    def set_shading(self, shading_cfg: ShadingConfig):
        """New shading constants; the pipelines are made anew."""
        self.shading_cfg = shading_cfg
        self._pipelines.clear()
        self.reset_temporal()

    def set_mode(self, mode: str):
        self.mode = mode
        self.reset_temporal()

    def reset_temporal(self):
        for p in self._pipelines.values():
            p.reset()
        self._prev_rgb = None
        self._last_cam = None

    def _pipeline(self, mode: str) -> InferencePipeline:
        if mode not in self._pipelines:
            if mode in self.models:
                lm = self.models[mode]
                pipe = InferencePipeline(
                    model=lm.model, cfg=lm.cfg, render_cfg=self.render_cfg,
                    shading_cfg=self.shading_cfg, device=self.device)
            else:
                from isosurfacesuperresolution_tpu_torch.config import Config
                pipe = InferencePipeline(
                    model=None, cfg=Config(), render_cfg=self.render_cfg,
                    upscale_mode=mode, shading_cfg=self.shading_cfg,
                    device=self.device)
            pipe.set_render_params(isovalue=self.render_cfg.isovalue,
                                   **self._extra_render_params)
            self._pipelines[mode] = pipe
        return self._pipelines[mode]

    def _render_params(self) -> RenderParams:
        return RenderParams.from_config(self.render_cfg)

    def _high_cfg(self, **kw) -> RenderConfig:
        return self.render_cfg.replace(
            width=self.render_cfg.width * self.upscale,
            height=self.render_cfg.height * self.upscale,
            ao_samples=self.ao_samples, ao_radius=self.ao_radius, **kw)

    def _shaded_gt(self, cam, cfg: RenderConfig, rp=None) -> Tuple[
            torch.Tensor, torch.Tensor]:
        """The ground truth at high resolution: (its (1, H, W, 6) target,
        its shaded RGB (H, W, 3))."""
        from isosurfacesuperresolution_tpu_torch.render.api import (
            render_frame_gbuffer)
        from isosurfacesuperresolution_tpu_torch.render.raycast import (
            gbuffer_to_high_target)
        from isosurfacesuperresolution_tpu_torch.render.shading import (
            screen_space_shading)
        fr = render_frame_gbuffer(self.grid, cam, self._last_cam or cam,
                                  cfg, rp)
        target = gbuffer_to_high_target(fr)[None]
        return target, screen_space_shading(target, self.shading_cfg)[0]

    # -- focus of context ----------------------------------------------------
    def _foc_bounds_and_mask(self) -> Tuple[Tuple[int, int, int, int],
                                            np.ndarray]:
        """The viewport and the radial blending mask (H, W, 1), in
        high-res pixels."""
        w = self.render_cfg.width * self.upscale
        h = self.render_cfg.height * self.upscale
        half = self.foc_window_size
        fx, fy = self.foc_center
        viewport = (max(0, fx - half), max(0, fy - half),
                    min(w, fx + half), min(h, fy + half))
        outer = self.foc_window_size
        inner = max(0, self.foc_window_size - self.foc_blur_radius)
        ys = np.arange(h, dtype=np.float32)[:, None]
        xs = np.arange(w, dtype=np.float32)[None, :]
        r = np.sqrt((xs - fx) ** 2 + (ys - fy) ** 2)
        mask = np.clip((r - outer) / (inner - outer), 0, 1)
        return viewport, mask[..., None]

    # -- frame ---------------------------------------------------------------
    @torch.no_grad()
    def render_frame(self) -> np.ndarray:
        """Render one frame with all display features -> (H, W, 3) float32
        on the host."""
        from isosurfacesuperresolution_tpu_torch.models.videotools import (
            warp_upscale)
        from isosurfacesuperresolution_tpu_torch.ops.inpaint import (
            inpaint_flow)

        t0 = time.time()
        cam = self.camera.params()

        if self.mode == "gt":
            out_high, rgb = self._shaded_gt(cam, self._high_cfg(),
                                            self._render_params())
            low_fr = None
        else:
            pipe = self._pipeline(self.mode)
            cam_prev = pipe._last_cam if pipe._last_cam is not None else cam
            rgb, low_fr, pipe.state = pipe._frame(
                self.grid, cam, cam_prev, pipe.state, self._render_params())
            pipe._last_cam = cam
            out_high = pipe.state.prev_high
            if pipe.use_planar:
                # channel-first planes and the nested planar state: to the
                # high-res (1, H, W, 6) layout the channels read
                from isosurfacesuperresolution_tpu_torch.infer.planar import (
                    state_to_flat)
                from isosurfacesuperresolution_tpu_torch.ops.resize import (
                    pixel_shuffle)
                rgb = rgb.permute(1, 2, 0)
                out_high = pixel_shuffle(state_to_flat(out_high), 4)

        if self.channel != "color":
            rgb = self._select_channel(out_high, low_fr)

        if self.foc_enabled and self.mode != "gt" and self.channel == "color":
            viewport, mask = self._foc_bounds_and_mask()
            _, foc_rgb = self._shaded_gt(cam,
                                         self._high_cfg(viewport=viewport))
            mask = torch.as_tensor(mask, device=rgb.device)
            rgb = mask * foc_rgb + (1 - mask) * rgb

        if (self.temporal_smoothing > 0 and self._prev_rgb is not None
                and self.mode != "gt" and low_fr is not None):
            flow = inpaint_flow(low_fr[None, ..., 8:10],
                                low_fr[None, ..., 3:4], iterations=8)
            prev_warped = warp_upscale(self._prev_rgb[None], flow,
                                       self.upscale)[0]
            f = self.temporal_smoothing
            rgb = f * prev_warped + (1 - f) * rgb

        rgb = torch.clamp(rgb, 0.0, 1.0)
        out = rgb.cpu().numpy()          # waits for the device
        self._prev_rgb = rgb
        self._last_cam = cam
        dt = time.time() - t0
        self._frame_times.append(dt)
        self.last_frame_ms = dt * 1000.0
        return out

    def _select_channel(self, out_high: torch.Tensor, low_fr):
        buf = out_high[0]
        if self.channel == "mask":
            return (buf[..., 0:1] * 0.5 + 0.5).repeat(1, 1, 3)
        if self.channel == "normal":
            return buf[..., 1:4] * 0.5 + 0.5
        if self.channel == "depth":
            return torch.clamp(buf[..., 4:5], 0, 1).repeat(1, 1, 3)
        if self.channel == "ao":
            return torch.clamp(buf[..., 5:6], 0, 1).repeat(1, 1, 3)
        if self.channel == "flow":
            if low_fr is None:
                return torch.zeros(buf.shape[:2] + (3,), device=buf.device)
            from isosurfacesuperresolution_tpu_torch.ops.resize import resize
            f = resize(low_fr[None, ..., 8:10] * 10 + 0.5,
                       scale=float(self.upscale), method="nearest")[0]
            return torch.cat([torch.clamp(f, 0, 1),
                              torch.zeros_like(f[..., :1])], -1)
        raise ValueError(self.channel)

    @property
    def fps(self) -> float:
        if not self._frame_times:
            return 0.0
        return len(self._frame_times) / sum(self._frame_times)

    # -- screenshots ---------------------------------------------------------
    def save_screenshot(self, directory: str = "screenshots") -> str:
        """Render a frame to a PNG with a JSON sidecar of the settings."""
        os.makedirs(directory, exist_ok=True)
        rgb = self.render_frame()
        info = {
            "model": self.mode,
            "channel": self.channel,
            "data": self.input_name,
            "timestamp": time.strftime("%mm%dd-%Hh%Mm%Ss"),
            "iso": self.render_cfg.isovalue,
            "shading": {
                "ambient_light": list(self.shading_cfg.ambient_color),
                "diffuse_light": list(self.shading_cfg.diffuse_color),
                "specular_light": list(self.shading_cfg.specular_color),
                "specular_exponent": self.shading_cfg.specular_exponent,
                "material_color": list(self.shading_cfg.material_color),
            },
            "ao": {"samples": self.ao_samples, "radius": self.ao_radius,
                   "strength": self.shading_cfg.ao_strength},
        }
        name = ".".join([info["data"], info["model"], info["channel"],
                         info["timestamp"]]) + ".png"
        path = os.path.join(directory, name)
        write_png(path, to_uint8(rgb))
        with open(path + ".json", "w") as f:
            json.dump(info, f, indent=4, sort_keys=True)
        return path


def load_models(specs, device) -> Dict[str, "LoadedModel"]:
    """{run dir's name: LoadedModel} of the run dirs among ``specs``
    (the baseline modes are skipped)."""
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    return {os.path.basename(m.rstrip("/")):
            LoadedModel.from_run_dir(m, device=device)
            for m in specs if m not in MODES}


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--models", nargs="*", default=[],
                   help="run dirs of trained models")
    p.add_argument("--resX", type=int, default=320)
    p.add_argument("--resY", type=int, default=240)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas", "march"],
                   help="sweep_pallas = the march kernel (fastest)")
    p.add_argument("--tk", action="store_true", help="interactive Tk UI")
    p.add_argument("--frames", type=int, default=0,
                   help="headless: render an N-frame orbit to PNGs")
    p.add_argument("--output", type=str, default="gui_out")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    grid, vol_name = load_volume(args.volume, device=device)
    models = load_models(args.models, device)
    viewer = Viewer(grid, models, res_x=args.resX, res_y=args.resY,
                    isovalue=args.isovalue, renderer=args.renderer)
    viewer.input_name = vol_name
    if not models:
        viewer.set_mode("bilinear")

    if args.tk:
        _tk_main(viewer)
        return viewer

    os.makedirs(args.output, exist_ok=True)
    n = args.frames or 8
    for i in range(n):
        viewer.camera.start_move()
        viewer.camera.move(20 * i, 0)
        rgb = viewer.render_frame()
        out = os.path.join(args.output, f"frame_{i:04d}.png")
        write_png(out, to_uint8(rgb))
        print(f"{out}  ({viewer.fps:.1f} FPS)")
    return viewer


def _tk_main(viewer: Viewer):
    """The Tk front end over ``viewer``: isovalue and smoothing sliders,
    mode and channel buttons, a screenshot button, drag to orbit, the
    wheel to zoom."""
    import tkinter as tk

    from PIL import Image, ImageTk

    root = tk.Tk()
    label = tk.Label(root)
    label.pack(side=tk.LEFT)
    panel = tk.Frame(root)
    panel.pack(side=tk.RIGHT, fill=tk.Y)

    iso = tk.Scale(panel, from_=0.05, to=0.95, resolution=0.01,
                   orient=tk.HORIZONTAL, label="isovalue",
                   command=lambda v: viewer.set_isovalue(float(v)))
    iso.set(viewer.render_cfg.isovalue)
    iso.pack(fill=tk.X)
    smooth = tk.Scale(panel, from_=0, to=100, orient=tk.HORIZONTAL,
                      label="temporal smoothing %",
                      command=lambda v: setattr(viewer, "temporal_smoothing",
                                                float(v) / 100.0))
    smooth.pack(fill=tk.X)

    mode_var = tk.StringVar(value=viewer.mode)
    for m in list(viewer.models) + list(MODES):
        tk.Radiobutton(panel, text=m, variable=mode_var, value=m,
                       command=lambda: viewer.set_mode(mode_var.get())
                       ).pack(anchor=tk.W)
    chan_var = tk.StringVar(value="color")
    for c in Viewer.CHANNELS:
        tk.Radiobutton(panel, text=c, variable=chan_var, value=c,
                       command=lambda: setattr(viewer, "channel",
                                               chan_var.get())
                       ).pack(anchor=tk.W)
    tk.Button(panel, text="screenshot",
              command=viewer.save_screenshot).pack(fill=tk.X)

    drag = {"x": 0, "y": 0}

    def on_press(e):
        drag["x"], drag["y"] = e.x, e.y
        viewer.camera.start_move()

    def on_drag(e):
        viewer.camera.move(e.x - drag["x"], e.y - drag["y"])

    def on_wheel(e):
        viewer.camera.zoom(-1 if e.delta > 0 else 1)

    label.bind("<ButtonPress-1>", on_press)
    label.bind("<B1-Motion>", on_drag)
    label.bind("<MouseWheel>", on_wheel)

    def tick():
        rgb = viewer.render_frame()
        img = ImageTk.PhotoImage(Image.fromarray(to_uint8(rgb)))
        label.configure(image=img)
        label.image = img
        root.title(f"isosurface SR viewer - {viewer.fps:.1f} FPS "
                   f"({viewer.last_frame_ms:.1f} ms)")
        root.after(1, tick)

    tick()
    root.mainloop()


if __name__ == "__main__":
    main()
