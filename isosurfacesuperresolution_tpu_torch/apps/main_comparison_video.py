"""Scene-scripted comparison videos.

Counterpart of the JAX package's `apps/main_comparison_video.py`:
- ``--script``: scripted scenes (camera rotation, isovalue sweep, light
  sweep, material-color sweep, fov zoom; `mainComparisonVideo3.py`), one
  video or PNG sequence per model and channel;
- ``--preset v1|v2``: fixed scene sets (per-dataset isovalue, material
  and distance; `mainComparisonVideo1.py`, `mainComparisonVideo2.py`)
  rendered as labeled side-by-side rotations over all models, each scene
  on the analytic family that stands in for its dataset.

Frames come from the viewer (`apps/main_gui.Viewer`) on the card unless
``--device cpu``.  A video is written with ``imageio.mimwrite`` as in
JAX, and where that fails (no imageio, or no mp4 writer) as PNG frames
through Pillow; ``--pngs`` writes the PNGs directly.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_comparison_video \\
      --volume analytic:blobs --script rotation --frames 48 \\
      --models bilinear --output video_out
  python -m isosurfacesuperresolution_tpu_torch.apps.main_comparison_video \\
      --preset v1 --models bilinear artifacts/run00017 --output video_out
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Callable, Dict, List

import numpy as np


# ---------------------------------------------------------------------------
# scene scripts (mainComparisonVideo3.py:92-312)
# ---------------------------------------------------------------------------

def script_rotation(i: int, n: int, base: dict) -> dict:
    ang = 2 * math.pi * i / n
    d = base["distance"]
    return {**base, "eye": (d * math.sin(ang), base["height"],
                            -d * math.cos(ang))}


def script_isovalue(i: int, n: int, base: dict) -> dict:
    lo, hi = base.get("iso_range", (0.25, 0.7))
    a = i / max(n - 1, 1)
    tri = 1.0 - abs(2 * a - 1.0)           # sweep up then down
    return {**base, "isovalue": lo + (hi - lo) * tri}


def script_light(i: int, n: int, base: dict) -> dict:
    ang = 2 * math.pi * i / n
    return {**base, "camera_light": False,
            "light_direction": (math.sin(ang), -0.5, math.cos(ang))}


def script_color(i: int, n: int, base: dict) -> dict:
    a = i / max(n - 1, 1)
    return {**base, "diffuse": (1.0 - 0.7 * a, 0.3 + 0.5 * a, 0.2)}


def script_zoom(i: int, n: int, base: dict) -> dict:
    a = i / max(n - 1, 1)
    tri = 1.0 - abs(2 * a - 1.0)
    return {**base, "fov": 45.0 - 25.0 * tri}


SCRIPTS: Dict[str, Callable] = {
    "rotation": script_rotation,
    "isovalue": script_isovalue,
    "light": script_light,
    "color": script_color,
    "zoom": script_zoom,
}


# ---------------------------------------------------------------------------
# fixed scene sets (mainComparisonVideo1.py:28-79, mainComparisonVideo2.py);
# the colors are the reference's, 0-255 RGB
# ---------------------------------------------------------------------------

def _c(r, g, b):
    return (r / 255.0, g / 255.0, b / 255.0)


PRESETS: Dict[str, List[dict]] = {
    "v1": [
        {"name": "cloud-training", "volume": "analytic:blobs",
         "isovalue": 0.5, "diffuse": _c(255, 76, 0),
         "ambient": _c(25, 25, 25), "specular": _c(50, 50, 50),
         "distance": 1.8},
        {"name": "smoke-plume", "volume": "analytic:turbulence",
         "isovalue": 0.46, "diffuse": _c(165, 184, 186),
         "ambient": _c(25, 25, 25), "specular": _c(50, 50, 50),
         "distance": 1.95},
        {"name": "ejecta-test", "volume": "analytic:ejecta",
         "isovalue": 0.40, "diffuse": _c(138, 129, 255),
         "ambient": _c(0, 90, 15), "specular": _c(50, 50, 50),
         "distance": 0.9},
        {"name": "bonsai-test", "volume": "analytic:torus",
         "isovalue": 0.5, "diffuse": _c(0, 173, 0),
         "ambient": _c(76, 31, 31), "specular": _c(30, 30, 30),
         "distance": 2.6},
    ],
    "v2": [
        {"name": "rm-interface", "volume": "analytic:interface",
         "isovalue": 0.5, "diffuse": _c(200, 180, 140),
         "ambient": _c(25, 25, 25), "specular": _c(50, 50, 50),
         "distance": 1.6},
        {"name": "gyroid-shell", "volume": "analytic:gyroid",
         "isovalue": 0.5, "diffuse": _c(120, 160, 255),
         "ambient": _c(25, 25, 25), "specular": _c(50, 50, 50),
         "distance": 1.7},
        {"name": "ejecta-dense", "volume": "analytic:ejecta",
         "isovalue": 0.35, "diffuse": _c(255, 255, 255),
         "ambient": _c(10, 10, 40), "specular": _c(50, 50, 50),
         "distance": 1.2},
    ],
}


def _label(img: np.ndarray, text: str) -> np.ndarray:
    """Burn a model label into the frame top-left (the reference uses PIL
    fonts, `mainComparisonVideo1.py:152-`)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    d.rectangle([2, 2, 8 + 7 * len(text), 18], fill=(0, 0, 0))
    d.text((5, 4), text, fill=(255, 255, 255))
    return np.asarray(im)


def _label(img: np.ndarray, text: str) -> np.ndarray:
    """Burn a model label into the frame's top-left corner (Pillow's
    default font, as the reference's `mainComparisonVideo1.py`)."""
    from PIL import Image, ImageDraw
    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    d.rectangle([2, 2, 8 + 7 * len(text), 18], fill=(0, 0, 0))
    d.text((5, 4), text, fill=(255, 255, 255))
    return np.asarray(im)


def write_pngs(directory: str, frames: List[np.ndarray]) -> None:
    from isosurfacesuperresolution_tpu_torch.apps.main_gui import write_png
    os.makedirs(directory, exist_ok=True)
    for i, fr in enumerate(frames):
        write_png(os.path.join(directory, f"{i:04d}.png"), fr)


def write_video(path: str, frames: List[np.ndarray], fps: int) -> str:
    """``imageio.mimwrite`` to ``path``, as JAX writes it; where that
    fails, PNG frames into ``path`` without its ``.mp4``.  Returns what
    was written."""
    try:
        import imageio
        imageio.mimwrite(path, frames, fps=fps)
        print("wrote", path)
        return path
    except Exception as e:     # no imageio or no mp4 writer: PNGs
        print(f"mp4 write failed ({e}); writing PNGs")
        directory = path[:-len(".mp4")]
        write_pngs(directory, frames)
        return directory


def _viewer_setup(args):
    from isosurfacesuperresolution_tpu_torch.apps.main_gui import (
        MODES, load_models)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    models = load_models(args.models, device)
    modes = [m if m in MODES else os.path.basename(m.rstrip("/"))
             for m in args.models]
    return device, models, modes


def _set_eye(viewer, eye) -> None:
    cam = viewer.camera
    cam.current_distance, cam.current_pitch, cam.current_yaw = (
        cam.to_angles(eye))


def run_preset(args) -> List[str]:
    """Render each preset scene as one labeled side-by-side rotation over
    all requested models."""
    from isosurfacesuperresolution_tpu_torch.apps.main_gui import Viewer
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)

    device, models, mode_list = _viewer_setup(args)
    os.makedirs(args.output, exist_ok=True)
    written = []
    for scene in PRESETS[args.preset]:
        grid, _ = load_volume(scene["volume"], device=device)
        viewer = Viewer(grid, models, res_x=args.lowRes, res_y=args.lowRes,
                        isovalue=scene["isovalue"], renderer=args.renderer)
        viewer.set_material(diffuse_color=scene["diffuse"],
                            ambient_color=scene["ambient"],
                            specular_color=scene["specular"])
        frames = []
        for i in range(args.frames):
            ang = 2 * math.pi * i / args.frames
            d = scene["distance"]
            eye = (d * math.sin(ang), 0.9, -d * math.cos(ang))
            row = []
            for mode in mode_list:
                # switch the active mode only: `set_mode` resets every
                # pipeline's recurrence, and each pipeline keeps its own
                viewer.mode = mode
                _set_eye(viewer, eye)
                rgb = viewer.render_frame()
                img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                row.append(_label(img, mode))
            frames.append(np.concatenate(row, axis=1))
        written.append(write_video(
            os.path.join(args.output, f"{args.preset}_{scene['name']}.mp4"),
            frames, args.fps))
    return written


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--models", nargs="+", default=["bilinear"])
    p.add_argument("--script", type=str, default="rotation",
                   choices=sorted(SCRIPTS))
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--lowRes", type=int, default=120)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--channels", nargs="+", default=["color"],
                   help="subset of color|mask|normal|depth|ao|flow")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--output", type=str, default="video_out")
    p.add_argument("--preset", type=str, default=None,
                   choices=sorted(PRESETS),
                   help="render a fixed scene set as labeled side-by-side "
                        "comparisons instead of --volume/--script")
    p.add_argument("--pngs", action="store_true",
                   help="write PNG frames instead of mp4")
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas", "march"],
                   help="sweep_pallas = the march kernel (fastest)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Returns the videos or PNG directories written."""
    args = build_parser().parse_args(argv)
    if args.preset:
        return run_preset(args)

    from isosurfacesuperresolution_tpu_torch.apps.main_gui import (
        MODES, Viewer)
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)

    device, models, _ = _viewer_setup(args)
    grid, vol_name = load_volume(args.volume, device=device)
    baselines = [m for m in args.models if m in MODES]

    os.makedirs(args.output, exist_ok=True)
    base = {"distance": 1.7, "height": 0.9, "isovalue": args.isovalue,
            "fov": 45.0, "eye": (0.0, 0.9, -1.7), "camera_light": True}
    script = SCRIPTS[args.script]

    written = []
    for mode in list(models) + baselines:
        viewer = Viewer(grid, models, res_x=args.lowRes, res_y=args.lowRes,
                        isovalue=args.isovalue, renderer=args.renderer)
        viewer.set_mode(mode)
        for channel in args.channels:
            viewer.channel = channel
            frames: List[np.ndarray] = []
            for i in range(args.frames):
                s = script(i, args.frames, base)
                _set_eye(viewer, s["eye"])
                if s["isovalue"] != viewer.render_cfg.isovalue:
                    # a sweep keeps the recurrence (the reference's video3
                    # keeps its previous frames across an isovalue ramp)
                    viewer.set_isovalue(s["isovalue"], reset_temporal=False)
                rgb = viewer.render_frame()
                frames.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            tag = f"{vol_name}_{args.script}_{mode}_{channel}"
            if args.pngs:
                d = os.path.join(args.output, tag)
                write_pngs(d, frames)
                print("wrote", d)
                written.append(d)
            else:
                written.append(write_video(
                    os.path.join(args.output, tag + ".mp4"), frames,
                    args.fps))
    return written


if __name__ == "__main__":
    main()
