"""Paper-figure "lens" tool: full frames with magnified insets.

Counterpart of the JAX package's `apps/image_vis.py` (`mainImageVis.py`):
renders the ground truth and each model's output for a fixed camera
through the viewer (`apps/main_gui.Viewer`, on the grid's device), then
writes one figure per model: the frame with the lens rectangle marked
and the magnified inset to its right (PNG, Pillow).

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.image_vis \\
      --volume analytic:blobs --models bilinear gt --lens 0.5,0.5,0.15 \\
      --output figures/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _draw_rect(img: np.ndarray, y0: int, x0: int, y1: int, x1: int,
               color=(1.0, 0.2, 0.2), width: int = 2) -> np.ndarray:
    img = img.copy()
    c = np.asarray(color, img.dtype)
    img[y0:y0 + width, x0:x1] = c
    img[y1 - width:y1, x0:x1] = c
    img[y0:y1, x0:x0 + width] = c
    img[y0:y1, x1 - width:x1] = c
    return img


def make_lens_figure(rgb: np.ndarray, lens_cx: float, lens_cy: float,
                     lens_size: float, zoom: int = 3) -> np.ndarray:
    """The frame with the lens rectangle, and the inset magnified
    ``zoom`` times (letterboxed to the frame's height) to its right."""
    h, w = rgb.shape[:2]
    s = int(lens_size * min(h, w) / 2)
    cy, cx = int(lens_cy * h), int(lens_cx * w)
    y0, y1 = max(0, cy - s), min(h, cy + s)
    x0, x1 = max(0, cx - s), min(w, cx + s)
    inset = rgb[y0:y1, x0:x1]
    inset = np.kron(inset, np.ones((zoom, zoom, 1), rgb.dtype))
    ih, iw = inset.shape[:2]
    canvas = np.zeros((h, iw, 3), rgb.dtype)
    off = max(0, (h - ih) // 2)
    canvas[off:off + min(ih, h)] = inset[:min(ih, h)]
    canvas = _draw_rect(canvas, max(0, off), 0, min(h, off + ih), iw)
    marked = _draw_rect(rgb, y0, x0, y1, x1)
    return np.concatenate([marked, canvas], axis=1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--models", nargs="+", default=["bilinear", "gt"])
    p.add_argument("--lowRes", type=int, default=120)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--lens", type=str, default="0.5,0.5,0.2",
                   help="cx,cy,size (fractions of the frame)")
    p.add_argument("--zoom", type=int, default=3)
    p.add_argument("--eye", type=str, default="0,0.9,-1.7")
    p.add_argument("--output", type=str, default="figures")
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas", "march"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_gui import (
        MODES, Viewer, load_models, write_png)
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device

    cx, cy, size = (float(v) for v in args.lens.split(","))
    eye = tuple(float(v) for v in args.eye.split(","))
    device = resolve_device(args.device)
    grid, vol_name = load_volume(args.volume, device=device)
    models = load_models(args.models, device)
    os.makedirs(args.output, exist_ok=True)

    viewer = Viewer(grid, models, res_x=args.lowRes, res_y=args.lowRes,
                    isovalue=args.isovalue, renderer=args.renderer)
    cam = viewer.camera
    cam.current_distance, cam.current_pitch, cam.current_yaw = (
        cam.to_angles(eye))

    paths = []
    for mode in args.models:
        name = mode if mode in MODES else os.path.basename(mode.rstrip("/"))
        viewer.set_mode(name)
        rgb = viewer.render_frame()
        fig = make_lens_figure(rgb, cx, cy, size, args.zoom)
        path = os.path.join(args.output, f"{vol_name}_{name}_lens.png")
        write_png(path, (np.clip(fig, 0, 1) * 255).astype(np.uint8))
        print("wrote", path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
