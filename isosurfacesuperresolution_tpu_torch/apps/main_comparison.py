"""Timing and comparison-image harness.

Counterpart of the JAX package's `apps/main_comparison.py`
(`mainComparisonImages.py`): per model, render frames at full HD (the
network's input a quarter of it), 5 warm-up and 10 timed frames, and
write ``timings.csv`` with the mean rendering, network and total seconds
and the FPS, plus each model's last frame with ``--saveImages``.  The
rendering column is the G-buffer alone (`render/api.
render_frame_gbuffer`, timed on its own first); frames are
`infer/pipeline.InferencePipeline`'s, on the card unless ``--device
cpu``; each clock read follows a synchronisation of the device.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_comparison \\
      --volume analytic:blobs --models bilinear artifacts/run00017 \\
      --renderer sweep_pallas --output comparison_out
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

BASELINES = ("nearest", "bilinear", "bicubic")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--models", nargs="+", default=["bilinear"])
    p.add_argument("--output", type=str, default="comparison_out")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--upscaling", type=int, default=4)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--saveImages", action="store_true")
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas"],
                   help="sweep_pallas = the march kernel (fastest)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns the rows of ``timings.csv``: (model, rendering s, network
    s, total s)."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_gui import (
        to_uint8, write_png)
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, RenderConfig)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        InferencePipeline)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    grid, vol_name = load_volume(args.volume, device=device)

    render_cfg = RenderConfig(width=args.width // args.upscaling,
                              height=args.height // args.upscaling,
                              isovalue=args.isovalue, step_voxels=0.5,
                              ao_samples=0, renderer=args.renderer)

    def cam_at(i):
        ang = 0.05 * i
        return CameraParams.create((1.7 * np.sin(ang), 0.9,
                                    -1.7 * np.cos(ang)))

    # the isolated G-buffer time (the "Rendering-Time (sec)" column)
    with torch.no_grad():
        render_frame_gbuffer(grid, cam_at(0), cam_at(0), render_cfg)
        _sync(device)
        t0 = time.time()
        for i in range(args.timed):
            render_frame_gbuffer(grid, cam_at(i), cam_at(i), render_cfg)
        _sync(device)
    render_time = (time.time() - t0) / args.timed

    rows = []
    for model_spec in args.models:
        if model_spec in BASELINES:
            pipe = InferencePipeline(model=None, cfg=Config(),
                                     render_cfg=render_cfg,
                                     upscale_mode=model_spec, device=device)
            name = model_spec
        else:
            loaded = LoadedModel.from_run_dir(model_spec, device=device)
            pipe = InferencePipeline(model=loaded.model, cfg=loaded.cfg,
                                     render_cfg=render_cfg, device=device)
            name = os.path.basename(model_spec.rstrip("/"))

        for i in range(args.warmup):
            rgb = pipe.frame(grid, cam_at(i))
        _sync(device)
        t0 = time.time()
        for i in range(args.timed):
            rgb = pipe.frame(grid, cam_at(args.warmup + i))
        _sync(device)
        total_time = (time.time() - t0) / args.timed
        network_time = max(total_time - render_time, 0.0)
        rows.append((name, render_time, network_time, total_time))
        print(f"{name}: total {1000 * total_time:.2f} ms "
              f"({1.0 / total_time:.1f} FPS)")
        if args.saveImages:
            write_png(os.path.join(args.output, f"{vol_name}_{name}.png"),
                      to_uint8(rgb.cpu().numpy()))

    csv_path = os.path.join(args.output, "timings.csv")
    with open(csv_path, "w") as f:
        f.write("Model,Rendering-Time (sec),Network-Time (sec),"
                "Total-Time (sec),FPS\n")
        for name, rt, nt, tt in rows:
            f.write(f"{name},{rt:.6f},{nt:.6f},{tt:.6f},{1.0 / tt:.2f}\n")
    print("wrote", csv_path)
    return rows


if __name__ == "__main__":
    main()
