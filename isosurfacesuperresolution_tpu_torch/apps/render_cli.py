"""Renderer CLI: single images and animations to files.

Counterpart of the JAX package's `apps/render_cli.py`, the CLI front of
the reference renderers (`CPURenderer.cpp:119-354` camera/material/light
arguments and modes, `renderSingle` / `renderAnimation` of
`GPURenderer.cpp:775-855`): a frame (with AO) over an interpolated
camera path, optionally a re-rendered low-res version, as PNGs of the
shaded color, ``.npz`` files of the 12-channel float G-buffer
(``--saveGbuffer``) and the reference's EXR layout (``--saveExr``: rgba,
``_depth``, ``_fx`` and ``_flow`` files, `GPURenderer.cpp:728-773`).
It renders on the card unless ``--device cpu`` is given; PNGs are
written by Pillow (their decoded pixels are JAX's).

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.render_cli \\
      --volume analytic:blobs --res 512,512 --animation 10 \\
      --origin 0,1,-1.7,0.3,1,-1.6 --downscale_factor 4 \\
      --ao volume --aosamples 64 --renderer sweep_pallas --output frames/
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def _vec(s: str, n: int):
    v = tuple(float(x) for x in s.split(","))
    if len(v) != n:
        raise argparse.ArgumentTypeError(f"expected {n} comma values: {s}")
    return v


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--output", type=str, default="render_out")
    p.add_argument("--res", type=lambda s: _vec(s, 2), default=(512, 512))
    p.add_argument("--animation", type=int, default=0,
                   help="number of frames (0 = single image)")
    p.add_argument("--origin", type=str, default="0,1,-1.7",
                   help="x,y,z or x0,y0,z0,x1,y1,z1 for animation")
    p.add_argument("--lookat", type=str, default="0,0,0")
    p.add_argument("--up", type=lambda s: _vec(s, 3), default=(0, 1, 0))
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--isovalue", type=float, default=0.36)
    p.add_argument("--diffuse", type=lambda s: _vec(s, 3),
                   default=(0.8, 0.8, 0.8))
    p.add_argument("--specular", type=lambda s: _vec(s, 3),
                   default=(0.1, 0.1, 0.1))
    p.add_argument("--exponent", type=int, default=16)
    p.add_argument("--light", type=str, default="camera",
                   help="'camera' or x,y,z direction")
    p.add_argument("--ao", type=str, default="none",
                   choices=["none", "ray", "volume", "screen"])
    p.add_argument("--aosamples", type=int, default=64)
    p.add_argument("--aoradius", type=float, default=0.1)
    p.add_argument("--downscale_factor", type=int, default=0,
                   help="also re-render 1/N resolution (0 = off)")
    p.add_argument("--renderer", type=str, default="sweep")
    p.add_argument("--sparse", action="store_true",
                   help="pack into sparse tile-atlas storage (GVDB-atlas "
                        "parity; forces renderer=sweep_pallas, reference "
                        "tolerance 1e-3)")
    p.add_argument("--saveGbuffer", action="store_true")
    p.add_argument("--saveExr", action="store_true",
                   help="also write the frame as reference-layout EXRs "
                        "(rgba + _depth + _fx + _flow files, built-in "
                        "codec; GPURenderer.cpp:728-773)")
    p.add_argument("-m", "--mode", type=str, default="iso",
                   choices=["iso", "volume"],
                   help="iso = G-buffer isosurface rendering; volume = "
                        "direct volume rendering with the transfer "
                        "function (CPURenderer.cpp:175, "
                        "GPURenderer.cpp:670-689)")
    p.add_argument("--tf", type=str, default="",
                   help="transfer function as d,r,g,b,a;d,r,g,b,a;... "
                        "(default: the reference's 4-segment ramp)")
    p.add_argument("--alphaScale", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write float RGB(A) in [0, 1] as 8-bit PNG (truncated, as JAX's
    ``(x * 255).astype(np.uint8)``)."""
    from PIL import Image
    Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(path)


def write_exrs(base: str, frame: np.ndarray) -> None:
    """The reference's four EXR files of one (H, W, 12) G-buffer."""
    from isosurfacesuperresolution_tpu_torch.data.exr import write_exr
    zeros = np.zeros_like(frame[..., 0])
    write_exr(base + ".exr",
              {"R": frame[..., 0], "G": frame[..., 1],
               "B": frame[..., 2], "A": frame[..., 3]})
    write_exr(base + "_depth.exr",
              {"R": frame[..., 4], "G": frame[..., 5],
               "B": frame[..., 6], "A": frame[..., 7]})
    write_exr(base + "_fx.exr",
              {"R": frame[..., 10], "G": frame[..., 11], "B": zeros,
               "A": np.ones_like(frame[..., 0])})
    write_exr(base + "_flow.exr",
              {"R": frame[..., 8], "G": frame[..., 9], "B": zeros})


def main(argv=None):
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.ssao import (
        apply_screen_ao)

    grid, vol_name = load_volume(args.volume,
                                 device=resolve_device(args.device))
    if args.sparse:
        if args.ao == "ray":
            raise SystemExit("--sparse supports --ao none|volume|screen "
                             "(hemisphere-ray AO needs dense values)")
        from isosurfacesuperresolution_tpu_torch.volume.packed import (
            SparseBrickGrid)
        if args.ao == "volume":
            # bake on the dense grid, then pack field + density together
            grid = attach_baked_ao(grid, args.isovalue, args.aoradius)
        grid = SparseBrickGrid.from_brick_grid(grid, tolerance=1e-3)
        args.renderer = "sweep_pallas"
    w, h = int(args.res[0]), int(args.res[1])

    tf = None
    if args.mode == "volume":
        from isosurfacesuperresolution_tpu_torch.render.volume_render import (
            DEFAULT_TF, render_volume_sweep)
        tf = DEFAULT_TF
        if args.tf:
            tf = tuple(tuple(float(x) for x in seg.split(","))
                       for seg in args.tf.split(";"))

    origin = tuple(float(x) for x in args.origin.split(","))
    lookat = tuple(float(x) for x in args.lookat.split(","))
    o0, o1 = ((origin[:3], origin[3:]) if len(origin) == 6
              else (origin, origin))
    l0, l1 = ((lookat[:3], lookat[3:]) if len(lookat) == 6
              else (lookat, lookat))

    camera_light = args.light == "camera"
    light_dir = ((0.0, 0.0, 1.0) if camera_light
                 else _vec(args.light, 3))

    cfg = RenderConfig(
        width=w, height=h, isovalue=args.isovalue, renderer=args.renderer,
        diffuse_color=args.diffuse, specular_color=args.specular,
        specular_exponent=args.exponent, camera_light=camera_light,
        light_direction=light_dir,
        ao_samples=args.aosamples if args.ao in ("ray", "volume") else 0,
        ao_radius=args.aoradius,
        ao_mode="volume" if args.ao == "volume" else "ray")
    if args.ao == "volume" and not args.sparse:
        # (--sparse bakes before packing, above)
        grid = attach_baked_ao(grid, args.isovalue, args.aoradius)

    os.makedirs(args.output, exist_ok=True)
    n = max(args.animation, 1)
    last = None
    for i in range(n):
        a = i / (n - 1) if n > 1 else 0.0
        eye = tuple((1 - a) * x0 + a * x1 for x0, x1 in zip(o0, o1))
        look = tuple((1 - a) * x0 + a * x1 for x0, x1 in zip(l0, l1))
        cam = CameraParams.create(eye, look, args.up, args.fov)
        suffix = f"_{i:05d}" if args.animation else ""
        base = os.path.join(args.output, f"{vol_name}{suffix}")
        if args.mode == "volume":
            cfg_v = dataclasses.replace(
                cfg, volume_alpha_scale=args.alphaScale)
            rgba = render_volume_sweep(grid, cam, cfg_v, tf).cpu().numpy()
            write_png(base + ".png", rgba)
            if args.saveGbuffer:
                np.savez_compressed(base + ".npz", rgba=rgba)
            last = cam
            continue
        frame = render_frame_gbuffer(grid, cam, last or cam, cfg)
        last = cam
        if args.ao == "screen":
            frame = apply_screen_ao(frame, samples=args.aosamples,
                                    radius_px=max(4, int(args.aoradius * w)))
        frame = frame.cpu().numpy()
        if args.saveExr:
            write_exrs(base, frame)
        write_png(base + ".png", frame[..., :3] * frame[..., 10:11])
        if args.saveGbuffer:
            np.savez_compressed(base + ".npz", gbuffer=frame)
        if args.downscale_factor:
            cfg_lo = cfg.replace(width=w // args.downscale_factor,
                                 height=h // args.downscale_factor,
                                 ao_samples=0)
            lo = render_frame_gbuffer(grid, cam, last, cfg_lo).cpu().numpy()
            write_png(base + "_low.png", lo[..., :3])
            if args.saveGbuffer:
                np.savez_compressed(base + "_low.npz", gbuffer=lo)
        print(f"frame {i + 1}/{n} written")


if __name__ == "__main__":
    main()
