"""All-angle robustness harness: PSNR / SSIM over random sphere cameras.

Counterpart of the JAX package's `apps/main_psnr_allangles.py`
(`mainPSNR2_AllAngles.py`): random sphere cameras x rolls, the ground
truth rendered live at 4x against each model's output, per-view unmasked
PSNR of the normal and the shaded color, SSIM, min / max / mean +-
variance by the Welford accumulator, and a count of frames with NaNs.
With ``--aoSamples`` > 0 the grid carries the baked AO field
(`render/ao_sweep.attach_baked_ao`), which ``--renderer sweep_pallas``
renders with the march kernel's AO variant (B1-ao).  Runs on the card
unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_psnr_allangles \\
      --volume analytic:torus --models bilinear --cameras 10 --rolls 2
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

BASELINES = ("nearest", "bilinear", "bicubic")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:torus")
    p.add_argument("--models", nargs="+", default=["bilinear"])
    p.add_argument("--cameras", type=int, default=50)
    p.add_argument("--rolls", type=int, default=6)
    p.add_argument("--lowRes", type=int, default=64,
                   help="low-res input size (GT = 4x)")
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--aoSamples", type=int, default=0)
    p.add_argument("--aoStrength", type=float, default=None,
                   help="AO shading strength; default 0 when --aoSamples=0 "
                        "(the reference pairs AO_SAMPLES=0 with "
                        "AO_STRENGTH=0.0), else 0.8")
    p.add_argument("--output", type=str, default="allangles_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas"],
                   help="sweep_pallas = the march kernel (fastest)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def roll_cameras(rng: np.random.RandomState, cameras: int, rolls: int):
    """Yield (camera index, roll index, CameraParams): per camera a
    uniformly random direction at distance U(1.2, 2), looking at the
    origin, rolled ``rolls`` times about the view axis."""
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    for ci in range(cameras):
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        eye = v * rng.uniform(1.2, 2.0)
        for ri in range(rolls):
            ang = 2 * math.pi * ri / rolls
            base_up = np.array([0.0, 1.0, 0.0])
            if abs(np.dot(v, base_up)) > 0.95:
                base_up = np.array([1.0, 0.0, 0.0])
            right = np.cross(v, base_up)
            right /= np.linalg.norm(right)
            up2 = np.cos(ang) * base_up + np.sin(ang) * right
            yield ci, ri, CameraParams.create(eye, (0, 0, 0), up2)


@torch.no_grad()
def main(argv=None):
    """Writes the TSV of every model's summary; returns its path."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.bench.stats import (
        STATS_SHADING)
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.ops.metrics import (
        MeanVariance, psnr, ssim)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        gbuffer_to_high_target, gbuffer_to_low_input)
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        clamp_output)

    device = resolve_device(args.device)
    grid, vol_name = load_volume(args.volume, device=device)
    ao_radius = 0.2      # the training generator's radius (SequenceConfig)
    if args.aoSamples > 0:
        # the baked occlusion field: AO frames take the sweep's field path
        from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
            attach_baked_ao)
        grid = attach_baked_ao(grid, args.isovalue, ao_radius)
    low_cfg = RenderConfig(width=args.lowRes, height=args.lowRes,
                           isovalue=args.isovalue,
                           ao_samples=args.aoSamples, ao_radius=ao_radius,
                           renderer=args.renderer)
    high_cfg = low_cfg.replace(width=args.lowRes * 4,
                               height=args.lowRes * 4)
    # AO_SAMPLES=0 goes with AO_STRENGTH=0: shading must not read an AO
    # channel the protocol does not render
    ao_strength = args.aoStrength
    if ao_strength is None:
        ao_strength = 0.0 if args.aoSamples == 0 else 0.8
    shading_cfg = STATS_SHADING.replace(ao_strength=ao_strength)

    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, f"allangles_{vol_name}.tsv")

    with open(out_path, "w") as f:
        f.write("Model\tPSNRnormal-min\tPSNRnormal-max\tPSNRnormal-mean\t"
                "PSNRnormal-var\tPSNRcolor-min\tPSNRcolor-max\t"
                "PSNRcolor-mean\tPSNRcolor-var\tSSIMnormal-mean\t"
                "SSIMcolor-mean\tNaN-frames\n")
        for model_spec in args.models:
            loaded = (None if model_spec in BASELINES
                      else LoadedModel.from_run_dir(model_spec,
                                                    device=device))
            mv_pn, mv_pc = MeanVariance(), MeanVariance()
            mv_sn, mv_sc = MeanVariance(), MeanVariance()
            pn_min, pn_max = np.inf, -np.inf
            pc_min, pc_max = np.inf, -np.inf
            nan_frames = 0
            for _, _, cam in roll_cameras(np.random.RandomState(args.seed),
                                          args.cameras, args.rolls):
                fr_lo = render_frame_gbuffer(grid, cam, cam, low_cfg)
                fr_hi = render_frame_gbuffer(grid, cam, cam, high_cfg)
                low = gbuffer_to_low_input(fr_lo)[None]
                gt = gbuffer_to_high_target(fr_hi)[None]
                # the reference's protocol: baselines upsample the low-res
                # SHADED image; networks are shaded at high res, and color
                # and normal composited over the black background with the
                # bilinearly upsampled INPUT mask; plain PSNR then
                if loaded is None:
                    up = resize(low, scale=4.0, method=model_spec)
                    pred_n = up[..., 1:4]
                    pred_c = torch.clamp(resize(
                        torch.clamp(screen_space_shading(low, shading_cfg),
                                    0, 1),
                        scale=4.0, method=model_spec), 0, 1)
                    pred_all = pred_c
                else:
                    flow = torch.zeros(low.shape[:3] + (2,), device=device)
                    pred = clamp_output(loaded.inference(low, None, flow))
                    pred_all = pred
                    base_mask = torch.clamp(resize(
                        low[..., 0:1], scale=4.0, method="bilinear")
                        * 0.5 + 0.5, 0.0, 1.0)
                    pred_n = base_mask * pred[..., 1:4]
                    pred_c = base_mask * torch.clamp(
                        screen_space_shading(pred, shading_cfg), 0, 1)
                if not bool(torch.isfinite(pred_all).all()):
                    nan_frames += 1
                    continue
                gt_n = gt[..., 1:4]
                gt_c = torch.clamp(screen_space_shading(gt, shading_cfg),
                                   0, 1)
                pn = float(psnr(pred_n, gt_n)[0])
                pc = float(psnr(pred_c, gt_c)[0])
                mv_pn.append(pn)
                mv_pc.append(pc)
                mv_sn.append(float(ssim(pred_n, gt_n, val_range=2.0)))
                mv_sc.append(float(ssim(pred_c, gt_c, val_range=1.0)))
                pn_min, pn_max = min(pn_min, pn), max(pn_max, pn)
                pc_min, pc_max = min(pc_min, pc), max(pc_max, pc)
            name = (model_spec if loaded is None
                    else os.path.basename(model_spec.rstrip("/")))
            f.write(f"{name}\t{pn_min:.4f}\t{pn_max:.4f}\t"
                    f"{mv_pn.mean():.4f}\t{mv_pn.var():.6f}\t"
                    f"{pc_min:.4f}\t{pc_max:.4f}\t"
                    f"{mv_pc.mean():.4f}\t{mv_pc.var():.6f}\t"
                    f"{mv_sn.mean():.4f}\t{mv_sc.mean():.4f}\t"
                    f"{nan_frames}\n")
            print(f"{name}: PSNR normal {mv_pn.mean():.2f} "
                  f"[{pn_min:.2f}, {pn_max:.2f}] dB, "
                  f"color {mv_pc.mean():.2f} "
                  f"[{pc_min:.2f}, {pc_max:.2f}] dB over "
                  f"{mv_pn.count()} views")
    print("wrote", out_path)
    return out_path


if __name__ == "__main__":
    main()
