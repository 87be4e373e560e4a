"""VGG layer-response analysis: the perceptual loss's layer weights.

Counterpart of the JAX package's `apps/vgg_analysis.py` (`VGGAnalysis.py`):
the mean response magnitude of each VGG-19 conv layer over shaded renders
from random sphere cameras; their reciprocals weigh the perceptual loss's
layers so that each contributes alike.  Without a VGG weight file the
features are the fixed-seed ones of `losses/vgg.load_vgg19_params`, as in
JAX.  Runs on the card unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.vgg_analysis \\
      --volume analytic:blobs --images 16 --layers 12
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas"],
                   help="sweep_pallas = the march kernel (fastest)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


@torch.no_grad()
def main(argv=None):
    """Returns [(layer, mean |response|, suggested weight)]."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.config import (
        RenderConfig, ShadingConfig)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        fp32_convs)
    from isosurfacesuperresolution_tpu_torch.losses.vgg import (
        VGG19Features, load_vgg19_params)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        random_sphere_camera)
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        gbuffer_to_high_target)
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)

    device = resolve_device(args.device)
    grid, _ = load_volume(args.volume, device=device)
    cfg = RenderConfig(width=args.res, height=args.res,
                       isovalue=args.isovalue, ao_samples=0,
                       renderer=args.renderer)
    shading = ShadingConfig(diffuse_color=(1.0,) * 3,
                            material_color=(1.0, 0.3, 0.0))

    vgg = VGG19Features(max_conv=args.layers)
    params, pretrained = load_vgg19_params(args.layers)
    vgg.load_state_dict(params)
    vgg.to(device)
    print("pretrained VGG:", pretrained)

    rng = np.random.RandomState(args.seed)
    acc = {f"conv_{i}": 0.0 for i in range(1, args.layers + 1)}
    for _ in range(args.images):
        cam = random_sphere_camera(rng)
        fr = render_frame_gbuffer(grid, cam, cam, cfg)
        rgb = screen_space_shading(gbuffer_to_high_target(fr)[None], shading)
        with fp32_convs():
            feats = vgg(rgb)
        for k, v in feats.items():
            acc[k] += float(torch.mean(torch.abs(v)))

    print("\nlayer\tmean|response|\tsuggested weight (1/response)")
    table = []
    for i in range(1, args.layers + 1):
        k = f"conv_{i}"
        mean = acc[k] / args.images
        w = 1.0 / max(mean, 1e-8)
        table.append((k, mean, w))
        print(f"{k}\t{mean:.4f}\t{w:.4f}")
    spec = ",".join(f"{k}:{w:.3g}" for k, _, w in table)
    print("\n--perceptualLossLayers", spec)
    return table


if __name__ == "__main__":
    main()
