"""PSNR of models against the ground truth on held-out test crops.

Counterpart of the JAX package's `apps/main_psnr_crops.py`
(`mainPSNR1.py:133-187`): trained run dirs and the interpolation
baselines on the dataset's test crops (the trainer's test split of the
same crops, `data/dataset`), per-channel masked PSNR averaged over crops
and frames.  All crops go to the device as one batch; runs on the card
unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_psnr_crops \\
      --dataset /path/to/clips --models bilinear artifacts/run00017
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

BASELINES = ("nearest", "bilinear", "bicubic")
BORDER = 16    # the training loss zeroes a 16-px border: crop it off


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True,
                   help="npy clip dir (e.g. a --cacheDataset directory)")
    p.add_argument("--models", nargs="+", default=["bilinear"])
    p.add_argument("--cropSize", type=int, default=32)
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--testFraction", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def load_test_crops(args, device):
    """The test split's clips as device tensors: low (N, T, h, w, 5),
    flow (N, T, h, w, 2), high (N, T, 4h, 4w, 6)."""
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset, load_reference_npy_dir)
    ds = VideoDataset(load_reference_npy_dir(args.dataset))
    rng = np.random.RandomState(args.seed)
    samples = ds.collect_samples(args.samples, args.cropSize, 0.5, rng)
    test = DatasetFromSamples(ds, samples, args.cropSize, test=True,
                              test_fraction=args.testFraction)
    print(f"test crops: {len(test)}")
    lows, flows, highs = zip(*[test[i] for i in range(len(test))])
    return tuple(torch.as_tensor(np.stack(a), device=device)
                 for a in (lows, flows, highs))


def predictions(spec: str, low_all, flow_all, device):
    """Yield each frame's (N, H, W, 6) prediction of model ``spec``: a
    baseline's upsampled input with a mask-free AO of 1, or the run's
    recurrent network, clamped."""
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        clamp_output)
    loaded = (None if spec in BASELINES
              else LoadedModel.from_run_dir(spec, device=device))
    prev = None
    for t in range(low_all.shape[1]):
        lo = low_all[:, t]
        if loaded is None:
            up = resize(lo, scale=4.0, method=spec)
            yield torch.cat([up, torch.ones_like(up[..., :1])], -1)
        else:
            prev = clamp_output(loaded.inference(lo, prev, flow_all[:, t]))
            yield prev


@torch.no_grad()
def main(argv=None):
    """Returns {model name: the six mean PSNRs (color, color inside the
    border, mask, normal, depth, AO)}."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.ops.metrics import psnr
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)

    device = resolve_device(args.device)
    low_all, flow_all, high_all = load_test_crops(args, device)
    shading_cfg = ShadingConfig()
    B = BORDER

    print(f"{'model':24s} {'color':>7s} {'col-i':>7s} {'mask':>7s} "
          f"{'normal':>7s} {'depth':>7s} {'ao':>7s}")

    def metrics_frame(pred, gt):
        """(N, H, W, 6) -> (N, 6) metric vector, on the device."""
        sp = screen_space_shading(pred, shading_cfg)
        sg = screen_space_shading(gt, shading_cfg)
        p_c = pred[:, B:-B, B:-B]
        g_c = gt[:, B:-B, B:-B]
        mask = g_c[..., 0:1] * 0.5 + 0.5
        return torch.stack([
            psnr(sp, sg),
            psnr(sp[:, B:-B, B:-B], sg[:, B:-B, B:-B]),
            psnr(p_c[..., 0:1], g_c[..., 0:1]),
            psnr(p_c[..., 1:4], g_c[..., 1:4], mask=mask),
            psnr(p_c[..., 4:5], g_c[..., 4:5], mask=mask),
            psnr(p_c[..., 5:6], g_c[..., 5:6], mask=mask),
        ], -1)

    N, T = low_all.shape[0], low_all.shape[1]
    results = {}
    for spec in args.models:
        acc = torch.zeros(6, device=device)
        for t, pred in enumerate(predictions(spec, low_all, flow_all,
                                             device)):
            acc = acc + torch.sum(metrics_frame(pred, high_all[:, t]), 0)
        acc = acc.cpu().numpy() / (N * T)
        name = (spec if spec in BASELINES
                else os.path.basename(spec.rstrip("/")))
        print(f"{name:24s} {acc[0]:7.2f} {acc[1]:7.2f} {acc[2]:7.2f} "
              f"{acc[3]:7.2f} {acc[4]:7.2f} {acc[5]:7.2f}", flush=True)
        results[name] = acc
    return results


if __name__ == "__main__":
    main()
