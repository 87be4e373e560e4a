"""What the adversarial stage buys: texture and sharpness evidence, panels.

Counterpart of the JAX package's `apps/adv_evidence.py`.  PSNR alone
always favours the L2-trained net; this harness measures the perceptual
side on held-out crops (the last frame of each clip, the recurrence
settled, inside the loss's 16-px border):

- PSNR of the shaded color (the known cost);
- gradient-magnitude retention |grad pred| / |grad GT| (1.0 = as sharp as
  the ground truth; smoothing sits below 1, hallucination above);
- the L1 distance of the log gradient-magnitude histograms to GT's;
- gram-matrix texture distance to GT on 16x16 patches: in pixel space, on
  VGG features (`losses/vgg.py`; the fixed-seed features without a weight
  file) and on the learned in-domain features
  (`losses/learned_features.py`, `artifacts/texenc/texenc.npz`);

and writes side-by-side shaded panels (GT | each model) of the crops with
the most gradient energy (PNG, Pillow).  Runs on the card unless
``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.adv_evidence \\
      --dataset /path/to/clips --models bilinear artifacts/run00017 \\
      --output adv_evidence
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True,
                   help="npy clip dir (a --cacheDataset directory)")
    p.add_argument("--models", nargs="+", required=True,
                   help="run dirs and/or nearest|bilinear|bicubic")
    p.add_argument("--cropSize", type=int, default=32)
    p.add_argument("--samples", type=int, default=400)
    p.add_argument("--testFraction", type=float, default=0.2)
    p.add_argument("--numPanels", type=int, default=6)
    p.add_argument("--output", type=str, default="adv_evidence")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _grad_mag(img: torch.Tensor) -> torch.Tensor:
    """Mean finite-difference gradient magnitude of (B, H, W, C) -> (B,)."""
    dx = img[:, :, 1:] - img[:, :, :-1]
    dy = img[:, 1:] - img[:, :-1]
    return (torch.mean(torch.abs(dx), dim=(1, 2, 3))
            + torch.mean(torch.abs(dy), dim=(1, 2, 3)))


def _grad_hist(img_np: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Log-space gradient-magnitude histogram over all crops (host)."""
    dx = np.abs(img_np[:, :, 1:] - img_np[:, :, :-1]).ravel()
    dy = np.abs(img_np[:, 1:] - img_np[:, :-1]).ravel()
    g = np.concatenate([dx, dy])
    h, _ = np.histogram(np.log10(g + 1e-4), bins=bins, density=True)
    return h


def panel_image(panels: dict, names, count: int) -> np.ndarray:
    """Rows of crops (each 3x nearest-upscaled), one column per name,
    4-px white separators -> float (H, W, 3)."""
    tiles = []
    for i in range(count):
        row = [np.clip(panels[n][i], 0, 1) for n in names]
        row = [np.kron(t, np.ones((3, 3, 1), np.float32)) for t in row]
        sep = np.ones((row[0].shape[0], 4, 3), np.float32)
        out = []
        for t in row:
            out.extend([t, sep])
        tiles.append(np.concatenate(out[:-1], axis=1))
    vsep = np.ones((4, tiles[0].shape[1], 3), np.float32)
    img = []
    for t in tiles:
        img.extend([t, vsep])
    return np.concatenate(img[:-1], axis=0)


@torch.no_grad()
def main(argv=None):
    """Returns the table's rows: (model, PSNR, grad ratio, hist L1, gram
    pixel, gram VGG, gram learned)."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_gui import write_png
    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_crops import (
        BASELINES, load_test_crops, predictions)
    from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        fp32_convs)
    from isosurfacesuperresolution_tpu_torch.losses.builder import (
        texture_loss)
    from isosurfacesuperresolution_tpu_torch.losses.learned_features import (
        TexEncoder, load_texenc_params)
    from isosurfacesuperresolution_tpu_torch.losses.vgg import (
        VGG19Features, load_vgg19_params)
    from isosurfacesuperresolution_tpu_torch.ops.metrics import psnr
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    low_all, flow_all, high_all = load_test_crops(args, device)

    shading_cfg = ShadingConfig()
    B = 16                     # the loss's border

    vgg = VGG19Features(max_conv=8)
    vgg_params, vgg_pretrained = load_vgg19_params(max_conv=8)
    vgg.load_state_dict(vgg_params)
    vgg.to(device)
    if not vgg_pretrained:
        print("note: tex-vgg uses the documented random-feature VGG "
              "fallback (no pretrained weights in this environment); "
              "random projections still rank gram distances")
    texenc_params = load_texenc_params()
    texenc = None
    if texenc_params is not None:
        texenc = TexEncoder()
        texenc.load_state_dict(texenc_params)
        texenc.to(device)
    else:
        print("note: no committed texenc weights "
              "(apps.train_texenc writes artifacts/texenc/texenc.npz); "
              "TexGramLearned column will read 'nan'")

    def shade(g):
        return screen_space_shading(g, shading_cfg)

    gt_shaded = shade(high_all[:, -1])[:, B:-B, B:-B]
    gt_np = gt_shaded.cpu().numpy().astype(np.float32)
    hist_bins = np.linspace(-4.0, 0.5, 46)
    gt_hist = _grad_hist(gt_np, hist_bins)
    gt_grad = _grad_mag(gt_shaded).cpu().numpy()

    panel_idx = np.argsort(-gt_grad)[:args.numPanels]
    panels = {"GT": gt_np[panel_idx]}

    print(f"{'model':24s} {'psnr':>7s} {'grad-ratio':>10s} "
          f"{'hist-L1':>8s} {'tex-pix':>9s} {'tex-vgg':>9s} "
          f"{'tex-lrn':>9s}")
    rows = []
    n = gt_shaded.shape[0]
    for spec in args.models:
        *_, pred = predictions(spec, low_all, flow_all, device)
        pr_shaded = shade(pred)[:, B:-B, B:-B]
        pr_np = pr_shaded.cpu().numpy().astype(np.float32)

        m_psnr = float(torch.mean(psnr(pr_shaded, gt_shaded)))
        m_ratio = float(np.mean(_grad_mag(pr_shaded).cpu().numpy()
                                / np.maximum(gt_grad, 1e-6)))
        m_hist = float(np.abs(_grad_hist(pr_np, hist_bins)
                              - gt_hist).mean())
        m_texp = float(texture_loss(gt_shaded, pr_shaded))
        both = torch.cat([gt_shaded, pr_shaded], 0)
        with fp32_convs():
            fg = vgg(both)
            fl = texenc(both) if texenc is not None else None
        key = sorted(fg.keys())[len(fg) // 2]   # a mid-depth layer
        m_texv = float(texture_loss(fg[key][:n], fg[key][n:]))
        m_texl = (float(texture_loss(fl["conv_3"][:n], fl["conv_3"][n:]))
                  if fl is not None else float("nan"))

        name = (spec if spec in BASELINES
                else os.path.basename(spec.rstrip("/")))
        print(f"{name:24s} {m_psnr:7.2f} {m_ratio:10.3f} {m_hist:8.4f} "
              f"{m_texp:9.2e} {m_texv:9.2e} {m_texl:9.2e}", flush=True)
        rows.append((name, m_psnr, m_ratio, m_hist, m_texp, m_texv,
                     m_texl))
        panels[name] = pr_np[panel_idx]

    tsv = os.path.join(args.output, "adv_evidence.tsv")
    with open(tsv, "w") as f:
        f.write("Model\tPSNR-color\tGradRatio\tGradHistL1\t"
                "TexGramPix\tTexGramVGG\tTexGramLearned\n")
        for r in rows:
            f.write(f"{r[0]}\t{r[1]:.4f}\t{r[2]:.4f}\t{r[3]:.5f}\t"
                    f"{r[4]:.6e}\t{r[5]:.6e}\t{r[6]:.6e}\n")
    print("wrote", tsv)

    names = ["GT"] + [r[0] for r in rows]
    img = panel_image(panels, names, len(panel_idx))
    png = os.path.join(args.output, "panels.png")
    write_png(png, (img * 255).astype(np.uint8))
    with open(os.path.join(args.output, "panels.txt"), "w") as f:
        f.write("columns left->right: " + " | ".join(names) + "\n")
    print("wrote", png, "columns:", " | ".join(names))
    return rows


if __name__ == "__main__":
    main()
