"""Quality statistics harness: the paper's PSNR / MS-SSIM / consistency table.

Counterpart of the JAX package's `bench/stats.py`
(`mainPSNR3_AllStats.py:100-299`): per-timestep masked PSNR and MS-SSIM
for normal / depth / AO / color with and without AO, downsample-
consistency L2 (mean + max), and per-channel L1 error histograms; frames
with fill < MIN_FILLING are skipped, a BORDER-pixel rim is cropped, and
SSIM is computed with the prediction blended onto the GT outside the
mask.

A frame's metrics are plain tensor code on the frame's device, gathered
into three tensors that come to the host in one copy a frame.  The
histograms count as ``jnp.histogram(bins=200, range=(0, 1))`` does:
float32 edges, right edge inclusive, values outside dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
from isosurfacesuperresolution_tpu_torch.ops.metrics import msssim, psnr
from isosurfacesuperresolution_tpu_torch.ops.resize import resize
from isosurfacesuperresolution_tpu_torch.render.shading import (
    safe_normalize, screen_space_shading)

BORDER = 15          # mainPSNR3_AllStats.py:126
MIN_FILLING = 0.05   # :127
NUM_BINS = 200       # :128
# jnp.histogram's float32 bin edges over (0, 1)
BIN_EDGES = np.linspace(np.float32(0), np.float32(1), NUM_BINS + 1,
                        dtype=np.float32)

# the paper's stats shading constants (:109-119)
STATS_SHADING = ShadingConfig(
    ambient_color=(0.1, 0.1, 0.1),
    diffuse_color=(1.0, 1.0, 1.0),
    specular_color=(0.0, 0.0, 0.0),
    specular_exponent=16,
    enable_specular=True,
    light_direction=(0.1, 0.1, 1.0),
    material_color=(1.0, 0.3, 0.0),
    ao_strength=1.0,
)


def histogram_counts(x: torch.Tensor) -> torch.Tensor:
    """Counts of ``x`` in NUM_BINS bins over [0, 1] (float32), as
    ``jnp.histogram(x, bins=NUM_BINS, range=(0, 1))[0]`` counts them."""
    edges = torch.from_numpy(BIN_EDGES).to(x.device)
    idx = torch.bucketize(x.reshape(-1), edges, right=True)
    idx = torch.where(x.reshape(-1) == edges[-1], NUM_BINS, idx)
    return torch.bincount(idx, minlength=NUM_BINS + 2)[1:NUM_BINS + 1]


class Statistics:
    """Accumulates the reference's per-timestep quality statistics."""

    FIELDS = ["psnr_normal", "psnr_depth", "psnr_ao", "psnr_color_noAO",
              "psnr_color_withAO", "ssim_normal", "ssim_depth", "ssim_ao",
              "ssim_color_noAO", "ssim_color_withAO",
              "l2ds_normal_mean", "l2ds_normal_max",
              "l2ds_colorNoAO_mean", "l2ds_colorNoAO_max"]
    _MEAN_FIELDS = [f for f in FIELDS if not f.endswith("_max")]
    _HIST_KEYS = ["mask", "normal", "depth", "ao", "color_withAO",
                  "color_noAO"]

    def __init__(self, upscaling: int = 4,
                 shading_cfg: ShadingConfig = STATS_SHADING):
        self.upscaling = upscaling
        self.shading_cfg = shading_cfg
        self.histograms = {k: np.zeros(NUM_BINS, np.float64)
                           for k in self._HIST_KEYS}
        self.histogram_counter = 0
        self.reset()

    def reset(self):
        self.n = 0
        for f in self.FIELDS:
            setattr(self, f, 0.0)
        # per-sequence segments for error bars: mark_sequence() snapshots
        # the mean of every mean-type field over the frames added since
        # the previous mark
        self.seq_means = []
        self._seg_n = 0
        self._seg_sums = {f: 0.0 for f in self._MEAN_FIELDS}

    def mark_sequence(self) -> None:
        """Close the current sequence segment; records its per-field means.

        Call once per rendered camera sequence; segments where every frame
        was skipped for insufficient filling are dropped (no sample).
        """
        dn = self.n - self._seg_n
        if dn > 0:
            self.seq_means.append(
                {f: (getattr(self, f) - s) / dn
                 for f, s in self._seg_sums.items()})
        self._seg_n = self.n
        self._seg_sums = {f: getattr(self, f) for f in self._seg_sums}

    def seq_spread(self) -> Dict[str, Dict[str, float]]:
        """Per-field mean / std / min / max over the recorded sequences."""
        out = {}
        if not self.seq_means:
            return out
        for f in self.seq_means[0]:
            vals = np.array([m[f] for m in self.seq_means], np.float64)
            out[f] = {"mean": float(vals.mean()),
                      "std": float(vals.std(ddof=1)) if len(vals) > 1
                      else 0.0,
                      "min": float(vals.min()), "max": float(vals.max()),
                      "nseq": len(vals)}
        return out

    # -- core ---------------------------------------------------------------
    def frame_metrics(self, pred_mnda: torch.Tensor, gt_mnda: torch.Tensor,
                      input_mnda: torch.Tensor):
        """(fill, means, maxes, histogram counts) of one frame, all on the
        frame's device: pred/gt (1, H, W, 6), input (1, h, w, 5)."""
        cfg = self.shading_cfg
        no_ao = dataclasses.replace(cfg, ao_strength=0.0)
        up = self.upscaling
        pred_color_withAO = screen_space_shading(pred_mnda, cfg)
        gt_color_withAO = screen_space_shading(gt_mnda, cfg)
        pred_color_noAO = screen_space_shading(pred_mnda, no_ao)
        gt_color_noAO = screen_space_shading(gt_mnda, no_ao)
        input_color_noAO = screen_space_shading(input_mnda, no_ao)

        b2 = BORDER * up

        def crop(x):
            return x[:, b2:-b2, b2:-b2]

        def crop_lo(x):
            return x[:, BORDER:-BORDER, BORDER:-BORDER]

        pred_mnda_c = crop(pred_mnda)
        gt_mnda_c = crop(gt_mnda)
        pred_color_withAO = crop(pred_color_withAO)
        gt_color_withAO = crop(gt_color_withAO)
        pred_color_noAO = crop(pred_color_noAO)
        gt_color_noAO = crop(gt_color_noAO)
        input_mnda_c = crop_lo(input_mnda)
        input_color_noAO = crop_lo(input_color_noAO)

        mask = gt_mnda_c[..., 0:1] * 0.5 + 0.5
        fill = torch.mean(mask)

        def p(a, b):
            return psnr(a, b, mask=mask)[0]

        # pred blended onto gt outside the mask (:222); the reference
        # reassigns pred_mnda to this blend before the downsample
        # consistency and the mask/normal/depth/ao histograms
        # (:222-266), while the shaded colors above come from the raw
        # prediction
        pred_b = gt_mnda_c + mask * (pred_mnda_c - gt_mnda_c)

        def s(a, b):
            # the range inferred from the data, on the device, like the
            # reference's MSSSIM() (utils/ssim.py:105-136 via :34-42)
            return msssim(a, b, val_range=None)

        def ds(x):
            return resize(x, scale=1.0 / up, method="bilinear")

        # downsample consistency (:229-239), on the blended prediction
        ds_normal = (input_mnda_c[..., 1:4]
                     - safe_normalize(ds(pred_b[..., 1:4]))) ** 2
        ds_color = (input_color_noAO - ds(pred_color_noAO)) ** 2

        means = torch.stack([                        # _MEAN_FIELDS order
            p(pred_mnda_c[..., 1:4], gt_mnda_c[..., 1:4]),
            p(pred_mnda_c[..., 4:5], gt_mnda_c[..., 4:5]),
            p(pred_mnda_c[..., 5:6], gt_mnda_c[..., 5:6]),
            p(pred_color_noAO, gt_color_noAO),
            p(pred_color_withAO, gt_color_withAO),
            s(pred_b[..., 1:4], gt_mnda_c[..., 1:4]),
            s(pred_b[..., 4:5], gt_mnda_c[..., 4:5]),
            s(pred_b[..., 5:6], gt_mnda_c[..., 5:6]),
            s(pred_color_noAO, gt_color_noAO),
            s(pred_color_withAO, gt_color_withAO),
            torch.mean(ds_normal),
            torch.mean(ds_color),
        ])
        maxes = torch.stack([torch.max(ds_normal), torch.max(ds_color)])
        # per-pixel L1 error histograms (:242-266), raw counts
        hists = torch.stack([                        # _HIST_KEYS order
            histogram_counts(torch.abs(gt_mnda_c[0, ..., 0]
                                       - pred_b[0, ..., 0])),
            histogram_counts(torch.sum(torch.abs(
                gt_mnda_c[0, ..., 1:4] - pred_b[0, ..., 1:4]), -1) / 6),
            histogram_counts(torch.abs(gt_mnda_c[0, ..., 4]
                                       - pred_b[0, ..., 4])),
            histogram_counts(torch.abs(gt_mnda_c[0, ..., 5]
                                       - pred_b[0, ..., 5])),
            histogram_counts(torch.abs(gt_color_withAO[0, ..., 0]
                                       - pred_color_withAO[0, ..., 0])),
            histogram_counts(torch.abs(gt_color_noAO[0, ..., 0]
                                       - pred_color_noAO[0, ..., 0])),
        ])
        return fill, means, maxes, hists

    @torch.no_grad()
    def add_timestep_sample(self, pred_mnda: torch.Tensor,
                            gt_mnda: torch.Tensor,
                            input_mnda: torch.Tensor) -> bool:
        """Add one frame; all NHWC: pred/gt (1, H, W, 6), input (1, h, w, 5).

        Returns False if the frame was skipped for insufficient filling.
        """
        fill, means, maxes, hists = self.frame_metrics(pred_mnda, gt_mnda,
                                                       input_mnda)
        # the frame's one copy to the host
        host = torch.cat([fill.reshape(1), means, maxes,
                          hists.reshape(-1).to(torch.float32)]).cpu().numpy()
        nm = len(self._MEAN_FIELDS)
        fill, means = host[0], host[1:1 + nm]
        maxes, hists = host[1 + nm:3 + nm], host[3 + nm:]
        if float(fill) < MIN_FILLING:
            return False
        self.n += 1
        for f, v in zip(self._MEAN_FIELDS, np.asarray(means, np.float64)):
            setattr(self, f, getattr(self, f) + float(v))
        self.l2ds_normal_max = max(self.l2ds_normal_max, float(maxes[0]))
        self.l2ds_colorNoAO_max = max(self.l2ds_colorNoAO_max,
                                      float(maxes[1]))

        self.histogram_counter += 1
        c = self.histogram_counter
        hists = np.asarray(hists, np.float64).reshape(len(self._HIST_KEYS),
                                                      NUM_BINS)
        for key, counts in zip(self._HIST_KEYS, hists):
            # np.histogram(density=True)/NUM_BINS == counts/counts.sum()
            # (bin width 1/NUM_BINS); an empty in-range set counts 0
            frac = counts / max(counts.sum(), 1.0)
            self.histograms[key] += (frac - self.histograms[key]) / c
        return True

    # -- output -------------------------------------------------------------
    def means(self) -> Dict[str, float]:
        out = {}
        n = max(self.n, 1)
        for f in self.FIELDS:
            v = getattr(self, f)
            out[f] = v if f.endswith("_max") else v / n
        return out

    @staticmethod
    def header() -> str:
        return ("PSNR-normal\tPSNR-depth\tPSNR-ao\tPSNR-color-noAO\t"
                "PSNR-color-withAO\tSSIM-normal\tSSIM-depth\tSSIM-ao\t"
                "SSIM-color-noAO\tSSIM-color-withAO\tL2-ds-normal-mean\t"
                "L2-ds-normal-max\tL2-ds-color-noAO-mean\t"
                "L2-ds-color-noAO-max\n")

    def write_sample(self, file) -> None:
        m = self.means()
        file.write("\t".join("%.6f" % m[f] for f in self.FIELDS) + "\n")
