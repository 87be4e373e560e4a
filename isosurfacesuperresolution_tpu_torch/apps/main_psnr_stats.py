"""Paper-statistics harness: masked PSNR / MS-SSIM / consistency per model.

Counterpart of the JAX package's `apps/main_psnr_stats.py`
(`mainPSNR3_AllStats.py`): for each volume and each model (trained run
dirs plus nearest/bilinear/bicubic baselines), run the frame-recurrent
inference over rendered sequences and accumulate the Statistics table
(border 15 px, fill >= 5%), writing one TSV per volume, a per-sequence
spread table and npz histograms.  Clips render on the card's march
kernels (`data/generation.generate_sequences`; ``--renderer sweep`` is
the slice scan, the renderer JAX's harness uses), the models run there
too (``--device``, default ``cuda``).

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats \\
      --volumes analytic:torus analytic:blobs \\
      --models bilinear runs/run00001 --output stats_out
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

BASELINES = ("nearest", "bilinear", "bicubic")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--volumes", nargs="+", default=["analytic:torus"],
                   help="analytic:<name>[:<res>], .dat, .npy, .vdb or "
                        ".cvol.npz files")
    p.add_argument("--models", nargs="+", default=["bilinear"],
                   help="run dirs and/or nearest|bilinear|bicubic")
    p.add_argument("--variants", nargs="+", default=[],
                   help="named model variants 'name=spec[:notemporal]"
                        "[:masked]' (mainPSNR4_ColoredNets.py): "
                        "notemporal disables the frame recurrence, masked "
                        "replaces the predicted silhouette with the "
                        "upscaled input mask (and gates AO on it)")
    p.add_argument("--output", type=str, default="stats_out")
    p.add_argument("--numSequences", type=int, default=4)
    p.add_argument("--numFrames", type=int, default=10)
    p.add_argument("--highRes", type=int, default=256)
    p.add_argument("--aoSamples", type=int, default=64)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--renderer", type=str, default="sweep_pallas",
                   help="clip renderer: sweep_pallas (the kernels, "
                        "default) or sweep (the slice scan)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def load_volume(spec: str, device=None):
    """A volume spec -> (BrickGrid on ``device``, name): analytic:<name>
    [:<resolution>] (made on the device), a ``.dat`` descriptor, a
    ``.cvol.npz``, a dense ``.npy`` or a ``.vdb``."""
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    from isosurfacesuperresolution_tpu_torch.volume.importers import (
        import_npy, import_raw, load_cvol)
    if spec.startswith("analytic:"):
        parts = spec.split(":")        # analytic:<name>[:<resolution>]
        name = parts[1]
        res = int(parts[2]) if len(parts) > 2 else 128
        return getattr(analytic, f"{name}_volume")(res, device=device), name
    if spec.endswith(".dat"):
        return (import_raw(spec, device=device),
                os.path.basename(spec)[:-4])
    if spec.endswith(".npz"):
        return (load_cvol(spec, device=device),
                os.path.basename(spec).split(".")[0])
    if spec.endswith(".npy"):
        return (import_npy(spec, device=device),
                os.path.basename(spec)[:-4])
    if spec.endswith(".vdb"):
        from isosurfacesuperresolution_tpu_torch.volume.vdb import load_vdb
        grid, _ = load_vdb(spec, device=device)
        return grid, os.path.basename(spec)[:-4]
    raise SystemExit(f"unknown volume spec {spec}")


def model_entries(args):
    """(name, spec, temporal, masked) of every --models and --variants
    entry."""
    entries = []
    for model_spec in args.models:
        name = (model_spec if model_spec in BASELINES
                else os.path.basename(model_spec.rstrip("/")))
        entries.append((name, model_spec, True, False))
    for v in args.variants:
        name, rest = v.split("=", 1)
        parts = rest.split(":")
        flags = set(parts[1:])
        unknown = flags - {"notemporal", "masked"}
        if unknown:
            raise SystemExit(f"unknown variant flags {unknown}")
        entries.append((name, parts[0], "notemporal" not in flags,
                        "masked" in flags))
    return entries


def run_model(sequences, model_spec: str, temporal: bool, masked: bool,
              device):
    """The Statistics of one model over the clips."""
    import torch

    from isosurfacesuperresolution_tpu_torch.bench.stats import Statistics
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        clamp_output)

    loaded: Optional[LoadedModel] = None
    if model_spec not in BASELINES:
        loaded = LoadedModel.from_run_dir(model_spec, device=device)
    stats = Statistics()
    for seq in sequences:
        clip = {k: torch.from_numpy(seq[k]).to(device)
                for k in ("low", "high", "flow")}
        prev_high = None
        for t in range(clip["low"].shape[0]):
            low = clip["low"][t:t + 1]
            gt = clip["high"][t:t + 1]
            flow = clip["flow"][t:t + 1]
            if loaded is None:
                up = resize(low, scale=4.0, method=model_spec)
                pred = torch.cat([up, torch.ones_like(up[..., :1])], -1)
            else:
                pred = clamp_output(loaded.inference(low, prev_high, flow))
                if temporal:
                    prev_high = pred
            if masked:
                # silhouette from the upscaled input; AO gated toward 1
                # outside it (mainComparisonVideo3.py:544-548)
                base = resize(low[..., 0:1], scale=4.0,
                              method="bilinear") * 0.5 + 0.5
                pred = torch.cat([base * 2.0 - 1.0, pred[..., 1:5],
                                  1.0 + base * (pred[..., 5:6] - 1.0)], -1)
            stats.add_timestep_sample(pred, gt, low)
        stats.mark_sequence()
    return stats


def main(argv=None):
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.bench.stats import Statistics
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    entries = model_entries(args)

    for vol_spec in args.volumes:
        grid, vol_name = load_volume(vol_spec, device=device)
        seq_cfg = SequenceConfig(num_frames=args.numFrames,
                                 high_res=args.highRes,
                                 ao_samples=args.aoSamples,
                                 iso_range=(args.isovalue, args.isovalue))
        base = RenderConfig(isovalue=args.isovalue, step_voxels=0.5,
                            renderer=args.renderer)
        sequences = generate_sequences(
            [(grid, (args.isovalue, args.isovalue))], args.numSequences,
            seq_cfg, base_render_cfg=base, seed=args.seed)

        out_path = os.path.join(args.output, f"stats_{vol_name}.tsv")
        err_rows = []       # (model, seq_spread dict) for the _err table
        with open(out_path, "w") as f:
            f.write("Model\t" + Statistics.header())
            for name, model_spec, temporal, masked in entries:
                stats = run_model(sequences, model_spec, temporal, masked,
                                  device)
                f.write(name + "\t")
                stats.write_sample(f)
                err_rows.append((name, stats.seq_spread()))
                # the per-sequence means ride along so that model
                # comparisons can be paired (same sequences for every
                # model)
                np.savez(os.path.join(
                    args.output, f"hist_{vol_name}_{name}.npz"),
                    **{f"seq_{k}": np.array([m[k] for m in
                                             stats.seq_means])
                       for k in (stats.seq_means[0] if stats.seq_means
                                 else {})},
                    **stats.histograms)
                m = stats.means()
                print(f"[{vol_name}] {name}: "
                      f"PSNR color+AO {m['psnr_color_withAO']:.2f} dB, "
                      f"normal {m['psnr_normal']:.2f} dB "
                      f"({stats.n} frames)")
        print("wrote", out_path)

        # per-sequence uncertainty (mean +- std over sequences per
        # mean-type field); _max fields are global and carry no spread
        err_path = os.path.join(args.output, f"stats_{vol_name}_err.tsv")
        with open(err_path, "w") as f:
            f.write("Model\tField\tMean\tStd\tMin\tMax\tNseq\n")
            for name, spread in err_rows:
                for field, s in spread.items():
                    f.write(f"{name}\t{field}\t{s['mean']:.6f}\t"
                            f"{s['std']:.6f}\t{s['min']:.6f}\t"
                            f"{s['max']:.6f}\t{s['nseq']}\n")
        print("wrote", err_path)


if __name__ == "__main__":
    main()
