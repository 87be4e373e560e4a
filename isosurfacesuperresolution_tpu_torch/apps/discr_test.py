"""Discriminator probe: logits for the ground truth and the prediction.

Counterpart of the JAX package's `apps/discr_test.py`
(`mainDiscrTest.py:37-105`): loads an adversarially trained run's
generator and discriminators (an orbax step or the port's own checkpoint,
`train/checkpoint.CheckpointManager`), renders a clip, and prints the
"adv" discriminator's logit for the ground truth and for the generator's
prediction on each crop: a check that it tells them apart.  Runs on the
card unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.discr_test \\
      artifacts/run00020/run00020 --volume analytic:blobs
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("--volume", type=str, default="analytic:blobs")
    p.add_argument("--crops", type=int, default=4)
    p.add_argument("--isovalue", type=float, default=0.5)
    p.add_argument("--renderer", type=str, default="sweep",
                   choices=["sweep", "sweep_pallas"],
                   help="the clip's renderer; sweep_pallas = the march "
                        "kernels")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


@torch.no_grad()
def main(argv=None):
    """Returns (epoch, [(crop, "gt" or "pred", adv logit)])."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.apps.main_psnr_stats import (
        load_volume)
    from isosurfacesuperresolution_tpu_torch.config import (
        RenderConfig, config_from_json)
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        VideoDataset)
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel, build_model)
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        fp32_convs)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        clamp_output)

    device = resolve_device(args.device)
    cfg = config_from_json(os.path.join(args.run_dir, "config.json"))
    u = cfg.model.upscale_factor
    criterion = LossNetUnshaded(cfg.loss, high_res=cfg.train.crop_size * u)
    if not criterion.has_discriminator:
        raise SystemExit("run was not trained adversarially "
                         "(no adv/tgan/sgan in its loss DSL)")
    mgr = CheckpointManager(args.run_dir)
    model, epoch = mgr.restore_params(create_network(cfg.model))
    mgr.restore_discr_params(criterion.discriminators, epoch)
    criterion.to(device).eval()
    lm = LoadedModel(build_model(cfg, model.state_dict(), device), cfg)
    print(f"restored epoch {epoch}")

    grid, _ = load_volume(args.volume, device=device)
    seq_cfg = SequenceConfig(num_frames=2, ao_samples=16,
                             high_res=cfg.train.crop_size * u * 2)
    base = RenderConfig(isovalue=args.isovalue, renderer=args.renderer)
    seqs = generate_sequences([(grid, (args.isovalue, args.isovalue))], 1,
                              seq_cfg, base_render_cfg=base, seed=0)
    ds = VideoDataset(seqs)
    samples = ds.collect_samples(args.crops, cfg.train.crop_size, 0.2,
                                 np.random.RandomState(0))

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    logits = []
    for si, s in enumerate(samples):
        low, flow, high = ds.get_clip(s, cfg.train.crop_size)
        low_t = dev(low[1:2])
        gt = dev(high[1:2])
        pred = clamp_output(lm.inference(low_t, dev(high[0:1]),
                                         dev(flow[1:2])))
        input_high = resize(low_t, scale=4.0, method=cfg.model.upsample)
        prev_in = input_high
        for name, tensor in [("gt", gt), ("pred", pred)]:
            x = torch.cat(
                [criterion._pad(input_high), criterion._pad(prev_in),
                 criterion._pad(criterion._colorize(tensor)),
                 criterion._pad(criterion._colorize(tensor))], -1)
            if criterion.has_adv:
                with fp32_convs():
                    logit = float(criterion.discriminators["adv"](x)[0, 0])
                print(f"crop {si} {name}: adv logit = {logit:+.4f}")
                logits.append((si, name, logit))
    return epoch, logits


if __name__ == "__main__":
    main()
