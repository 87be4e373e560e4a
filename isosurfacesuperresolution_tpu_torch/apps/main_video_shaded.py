"""CLI trainer for shaded (RGB-output) video super-resolution networks.

Counterpart of the JAX package's `apps/main_video_shaded.py` (the
reference's `mainVideo.py`): the network takes the shaded low-res frame
(RGB, mask, normal, depth) and gives RGB; the losses are
`losses/lossnet.py`'s ``<loss>:<weight>`` list (default
``l1:1,temp-l2:0.1``).  It takes `main_video_unshaded`'s flags, its
configuration and its clips (shaded here by `train.trainer_shaded.
shade_clip`), and runs on the card unless ``--device cpu`` is given.

A run dir gets ``config.json``, ``info.txt``, the epoch's mean loss a
frame under JAX's tag ``train/total_loss`` in JAX's TensorBoard event
file (``tensorboard/events.out.tfevents.*``) and in ``scalars.jsonl``,
and ``checkpoints/epoch_<N>.pt``; `infer.loadedmodel.LoadedModel` reads
the newest of these.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_video_shaded \\
      --dataset analytic:blobs --epochs 5 --losses l1:1,temp-l2:0.1
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from isosurfacesuperresolution_tpu_torch.apps.main_video_unshaded import (
        build_parser as base_parser)
    p = base_parser()
    p.description = "Video super-resolution trainer (shaded nets)"
    p.set_defaults(losses="l1:1,temp-l2:0.1")
    return p


def main(argv=None) -> str:
    """Train; returns the run dir."""
    args = build_parser().parse_args(argv)
    from isosurfacesuperresolution_tpu_torch.apps.main_video_unshaded import (
        ScalarWriter, load_sequences, make_config)
    cfg = make_config(args)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, input_channels=8, output_channels=3,
        channel_mask=(0, 1, 2)))

    import torch

    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
        CheckpointManager, next_run_dir, write_info)
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        epoch_learning_rate, make_optimizer, set_learning_rate)
    from isosurfacesuperresolution_tpu_torch.train.trainer_shaded import (
        TRAINING_SHADING, create_shaded_train_state, make_shaded_train_step,
        shade_clip)

    device = resolve_device(args.device)
    t = cfg.train
    rng = np.random.RandomState(t.seed)
    sequences = load_sequences(args, cfg, device)
    dataset = VideoDataset(sequences, upscale_factor=cfg.model.upscale_factor)
    samples = dataset.collect_samples(t.samples, t.crop_size,
                                      t.min_fill_rate, rng,
                                      augment=t.augment)
    train_set = DatasetFromSamples(dataset, samples, t.crop_size,
                                   test=False, test_fraction=t.test_fraction)
    print(f"#sequences: {len(sequences)}, train crops: {len(train_set)}")

    gen = torch.Generator().manual_seed(t.seed)
    model = create_network(cfg.model, generator=gen).to(device)
    criterion = LossNet(cfg.loss,
                        high_res=t.crop_size * cfg.model.upscale_factor,
                        input_channels=8, output_channels=3,
                        losses=cfg.loss.losses)
    state = create_shaded_train_state(cfg, model, criterion,
                                      make_optimizer(cfg), gen)
    train_step = make_shaded_train_step(cfg, model, criterion)

    run_dir = next_run_dir(t.run_dir_base)
    write_info(run_dir, cfg)
    ckpt = CheckpointManager(run_dir)
    writer = ScalarWriter(run_dir)
    print("run dir:", run_dir)
    try:
        for epoch in range(1, t.epochs + 1):
            set_learning_rate(state.optimizer,
                              epoch_learning_rate(cfg, epoch - 1))
            t0 = time.time()
            epoch_loss, n = 0.0, 0
            for batch in train_set.batches(t.batch_size, rng=rng):
                low, flow, high = (torch.from_numpy(b).to(device)
                                   for b in batch)
                lo_shaded, hi_rgb = shade_clip(low, high, TRAINING_SHADING)
                state, loss = train_step(state, lo_shaded, flow, hi_rgb)
                epoch_loss += float(loss)
                n += 1
            epoch_loss /= max(n, 1) * t.num_frames
            writer.add_scalar("train/total_loss", epoch_loss, epoch)
            print(f"===> Epoch {epoch}: loss {epoch_loss:.4f} "
                  f"({time.time() - t0:.1f}s)")
            if epoch % t.checkpoint_every == 0:
                ckpt.save(epoch, state)
    finally:
        writer.close()
    print("done; checkpoints in", run_dir)
    return run_dir


if __name__ == "__main__":
    main()
