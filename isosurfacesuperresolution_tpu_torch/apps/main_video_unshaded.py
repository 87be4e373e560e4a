"""CLI trainer for unshaded video super-resolution networks.

Counterpart of the JAX package's `apps/main_video_unshaded.py` (the
reference's `mainVideoUnshaded.py`), with the same flags: the loss DSL,
the generator zoo, initial-image modes, adversarial training, run-dir
numbering, per-epoch checkpoints and the spike guard.  Data comes from
npy clip directories or from the renderer in the loop over analytic
volumes (`data.generation.generate_sequences` with JAX's
`SequenceConfig` and `RenderConfig` choices, the "sweep" scan renderer).

It runs on the card unless ``--device cpu`` is given.  Scalars and
``--imageEvery`` panels go, under JAX's tags, to JAX's TensorBoard event
file, ``<run_dir>/tensorboard/events.out.tfevents.*``
(`utils.tensorboard`), and also to ``<run_dir>/scalars.jsonl`` (one JSON
object a line: tag, value, step) and ``<run_dir>/images/<tag>_<epoch>.npy``.
``--restore RUN_DIR`` resumes the port's run dirs and JAX's orbax ones
alike at the epoch after the newest checkpoint (or ``--restoreEpoch``):
parameters, optimizer states, learning rate and step count.  Checkpoints go to
``<run_dir>/checkpoints/epoch_<N>.pt`` and the generator to
``<run_dir>/params.npz`` (JAX's format).  ``--dataset`` also takes a
``.dat`` volume or ``descriptor:<file>`` (a line "volume min_iso
max_iso" a volume), imported onto the run's device
(`volume/importers.py`) and rendered into clips there.

``--dataParallel N`` > 1 trains on N devices, one process each
(`parallel.mesh.make_sharded_train_step`: every process runs its 1/N of
each batch, one all-reduce averages the loss and gradients).  The
command spawns its N workers itself (rendezvous in a temporary
directory).  As in JAX, data parallelism batches on the host, and only
the plain step is sharded: with ``--advTraining`` the adversarial steps
run unsharded, once, on process 0, and the other processes idle, so that
mode gains nothing from N devices.  Process 0 writes the run dir, the
scalars and the checkpoints.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.main_video_unshaded \\
      --dataset analytic:blobs --samples 200 --epochs 5
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from isosurfacesuperresolution_tpu_torch.utils.tensorboard import EventWriter


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Video super-resolution trainer (unshaded nets)")
    p.add_argument("--dataset", type=str, default="analytic:blobs",
                   help="npy clip dir / index file, or analytic:<name> "
                        "(sphere|torus|gyroid|blobs|mix...)")
    p.add_argument("--numberOfImages", type=int, default=8,
                   help="sequences to generate for analytic datasets")
    p.add_argument("--aoSamples", type=int, default=64,
                   help="AO sample budget of generated training targets "
                        "(0 disables AO in the generated clips)")
    p.add_argument("--cameraDistance", type=str, default="0.95,1.3",
                   help="lo,hi camera-distance range of generated clips")
    p.add_argument("--testFraction", type=float, default=0.2)
    p.add_argument("--model", type=str, default="EnhanceNet")
    p.add_argument("--upsample", type=str, default="bilinear")
    p.add_argument("--reconType", type=str, default="residual")
    p.add_argument("--useBN", action="store_true")
    p.add_argument("--useSN", action="store_true",
                   help="spectral normalization in the generator and "
                        "discriminator")
    p.add_argument("--numResidualLayers", type=int, default=10)
    p.add_argument("--numFeatures", type=int, default=64)
    p.add_argument("--upscaleFactor", type=int, default=4)
    p.add_argument("--computeDtype", type=str, default="float32")
    p.add_argument("--samples", type=int, default=500)
    p.add_argument("--cropSize", type=int, default=32)
    p.add_argument("--numFrames", type=int, default=10)
    p.add_argument("--batchSize", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optim", type=str, default="Adam",
                   help="Adam (default), RMSprop or Rprop")
    p.add_argument("--gradClip", type=float, default=1.0,
                   help="global-norm gradient clip; 0 disables")
    p.add_argument("--lrGamma", type=float, default=0.5)
    p.add_argument("--lrStep", type=int, default=500)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--initialImage", type=str, default="zero",
                   choices=["zero", "unshaded", "input"])
    p.add_argument("--disableTemporal", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--minFillRate", type=float, default=0.5,
                   help="crop acceptance fill ratio")
    p.add_argument("--remat", action="store_true",
                   help="recompute each frame in the backward")
    p.add_argument("--losses", type=str,
                   default="l1:mask:1,l1:ao:1,l1:normal:10,l1:depth:10,"
                           "temp-l2:color:0.1")
    p.add_argument("--perceptualLossLayers", type=str,
                   default="conv_1:0.026423,conv_2:0.009285,conv_3:0.006710,"
                           "conv_4:0.004898,conv_5:0.003910,conv_6:0.003956,"
                           "conv_7:0.003813,conv_8:0.002968,conv_9:0.002997,"
                           "conv_10:0.003631,conv_11:0.004147,"
                           "conv_12:0.005765,conv_13:0.007442,"
                           "conv_14:0.009666,conv_15:0.012586,"
                           "conv_16:0.013377")
    p.add_argument("--textureLossLayers", type=str,
                   default="conv_1:1,conv_3:1,conv_5:1")
    p.add_argument("--discriminator", type=str, default="enhanceNetLarge")
    p.add_argument("--lossAmbient", type=float, default=0.1)
    p.add_argument("--lossDiffuse", type=float, default=1.0)
    p.add_argument("--lossSpecular", type=float, default=0.0)
    p.add_argument("--lossAO", type=float, default=1.0)
    p.add_argument("--lossBorderPadding", type=int, default=16)
    p.add_argument("--advTraining", action="store_true")
    p.add_argument("--pretrainedDiscr", type=str, default=None,
                   help="run dir: initialize the DISCRIMINATOR from its "
                        "latest checkpoint")
    p.add_argument("--ganType", type=str, default="bce",
                   choices=["bce", "wgan", "wgan-gp"])
    p.add_argument("--advDiscrLr", type=float, default=1e-4)
    p.add_argument("--advDiscrMaxSteps", type=int, default=1)
    p.add_argument("--advGenMaxSteps", type=int, default=1)
    p.add_argument("--runDir", type=str, default="runs")
    p.add_argument("--restore", type=str, default=None,
                   help="run dir to restore from")
    p.add_argument("--restoreEpoch", type=int, default=None)
    p.add_argument("--pretrained", type=str, default=None,
                   help="run dir or params .npz: initialize the GENERATOR "
                        "only, optimizers/discriminator fresh")
    p.add_argument("--imageEvery", type=int, default=10,
                   help="save test image panels every N epochs (0 "
                        "disables)")
    p.add_argument("--checkpointEvery", type=int, default=1)
    p.add_argument("--dataParallel", type=int, default=1,
                   help="devices on the batch axis, one process each")
    p.add_argument("--dataDtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage type of the device-resident dataset")
    p.add_argument("--hostData", action="store_true",
                   help="force host-side batching")
    p.add_argument("--volumeDtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "uint8"],
                   help="storage type of imported volumes")
    p.add_argument("--cacheDataset", type=str, default=None,
                   help="directory to cache generated clips (reference npy "
                        "layout); reused on the next run")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card)")
    return p


def make_config(args):
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, ParallelConfig, TrainConfig)
    return Config(
        model=ModelConfig(
            model=args.model, upscale_factor=args.upscaleFactor,
            upsample=args.upsample, recon_type=args.reconType,
            use_bn=args.useBN, use_sn=args.useSN,
            num_residual_blocks=args.numResidualLayers,
            num_features=args.numFeatures,
            compute_dtype=args.computeDtype),
        loss=LossConfig(
            losses=args.losses,
            perceptual_loss_layers=args.perceptualLossLayers,
            texture_loss_layers=args.textureLossLayers,
            discriminator=args.discriminator,
            loss_ambient=args.lossAmbient, loss_diffuse=args.lossDiffuse,
            loss_specular=args.lossSpecular, loss_ao=args.lossAO,
            padding=args.lossBorderPadding,
            gan_type=args.ganType),
        train=TrainConfig(
            batch_size=args.batchSize, crop_size=args.cropSize,
            num_frames=args.numFrames, samples=args.samples,
            test_fraction=args.testFraction, epochs=args.epochs,
            learning_rate=args.lr, optimizer=args.optim.lower(),
            lr_gamma=args.lrGamma,
            lr_step=args.lrStep, grad_clip=args.gradClip, seed=args.seed,
            initial_image_mode=args.initialImage,
            disable_temporal=args.disableTemporal, augment=args.augment,
            min_fill_rate=args.minFillRate,
            adv_training=args.advTraining, discr_lr=args.advDiscrLr,
            discr_steps=args.advDiscrMaxSteps,
            gen_steps=args.advGenMaxSteps, remat=args.remat,
            run_dir_base=args.runDir,
            checkpoint_every=args.checkpointEvery),
        parallel=ParallelConfig(data_parallel=args.dataParallel),
    )


def _camera_distance(args):
    lo, hi = (float(v) for v in args.cameraDistance.split(","))
    if not (0.0 < lo <= hi):
        raise SystemExit(f"bad --cameraDistance {args.cameraDistance!r}")
    return (lo, hi)


def _mix_grids(name: str, analytic, dev) -> list:
    """The analytic training zoo of ``mix`` .. ``mix4`` (JAX's lists)."""
    grids = [(analytic.blobs_volume(128, num_blobs=8, device=dev), (0.5, 0.5)),
             (analytic.torus_volume(128, device=dev), (0.5, 0.5)),
             (analytic.gyroid_volume(128, device=dev), (0.45, 0.55)),
             (analytic.blobs_volume(128, num_blobs=14, seed=7, device=dev),
              (0.4, 0.6))]
    if name in ("mix2", "mix3", "mix4"):
        grids += [
            (analytic.turbulence_volume(256, seed=1, device=dev),
             (0.45, 0.55)),
            (analytic.turbulence_volume(256, seed=2, beta=3.0, device=dev),
             (0.45, 0.55)),
            (analytic.ejecta_volume(256, seed=3, device=dev), (0.3, 0.5)),
            (analytic.ejecta_volume(256, seed=4, num_particles=700,
                                    device=dev), (0.3, 0.5)),
            (analytic.interface_volume(256, seed=5, device=dev),
             (0.45, 0.55)),
        ]
    if name in ("mix3", "mix4"):
        grids += [
            (analytic.interface_volume(256, seed=6, roughness=0.18,
                                       device=dev), (0.45, 0.55)),
            (analytic.interface_volume(256, seed=7, roughness=0.08,
                                       device=dev), (0.45, 0.55)),
            (analytic.turbulence_volume(256, seed=8, beta=4.0, device=dev),
             (0.45, 0.55)),
        ]
    if name == "mix4":
        grids += [
            (analytic.skull_volume(256, shell_thickness=0.018,
                                   sharpness=9.0, device=dev), (0.48, 0.52)),
            (analytic.skull_volume(192, shell_thickness=0.03,
                                   sharpness=12.0, device=dev), (0.48, 0.52)),
            (analytic.thorax_volume(256, num_ribs=8, sharpness=10.0,
                                    device=dev), (0.48, 0.52)),
            (analytic.thorax_volume(192, num_ribs=6, sharpness=14.0,
                                    device=dev), (0.48, 0.52)),
        ]
    return grids


def load_sequences(args, cfg, device):
    """npy clip dirs, or clips generated on ``device`` over analytic
    volumes, a ``.dat`` volume or the volumes a descriptor file lists."""
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        load_reference_npy_dir)
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    spec = args.dataset
    if spec.startswith("descriptor:") or spec.endswith((".dat", ".raw")):
        return _imported_sequences(args, spec, device)
    if not spec.startswith("analytic:"):
        return load_reference_npy_dir(spec)
    name = spec.split(":", 1)[1]
    makers = {"sphere": analytic.sphere_volume,
              "torus": analytic.torus_volume,
              "gyroid": analytic.gyroid_volume,
              "blobs": analytic.blobs_volume,
              "turbulence": analytic.turbulence_volume,
              "ejecta": analytic.ejecta_volume,
              "interface": analytic.interface_volume,
              "skull": analytic.skull_volume,
              "thorax": analytic.thorax_volume}
    mixes = ("mix", "mix2", "mix3", "mix4")
    if name not in makers and name not in mixes:
        raise SystemExit(f"unknown analytic volume {name}")
    seq_cfg = SequenceConfig(
        num_frames=args.numFrames,
        high_res=args.cropSize * args.upscaleFactor * 4,
        ao_samples=args.aoSamples,
        distance_range=_camera_distance(args))
    if name in mixes:
        grids = _mix_grids(name, analytic, device)
        base = RenderConfig(step_voxels=0.5)
    else:
        grids = [(makers[name](128, device=device), (0.5, 0.5))]
        base = RenderConfig(isovalue=0.5, step_voxels=0.5)
    print(f"Generating {args.numberOfImages} sequences from "
          f"analytic:{name} ...")
    return generate_sequences(grids, args.numberOfImages, seq_cfg,
                              base_render_cfg=base, seed=args.seed)


def _imported_sequences(args, spec: str, device):
    """Clips over a descriptor file's volumes (a line "volume_path
    min_iso max_iso" each, `DataGeneratorVideo2.py:99-121`) or one
    ``.dat`` volume (isovalues 0.3-0.6), as the JAX trainer renders
    them, on ``device``."""
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.volume.importers import (
        import_npy, import_raw, load_cvol)

    if spec.startswith("descriptor:"):
        path = spec.split(":", 1)[1]
        base_dir = os.path.dirname(os.path.abspath(path))
        grids = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 3 or parts[0].startswith("#"):
                    continue
                vp = os.path.join(base_dir, parts[0])
                if vp.endswith(".dat"):
                    g = import_raw(vp, device=device)
                elif vp.endswith(".npz"):
                    g = load_cvol(vp, device=device)
                else:
                    g = import_npy(vp, device=device)
                grids.append((g, (float(parts[1]), float(parts[2]))))
        if not grids:
            raise SystemExit(f"no volumes in descriptor {path}")
    else:
        grids = [(import_raw(spec, store_dtype=args.volumeDtype,
                             device=device), (0.3, 0.6))]
    seq_cfg = SequenceConfig(
        num_frames=args.numFrames,
        high_res=args.cropSize * args.upscaleFactor * 4,
        ao_samples=args.aoSamples)
    return generate_sequences(grids, args.numberOfImages, seq_cfg,
                              base_render_cfg=RenderConfig(step_voxels=0.5),
                              seed=args.seed)


class ScalarWriter:
    """JAX's TensorBoard log, ``tensorboard/events.out.tfevents.*`` in the
    run dir (`utils.tensorboard.EventWriter`), and beside it the scalars
    as JSON lines, ``scalars.jsonl``, and the images as ``.npy`` files
    under ``images/``."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._f = open(os.path.join(run_dir, "scalars.jsonl"), "a")
        self.events = EventWriter(os.path.join(run_dir, "tensorboard"))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")
        self._f.flush()
        self.events.add_scalar(tag, value, step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        d = os.path.join(self.run_dir, "images")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{tag.replace('/', '_')}_{step}.npy"),
                np.asarray(image, np.float32))
        self.events.add_image(tag, image, step)

    def close(self) -> None:
        self._f.close()
        self.events.close()


def _log_test_images(writer, cfg, predict_clip, batch, epoch):
    """Panels of one fixed test clip's last frame: input, prediction and
    GT side by side (3, H, 3W) for the shaded colour and each unshaded
    channel, and the residual."""
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)

    low, flow, high = (t[:1] for t in batch)
    pred = predict_clip(low, flow)[0, -1]
    gt = high[0, -1]
    inp = resize(low[:, -1], size=(gt.shape[0], gt.shape[1]),
                 method=cfg.model.upsample)[0][..., :gt.shape[-1]]

    def panel(x):
        x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
        if x.ndim == 2:
            x = x[..., None]
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, axis=-1)
        return np.transpose(x, (2, 0, 1))

    triple = {}
    for buf in (inp, pred, gt):
        shaded = screen_space_shading(buf[None], cfg.shading)[0]
        b = buf.cpu().numpy()
        triple.setdefault("shaded", []).append(panel(shaded.cpu().numpy()))
        triple.setdefault("mask", []).append(panel((b[..., 0] + 1.0) / 2.0))
        triple.setdefault("normal", []).append(
            panel((b[..., 1:4] + 1.0) / 2.0))
        triple.setdefault("depth", []).append(panel(b[..., 4]))
        if b.shape[-1] >= 6:
            triple.setdefault("ao", []).append(panel(b[..., 5]))
    for name, panels in triple.items():
        writer.add_image(f"test/{name}", np.concatenate(panels, axis=2),
                         epoch)
    residual = (pred - gt).abs().mean(-1).cpu().numpy()
    writer.add_image("test/residual", panel(residual * 4.0), epoch)


def _data_parallel_worker(rank: int, argv, world: int, init_method: str,
                          run_dir: str) -> None:
    """One of the processes `main` spawns for ``--dataParallel``."""
    import torch.distributed as dist

    from isosurfacesuperresolution_tpu_torch.parallel.multihost import (
        initialize_distributed)
    args = build_parser().parse_args(argv)
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(init_method, world, rank, _requested_device(args))
    try:
        train(args, make_config(args), run_dir)
    finally:
        dist.destroy_process_group()


def _requested_device(args):
    import torch
    return torch.device(args.device or "cuda")


def main(argv=None) -> str:
    """Train; returns the run dir.  With ``--dataParallel N`` > 1, spawns
    N processes and waits for them."""
    args = build_parser().parse_args(argv)
    cfg = make_config(args)
    n = cfg.parallel.data_parallel
    if n > 1:
        import torch
        import torch.multiprocessing as mp

        from isosurfacesuperresolution_tpu_torch.device import (
            resolve_device)
        from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
            next_run_dir)
        dev = resolve_device(args.device)
        if dev.type == "cuda" and torch.cuda.device_count() < n:
            raise RuntimeError(f"--dataParallel {n} needs {n} cards; this "
                               f"machine has {torch.cuda.device_count()}")
        run_dir = next_run_dir(cfg.train.run_dir_base)
        with tempfile.TemporaryDirectory() as rdv:
            mp.start_processes(
                _data_parallel_worker,
                args=(list(sys.argv[1:] if argv is None else argv), n,
                      "file://" + os.path.join(rdv, "rendezvous"), run_dir),
                nprocs=n, join=True, start_method="spawn")
        return run_dir
    return train(args, cfg)


def train(args, cfg, run_dir: Optional[str] = None) -> str:
    """The training loop of `main` in this process; returns the run dir.
    Under ``--dataParallel`` this process is one rank of the group
    `_data_parallel_worker` set up, and ``run_dir`` is the group's."""
    import torch
    import torch.distributed as dist

    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset, load_reference_npy_dir)
    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
        CheckpointManager, load_params_npz, next_run_dir, save_params_npz,
        write_info)
    from isosurfacesuperresolution_tpu_torch.train.device_data import (
        DeviceVideoDataset)
    from isosurfacesuperresolution_tpu_torch.train.trainer import (
        create_train_state, epoch_learning_rate, make_adv_train_steps,
        make_eval_step, make_optimizer, make_predict_clip, make_train_step,
        set_learning_rate)
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng

    n_dp = cfg.parallel.data_parallel
    rank = 0
    if n_dp > 1:
        rank = dist.get_rank()
        device = _requested_device(args)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        resolve_device(device)
    else:
        device = resolve_device(args.device)
    lead = rank == 0
    t = cfg.train
    rng = np.random.RandomState(t.seed)

    if args.cacheDataset and os.path.exists(
            os.path.join(args.cacheDataset, "low_00000.npy")):
        print("loading cached dataset from", args.cacheDataset)
        sequences = load_reference_npy_dir(args.cacheDataset)
    else:
        sequences = load_sequences(args, cfg, device)
        if args.cacheDataset:
            os.makedirs(args.cacheDataset, exist_ok=True)
            for i, seq in enumerate(sequences):
                for key in ("low", "high", "flow"):
                    np.save(os.path.join(args.cacheDataset,
                                         f"{key}_{i:05d}.npy"),
                            seq[key].transpose(0, 3, 1, 2))
            print("cached dataset to", args.cacheDataset)
    dataset = VideoDataset(sequences, upscale_factor=cfg.model.upscale_factor)
    samples = dataset.collect_samples(t.samples, t.crop_size,
                                      t.min_fill_rate, rng,
                                      augment=t.augment)
    train_set = DatasetFromSamples(dataset, samples, t.crop_size,
                                   test=False, test_fraction=t.test_fraction)
    test_set = DatasetFromSamples(dataset, samples, t.crop_size,
                                  test=True, test_fraction=t.test_fraction)
    print(f"#sequences: {len(sequences)}, train crops: {len(train_set)}, "
          f"test crops: {len(test_set)}")

    device_data = None
    if not t.augment and not args.hostData and n_dp <= 1:
        dd = DeviceVideoDataset(sequences,
                                upscale_factor=cfg.model.upscale_factor,
                                store_dtype=getattr(torch, args.dataDtype),
                                device=device)
        if dd.nbytes() < 6 * 1024 ** 3:
            device_data = dd
            print(f"device-resident dataset: {dd.nbytes() / 1e9:.2f} GB "
                  f"on {device}")

    def host_batches(it):
        for batch in it:
            yield tuple(torch.from_numpy(b).to(device) for b in batch)

    gen = torch.Generator().manual_seed(t.seed)
    model = create_network(cfg.model, generator=gen).to(device)
    criterion = LossNetUnshaded(
        cfg.loss, high_res=t.crop_size * cfg.model.upscale_factor,
        use_spectral_norm=args.useSN)
    optimizer = make_optimizer(cfg)
    state = create_train_state(
        cfg, model, criterion, optimizer, gen,
        discr_optimizer=optimizer if t.adv_training else None)
    if t.adv_training:
        d_step, g_step = make_adv_train_steps(cfg, model, criterion)
    else:
        train_step = make_train_step(cfg, model, criterion)
    eval_step = make_eval_step(cfg, model, criterion)
    predict_clip = make_predict_clip(cfg, model)
    sync_stop = None
    if n_dp > 1:
        from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
            make_mesh, make_sharded_train_step)
        mesh = make_mesh(n_dp)
        if not t.adv_training:
            train_step = make_sharded_train_step(train_step, mesh)

        def sync_stop(flag: bool) -> bool:
            """Whether any process was asked to stop (one all-reduce)."""
            x = torch.tensor([float(flag)], device=device)
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            return bool(x.item())

    else:
        run_dir = next_run_dir(t.run_dir_base)
    if lead:
        write_info(run_dir, cfg)
        ckpt = CheckpointManager(run_dir)
        writer = ScalarWriter(run_dir)
        print("run dir:", run_dir)
    else:
        ckpt = writer = None

    start_epoch = 1
    if args.restore:
        state, epoch = CheckpointManager(args.restore).restore(
            state, args.restoreEpoch)
        start_epoch = epoch + 1
        print(f"restored epoch {epoch} from {args.restore}")
    elif args.pretrained:
        npz = (args.pretrained if args.pretrained.endswith(".npz")
               else os.path.join(args.pretrained, "params.npz"))
        if args.pretrained.endswith(".npz") or (
                not os.path.isdir(os.path.join(args.pretrained,
                                               "checkpoints"))
                and os.path.exists(npz)):
            load_params_npz(npz, model)
            print(f"pretrained generator from {npz}")
        else:
            _, epoch = CheckpointManager(args.pretrained).restore_params(
                model, args.restoreEpoch)
            print(f"pretrained generator from {args.pretrained} "
                  f"(epoch {epoch})")
    if args.pretrainedDiscr:
        if not t.adv_training:
            raise SystemExit("--pretrainedDiscr requires --advTraining")
        _, depoch = CheckpointManager(
            args.pretrainedDiscr).restore_discr_params(state.discriminators,
                                                       args.restoreEpoch)
        print(f"pretrained discriminator from {args.pretrainedDiscr} "
              f"(epoch {depoch})")

    # SIGTERM: checkpoint at the next batch boundary, then exit; the
    # checkpoint carries the interrupted epoch's number, so --restore
    # resumes at the next epoch
    stop = {"sig": None}

    def on_term(signum, frame):
        stop["sig"] = signum
        print(f"signal {signum} received: checkpointing at the next "
              f"batch boundary, then exiting", flush=True)

    old_handler = signal.signal(signal.SIGTERM, on_term)
    recent_losses: List[float] = []      # the spike guard's window
    verdict = {}

    def guard(loss) -> bool:
        """Skip the step (before the optimizer touches anything) on a
        non-finite loss or one above 5x the recent median."""
        lossf = float(loss)
        verdict["loss"] = lossf
        verdict["ok"] = np.isfinite(lossf) and not (
            len(recent_losses) >= 20
            and lossf > 5.0 * np.median(recent_losses))
        if not verdict["ok"]:
            print(f"WARNING: loss {lossf:.3g} at epoch {verdict['epoch']}, "
                  f"batch {verdict['batch']} (median "
                  f"{np.median(recent_losses) if recent_losses else 0:.3g});"
                  f" skipping batch")
            return False
        recent_losses.append(lossf)
        if len(recent_losses) > 200:
            recent_losses.pop(0)
        return True

    try:
        for epoch in range(start_epoch, t.epochs + 1):
            lr = epoch_learning_rate(cfg, epoch - 1)
            set_learning_rate(state.optimizer, lr)
            t0 = time.time()
            epoch_loss, n_batches = 0.0, 0
            if device_data is not None:
                batch_iter = device_data.batches(train_set.samples,
                                                 t.batch_size, t.crop_size,
                                                 rng=rng)
            else:
                batch_iter = host_batches(train_set.batches(t.batch_size,
                                                            rng=rng))
            for low, flow, high in batch_iter:
                if sync_stop is not None:
                    if sync_stop(stop["sig"] is not None):
                        stop["sig"] = stop["sig"] or signal.SIGTERM
                if stop["sig"] is not None:
                    break
                if t.adv_training:
                    if not lead:        # unsharded: process 0 alone
                        continue
                    for _ in range(t.discr_steps):
                        state, d_loss, gt_s, pred_s = d_step(
                            state, low, flow, high,
                            jax_prng.prng_key(rng.randint(1 << 31)))
                    for _ in range(t.gen_steps):
                        state, loss = g_step(state, low, flow, high)
                    if lead:
                        writer.add_scalar("train/discr_loss", float(d_loss),
                                          epoch)
                        writer.add_scalar("train/gt_score", float(gt_s),
                                          epoch)
                        writer.add_scalar("train/pred_score", float(pred_s),
                                          epoch)
                    lossf = float(loss)
                else:
                    verdict.update(epoch=epoch, batch=n_batches)
                    state, _ = train_step(state, low, flow, high,
                                          accept=guard)
                    if not verdict["ok"]:
                        continue
                    lossf = verdict["loss"]
                epoch_loss += lossf
                n_batches += 1
            if stop["sig"] is not None:
                if lead:
                    ckpt.save(epoch, state)
                    save_params_npz(os.path.join(run_dir, "params.npz"),
                                    model)
                    print(f"preempted at epoch {epoch} ({n_batches} "
                          f"batches): checkpoint + params.npz saved to "
                          f"{run_dir}", flush=True)
                break
            epoch_loss /= max(n_batches, 1) * t.num_frames
            if not lead:
                continue
            writer.add_scalar("train/total_loss", epoch_loss, epoch)
            writer.add_scalar("train/lr", lr, epoch)

            test_loss, test_psnr, n_test = 0.0, 0.0, 0
            if device_data is not None:
                test_iter = device_data.batches(test_set.samples,
                                                t.batch_size, t.crop_size,
                                                shuffle=False, drop_last=True)
            else:
                test_iter = host_batches(test_set.batches(
                    t.batch_size, shuffle=False, drop_last=False))
            first_test = None
            for low, flow, high in test_iter:
                if first_test is None:
                    first_test = (low, flow, high)
                l, p = eval_step(low, flow, high)
                test_loss += float(l)
                test_psnr += float(p)
                n_test += 1
            if n_test:
                writer.add_scalar("test/total_loss", test_loss / n_test,
                                  epoch)
                writer.add_scalar("test/psnr", test_psnr / n_test, epoch)
            if (args.imageEvery and epoch % args.imageEvery == 0
                    and first_test is not None):
                _log_test_images(writer, cfg, predict_clip, first_test,
                                 epoch)
            print(f"===> Epoch {epoch}: train loss {epoch_loss:.4f}, "
                  f"test psnr {test_psnr / max(n_test, 1):.2f} dB "
                  f"({time.time() - t0:.1f}s)")
            if epoch % t.checkpoint_every == 0:
                ckpt.save(epoch, state)
                save_params_npz(os.path.join(run_dir, "params.npz"), model)
        if lead:
            save_params_npz(os.path.join(run_dir, "params.npz"), model)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
        if writer is not None:
            writer.close()
    if lead:
        print("done; checkpoints in", run_dir)
    return run_dir


if __name__ == "__main__":
    main()
