"""Train the learned texture-feature encoder (`losses/learned_features`).

Counterpart of the JAX package's `apps/train_texenc.py`: self-supervised
restoration on the repo's own rendered crops.  The shaded ground truth of
the training crops is degraded (`learned_features.degrade`: 4x linear
down and up, plus noise) and the encoder and decoder restore it under
Adam (optax's rule, `train/optim.py`); the encoder's weights are written
in the JAX package's npz layout.  Each step's batch indices and noise are
JAX's draws (``split``, ``randint``, ``normal`` of `utils/jax_prng.py`)
from ``PRNGKey(seed)``; the initial weights are Flax's default
initialisation drawn from a seeded `torch.Generator`.  Runs on the card
unless ``--device cpu``.

Usage:
  python -m isosurfacesuperresolution_tpu_torch.apps.train_texenc \\
      --dataset /path/to/clips --steps 2000 \\
      --output artifacts/texenc/texenc.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True,
                   help="npy clip dir (a --cacheDataset directory)")
    p.add_argument("--cropSize", type=int, default=32,
                   help="crop size in LOW-res pixels (x4 in the crops)")
    p.add_argument("--samples", type=int, default=800)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str,
                   default="artifacts/texenc/texenc.npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def clean_crops(dataset: str, crop_size: int, samples: int, seed: int,
                device) -> torch.Tensor:
    """The shaded high-res ground truth of the last frame of each training
    crop, (N, 4c, 4c, 3) float32 on ``device``."""
    from isosurfacesuperresolution_tpu_torch.config import ShadingConfig
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset, load_reference_npy_dir)
    from isosurfacesuperresolution_tpu_torch.render.shading import (
        screen_space_shading)
    ds = VideoDataset(load_reference_npy_dir(dataset))
    rng = np.random.RandomState(seed)
    picked = ds.collect_samples(samples, crop_size, 0.5, rng)
    train = DatasetFromSamples(ds, picked, crop_size, test=False,
                               test_fraction=0.2)
    highs = np.stack([train[i][2][-1] for i in range(len(train))])
    return screen_space_shading(torch.as_tensor(highs, device=device),
                                ShadingConfig()).float()


def init_models(seed: int, device) -> Tuple[torch.nn.Module,
                                             torch.nn.Module]:
    """A fresh (TexEncoder, TexDecoder): Flax's default initialisation
    (lecun-normal kernels, zero biases) from a `torch.Generator` seeded
    ``seed``."""
    from isosurfacesuperresolution_tpu_torch.losses.learned_features import (
        TexDecoder, TexEncoder)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        LECUN, init_like_flax)
    gen = torch.Generator().manual_seed(seed)
    enc, dec = TexEncoder(), TexDecoder()
    for m in (enc, dec):
        init_like_flax(m, lambda name: LECUN, gen)
    return enc.to(device), dec.to(device)


def train(clean: torch.Tensor, enc: torch.nn.Module, dec: torch.nn.Module,
          steps: int, batch_size: int, lr: float, seed: int,
          log: Optional[Callable[[int, float], None]] = None
          ) -> List[torch.Tensor]:
    """``steps`` Adam steps of the restoration loss on ``clean``; the
    models are updated in place.  Returns each step's loss (a device
    scalar; ``log(step, loss)`` reads steps 0, 200, ... and the last)."""
    from isosurfacesuperresolution_tpu_torch.losses.learned_features import (
        degrade)
    from isosurfacesuperresolution_tpu_torch.train.optim import (
        OptimizerSpec)
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng

    params = {f"enc.{k}": v for k, v in enc.named_parameters()}
    params.update({f"dec.{k}": v for k, v in dec.named_parameters()})
    opt = OptimizerSpec(rule="adam", learning_rate=lr).init(params)
    key = jax_prng.prng_key(seed)
    n = clean.shape[0]
    losses = []
    for i in range(steps):
        key, k1, k2 = jax_prng.split(key, 3)
        idx = torch.from_numpy(jax_prng.randint(k1, (batch_size,), 0, n)
                               .astype(np.int64)).to(clean.device)
        batch = clean[idx]
        noisy = degrade(batch, k2)
        out = dec(enc(noisy)["conv_4"])
        loss = torch.mean((out - batch) ** 2)
        grads = torch.autograd.grad(loss, opt.params)
        opt.step(grads)
        losses.append(loss.detach())
        if log is not None and (i % 200 == 0 or i == steps - 1):
            log(i, float(losses[-1]))
    return losses


def main(argv=None):
    """Returns (the losses of every step as floats, the trained encoder)."""
    args = build_parser().parse_args(argv)

    from isosurfacesuperresolution_tpu_torch.device import resolve_device
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        fp32_convs)
    from isosurfacesuperresolution_tpu_torch.losses.builder import (
        texture_loss)
    from isosurfacesuperresolution_tpu_torch.losses.learned_features import (
        save_texenc_params)
    from isosurfacesuperresolution_tpu_torch.ops.resize import resize

    device = resolve_device(args.device)
    clean = clean_crops(args.dataset, args.cropSize, args.samples,
                        args.seed, device)
    print(f"training crops: {tuple(clean.shape)}")
    enc, dec = init_models(args.seed, device)

    t0 = time.time()

    def log(i, loss):
        print(f"step {i}: loss {loss:.5f} ({time.time() - t0:.0f}s)",
              flush=True)

    with fp32_convs():
        losses = train(clean, enc, dec, args.steps, args.batchSize,
                       args.lr, args.seed, log)
    save_texenc_params(enc.state_dict(), args.output)
    print("wrote", args.output)

    # the learned features must tell sharp from blurred
    with torch.no_grad(), fp32_convs():
        sharp = clean[:64]
        h, w = sharp.shape[1], sharp.shape[2]
        blur = resize(resize(sharp, size=(h // 4, w // 4), method="linear"),
                      size=(h, w), method="linear")
        d = float(texture_loss(enc(sharp)["conv_3"], enc(blur)["conv_3"]))
    print(f"gram(clean, blurred) at conv_3: {d:.3e} (must be > 0)")
    return [float(v) for v in losses], enc


if __name__ == "__main__":
    main()
