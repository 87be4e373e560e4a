"""Profile the port's full-width training steps on the card.

    python -m isosurfacesuperresolution_tpu_torch.profile_train \
        [--steps N] [--variants plain,remat,adv]

The setup of `chip_smoke.py` phase 29: 4 clips of `SequenceConfig()` (10
frames, 512^2 with the baked AO field, 128^2) from the 256^3 blobs and
torus on the march kernels, stacked in `DeviceVideoDataset`, a fresh 10x64
EnhanceNet at the `TrainConfig()` defaults (batch 16, crop 32 -> 128, 10
frames, Adam, clip 1.0) and the default loss DSL:

* ``plain``: `make_train_step`;
* ``remat``: the same with ``remat`` (each frame recomputed in the
  backward);
* ``adv``: one discriminator and one generator step of
  `make_adv_train_steps` with ``adv:all:0.3,perceptual:color:0.1`` added
  (EnhanceNetLarge critic at 128, the seeded VGG-19).

For each: host syncs inside the timed steps (none: no spike guard here),
ms a step from CUDA events and peak memory without the profiler; then,
under `torch.profiler`, the device time a step by kernel and by kind
(convolutions and GEMMs, elementwise, reductions, copies), and the idle
share against the unprofiled step time.  Float32 matmuls and
convolutions run without TF32.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

from isosurfacesuperresolution_tpu_torch.config import (
    Config, LossConfig, ModelConfig, RenderConfig, TrainConfig)
from isosurfacesuperresolution_tpu_torch.data.dataset import VideoDataset
from isosurfacesuperresolution_tpu_torch.data.generation import (
    SequenceConfig, generate_sequences)
from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
    LossNetUnshaded)
from isosurfacesuperresolution_tpu_torch.models.generators import (
    create_network)
from isosurfacesuperresolution_tpu_torch.train import trainer as TR
from isosurfacesuperresolution_tpu_torch.train.device_data import (
    DeviceVideoDataset)
from isosurfacesuperresolution_tpu_torch.volume import analytic

VARIANTS = ("plain", "remat", "adv")
KINDS = (("conv/gemm", ("conv", "gemm", "cudnn", "xmma", "winograd",
                        "implicit", "cutlass", "sm90", "sm80", "wgrad",
                        "dgrad")),
         ("copy", ("copy", "memcpy", "memset", "cat")),
         ("reduce", ("reduce", "sum", "norm", "mean")),
         ("elementwise", ("",)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise"


def profile(step, n: int) -> None:
    """Time and profile ``step(i)`` after two warm-up steps."""
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            step(2 + i)
        end.record()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    step_ms = start.elapsed_time(end) / n
    print(f"host syncs in {n} steps: {len(syncs)}"
          + (f" (first: {syncs[0][:200]})" if syncs else ""))
    print(f"{step_ms:.3f} ms a step over {n} steps (CUDA events), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(2 + n + i)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    kinds = {}
    for ms, count, name in rows:
        k = kinds.setdefault(kind_of(name), [0.0, 0])
        k[0] += ms
        k[1] += count
    print(f"profiled {n} steps: device busy {busy / n:.3f} ms a step; idle "
          f"share of the unprofiled step time "
          f"{max(0.0, 1.0 - busy / n / step_ms):.3f}; launches a step "
          f"{sum(r[1] for r in rows) / n:.0f}")
    for kind, (ms, count) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind}: {ms / n:.3f} ms, {count / n:.0f} launches a step")
    print("device ms/step  launches/step  kernel")
    for ms, count, name in rows[:20]:
        print(f"{ms / n:13.4f}  {count / n:13.1f}  {name[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0))

    grids = [(analytic.blobs_volume(256, num_blobs=8, device="cuda"),
              (0.5, 0.5)), (analytic.torus_volume(256, device="cuda"),
                            (0.5, 0.5))]
    seqs = generate_sequences(grids, 4, SequenceConfig(),
                              base_render_cfg=RenderConfig(
                                  renderer="sweep_pallas", step_voxels=0.5),
                              seed=29)
    base = Config(model=ModelConfig(), loss=LossConfig(),
                  train=TrainConfig())
    t = base.train
    dd = DeviceVideoDataset(seqs, device="cuda")
    samples = VideoDataset(seqs).collect_samples(
        t.samples, t.crop_size, t.min_fill_rate, np.random.RandomState(0))
    for variant in args.variants.split(","):
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}")
        cfg = base
        if variant == "remat":
            cfg = base.replace(train=TrainConfig(remat=True))
        if variant == "adv":
            cfg = base.replace(loss=LossConfig(
                losses=LossConfig().losses
                + ",adv:all:0.3,perceptual:color:0.1"))
        gen = torch.Generator().manual_seed(t.seed)
        model = create_network(cfg.model, generator=gen).cuda()
        crit = LossNetUnshaded(cfg.loss, high_res=t.crop_size * 4)
        spec = TR.make_optimizer(cfg)
        state = TR.create_train_state(
            cfg, model, crit, spec, gen,
            discr_optimizer=spec if crit.has_discriminator else None)
        batches = list(dd.batches(samples, t.batch_size, t.crop_size,
                                  rng=np.random.RandomState(1)))
        if variant == "adv":
            d_step, g_step = TR.make_adv_train_steps(cfg, model, crit)

            def step(i):
                b = batches[i % len(batches)]
                d_step(state, *b, (0, i))
                g_step(state, *b)
        else:
            train_step = TR.make_train_step(cfg, model, crit)

            def step(i):
                train_step(state, *batches[i % len(batches)])
        print(f"--- {variant}")
        profile(step, args.steps)
        del state, crit, model, batches


if __name__ == "__main__":
    main()
