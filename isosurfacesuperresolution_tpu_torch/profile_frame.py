"""Profile the port's fused 1080p frame on the card.

    python -m isosurfacesuperresolution_tpu_torch.profile_frame [--frames N]

Drives `InferencePipeline` as the interactive frame does (trained
run00017 EnhanceNet, 256^3 blobs, 480x270 -> 1920x1080, bf16 sweep,
orbit steps of 0.03 rad) and prints:

* host syncs inside the timed frames (`torch.cuda.set_sync_debug_mode`),
  which should be none;
* ms/frame from CUDA events, without the profiler;
* under `torch.profiler`, each CUDA kernel's device time per frame and
  their sum; the idle share compares that sum with the unprofiled frame
  time (the profiler's host cost would inflate a profiled wall time).

Float32 matmuls and convolutions run without TF32.
"""

from __future__ import annotations

import argparse
import math
import warnings
from pathlib import Path

import torch

from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    InferencePipeline)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.volume import analytic

RUN_DIR = Path(__file__).resolve().parent.parent / "artifacts" / "run00017"


def cam_at(ang: float) -> CameraParams:
    return CameraParams.create((1.7 * math.sin(ang), 0.9,
                                -1.7 * math.cos(ang)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)

    lm = LoadedModel.from_run_dir(str(RUN_DIR))
    cfg = RenderConfig(width=480, height=270, isovalue=0.5, ao_samples=0,
                       renderer="sweep_pallas", sweep_oversample=1.25,
                       sweep_dtype="bfloat16")
    pipe = InferencePipeline(lm.model, lm.cfg, cfg)
    grid = analytic.blobs_volume(256, num_blobs=8)
    for i in range(3):                                   # warm-up
        pipe.frame(grid, cam_at(0.03 * i))
    torch.cuda.synchronize()

    n = args.frames
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            pipe.frame(grid, cam_at(0.03 * (3 + i)))
        end.record()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"host syncs in {n} frames: {len(syncs)}"
          + (f" (first: {syncs[0][:200]})" if syncs else ""))
    frame_ms = start.elapsed_time(end) / n
    print(f"{frame_ms:.3f} ms/frame over {n} frames (CUDA events)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            pipe.frame(grid, cam_at(0.03 * (3 + n + i)))
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profiled {n} frames: device busy {busy / n:.3f} ms/frame; "
          f"idle share of the unprofiled frame time "
          f"{max(0.0, 1.0 - busy / n / frame_ms):.3f}")
    print("device ms/frame  launches/frame  kernel")
    for ms, count, name in rows[:25]:
        print(f"{ms / n:14.4f}  {count / n:14.1f}  {name[:110]}")


if __name__ == "__main__":
    main()
