"""Profile the port's fused 1080p frames on the card.

    python -m isosurfacesuperresolution_tpu_torch.profile_frame \
        [--frames N] [--variants planar,phase,phase_ao,nonplanar,...]

The first four variants drive the interactive frame (trained run00017
EnhanceNet, 256^3 blobs, iso 0.5, 480x270 -> 1920x1080, bf16 sweep, orbit
steps of 0.03 rad):

* ``planar``: run00017 as it is through `InferencePipeline` (planar
  "auto" -> the planar engine, float32, dense tail);
* ``phase``: compute_dtype bfloat16 with the phase-conv tail (the frame
  `bench.py --phase` times);
* ``phase_ao``: ``phase`` on the grid with the baked SH occlusion field
  (ao_samples 64, ao_mode "volume");
* ``nonplanar``: the interleaved network (planar "off"), float32;
* ``int8``: the frame `bench.py --int8` times: compute_dtype bfloat16,
  ``planar_int8`` (int8 post-training quantization of the trunk and
  post1-post3), no phase tail, run00017's trained weights (the bench
  draws random ones; the port has no Flax initializer).

The others run the large dense volume of `scripts/bench_volumes.py`,
`blobs_volume(512)` stored uint8 (made once, on the host), iso 0.36, on
the tiled march:

* ``planar512``: the 512-tuned run00015 through `InferencePipeline`
  (planar "auto"), orbit steps of 0.03 rad;
* ``gbuffer512``, ``gbuffer512_ao``, ``gbuffer512_aoc``: the G-buffer
  alone (`render_gbuffer_sweep`, orbit steps of 0.05 rad) without AO,
  with the full-resolution bf16 field, with the half-resolution uint8
  field kept coarse;
* ``gbuffer512_packed``, ``gbuffer512_packed_ao``, ``planar512_packed``:
  ``gbuffer512``, ``gbuffer512_ao`` and ``planar512`` on the grid packed
  as `scripts/bench_volumes.py --sparse` packs it
  (`SparseBrickGrid.from_brick_grid(grid, tolerance=1e-3)`, the field
  included): the packed march (B3) and the packed AO capture (B4p).

For each it prints:

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
import dataclasses
import math
import time
import warnings
from pathlib import Path

import torch

from isosurfacesuperresolution_tpu_torch.config import Config, RenderConfig
from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import LoadedModel
from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
    FusedFrame, InferencePipeline, initial_state)
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.render.camera import CameraParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    render_gbuffer_sweep)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    SparseBrickGrid)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
RUN_DIR = ARTIFACTS / "run00017"
VARIANTS = ("planar", "phase", "phase_ao", "nonplanar", "int8", "planar512",
            "gbuffer512", "gbuffer512_ao", "gbuffer512_aoc",
            "gbuffer512_packed", "gbuffer512_packed_ao", "planar512_packed")


def cam_at(ang: float) -> CameraParams:
    return CameraParams.create((1.7 * math.sin(ang), 0.9,
                                -1.7 * math.cos(ang)))


def profile(step, n: int) -> None:
    """Time and profile ``step(i)``, the i-th frame of an orbit."""
    for i in range(3):                                   # warm-up
        step(i)
    torch.cuda.synchronize()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            step(3 + i)
        end.record()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"host syncs in {n} frames: {len(syncs)}"
          + (f" (first: {syncs[0][:200]})" if syncs else ""))
    frame_ms = start.elapsed_time(end) / n
    print(f"{frame_ms:.3f} ms/frame over {n} frames (CUDA events)")

    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(3 + n + i)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS[:3]),
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    args = ap.parse_args()
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)

    lm = LoadedModel.from_run_dir(str(RUN_DIR))
    render_cfg = RenderConfig(width=480, height=270, isovalue=0.5,
                              ao_samples=0, renderer="sweep_pallas",
                              sweep_oversample=1.25, sweep_dtype="bfloat16")
    grid = analytic.blobs_volume(256, num_blobs=8)
    phase_cfg = Config(model=dataclasses.replace(
        lm.cfg.model, compute_dtype="bfloat16", planar_phase_tail=True))
    cfg512 = render_cfg.replace(isovalue=0.36)
    grids512 = {}

    def grid512(field: str):
        """The 512^3 uint8 grid, made once, with its AO field baked and
        its packed forms made on first use."""
        if "" not in grids512:
            t = time.time()
            grids512[""] = analytic.blobs_volume(512, store_dtype="uint8")
            print(f"blobs_volume(512) uint8: {time.time() - t:.1f} s")
        if field not in grids512 and field.startswith("packed"):
            grids512[field] = SparseBrickGrid.from_brick_grid(
                grid512(field[len("packed_"):]), tolerance=1e-3)
        elif field not in grids512:
            kw = (dict(out_dtype=torch.bfloat16) if field == "ao" else
                  dict(downsample=2, keep_coarse=True, out_dtype="uint8"))
            grids512[field] = attach_baked_ao(grids512[""], 0.36, 0.2, **kw)
        return grids512[field]

    for variant in variants:
        print(f"== {variant}", flush=True)
        if variant.startswith("planar512"):
            lm15 = LoadedModel.from_run_dir(str(ARTIFACTS / "run00015"))
            pipe = InferencePipeline(lm15.model, lm15.cfg, cfg512)
            g = grid512("packed" if variant.endswith("packed") else "")

            def step(i, pipe=pipe, g=g):
                pipe.frame(g, cam_at(0.03 * i))
            profile(step, args.frames)
            continue
        if variant.startswith("gbuffer512"):
            field = variant[len("gbuffer512_"):]
            g = grid512(field)
            rcfg = (cfg512.replace(ao_samples=64, ao_mode="volume")
                    if "ao" in field else cfg512)

            def step(i, g=g, rcfg=rcfg):
                render_gbuffer_sweep(g, cam_at(0.05 * i),
                                     cam_at(0.05 * i - 0.03), rcfg)
            profile(step, args.frames)
            continue
        cfg, rcfg, g = lm.cfg, render_cfg, grid
        if variant in ("phase", "phase_ao"):
            cfg = phase_cfg
        if variant == "int8":
            cfg = Config(model=dataclasses.replace(
                lm.cfg.model, compute_dtype="bfloat16", planar_int8=True))
        if variant == "phase_ao":
            torch.cuda.synchronize()
            t = time.time()
            g = attach_baked_ao(grid, 0.5, 0.1)
            torch.cuda.synchronize()
            print(f"AO bake {time.time() - t:.3f} s (not in the frames)")
            rcfg = render_cfg.replace(ao_samples=64, ao_mode="volume")
        if variant == "nonplanar":
            # the interleaved network: the fused frame with planar "off"
            ff = FusedFrame(lm.model, cfg, rcfg, planar="off")
            st = [initial_state(cfg, rcfg, planar="off")]

            def step(i, ff=ff, st=st, g=g):
                st[0] = ff(g, cam_at(0.03 * i),
                           cam_at(0.03 * max(i - 1, 0)), st[0])[2]
        else:
            pipe = InferencePipeline(lm.model, cfg, rcfg)

            def step(i, pipe=pipe, g=g):
                pipe.frame(g, cam_at(0.03 * i))
        profile(step, args.frames)


if __name__ == "__main__":
    main()
