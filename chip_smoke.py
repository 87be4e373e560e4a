#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one CUDA card).

Run from the repository root:  python3 chip_smoke.py

Phases, each announced before it starts and after it ends with the elapsed
seconds; any failure ends the run with a non-zero exit code:

1. versions and the card (`nvidia-smi` name and power limit);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together), and print each instantiation's registers,
   spills and shared memory from the ``-Xptxas -v`` logs: the marches and
   AO captures, the 3x3 convs and the phase conv (any spill fails the
   run);
3. each kernel vs its plain PyTorch version on the card at the shapes of
   the interactive frame, with stated bounds, and their times: the march
   (256^3 blobs, 480x270, oversample 1.25: K = 512 slices, Sn x Tn =
   600 x 338) without and with the baked AO field (each march with its
   share of its bound and its m_hit mismatch share, expected 0; likewise
   in phases 9 and 14), and the phase conv (B5)
   at (1, 540, 960, 256) with the trained post3 weights, bf16 and float32
   out: B5 and cuDNN (`F.conv2d` bf16 on the shuffled tensor) timed in
   turns behind a queued backlog, with B5's TFLOP/s, share of its bound,
   idle-queue time and the host microseconds of a call;
4. the non-planar fused frame (`FusedFrame(..., planar="off")`): the
   trained 10x64 EnhanceNet (artifacts/run00017) at 480x270 -> 1920x1080,
   renderer "sweep_pallas", bf16 sweep, 10 orbit frames stepping the angle
   by 0.03;
5. card vs CPU on three chained small frames (the CPU path is the one the
   tests hold against the JAX package): the non-planar frame, and the
   planar phase-tail bf16 frame with baked AO;
6. the main path: run00017 as it is through `InferencePipeline` (planar
   "auto" -> the planar engine, float32, dense tail), 20 orbit frames;
7. the frames `bench.py --phase` times: run00017's weights with
   compute_dtype bfloat16 and the phase tail, 20 frames without AO, then
   20 on the baked-AO grid (ao_samples 64, ao_mode "volume");
8. the large dense volume of `scripts/bench_volumes.py`: `blobs_volume(512)`
   stored uint8, made once on the host (its seconds logged), its baked
   SH field at full resolution in bf16 and at half resolution kept coarse
   in uint8;
9. the tiled march (B2) and the tiled AO capture (B4, both fields) vs
   their plain versions at the 512^3 frame's shapes (iso 0.36, 480x270,
   oversample 1.25, bf16 sweep: K = 1024, Sn x Tn = 600 x 338), with
   stated bounds, and their times; each AO capture (here and in phase
   14) three ways: its device time behind a backlog with a cold L2 and
   its share of the bound, its idle-queue time, and the host
   microseconds of one call of the wrapper and of the launch entry;
10. the 512^3 G-buffer frames `bench_volumes.py` times
   (`render_gbuffer_sweep`, 20 orbit frames each): no AO, the full-res
   bf16 field, the coarse uint8 field;
11. the main path at 512^3: the 512-tuned 10x64 EnhanceNet
   (artifacts/run00015, iso 0.36, no AO as in its config) through
   `InferencePipeline` (planar "auto"), 480x270 -> 1920x1080, 20 frames;
12. card vs CPU on three chained small tiled frames (48^3 blobs,
   sweep_tile 16, a coarse uint8 AO field);
13. the packed volumes of `bench_volumes.py --sparse`
   (`SparseBrickGrid.from_brick_grid(grid, tolerance=1e-3)`): the 512^3
   blobs, the same with its full-res bf16 field (`--sparse --ao`), and
   `ejecta_volume(512)` stored uint8 (made on the host); seconds, atlas
   sizes, slot occupancy and storage against dense logged;
14. the packed march (B3) and the packed AO capture (B4p) vs their plain
   versions at 512^3 (the camera of phase 9), with stated bounds, and
   their times; B3 on the packed uint8 grid against B2 on the dense one,
   bit for bit;
15. packed 512^3 G-buffer frames, 20 each: blobs, blobs with its packed
   AO field, ejecta;
16. the main path on the packed blobs: run00015 through
   `InferencePipeline`, 20 frames, and the device time of copies per
   frame beside the dense grid's (`torch.profiler`, 5 frames each);
17. card vs CPU on three chained small packed frames (48^3 blobs, tiles
   of 16, a packed full-res AO field);
18. the 3x3 conv kernels at full width, each vs its plain version with
   stated bounds, its time and cuDNN's (`F.conv2d` bf16, channels-last)
   for the same conv: the 128-lane conv (B6) on run00017's composed post3
   planar kernel at (1, 540, 960, 256) and on block0_conv1 padded to 128
   lanes at (1, 270, 480, 128), `conv3x3_packed` with block0_conv1 at
   (1, 270, 480, 64), the pixel-pair packed conv (B7) on each of
   run00017's 20 trunk kernels at (1, 270, 240, 128) and the 20-conv B7
   chain of `profile_convs` beside a cuDNN chain; each kernel and its
   cuDNN call timed in turns (cuDNN, kernel, kernel, cuDNN), with its
   TFLOP/s and its share of its bound (bound ms / ms); B6 post3 again
   with float32 output, held and timed; the host microseconds of one B7
   call (the wrapper, and its launch entry alone, enqueued without a
   sync); then the path of these entry points (`ops.conv3x3` at both
   shapes, `conv3x3_packed`, the B7 chain on the trunk kernels) with its
   launches counted;
19. the frames `bench.py --int8` times: run00017 in bf16 with
   `planar_int8` through `InferencePipeline`, 20 frames, then the float
   bf16 frame at the same cameras for the difference int8 makes;
20. card vs CPU on three chained small int8 frames and on small frames of
   run00017 with `use_sn`;
21. the loader at full width: `LoadedModel.from_run_dir(run00017,
   fast=True)` and the unfused model through the non-planar frame, 10
   orbit frames each (their first frames' rgb equal in the interior, 8
   px border excluded, within a stated bound), and the unfused model
   with the exact gather warp (`fast_warp=False`); the planar frames of the
   fast model equal the main path's bit for bit (the planar engine
   ignores `fused_upsample`); run00017 exported to `build/run00017.pth`
   and read back through `from_run_dir`: every weight and a non-planar
   frame bit for bit;
22. the GUI's modes: 20 frames of `InferencePipeline(upscale_mode=
   "bicubic")`, then the main path with `set_render_params(isovalue=0.4)`
   after frame 10: the G-buffer's mask changes, the state follows the new
   mask, and the `FusedFrame`, its planar tables and weights are the
   same objects;
23. `LoadedModel.inference` (the exact gather warp) on run00017, 10
   recurrent steps at 480x270 on rendered G-buffers, and card vs CPU on
   two steps of a small input;
24. card vs CPU on small seeded nets of each EnhanceNet option (BN, SN,
   pixelShuffle, bicubic) and of RCAN, TecoGAN and SubpixelNet, then one
   forward each of RCAN (10 x 20 blocks), TecoGAN and SubpixelNet at
   full width (64 features, 480x270 -> 1920x1080), timed;
25. the march oracle (`renderer="march"`, step 0.25) at 480x270 on the
   main path's volume and camera against the sweep with B1, under the
   sweep-vs-march bounds of tests/test_sweep.py (mask IoU, normal cosine
   and depth in the interior eroded by 2 px), its ms/frame, and card vs
   CPU on a 64x48 frame of a 64^3 volume;
26. hemisphere-ray AO (32 samples, radius 0.2) on the torus view of
   tests/test_ao_sweep.py at 480x270 over a 256^3 torus: the march with
   ray AO against the sweep with the baked field (B1-ao) under that
   test's bounds, and the ms/frame of the march and of the sweep with ray
   AO (B1 plus the rays);
27. the clip generator (`generate_sequences`) with one clip at its
   reference settings (`SequenceConfig()`: 10 frames, 512^2 with 256 AO
   samples, baked, and 128^2; `sweep_pallas`, step 0.5): shapes, finite
   values, non-empty masks, 10 B1 and 10 B1-ao launches, seconds a clip;
   the same clip with the scan (`renderer="sweep"`), and the kernels'
   clip held against the scan's under the port's kernel-vs-scan bounds;
   card vs CPU on a 3-frame 64^2 clip with the same seed;
28. DVR: the sweep against the per-ray march at 480x270 under the bound
   of tests/test_volume_render.py, ms/frame each; SSAO on a main-path
   G-buffer, ms/frame;
29. training at full width on kernel-made clips: 4 clips of
   `SequenceConfig()` from the blobs and the 256^3 torus on B1 and B1-ao
   (40 launches each), stacked in `DeviceVideoDataset` on the card, crops
   from `VideoDataset.collect_samples`, then 20 `make_train_step` steps
   of a fresh 10x64 EnhanceNet (run00017's architecture) at the
   `TrainConfig()` defaults (batch 16, crop 32 -> 128, 10 frames, Adam,
   clip 1.0) and the default loss DSL: ms a step (CUDA events over steps
   3-20, whose only host sync is the spike guard's loss read), peak
   memory, every step's loss (finite), one `make_eval_step` PSNR;
30. adversarial and perceptual steps at full width: the EnhanceNetLarge
   critic at 128 and the seeded VGG (``adv:all:0.3,perceptual:color:0.1``
   added), 5 discriminator/generator rounds (ms a round), then one round
   with wgan-gp and spectrally normalized critics: losses finite, both
   networks' parameters changed;
31. card vs CPU on three Adam steps of a small net (2 blocks x 16
   features, batch 2, crop 16, 3 frames) from the same seeded state, then
   `apps.main_video_unshaded.main` on the card (2 epochs on
   analytic:sphere, 2 small clips, in a temporary run dir under
   ``build/``), ``--restore`` for a third, and `LoadedModel.from_run_dir`
   on the run dir and at ``epoch=3``, each giving a finite frame;
32. shaded training at full width on phase 29's clips, shaded on the card
   (`shade_clip`): 20 `make_shaded_train_step` steps of a fresh 10x64
   EnhanceNet at 8 + 48 -> 3 channels at the `TrainConfig()` defaults
   with ``l1:1,temp-l2:0.1`` (ms a step over steps 3-20, peak memory,
   every loss finite), 3 steps with perceptual, texture and tgan added
   (the seeded VGG, the untrained critic: ms a step, losses finite, the
   network moved), card vs CPU on three steps of a small shaded net under
   phase 31's bounds, and `apps.main_video_shaded.main` on the card (2
   epochs on analytic:sphere, small clips, a run dir under ``build/``);
33. the parallel layer in a one-process nccl group: the data-parallel
   step at world 1 against the plain step (phase 31's bounds; the
   all-reduce runs on the card), `render_cameras_sharded` of 8 orbit
   cameras at 480x270 (8 B1 launches) bit for bit the 8 single renders,
   and `render_gbuffer_sweep_sharded` at D = 1 on the 256^3 torus at
   480x270, without and with its baked AO field, from a copy of the grid
   on the host (the rank copies its slab to the card; the call's peak
   device memory printed), against the single device's scan under
   tests/test_sharded_sweep.py's bounds, its ms/frame beside B1's frame;
   the group is destroyed at the end;
34. the orbax run dirs artifacts/run00020/run00020 (step 23) and
   artifacts/run00022/run00022 (step 70) through
   `LoadedModel.from_run_dir` on the card (seconds to read each), their
   parameters bit for bit a CPU read, and a main-path frame of each
   (`InferencePipeline`, 3 frames, finite);
35. volume I/O at real size: phase 8's 512^3 uint8 bytes written as a
   ``.raw`` + ``.dat`` under ``build/smoke_io/`` (removed at the end), the
   native readers built (a failed build fails the run), the raw decode
   native (`native.volumeio.load_raw`, called directly) and numpy at
   downsampling 1 and 2 (equal to 1e-6) and `import_raw` onto the card
   both ways, a 256^3 float32 ``.vdb`` written (zip) and read natively
   (bit for bit), a 1920x1080 G-buffer (B1) as the four EXRs of
   ``render_cli --saveExr`` read back exactly, a ``.cvol.npz`` round trip
   onto the card, and B2 at 480x270 on the imported uint8 grid bit for
   bit the grid built directly from the same bytes;
36. the pipe server: the port's `apps.render_server` in a child process
   on the card (``--volume analytic:blobs:256 --renderer sweep_pallas``)
   driven by `infer.pipe_client.PipeRenderer`: 20 orbit frames at
   480x270 (the client's ms a frame, the server's trailing seconds), the
   banner on stdout, EOF on the frame stream after ``exit``, the last
   frame bit for bit an in-process `render_frame_gbuffer`; then 3 frames
   of the default ``sweep`` renderer;
37. `apps.render_cli` on the ``.dat`` at 1920x1080 with ``--ao volume
   --animation 5 --downscale_factor 4 --saveGbuffer`` (B2 and B4; with
   ``--saveExr``), again ``--sparse`` (B3 and B4p), and ``-m volume`` at
   480x270: PNGs and EXRs read back equal to the saved G-buffers;
   `apps.convert_volume` ``.dat`` -> ``.cvol.npz --bakeAO --downsample 2``
   and ``.dat`` -> ``.vdb``; `main_video_unshaded.load_sequences` on a
   ``descriptor:`` file and on the ``.dat`` (one clip of 2 frames each);
38. `apps.main_psnr_stats` at the reference defaults (4 clips of 10
   frames at 256^2 with 64-sample AO; bilinear, bicubic and run00017) on
   ``analytic:blobs:256`` (B1, B1-ao) and on the ``.dat`` (B2, B4), its
   seconds a volume, and card vs CPU on one 3-frame clip at 160^2 (the
   15-px border leaves MS-SSIM too few pixels at 128^2) within stated
   bounds;
39. the viewer without a display (`apps.main_gui.Viewer`, 480x270 ->
   1920x1080, ``renderer="sweep_pallas"``, on the main path's volume): 20
   orbit frames each of run00017 (B1), run00017 with the bf16 phase tail
   (B1, B5), the ground truth at 1080p, bicubic, focus of context (a 1080p
   viewport render beside each frame) and temporal smoothing, each
   frame's ms on the host clock with its copy to the host, 3 frames of
   the normal channel; card vs CPU on small viewers (run00017's first
   three frames, bilinear, the ground truth) within phase 5's bounds;
40. `apps.main_comparison` at its defaults (1920x1080, x4, bilinear and
   run00017, ``--renderer sweep_pallas``): its `timings.csv` printed;
41. `apps.main_comparison_video`, 8 frames: the rotation script (run00017
   and bilinear) and the ``v1`` preset (four scenes, labeled side by
   side); without imageio on the card's machine each video is written as
   PNGs through Pillow, which are read back and checked;
42. `apps.image_vis`: one lens figure of run00017;
43. `apps.main_psnr_allangles`, 4 cameras x 2 rolls, bilinear and
   run00017, without AO (B1) and with the baked AO field, 64 samples
   (B1-ao);
44. `apps.vgg_analysis` at its defaults, `apps.discr_test` on
   artifacts/run00020/run00020 (step 23; its clip on B1 and B1-ao), 4
   clips of `SequenceConfig()` written as npy (B1, B1-ao), then
   `apps.train_texenc` for 20 steps and `apps.adv_evidence` (bilinear,
   run00017) on them;
45. JAX's orbax runs resumed on the card: artifacts/run00022/run00022
   (step 70) and artifacts/run00020/run00020 (step 23, its critic and the
   critic's Adam state too) restored in full into fresh full-width train
   states of their config.json (seconds to restore; every tensor bit for
   bit a CPU restore, step and counts), card vs CPU on the first step (or
   D+G round) after the restore under phase 31's bounds, 20 more on
   phase 29's clips (ms a step or round, peak memory, losses finite);
   then `apps.main_video_unshaded --restore` on run00022 with its own
   flags for epoch 71, cut to 64 crops of 2 clips of 3 frames at crop
   16, and its TensorBoard event file read back (every record's CRCs,
   the version record, the four scalars at step 71, finite, the learning
   rate of epoch 71, the image panels).

In phases 4, 6, 7, 10, 11, 15, 16, 18, 19, 21-23 and 25-45 the launch
counts are zeroed just before each run and read just after it; in phases
4-23 frames 3 onwards must make no host sync (`torch.cuda.set_sync_debug_mode`).  Then one JSON line
of kernel numbers, the card line, and last the device line.  Float32
matmuls and convolutions run without TF32 throughout
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.time()

# clock cycles of the spin that keeps the card busy while the host enqueues
# the calls a timing measures (about 5 ms)
SPIN_CYCLES = 10_000_000
# bytes written before each cold-cache timing, more than the card's 50 MB
# L2: the timed call finds none of its inputs there, as a frame's AO
# capture does after the march has streamed the volume
FLUSH_BYTES = 128 << 20
# H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
PKG = "isosurfacesuperresolution_tpu_torch"
MARCH_SOURCE = f"{PKG}/csrc/sweep_march.cu"
MARCH_REPLACES = "isosurfacesuperresolution_tpu/render/sweep_pallas.py:46"
PHASE_REPLACES = "isosurfacesuperresolution_tpu/ops/phase_conv.py:245"
TILED_REPLACES = ("isosurfacesuperresolution_tpu/render/"
                  "sweep_pallas_tiled.py:54")
AO_TILED_REPLACES = ("isosurfacesuperresolution_tpu/render/"
                     "sweep_pallas_tiled.py:346")
PACKED_REPLACES = ("isosurfacesuperresolution_tpu/render/"
                   "sweep_pallas_tiled.py:705")
AO_PACKED_REPLACES = ("isosurfacesuperresolution_tpu/render/"
                      "sweep_pallas_tiled.py:631")
CONV_SOURCE = f"{PKG}/csrc/conv3x3.cu"
P128_REPLACES = "isosurfacesuperresolution_tpu/ops/pallas_conv.py:35"
PACKED_CONV_REPLACES = "isosurfacesuperresolution_tpu/ops/packed_conv.py:80"
# bounds of the march comparison: both round the same operands at the same
# points; float32 sums may differ in the last place, which can move a
# crossing where F is within rounding of the isovalue
MAX_HIT_MISMATCH = 1e-3      # share of pixels whose m_hit differs
MAX_FRAC_DIFF = 1e-3         # inverse lerp divides by F - Fm1
MAX_GRAD_DIFF = 1e-4
MAX_SH_DIFF = 1e-4           # SH capture: two-tap sums like F
# the tiled capture sums per tile pair, as its plain version does; a bf16
# rounding of a pair term may still go the other way (2^-8 of the term)
MAX_SH_REL = 2.0 ** -8
# phase conv vs plain: exact bf16 products, float32 sums in another order
# (O(1e-5) on these sums); a bf16 output may round the other way, one
# bf16 step, at most 2^-7 of the value
MAX_PHASE_ABS = {"float32": 1e-4, "bfloat16": 0.06}
MAX_PHASE_REL = {"float32": 1e-3, "bfloat16": 2.0 ** -7 + 1e-3}
# fused vs unfused upsample, first frame's rgb: equal maths in the
# interior, float32 convs of other shapes (other cuDNN algorithms), and
# normals normalized before the shading (short vectors amplify); the
# 1-px border of each high-res conv reaches ~6 px inward
MAX_FUSED_INTERIOR = 1e-3
# the isovalue the slider moves the main path's 0.5 to after frame 10
ISO_SLIDER = 0.4
# LoadedModel.inference card vs CPU: float32 through 26 convs twice in
# other sum orders (1e-4 a pass, as the CPU tests hold oneDNN against
# XLA), the second step's warp carrying the first's differences
MAX_INFER_DIFF = 1e-3
# the zoo's small nets card vs CPU (as the `cuda` tests): float32
MAX_ZOO_DIFF = 1e-4
# sweep vs march oracle (tests/test_sweep.py): mask IoU, mean normal cosine
# and mean |depth| difference in the interior eroded by 2 px
MIN_MARCH_IOU = 0.93
MIN_MARCH_COS = 0.995
MAX_MARCH_DEPTH = 2e-3
# ray AO vs the baked field (tests/test_ao_sweep.py): SH-L1 against a
# 32-ray Monte Carlo estimate
MAX_AO_MEAN_DIFF = 0.03
MIN_AO_CORR = 0.6
# the march oracle and the clip generator card vs CPU: the same float32
# elementwise ops in the same order on both; a grazing ray may flip hit
# or miss on one ulp of a sample (a pixel in a few hundred), and AO rays
# likewise (one flip moves AO by 1/samples)
MAX_ORACLE_MASK_MISMATCH = 0.01
MAX_ORACLE_DIFF = 1e-3
# a clip on the kernels (B1, B1-ao) vs the scan: the bounds of
# tests/test_sweep_pallas.py and tests/test_torch_port_sweep.py (mask
# mismatch share; where both hit depth 3e-3, normals 3e-2, flow 1e-3),
# on the clip's channels (low: mask, normal, depth; high: + AO); AO
# read from the same field at the same hit plane: the 0.02 that
# tests/test_sweep_pallas.py holds its 95th percentile to, on the max
MAX_SCAN_MASK_MISMATCH = 0.01
SCAN_TOL_LOW = {1: 3e-2, 2: 3e-2, 3: 3e-2, 4: 3e-3}
SCAN_TOL_HIGH = {**SCAN_TOL_LOW, 5: 0.02}
MAX_SCAN_FLOW = 1e-3
# sweep vs march DVR (tests/test_volume_render.py:46), 2-px border excluded
MAX_DVR_MEAN = 0.015
MAX_DVR_MAX = 0.15
# training card vs CPU (phase 31, as tests/test_torch_port_train.py holds
# the CPU path against JAX): losses of three Adam steps at rel 1e-4; the
# parameters within 1e-2 x lr, but for a few elements of a leaf (at most
# 3%, each within 0.1 x lr) that Adam's normalized step moves on a
# gradient known only to float32 rounding
MAX_TRAIN_LOSS_REL = 1e-4
MAX_TRAIN_PARAM = 1e-2
MAX_TRAIN_FAR_SHARE = 0.03
MAX_TRAIN_FAR = 0.1
ZOO_SMALL = (("EnhanceNet use_bn", dict(use_bn=True)),
             ("EnhanceNet use_sn", dict(use_sn=True)),
             ("EnhanceNet pixelShuffle", dict(upsample="pixelShuffle")),
             ("EnhanceNet bicubic", dict(upsample="bicubic")),
             ("RCAN 2x2", dict(model="RCAN")),
             ("TecoGAN", dict(model="TecoGAN")),
             ("SubpixelNet", dict(model="SubpixelNet")))


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


@contextmanager
def phase(name: str):
    t = time.time()
    log(f"phase {name}: start")
    yield
    log(f"phase {name}: done in {time.time() - t:.1f}s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cam_at(ang: float):
    """The orbit camera of the repository's frame benchmark."""
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    return CameraParams.create((1.7 * math.sin(ang), 0.9,
                                -1.7 * math.cos(ang)), (0.0, 0.0, 0.0),
                               (0.0, 1.0, 0.0), 45.0)


def time_samples(fn, reps: int, backlog: bool = False,
                 cold: bool = False) -> list:
    """Milliseconds of ``reps`` calls after one warm-up call, each between
    CUDA events.  With ``backlog`` each call is enqueued behind a spin of
    a few milliseconds, so the card runs it without waiting for the host:
    its device time without the host's launch cost.  With ``cold`` a
    write of FLUSH_BYTES is enqueued before that spin, outside the timed
    window, so each call starts with a cold L2; the buffer it writes is
    freed on return, so later peak-memory readings do not hold it."""
    import torch
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    fn()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.fill_(i & 0xFF)
        if backlog:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_cuda(fn, reps: int):
    """Median milliseconds of ``reps`` calls after one warm-up call, each
    between CUDA events."""
    return statistics.median(time_samples(fn, reps))


def time_turns(kernel_fn, lib_fn, reps: int) -> tuple:
    """A kernel and the library call for the same function timed in turns,
    library, kernel, kernel, library (``reps`` calls a turn, each behind a
    backlog): (kernel ms, library ms, the per-turn medians of each), ms
    the median over both turns."""
    lib1 = time_samples(lib_fn, reps, backlog=True)
    k1 = time_samples(kernel_fn, reps, backlog=True)
    k2 = time_samples(kernel_fn, reps, backlog=True)
    lib2 = time_samples(lib_fn, reps, backlog=True)
    return (statistics.median(k1 + k2), statistics.median(lib1 + lib2),
            [statistics.median(k1), statistics.median(k2)],
            [statistics.median(lib1), statistics.median(lib2)])


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work while
    the card is busy (as in a chain of calls): ``n`` calls on the host
    clock behind a long spin, with no sync between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20 * SPIN_CYCLES)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return dt


def _out(bf16: str) -> str:
    return "bf16 out" if bf16 == "1" else "float32 out"


def _relu(relu: str) -> str:
    return "ReLU" if relu == "1" else "no ReLU"


# each library's kernel templates: name, ptxas entry pattern, the
# instantiations expected, a label, and for the conv library the dynamic
# shared memory entry and its arguments
CONV_ENTRIES = (
    ("conv3x3_kernel", r"conv3x3_kernelILi(\d+)ELb([01])ELb([01])E", 12,
     lambda g: f"conv3x3_kernel<{g[0]}, {_out(g[1])}, {_relu(g[2])}>",
     ("conv3x3_smem_bytes", lambda g: (int(g[0]),))),
    ("phase_conv_kernel", r"phase_conv_kernelILb([01])ELb([01])E", 4,
     lambda g: f"phase_conv_kernel<{_out(g[0])}, {_relu(g[1])}>",
     ("phase_conv_smem_bytes", lambda g: ())))
_STORE = {"h": "uint8", "f": "float32", "13__nv_bfloat16": "bf16"}
_RESAMPLE = {"1": "bf16", "0": "float32"}
_MARCH_OF = {("0", "0", "0"): "B1", ("1", "0", "0"): "B1-ao",
             ("0", "1", "0"): "B2", ("0", "1", "1"): "B3"}
MARCH_ENTRIES = (
    ("march_kernel",
     r"march_kernelI(h|f|13__nv_bfloat16)Lb([01])ELb([01])ELb([01])ELb([01])E",
     24, lambda g: f"march_kernel {_MARCH_OF[g[2:]]} ({_STORE[g[0]]} "
                   f"store, {_RESAMPLE[g[1]]} resample)", None),
    ("ao_capture_kernel",
     r"ao_capture_kernelI(h|f|13__nv_bfloat16)Lb([01])ELb([01])E", 8,
     lambda g: f"ao_capture_kernel {'B4p' if g[2] == '1' else 'B4'} "
               f"({_STORE[g[0]]} field, {_RESAMPLE[g[1]]} resample)", None))


def ptxas_lines(kernels, library: str, entries) -> list:
    """Phase 2's figures for one library, a line per instantiation of each
    kernel template in ``entries`` (the march library's `march_kernel`
    for B1, B1-ao, B2, B3 and `ao_capture_kernel`; the conv library's
    `conv3x3_kernel<NT, OUT_BF16, RELU>` and `phase_conv_kernel<OUT_BF16,
    RELU>`): registers, spill bytes and stack from the ``-Xptxas -v``
    log, static shared memory from it and, where the library reports it,
    the dynamic shared memory it launches with.  Raises on a missing log,
    a missing instantiation or any spill."""
    import ctypes
    lib = kernels.load(library)
    usage = kernels.ptxas_usage(kernels.build_log(library))
    lines = []
    for name, pattern, count, label, dynamic in entries:
        found = [(u, re.search(pattern, u["entry"]).groups())
                 for u in usage if name in u["entry"]]
        if len(found) != count:
            raise RuntimeError(f"the {library} library's ptxas log lists "
                               f"{len(found)} {name} entries, expected "
                               f"{count}")
        for u, g in found:
            smem = f"{u['static_smem']} B static"
            if dynamic is not None:
                fn = getattr(lib, dynamic[0])
                fn.restype = ctypes.c_int  # its int arguments pass as c_int
                smem += f" + {fn(*dynamic[1](g))} B dynamic"
            lines.append(
                f"{label(g)}: {u['registers']} registers, spill stores "
                f"{u['spill_stores']} B, spill loads {u['spill_loads']} B, "
                f"stack {u['stack']} B, shared memory {smem}")
            if u["spill_stores"] or u["spill_loads"]:
                raise RuntimeError(f"spills in {lines[-1]}")
    return lines


def march_bound_ms(args: dict, outs) -> tuple:
    """Least time for this march on the card: its bytes (volume, table,
    grids read once, outputs written once, and with AO only the field
    values it samples: 2 z-planes x 2 x 2 taps x 4 channels at each hit)
    over HBM bandwidth, and its float32 operations for THIS data (every
    pixel samples each kept slice up to its hit, plus four neighbour
    samples and, with AO, four SH samples at the hit; ~40 flops per
    sample: 4 taps x (z-lerp, dequant, weight, product) + 2 sums) over the
    CUDA-core float32 peak."""
    import torch
    vol, meta = args["vol_zxy"], args["meta"]
    Sn, Tn = args["Sn"], args["Tn"]
    store = torch.uint8 if vol.dtype == torch.uint8 else args["dtype"]
    elem = torch.empty((), dtype=store).element_size()
    nbytes = (vol.numel() * elem + meta.numel() * 4 + (Sn + Tn) * 4
              + 5 * Sn * Tn * 4)
    cum = torch.cumsum((meta[:, 4] > 0.5).to(torch.float64), 0)
    m_hit = outs[0]
    hit = m_hit >= 0
    ao = args.get("ao_zcxy")
    if ao is not None:
        mm = torch.empty((), dtype=args["dtype"]).element_size()
        nbytes += float(hit.sum()) * 2 * 4 * 4 * mm + 4 * Sn * Tn * 4
    live = torch.where(hit, cum[m_hit.clamp(min=0).long()], cum[-1])
    per_hit = 4.0 + (4.0 if ao is not None else 0.0)
    samples = float(live.sum()) + per_hit * float(hit.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 40.0 * samples / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bound_ms(H: int, W: int, out_elem: int) -> tuple:
    """Least time for the phase conv: 2 * (2H)(2W) * 64 * 64 * 9 bf16
    tensor-core operations, and its bytes (bf16 input, weights and bias
    read once, the output written once)."""
    flops = 2.0 * (2 * H) * (2 * W) * 64 * 64 * 9
    nbytes = H * W * 256 * (2 + out_elem) + 9 * 64 * 64 * 2 + 64 * 4
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_bound_ms(h: int, w: int, cin: int, cout: int,
                  out_elem: int) -> tuple:
    """Least time for a 3x3 conv on the card: 2 * h * w * cin * cout * 9
    bf16 tensor-core operations, and its bytes (bf16 input and weights,
    float32 bias read once, the output written once)."""
    flops = 2.0 * h * w * cin * cout * 9
    nbytes = (h * w * cin * 2 + 9 * cin * cout * 2 + cout * 4
              + h * w * cout * out_elem)
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_conv(tag: str, got, want) -> float:
    """Hold a conv kernel's output against its plain version's: exact
    bf16 products, float32 sums in another order (1e-5 of the output's
    scale), and a bf16 output may round the other way (one step, 2^-7 of
    the value).  Raises out of bounds; returns the largest difference."""
    import torch
    bf16_out = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    d = (got - want).abs()
    tol = 1e-5 * float(want.abs().max())
    ok = bool((d <= tol + (2.0 ** -7 * want.abs() if bf16_out else 0.0))
              .all())
    log(f"[{tag}] max |diff| {float(d.max()):.3g}, output max "
        f"{float(want.abs().max()):.3g}; bound 1e-5 x output max"
        + (" + one bf16 step (2^-7 |ref|)" if bf16_out else "")
        + f": {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{tag} disagrees with its plain version")
    return float(d.max())


def tiled_bound_ms(args: dict, outs, tables, shape, elem: int,
                   slots=None) -> tuple:
    """Least time for the tiled march on THIS data, counted as
    `march_bound_ms` counts the flat march.  ``tables`` is
    `sweep_tiled.march_tables` of ``args``, ``shape`` the (Z, X, Y) volume
    and ``elem`` its bytes per value.  Bytes: the volume planes that
    working slices read, only inside their occupied tiles (each (plane,
    tile) once; packed, with ``slots``: each slot entry so read, 4 bytes,
    and each distinct atlas tile it names), the tile table and grids, the
    five outputs.  Operations: 10 float32 flops per tap in an occupied
    tile on every working slice up to the pixel's hit (the flat march's 40
    per four-tap sample: z-lerp, dequant, weight, product, and the sums),
    and at each hit four neighbour samples (4 x 40)."""
    import torch
    meta, Sn, Tn = args["meta"], args["Sn"], args["Tn"]
    TX, TY, occ, counts = tables
    Z, X, Y = shape
    K, NTX, NTY = occ.shape
    dev = meta.device
    occ_f = occ.reshape(K, -1).to(torch.float32)
    zf = meta[:, 2].long()
    planes = torch.zeros((Z, NTX * NTY), device=dev)
    planes.index_add_(0, zf, occ_f).index_add_(0, zf + 1, occ_f)
    read = planes > 0
    if slots is None:
        tile_bytes = float(read.sum()) * TX * TY * elem
    else:
        tile_bytes = (float(read.sum()) * 4 + TX * TY * elem * float(
            torch.unique(slots.reshape(Z, -1)[read]).numel()))
    nbytes = (tile_bytes + meta.numel() * 4 + (Sn + Tn) * 4
              + args["table"].numel() * 4 + 5 * Sn * Tn * 4)
    m_hit = outs[0]
    live_until = torch.where(m_hit >= 0, m_hit, float(K))
    taps = torch.zeros((), dtype=torch.float64, device=dev)

    def tap_tiles(pos, n, t, nt):
        """(len(pos), nt) count of a pixel's valid taps in each tile"""
        j0 = torch.floor(pos - 0.5).long()
        out = torch.zeros((pos.shape[0], nt), device=pos.device)
        for a in range(2):
            j = j0 + a
            ok = (j >= 0) & (j < n)
            out += torch.nn.functional.one_hot(
                torch.clamp(j, 0, n - 1) // t, nt) * ok[:, None]
        return out

    rows = meta.cpu()
    for k in torch.nonzero(counts.cpu() > 0).flatten().tolist():
        lam, eye_s, eye_t = (float(v) for v in rows[k, [1, 6, 7]])
        ax = tap_tiles(eye_s + lam * (args["s_grid"] - eye_s), X, TX, NTX)
        ay = tap_tiles(eye_t + lam * (args["t_grid"] - eye_t), Y, TY, NTY)
        live = (live_until >= k).to(torch.float64)
        per_px = ax @ occ[k].to(torch.float32) @ ay.t()
        taps += (per_px * live).sum()
    hits = float((m_hit >= 0).sum())
    ops = 10.0 * float(taps) + 4 * 40.0 * hits
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ao_tiled_bound_ms(field_shape, elem: int, meta, s_grid, t_grid, m_hit,
                      fd, tables, table_bytes: float) -> tuple:
    """Least time for the tiled AO capture (or the packed one) on THIS
    data.  ``tables`` is `sweep_tiled.ao_tables` of these inputs (packed:
    the tile sizes and kept pairs of `ao_packed_tables`, and the meta),
    ``table_bytes`` what the kernel reads of its tile table (packed: of
    its slot table).  Bytes: the field values sampled at the hits (2
    planes x 4 channels of ``elem`` bytes at each of a hit's taps in a
    kept tile), m_hit read, sh written, the table.  Operations: 4
    channels x 10 flops (z-lerp, dequant, weight, product, sum, as the
    marches count) per such tap."""
    import torch
    Sn, Tn = m_hit.shape
    TX, TY, occ, _, meta2 = tables
    K = meta.shape[0]
    _, _, X2, Y2 = field_shape
    NTY = Y2 // TY
    hit = m_hit >= 0
    k = torch.clamp(m_hit.long(), 0, K - 1)
    lam, eye_s, eye_t = meta2[k, 1], meta2[k, 6], meta2[k, 7]
    sp = (eye_s + lam * (s_grid[:, None] - eye_s)) / fd
    tp = (eye_t + lam * (t_grid[None, :] - eye_t)) / fd
    jx0, jy0 = torch.floor(sp - 0.5).long(), torch.floor(tp - 0.5).long()
    occ_f = occ.reshape(K, -1)
    n_taps = 0.0
    for a in range(2):
        for b in range(2):
            jx, jy = jx0 + a, jy0 + b
            ok = (jx >= 0) & (jx < X2) & (jy >= 0) & (jy < Y2) & hit
            pid = (torch.clamp(jx, 0, X2 - 1) // TX * NTY
                   + torch.clamp(jy, 0, Y2 - 1) // TY)
            n_taps += float((ok & occ_f[k, pid]).sum())
    nbytes = (n_taps * 2 * 4 * elem + Sn * Tn * 4 + 4 * Sn * Tn * 4
              + table_bytes + meta.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_taps * 4 * 10 / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def capture_row(tag: str, kernel_fn, wrapper_fn, plain_fn, bound: float,
                bound_by: str, err: float, m_hit) -> dict:
    """Time an AO capture three ways and log it: its device time (the
    launch entry behind a backlog with a cold L2, median of 21), its
    idle-queue time and its wrapper's (median of 7), and the host
    microseconds of one call of each; beside them the plain version's
    time, the bound and the share of it the device time takes.  Returns
    the kernel line's row (ms: the device time)."""
    dev_ms = statistics.median(time_samples(kernel_fn, 21, backlog=True,
                                            cold=True))
    idle_ms = time_cuda(kernel_fn, 7)
    wrapper_ms = time_cuda(wrapper_fn, 7)
    plain_ms = time_cuda(plain_fn, 3)
    entry_us = host_us(kernel_fn)
    wrap_us = host_us(wrapper_fn)
    hits = float((m_hit >= 0).float().mean())
    log(f"[{tag}] device {dev_ms:.4f} ms (behind a backlog, cold L2, median "
        f"of 21): {bound / dev_ms:.4f} of its bound {bound:.4f} ms by "
        f"{bound_by}; idle queue {idle_ms:.4f} ms, the wrapper "
        f"{wrapper_ms:.4f} ms (median of 7); host {entry_us:.1f} us a call "
        f"of the launch entry, {wrap_us:.1f} us of the wrapper; plain "
        f"{plain_ms:.1f} ms (median of 3); hits {hits:.4f}")
    return {"max_abs_err": err, "ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def compare_march(got, want) -> dict:
    m_got, m_want = got[0], want[0]
    mismatch = float((m_got != m_want).float().mean())
    same = (m_got == m_want) & (m_got >= 0)
    names = ("frac", "g_s", "g_t", "g_z", "sh")[:len(got) - 1]
    diffs = {}
    for name, g, w in zip(names, got[1:], want[1:]):
        d = (g - w).abs()
        d = d[:, same] if name == "sh" else d[same]
        diffs[name] = float(d.max()) if d.numel() else 0.0
    return {"hit_mismatch": mismatch, **diffs}


def check_march(tag: str, got, want) -> tuple:
    """Log the comparison of the march with its plain version and raise
    if it is out of bounds; returns (the largest difference, the m_hit
    mismatch share)."""
    cmp = compare_march(got, want)
    log(f"[{tag}] hits {float((got[0] >= 0).float().mean()):.4f}, "
        + ", ".join(f"{k} {v:.3g}" for k, v in cmp.items()))
    ok = (cmp["hit_mismatch"] <= MAX_HIT_MISMATCH
          and cmp["frac"] <= MAX_FRAC_DIFF
          and max(cmp["g_s"], cmp["g_t"], cmp["g_z"]) <= MAX_GRAD_DIFF
          and cmp.get("sh", 0.0) <= MAX_SH_DIFF)
    log(f"[{tag}] bounds: m_hit mismatch <= {MAX_HIT_MISMATCH}, |frac| <= "
        f"{MAX_FRAC_DIFF}, |g_*| <= {MAX_GRAD_DIFF}"
        + (f", |sh| <= {MAX_SH_DIFF}" if "sh" in cmp else "")
        + f" where both hit the same slice: {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"sweep_march disagrees with its plain version "
                           f"({tag})")
    if "sh" in cmp:
        hit = got[0] >= 0
        if not bool((got[5][:, ~hit] == 0).all()):
            raise RuntimeError(f"[{tag}] SH written where no crossing")
    return (max(v for k, v in cmp.items() if k != "hit_mismatch"),
            cmp["hit_mismatch"])


def march_line(tag: str, ms: float, plain_ms: float, bound: float,
               bound_by: str, mismatch: float, wrapper_ms=None) -> None:
    """Log a march's time beside its bound: the share of the bound it
    reaches (bound ms / ms) and its m_hit mismatch share (expected 0)."""
    wrap = ("" if wrapper_ms is None else
            f"; the wrapper, its tile table kept with the grid, "
            f"{wrapper_ms:.3f} ms")
    log(f"[{tag}] kernel {ms:.3f} ms (median of 7{wrap}), plain "
        f"{plain_ms:.1f} ms (median of 3), bound {bound:.4f} ms by "
        f"{bound_by}: {bound / ms:.4f} of its bound; m_hit mismatch share "
        f"{mismatch:.6f} (expected 0)")


def check_card_vs_cpu(tag: str, outs: dict, with_ao: bool) -> None:
    """Compare the last of three chained small frames rendered on the card
    and on the CPU, ``outs[dev] = (rgb, G-buffer)``; raise out of bounds
    (and, ``with_ao``, if the AO channel is 1 on every hit)."""
    d_rgb = (outs["cuda"][0] - outs["cpu"][0]).abs()
    fr_c, fr_h = outs["cuda"][1], outs["cpu"][1]
    mask_mismatch = float((fr_c[..., 3] != fr_h[..., 3]).float().mean())
    far = float((d_rgb > 0.05).float().mean())
    both = (fr_c[..., 3] > 0.5) & (fr_h[..., 3] > 0.5)
    d_ao = float((fr_c[..., 10] - fr_h[..., 10]).abs()[both].max())
    log(f"[{tag}] 3 chained 64x48 -> 256x192 frames: G-buffer mask "
        f"mismatch {mask_mismatch:.4f}, AO |diff| on hits {d_ao:.2e}, rgb "
        f"median |diff| {float(d_rgb.median()):.2e}, share > 0.05: "
        f"{far:.4f}")
    if (mask_mismatch > 0.01 or far > 0.01
            or float(d_rgb.median()) > 1e-3 or d_ao > MAX_SH_DIFF):
        raise RuntimeError(
            f"card and CPU frames disagree ({tag}; bounds: mask mismatch "
            f"<= 0.01, share of rgb |diff| > 0.05 <= 0.01, median |diff| "
            f"<= 1e-3, AO |diff| on hits <= {MAX_SH_DIFF})")
    if with_ao and not bool((fr_c[..., 10][both] < 1).any()):
        raise RuntimeError(f"[{tag}] the AO channel is 1 on every hit")


FRAME_MS = {}     # ms/frame of each `drive` run, by tag


def drive(frame_fn, n_frames: int, tag: str, counters: dict):
    """Run ``frame_fn(i)`` for i < n_frames with the launch counts zeroed
    just before and read just after; frames 3 onwards must make no host
    sync.  Logs the times and peak memory (ms/frame kept in FRAME_MS);
    returns (last output, launches)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(n_frames + 1)]
    for holder, attr in counters.values():
        setattr(holder, attr, 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        events[0].record()
        for i in range(n_frames):
            if i == 2:      # frames 3 onwards must not wait for the card
                torch.cuda.set_sync_debug_mode("warn")
            out = frame_fn(i)
            events[i + 1].record()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k: getattr(h, a) for k, (h, a) in counters.items()}
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    ms_frame = events[2].elapsed_time(events[n_frames]) / (n_frames - 2)
    FRAME_MS[tag] = ms_frame
    first_ms = events[0].elapsed_time(events[1])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {ms_frame:.2f} ms/frame over frames 3-{n_frames} (first "
        f"frame {first_ms:.1f} ms), peak memory allocated {peak_gib:.2f} "
        f"GiB, launches {launches}, host syncs in frames 3-{n_frames}: "
        f"{len(syncs)}")
    if syncs:
        raise RuntimeError(f"[{tag}] a frame waited for the card: "
                           f"{syncs[0]}")
    return out, launches


def copy_ms(frame_fn, n_frames: int = 5) -> tuple:
    """(device ms per frame of copies, of all kernels) over ``n_frames``
    frames under `torch.profiler`, after two warm-up frames: copies are
    the kernels and transfers whose names say copy or memcpy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        frame_fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_frames):
            frame_fn(2 + i)
        torch.cuda.synchronize()
    busy = copies = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total / 1e3
            if "copy" in e.key.lower():
                copies += e.self_device_time_total / 1e3
    return copies / n_frames, busy / n_frames


def check_rgb(rgb, mask, shape) -> None:
    import torch
    if tuple(rgb.shape) != shape:
        raise RuntimeError(f"rgb shape {tuple(rgb.shape)}, not {shape}")
    if not bool(torch.isfinite(rgb).all()):
        raise RuntimeError("non-finite rgb")
    if not bool(mask.any()):
        raise RuntimeError("empty mask")
    log(f"rgb {tuple(rgb.shape)} finite, mask share "
        f"{float(mask.float().mean()):.4f}")


def expect(launches: dict, want: dict, tag: str) -> None:
    """``want`` names the kernels launched; every other count must be 0."""
    unknown = set(want) - set(launches)
    if unknown:
        raise KeyError(f"[{tag}] no launch counter for {sorted(unknown)}")
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"[{tag}] kernel launches {launches}, expected "
                           f"{want}")


def erode(m, iterations: int):
    """Binary erosion of a (H, W) bool tensor by the 4-neighbour cross,
    pixels outside the image counted empty (scipy's default)."""
    for _ in range(iterations):
        e = m.clone()
        e[1:] &= m[:-1]
        e[:-1] &= m[1:]
        e[:, 1:] &= m[:, :-1]
        e[:, :-1] &= m[:, 1:]
        e[0], e[-1], e[:, 0], e[:, -1] = False, False, False, False
        m = e
    return m


def counted(fn, tag: str, counters: dict, want, add):
    """Run ``fn()`` once with the launch counts zeroed just before and
    read just after (a path run): (output, seconds on the host clock
    around a synced call); the launches must be ``want``, a dict of
    counts, or, where the counts depend on the data (tiles, clips), a
    set of the kernels that must launch while no other one does."""
    import torch
    torch.cuda.synchronize()
    for holder, attr in counters.values():
        setattr(holder, attr, 0)
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    sec = time.time() - t
    launches = {k: getattr(h, a) for k, (h, a) in counters.items()}
    if isinstance(want, set):
        if {k for k, v in launches.items() if v} != want:
            raise RuntimeError(f"[{tag}] kernels launched {launches}, "
                               f"expected {sorted(want)} and no other")
    else:
        expect(launches, want, tag)
    add(launches)
    log(f"[{tag}] {sec * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out, sec


def sweep_vs_march(fr_m, fr_s) -> tuple:
    """(mask IoU, mean normal cosine, mean |depth diff|, interior pixels)
    of two G-buffers, as tests/test_sweep.py measures them."""
    ma, mb = fr_m[..., 3] > 0.5, fr_s[..., 3] > 0.5
    iou = float((ma & mb).sum()) / max(float((ma | mb).sum()), 1.0)
    inner = erode(ma & mb, 2)
    cos = (fr_m[..., 4:7][inner] * fr_s[..., 4:7][inner]).sum(-1)
    dd = (fr_m[..., 7] - fr_s[..., 7]).abs()[inner]
    return iou, float(cos.mean()), float(dd.mean()), int(inner.sum())


def oracle_card_vs_cpu(tag: str, outs: dict, pairs) -> None:
    """Card against CPU outputs ``outs[dev]``: for each (key, mask
    channel, mask threshold) in ``pairs`` the share of pixels whose mask
    differs and the largest difference where both masks hold; raise out
    of bounds."""
    for key, ch, thr in pairs:
        a, b = outs["cuda"][key].cpu(), outs["cpu"][key]
        ma, mb = a[..., ch] > thr, b[..., ch] > thr
        mism = float((ma != mb).float().mean())
        both = ma & mb
        diff = float((a - b).abs()[both].max()) if bool(both.any()) else 0.0
        log(f"[{tag} {key}] card vs CPU: mask mismatch {mism:.4f} (bound "
            f"{MAX_ORACLE_MASK_MISMATCH}), max |diff| where both hit "
            f"{diff:.3g} (bound {MAX_ORACLE_DIFF}), {int(both.sum())} "
            f"pixels")
        if (mism > MAX_ORACLE_MASK_MISMATCH or diff > MAX_ORACLE_DIFF
                or not bool(both.any())):
            raise RuntimeError(f"{tag} {key}: card and CPU disagree")


def compare_clips(tag: str, a: dict, b: dict, tol_low: dict,
                  tol_high: dict, tol_flow: float, max_mismatch: float,
                  iterations: int) -> None:
    """Two clips of one camera path (``low``, ``high``, ``flow``; numpy
    arrays or tensors): for ``low`` and ``high`` the share of pixels
    whose mask (channel 0 > 0) differs, at most ``max_mismatch``, and for
    each channel c of ``tol_*`` the largest difference where both masks
    hold, at most ``tol_*[c]``.  The flow is held to ``tol_flow`` where
    both low masks hold and on the background farther than
    ``iterations`` pixels from any mask flip: the inpainting spreads a
    pixel's flow that far and no farther, and elsewhere averages the same
    hits on both sides.  Raise out of bounds."""
    import torch
    import torch.nn.functional as F
    a = {k: torch.as_tensor(v).cpu() for k, v in a.items()}
    b = {k: torch.as_tensor(v).cpu() for k, v in b.items()}
    for key, tols in (("low", tol_low), ("high", tol_high)):
        ma, mb = a[key][..., 0] > 0, b[key][..., 0] > 0
        mism = float((ma != mb).float().mean())
        both = ma & mb
        d = (a[key] - b[key]).abs()[both][:, list(tols)]
        worst = {c: float(d[:, i].max()) if bool(both.any()) else 0.0
                 for i, c in enumerate(tols)}
        log(f"[{tag} {key}] mask mismatch {mism:.5f} (bound "
            f"{max_mismatch}); max |diff| where both hit by channel "
            f"{ {c: float(f'{w:.3g}') for c, w in worst.items()} } (bounds "
            f"{tols}), {int((d > 1e-4).any(-1).sum())} of "
            f"{int(both.sum())} pixels beyond 1e-4")
        if (mism > max_mismatch or not bool(both.any())
                or any(worst[c] > tols[c] for c in tols)):
            raise RuntimeError(f"{tag} {key}: the clips disagree")
    ma, mb = a["low"][..., 0] > 0, b["low"][..., 0] > 0
    near = F.max_pool2d((ma != mb).float()[:, None], 2 * iterations + 1,
                        stride=1, padding=iterations)[:, 0] > 0
    d = (a["flow"] - b["flow"]).abs().amax(-1)
    on_hits = float(d[ma & mb].max())
    rest = ~ma & ~mb & ~near
    off = float(d[rest].max()) if bool(rest.any()) else 0.0
    log(f"[{tag} flow] max |diff| where both hit {on_hits:.3g}, on the "
        f"inpainted background beyond {iterations} px of a mask flip "
        f"{off:.3g} over {int(rest.sum())} pixels (bound {tol_flow})")
    if on_hits > tol_flow or off > tol_flow:
        raise RuntimeError(f"{tag} flow: the clips disagree")


def reference_renderers(grid, counters: dict, add, frame_cfg) -> None:
    """Phases 25-28: the march oracle, hemisphere-ray AO, the clip
    generator and DVR + SSAO on the main path's volume (``grid``,
    `blobs_volume(256, num_blobs=8)`) and camera."""
    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences, random_camera_path)
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.ssao import (
        apply_screen_ao)
    from isosurfacesuperresolution_tpu_torch.render.volume_render import (
        render_volume_march, render_volume_sweep)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    times = {}
    cam = cam_at(0.0)
    b1, b1ao = {"sweep_march": 1}, {"sweep_march_ao": 1}
    with phase("25 the march oracle at 480x270 against the sweep (B1)"):
        cfg_m = RenderConfig(width=480, height=270, isovalue=0.5,
                             step_voxels=0.25, renderer="march")
        cfg_s = cfg_m.replace(renderer="sweep_pallas")
        render_frame_gbuffer(grid, cam, cam, cfg_m)          # warm-up
        fr_m, times["march"] = counted(
            lambda: render_frame_gbuffer(grid, cam, cam, cfg_m), "march",
            counters, {}, add)
        fr_s, _ = counted(lambda: render_frame_gbuffer(grid, cam, cam,
                                                       cfg_s),
                          "sweep_pallas", counters, b1, add)
        iou, cos, dd, n_in = sweep_vs_march(fr_m, fr_s)
        ok = iou > MIN_MARCH_IOU and cos > MIN_MARCH_COS and \
            dd < MAX_MARCH_DEPTH and n_in > 50
        log(f"[march vs sweep_pallas] mask IoU {iou:.4f} (> {MIN_MARCH_IOU})"
            f", mean normal cosine {cos:.5f} (> {MIN_MARCH_COS}), mean "
            f"|depth diff| {dd:.2e} (< {MAX_MARCH_DEPTH}) over {n_in} "
            f"interior pixels; march {times['march'] * 1e3:.1f} ms/frame, "
            f"hits {float((fr_m[..., 3] > 0.5).float().mean()):.4f}: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("the march oracle and the sweep disagree")
        outs = {}
        for dev in ("cuda", "cpu"):
            g = analytic.blobs_volume(64, num_blobs=8, device=dev)
            outs[dev] = {"march": render_frame_gbuffer(
                g, cam, cam_at(0.03), cfg_m.replace(width=64, height=48))}
        oracle_card_vs_cpu("march 64x48", outs, [("march", 3, 0.5)])
        del fr_m, fr_s

    with phase("26 hemisphere-ray AO against the baked field"):
        torus = analytic.torus_volume(256, device="cuda")
        cam_t = CameraParams.create((0.0, 1.2, -0.25))
        # the view of tests/test_ao_sweep.py; AO rays reach the same
        # world distance (1024 steps of half a voxel at 256^3)
        cfg_ray = RenderConfig(width=480, height=270, isovalue=0.5,
                               step_voxels=0.5, ao_samples=32,
                               ao_radius=0.2, ao_ray_steps=1024,
                               ao_mode="ray", renderer="march")
        t = time.time()
        baked = attach_baked_ao(torus, 0.5, 0.2, num_dirs=48)
        torch.cuda.synchronize()
        log(f"baked the 256^3 torus's field (48 directions) in "
            f"{time.time() - t:.2f} s")
        ref, times["march ray AO"] = counted(
            lambda: render_frame_gbuffer(torus, cam_t, cam_t, cfg_ray),
            "march + ray AO", counters, {}, add)
        cfg_vol = cfg_ray.replace(ao_mode="volume", renderer="sweep_pallas")
        got, _ = counted(lambda: render_frame_gbuffer(baked, cam_t, cam_t,
                                                      cfg_vol),
                         "sweep_pallas + baked AO", counters, b1ao, add)
        _, times["sweep ray AO"] = counted(
            lambda: render_frame_gbuffer(
                torus, cam_t, cam_t, cfg_ray.replace(renderer="sweep_pallas")),
            "sweep_pallas + ray AO", counters, b1, add)
        both = erode((ref[..., 3] > 0.5) & (got[..., 3] > 0.5), 2)
        d = (ref[..., 10] - got[..., 10]).abs()[both]
        occ = torch.stack([1 - ref[..., 10][both], 1 - got[..., 10][both]])
        corr = float(torch.corrcoef(occ)[0, 1])
        ok = (int(both.sum()) > 100 and float(d.mean()) < MAX_AO_MEAN_DIFF
              and corr > MIN_AO_CORR
              and float(got[..., 10][both].min()) < 0.92)
        log(f"[ray AO vs baked] {int(both.sum())} interior pixels: mean "
            f"|dAO| {float(d.mean()):.4f} (< {MAX_AO_MEAN_DIFF}), "
            f"occlusion correlation {corr:.3f} (> {MIN_AO_CORR}); march + "
            f"ray AO {times['march ray AO'] * 1e3:.1f} ms/frame, "
            f"sweep_pallas + ray AO {times['sweep ray AO'] * 1e3:.1f} "
            f"ms/frame: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("ray AO and the baked field disagree")
        del torus, baked, ref, got

    with phase("27 the clip generator at its reference settings"):
        base = RenderConfig(renderer="sweep_pallas", step_voxels=0.5)
        seq_cfg = SequenceConfig()
        shapes = {"low": (10, 128, 128, 5), "high": (10, 512, 512, 6),
                  "flow": (10, 128, 128, 2)}
        clips = {}
        for renderer, want in (("sweep_pallas",
                                {"sweep_march": 10, "sweep_march_ao": 10}),
                               ("sweep", {})):
            seqs, sec = counted(lambda: generate_sequences(
                [(grid, (0.5, 0.5))], 1, seq_cfg,
                base_render_cfg=base.replace(renderer=renderer), seed=0),
                f"clip {renderer}", counters, want, add)
            times[f"clip {renderer}"] = sec
            seq = clips[renderer] = seqs[0]
            for k, shape in shapes.items():
                if seq[k].shape != shape or not np.isfinite(seq[k]).all():
                    raise RuntimeError(f"clip {k}: shape {seq[k].shape} "
                                       f"(want {shape}) or not finite")
            hi_mask = seq["high"][..., 0] > 0
            lo_mask = seq["low"][..., 0] > 0
            ao = seq["high"][..., 5][hi_mask]
            log(f"[clip {renderer}] {sec:.2f} s a clip of 10 frames "
                f"(512^2 with 256-sample AO, baked, and 128^2), bake "
                f"included; mask share high {hi_mask.mean():.4f}, low "
                f"{lo_mask.mean():.4f}; AO on hits min {ao.min():.4f}, "
                f"mean {ao.mean():.4f}")
            if not (lo_mask.any(axis=(1, 2)).all()
                    and hi_mask.any(axis=(1, 2)).all()):
                raise RuntimeError(f"clip {renderer}: an empty mask")
        compare_clips("clip sweep_pallas vs scan", clips["sweep_pallas"],
                      clips["sweep"], SCAN_TOL_LOW, SCAN_TOL_HIGH,
                      MAX_SCAN_FLOW, MAX_SCAN_MASK_MISMATCH,
                      seq_cfg.inpaint_iterations)
        del clips, seqs, seq
        small = SequenceConfig(num_frames=3, high_res=64)
        outs, cams = {}, {}
        for dev in ("cuda", "cpu"):
            g = analytic.blobs_volume(64, num_blobs=8, device=dev)
            outs[dev] = generate_sequences([(g, (0.5, 0.5))], 1, small,
                                           base_render_cfg=base, seed=0)[0]
            rng = np.random.RandomState(0)
            rng.randint(1)
            cams[dev] = [c.eye for c in random_camera_path(rng, small)]
        if not all(bool((a == b).all()) for a, b in zip(cams["cuda"],
                                                        cams["cpu"])):
            raise RuntimeError("the clip's cameras differ")
        every = {c: MAX_ORACLE_DIFF for c in range(1, 6)}
        compare_clips("clip 64/16, 3 frames, card vs CPU", outs["cuda"],
                      outs["cpu"], {c: every[c] for c in range(1, 5)},
                      every, MAX_ORACLE_DIFF, MAX_ORACLE_MASK_MISMATCH,
                      small.inpaint_iterations)

    with phase("28 direct volume rendering and SSAO"):
        cfg_v = RenderConfig(width=480, height=270, step_voxels=0.25)
        render_volume_sweep(grid, cam, cfg_v)              # warm-up
        sw, times["dvr sweep"] = counted(
            lambda: render_volume_sweep(grid, cam, cfg_v), "dvr sweep",
            counters, {}, add)
        ma, times["dvr march"] = counted(
            lambda: render_volume_march(grid, cam, cfg_v), "dvr march",
            counters, {}, add)
        d = (sw - ma).abs()[2:-2, 2:-2]
        ok = (float(d.mean()) < MAX_DVR_MEAN and float(d.max()) < MAX_DVR_MAX
              and bool(torch.isfinite(sw).all())
              and float(sw[..., 3].max()) > 0.2)
        log(f"[dvr sweep vs march] mean |diff| {float(d.mean()):.4f} (< "
            f"{MAX_DVR_MEAN}), max {float(d.max()):.4f} (< {MAX_DVR_MAX}), "
            f"alpha max {float(sw[..., 3].max()):.3f}; sweep "
            f"{times['dvr sweep'] * 1e3:.1f} ms/frame, march "
            f"{times['dvr march'] * 1e3:.1f} ms/frame: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("DVR sweep and march disagree")
        fr, _ = counted(lambda: render_frame_gbuffer(grid, cam, cam,
                                                     frame_cfg),
                        "main-path G-buffer", counters, b1, add)
        times["ssao"] = time_cuda(lambda: apply_screen_ao(fr), 7)
        out = apply_screen_ao(fr)
        hit = fr[..., 3] > 0.5
        ao = out[..., 10]
        log(f"[ssao] {times['ssao']:.3f} ms/frame (median of 7) on the "
            f"480x270 G-buffer; AO on hits min {float(ao[hit].min()):.4f}, "
            f"mean {float(ao[hit].mean()):.4f}")
        if not (bool((ao[~hit] == 1).all()) and bool((ao[hit] < 1).any())):
            raise RuntimeError("SSAO: AO 1 on every hit or below 1 on the "
                               "background")


def train_steps(step, state, batches, n: int, tag: str, counters: dict,
                add) -> list:
    """``n`` train steps with the launch counts zeroed just before and read
    just after (the training path launches no kernel); steps 3 onwards
    may make one host sync, the spike guard's loss read.  Logs ms a step
    (CUDA events over steps 3-n) and peak memory; returns the losses."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for holder, attr in counters.values():
        setattr(holder, attr, 0)
    losses = []

    def accept(loss) -> bool:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        losses.append(float(loss))
        torch.cuda.set_sync_debug_mode(mode)
        return bool(math.isfinite(losses[-1]))

    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        events[0].record()
        for i in range(n):
            if i == 2:
                torch.cuda.set_sync_debug_mode("warn")
            step(state, *next(batches), accept=accept)
            events[i + 1].record()
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k: getattr(h, a) for k, (h, a) in counters.items()}
    expect(launches, {}, tag)
    add(launches)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    ms = events[2].elapsed_time(events[n]) / (n - 2)
    FRAME_MS[tag] = ms
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag}] {ms:.2f} ms a step over steps 3-{n} (first "
        f"{events[0].elapsed_time(events[1]):.1f} ms), peak memory "
        f"allocated {peak:.2f} GiB, host syncs in steps 3-{n} besides the "
        f"loss reads: {len(syncs)}; losses "
        + " ".join(f"{v:.5g}" for v in losses))
    if syncs:
        raise RuntimeError(f"[{tag}] a step waited for the card: "
                           f"{syncs[0]}")
    if len(losses) != n or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"[{tag}] a loss is not finite: {losses}")
    return losses


def params_close(card: dict, cpu: dict, lr: float) -> tuple:
    """(largest |diff| / lr, largest share of a leaf beyond
    MAX_TRAIN_PARAM x lr, within phase 31's bounds)."""
    worst, share = 0.0, 0.0
    for k, v in cpu.items():
        d = (card[k].cpu() - v.cpu()).abs()
        worst = max(worst, float(d.max()) / lr)
        share = max(share, float((d > MAX_TRAIN_PARAM * lr).float().mean()))
    return worst, share, worst < MAX_TRAIN_FAR and share <= \
        MAX_TRAIN_FAR_SHARE


def training(model_cfg, grid, counters: dict, add) -> list:
    """Phases 29-31: the trainer at full width on clips the kernels made,
    adversarial and perceptual rounds, card vs CPU and the entry point.
    Returns phase 29's clips."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, RenderConfig, TrainConfig)
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset)
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    from isosurfacesuperresolution_tpu_torch.train.device_data import (
        DeviceVideoDataset)
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    def fresh(cfg, device, seed, sn=False):
        gen = torch.Generator().manual_seed(seed)
        model = create_network(cfg.model, generator=gen).to(device)
        crit = LossNetUnshaded(cfg.loss, high_res=cfg.train.crop_size
                               * cfg.model.upscale_factor,
                               use_spectral_norm=sn)
        spec = TR.make_optimizer(cfg)
        state = TR.create_train_state(
            cfg, model, crit, spec, gen,
            discr_optimizer=spec if crit.has_discriminator else None)
        return state, crit

    def batches(dd, samples, t, seed):
        rng = np.random.RandomState(seed)
        while True:
            yield from dd.batches(samples, t.batch_size, t.crop_size, rng=rng)

    with phase("29 training at full width on kernel-made clips"):
        torus = analytic.torus_volume(256, device="cuda")
        base = RenderConfig(renderer="sweep_pallas", step_voxels=0.5)
        seqs, sec = counted(lambda: generate_sequences(
            [(grid, (0.5, 0.5)), (torus, (0.5, 0.5))], 4, SequenceConfig(),
            base_render_cfg=base, seed=29), "4 training clips", counters,
            {"sweep_march": 40, "sweep_march_ao": 40}, add)
        del torus
        cfg = Config(model=model_cfg, loss=LossConfig(), train=TrainConfig())
        t = cfg.train
        dd = DeviceVideoDataset(seqs, upscale_factor=4, device="cuda")
        dataset = VideoDataset(seqs)
        samples = dataset.collect_samples(t.samples, t.crop_size,
                                          t.min_fill_rate,
                                          np.random.RandomState(t.seed))
        train_set = DatasetFromSamples(dataset, samples, t.crop_size, False,
                                       t.test_fraction)
        test_set = DatasetFromSamples(dataset, samples, t.crop_size, True,
                                      t.test_fraction)
        log(f"[training data] 4 clips in {sec:.2f} s; "
            f"{dd.nbytes() / 2 ** 30:.3f} GiB on the card; "
            f"{len(train_set)} train and {len(test_set)} test crops of "
            f"{t.crop_size} (-> {t.crop_size * 4})")
        state, crit = fresh(cfg, "cuda", t.seed)
        m = cfg.model
        n_par = sum(p.numel() for p in state.model.parameters())
        log(f"EnhanceNet {m.num_residual_blocks} x {m.num_features}, fresh "
            f"(seed {t.seed}), {n_par} parameters; batch {t.batch_size}, "
            f"{t.num_frames} frames, {t.optimizer}, clip {t.grad_clip}, "
            f"losses {cfg.loss.losses}")
        step = TR.make_train_step(cfg, state.model, crit)
        it = batches(dd, train_set.samples, t, 0)
        losses = train_steps(step, state, it, 20, "train step", counters, add)
        if state.step != 20:
            raise RuntimeError(f"{state.step} steps taken of 20")
        low, flow, high = next(dd.batches(test_set.samples, t.batch_size,
                                          t.crop_size, shuffle=False))
        test_loss, psnr = TR.make_eval_step(cfg, state.model, crit)(
            low, flow, high)
        log(f"[train step] eval on a test batch: loss a frame "
            f"{float(test_loss):.5g}, PSNR {float(psnr):.3f} dB (first train "
            f"loss {losses[0]:.5g}, last {losses[-1]:.5g})")
        if not math.isfinite(float(psnr)):
            raise RuntimeError("eval PSNR not finite")
        del state, crit, step, it

    with phase("30 adversarial and perceptual steps at full width"):
        for tag, loss_kw, sn, rounds in (
                ("adv bce + perceptual",
                 dict(losses=LossConfig().losses
                      + ",adv:all:0.3,perceptual:color:0.1"), False, 5),
                ("adv wgan-gp + SN",
                 dict(losses=LossConfig().losses + ",adv:all:0.3",
                      gan_type="wgan-gp"), True, 1)):
            acfg = cfg.replace(loss=LossConfig(**loss_kw))
            state, crit = fresh(acfg, "cuda", t.seed, sn)
            d_step, g_step = TR.make_adv_train_steps(acfg, state.model, crit)
            before = [{k: v.clone() for k, v in mod.state_dict().items()}
                      for mod in (state.model, crit.discriminators)]
            it = batches(dd, train_set.samples, t, 1)
            rng = np.random.RandomState(30)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for holder, attr in counters.values():
                setattr(holder, attr, 0)
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(rounds + 1)]
            vals = []
            ev[0].record()
            for r in range(rounds):
                low, flow, high = next(it)
                _, dl, gs, ps = d_step(state, low, flow, high,
                                       jax_prng.prng_key(rng.randint(1 << 31)))
                _, gl = g_step(state, low, flow, high)
                ev[r + 1].record()
                vals.append((dl, gs, ps, gl))
            torch.cuda.synchronize()
            launches = {k: getattr(h, a) for k, (h, a) in counters.items()}
            expect(launches, {}, tag)
            add(launches)
            vals = [[float(v) for v in row] for row in vals]
            ms = (ev[1].elapsed_time(ev[rounds]) / (rounds - 1) if rounds > 1
                  else ev[0].elapsed_time(ev[1]))
            changed = [any(not torch.equal(v, b[k]) for k, v in
                           mod.state_dict().items())
                       for mod, b in zip((state.model, crit.discriminators),
                                         before)]
            ok = all(math.isfinite(v) for row in vals for v in row) and all(
                changed)
            log(f"[{tag}] {ms:.2f} ms a round ("
                + ("rounds 2-5" if rounds > 1 else "one round, first use")
                + f"), peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                f"(discr loss, real, fake, gen loss) "
                + " ".join("(" + ", ".join(f"{v:.4g}" for v in row) + ")"
                           for row in vals)
                + f"; VGG pretrained: {crit.vgg_pretrained}; generator and "
                f"critic changed: {changed}: {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{tag}: non-finite losses or a network "
                                   f"that did not move")
            del state, crit, d_step, g_step, it
        del dd

    with phase("31 card vs CPU, and the entry point"):
        scfg = Config(model=ModelConfig(num_residual_blocks=2,
                                        num_features=16),
                      loss=LossConfig(padding=4),
                      train=TrainConfig(batch_size=2, crop_size=16,
                                        num_frames=3, learning_rate=1e-3))
        rng = np.random.RandomState(31)
        clips = []
        for _ in range(3):
            low = rng.rand(2, 3, 16, 16, 5).astype(np.float32)
            low[..., 0] = np.sign(low[..., 0] - 0.3)
            flow = (rng.rand(2, 3, 16, 16, 2).astype(np.float32) - 0.5) * 0.1
            high = np.repeat(np.repeat(np.concatenate(
                [low, rng.rand(2, 3, 16, 16, 1).astype(np.float32)], -1),
                4, 2), 4, 3)
            clips.append([torch.from_numpy(a) for a in (low, flow, high)])
        def three_steps(dev):
            state, crit = fresh(scfg, dev, 31)
            step = TR.make_train_step(scfg, state.model, crit)
            ls = [float(step(state, *[a.to(dev) for a in c])[1])
                  for c in clips]
            return ls, {k: v.cpu() for k, v in
                        state.model.state_dict().items()}

        card, cpu = three_steps("cuda"), three_steps("cpu")
        rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        worst, worst_share, close = params_close(
            card[1], cpu[1], scfg.train.learning_rate)
        ok = rel <= MAX_TRAIN_LOSS_REL and close
        log(f"[train card vs CPU] 3 Adam steps, 2 x 16 net, crop 16, 3 "
            f"frames: losses {card[0]} vs {cpu[0]} (max rel "
            f"{rel:.3g}, bound {MAX_TRAIN_LOSS_REL}); parameters: largest "
            f"|diff| {worst:.3g} x lr (bound {MAX_TRAIN_FAR}), largest "
            f"share of a leaf beyond {MAX_TRAIN_PARAM} x lr {worst_share:.4f}"
            f" (bound {MAX_TRAIN_FAR_SHARE}): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("training: card and CPU disagree")

        work = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
        try:
            argv = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
                    "--numFrames", "3", "--cropSize", "16", "--samples",
                    "32", "--batchSize", "4", "--numResidualLayers", "2",
                    "--numFeatures", "16", "--aoSamples", "16",
                    "--lossBorderPadding", "4", "--imageEvery", "1",
                    "--runDir", str(work / "runs"), "--device", "cuda",
                    "--cacheDataset", str(work / "clips")]
            t0 = time.time()
            run_a, _ = counted(lambda: main_video_unshaded.main(
                argv + ["--epochs", "2"]), "main_video_unshaded 2 epochs",
                counters, {}, add)
            run_b, _ = counted(lambda: main_video_unshaded.main(
                argv + ["--epochs", "3", "--restore", run_a]),
                "main_video_unshaded --restore", counters, {}, add)
            rows = [json.loads(line) for line in
                    open(Path(run_b) / "scalars.jsonl")]
            ckpts = sorted(os.listdir(Path(run_b) / "checkpoints"))
            x = torch.rand((1, 16, 16, 5), generator=torch.Generator()
                           .manual_seed(31)).cuda() * 2 - 1
            flow0 = torch.zeros((1, 16, 16, 2), device="cuda")
            outs = {}
            for tag, kw in (("params.npz", {}), ("epoch 3", {"epoch": 3})):
                lm = LoadedModel.from_run_dir(run_b, device="cuda", **kw)
                y = lm.inference(x, None, flow0)
                y = lm.inference(x, y, flow0)
                outs[tag] = y
            ok = (ckpts == ["epoch_3.pt"] and {r["step"] for r in rows} == {3}
                  and all(math.isfinite(r["value"]) for r in rows)
                  and all(bool(torch.isfinite(y).all())
                          and tuple(y.shape) == (1, 64, 64, 6)
                          for y in outs.values())
                  and bool(torch.equal(outs["params.npz"], outs["epoch 3"])))
            log(f"[main_video_unshaded] 2 epochs then --restore for a third "
                f"in {time.time() - t0:.1f} s; run dir {Path(run_b).name}: "
                f"checkpoints {ckpts}, epoch 3 scalars "
                + ", ".join(f"{r['tag']} {r['value']:.4g}" for r in rows)
                + f"; LoadedModel from params.npz and from epoch 3: finite "
                f"(1, 64, 64, 6) frames, equal: "
                f"{bool(torch.equal(outs['params.npz'], outs['epoch 3']))}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError("the training entry point's run dir is "
                                   "wrong")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return seqs


def shaded_training(model_cfg, seqs, counters: dict, add) -> None:
    """Phase 32: the shaded trainer at full width on phase 29's clips,
    perceptual, texture and tgan steps, card vs CPU and the entry point."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.apps import main_video_shaded
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, TrainConfig)
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset)
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as TS
    from isosurfacesuperresolution_tpu_torch.train.device_data import (
        DeviceVideoDataset)

    shaded = dict(input_channels=8, output_channels=3,
                  channel_mask=(0, 1, 2))
    shading = TS.TRAINING_SHADING

    def fresh(cfg, device, seed):
        gen = torch.Generator().manual_seed(seed)
        model = create_network(cfg.model, generator=gen).to(device)
        crit = LossNet(cfg.loss, cfg.train.crop_size
                       * cfg.model.upscale_factor, 8, 3,
                       losses=cfg.loss.losses)
        state = TS.create_shaded_train_state(cfg, model, crit,
                                             TR.make_optimizer(cfg), gen)
        return state, TS.make_shaded_train_step(cfg, model, crit)

    with phase("32 shaded training at full width on kernel-made clips"):
        cfg = Config(model=dataclasses.replace(model_cfg, **shaded),
                     loss=LossConfig(losses="l1:1,temp-l2:0.1"),
                     train=TrainConfig())
        t = cfg.train
        dd = DeviceVideoDataset(seqs, upscale_factor=4, device="cuda")
        dataset = VideoDataset(seqs)
        samples = dataset.collect_samples(t.samples, t.crop_size,
                                          t.min_fill_rate,
                                          np.random.RandomState(t.seed))
        train_set = DatasetFromSamples(dataset, samples, t.crop_size, False,
                                       t.test_fraction)

        def batches(seed):
            """Shaded batches: the clips' crops shaded on the card."""
            rng = np.random.RandomState(seed)
            while True:
                for low, flow, high in dd.batches(
                        train_set.samples, t.batch_size, t.crop_size,
                        rng=rng):
                    lo, hi = TS.shade_clip(low, high, shading)
                    yield lo, flow, hi

        state, step = fresh(cfg, "cuda", t.seed)
        n_par = sum(p.numel() for p in state.model.parameters())
        log(f"shaded EnhanceNet {cfg.model.num_residual_blocks} x "
            f"{cfg.model.num_features}, {state.model.in_channels} -> 3 "
            f"channels, fresh (seed {t.seed}), {n_par} parameters; batch "
            f"{t.batch_size}, {t.num_frames} frames, crop {t.crop_size} -> "
            f"{t.crop_size * 4}, losses {cfg.loss.losses}; "
            f"card: {card_line()}")
        losses = train_steps(step, state, batches(0), 20,
                             "shaded train step", counters, add)
        if state.step != 20:
            raise RuntimeError(f"{state.step} shaded steps taken of 20")
        del state, step

        pcfg = cfg.replace(loss=LossConfig(
            losses="l1:1,temp-l2:0.1,perceptual:0.1,texture:1,tgan:0.1"))
        state, step = fresh(pcfg, "cuda", t.seed)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        losses = train_steps(step, state, batches(1), 3,
                             "shaded + perceptual, texture, tgan", counters,
                             add)
        moved = any(not torch.equal(v, before[k])
                    for k, v in state.model.state_dict().items())
        log(f"[shaded + perceptual, texture, tgan] the generator moved: "
            f"{moved}; losses {losses}")
        if not moved:
            raise RuntimeError("shaded perceptual steps left the generator "
                               "as it was")
        del state, step, dd

        small = Config(model=ModelConfig(num_residual_blocks=2,
                                         num_features=16, **shaded),
                       loss=LossConfig(losses="l1:1,temp-l2:0.1", padding=4),
                       train=TrainConfig(batch_size=2, crop_size=16,
                                         num_frames=3, learning_rate=1e-3))
        rng = np.random.RandomState(32)
        clips = []
        for _ in range(3):
            low = rng.rand(2, 3, 16, 16, 8).astype(np.float32)
            low[..., 3] = low[..., 3] > 0.3
            flow = (rng.rand(2, 3, 16, 16, 2).astype(np.float32) - 0.5) * 0.1
            high = np.repeat(np.repeat(low[..., :3], 4, 2), 4, 3)
            clips.append([torch.from_numpy(np.ascontiguousarray(a))
                          for a in (low, flow, high)])

        def three_steps(dev):
            state, step = fresh(small, dev, 32)
            ls = [float(step(state, *[a.to(dev) for a in c])[1])
                  for c in clips]
            return ls, state.model.state_dict()

        card, cpu = three_steps("cuda"), three_steps("cpu")
        rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        worst, share, close = params_close(card[1], cpu[1],
                                           small.train.learning_rate)
        ok = rel <= MAX_TRAIN_LOSS_REL and close
        log(f"[shaded train card vs CPU] 3 Adam steps, 2 x 16 net, crop 16,"
            f" 3 frames: losses {card[0]} vs {cpu[0]} (max rel {rel:.3g}, "
            f"bound {MAX_TRAIN_LOSS_REL}); parameters: largest |diff| "
            f"{worst:.3g} x lr (bound {MAX_TRAIN_FAR}), largest share of a "
            f"leaf beyond {MAX_TRAIN_PARAM} x lr {share:.4f} (bound "
            f"{MAX_TRAIN_FAR_SHARE}): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("shaded training: card and CPU disagree")

        work = Path(tempfile.mkdtemp(prefix="shaded_", dir=ROOT / "build"))
        try:
            argv = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
                    "--numFrames", "3", "--cropSize", "16", "--samples",
                    "32", "--batchSize", "4", "--numResidualLayers", "2",
                    "--numFeatures", "16", "--aoSamples", "16",
                    "--lossBorderPadding", "4", "--epochs", "2",
                    "--runDir", str(work / "runs"), "--device", "cuda"]
            run, sec = counted(lambda: main_video_shaded.main(argv),
                               "main_video_shaded 2 epochs", counters, {},
                               add)
            rows = [json.loads(line) for line in
                    open(Path(run) / "scalars.jsonl")]
            ckpts = sorted(os.listdir(Path(run) / "checkpoints"))
            lm = LoadedModel.from_run_dir(run, device="cuda")
            x = torch.rand((1, 16, 16, 8), generator=torch.Generator()
                           .manual_seed(32)).cuda()
            y = lm.inference(x, None, torch.zeros((1, 16, 16, 2),
                                                  device="cuda"))
            ok = (ckpts == ["epoch_1.pt", "epoch_2.pt"]
                  and [r["step"] for r in rows] == [1, 2]
                  and all(math.isfinite(r["value"]) for r in rows)
                  and tuple(y.shape) == (1, 64, 64, 3)
                  and bool(torch.isfinite(y).all()))
            log(f"[main_video_shaded] 2 epochs in {sec:.1f} s; run dir "
                f"{Path(run).name}: checkpoints {ckpts}, train/total_loss "
                + ", ".join(f"{r['value']:.4g}" for r in rows)
                + f"; LoadedModel from it: a finite {tuple(y.shape)} frame: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError("the shaded entry point's run dir is "
                                   "wrong")
        finally:
            shutil.rmtree(work, ignore_errors=True)


def parallel_layer(grid, counters: dict, add, frame_cfg) -> None:
    """Phase 33: the parallel layer in a one-process nccl group."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from isosurfacesuperresolution_tpu_torch.config import (
        Config, LossConfig, ModelConfig, TrainConfig)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet import LossNet
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_train_step, render_cameras_sharded)
    from isosurfacesuperresolution_tpu_torch.parallel.sharded_sweep import (
        render_gbuffer_sweep_sharded)
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.sweep import (
        render_gbuffer_sweep)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    from isosurfacesuperresolution_tpu_torch.train import trainer_shaded as TS
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    with phase("33 the parallel layer on one card (one-process nccl "
               "group)"):
        rdv = Path(tempfile.mkdtemp(prefix="nccl_", dir=ROOT / "build"))
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", 0))
        try:
            if dist.get_backend() != "nccl":
                raise RuntimeError(f"backend {dist.get_backend()}, not nccl")
            mesh = make_mesh(1)
            cfg = Config(model=ModelConfig(num_residual_blocks=2,
                                           num_features=16, input_channels=8,
                                           output_channels=3,
                                           channel_mask=(0, 1, 2)),
                         loss=LossConfig(losses="l1:1,temp-l2:0.1",
                                         padding=4),
                         train=TrainConfig(batch_size=2, crop_size=16,
                                           num_frames=3, learning_rate=1e-3))
            rng = np.random.RandomState(33)
            low = rng.rand(2, 3, 16, 16, 8).astype(np.float32)
            low[..., 3] = low[..., 3] > 0.3
            flow = (rng.rand(2, 3, 16, 16, 2).astype(np.float32) - 0.5) * 0.1
            high = np.repeat(np.repeat(low[..., :3], 4, 2), 4, 3)
            batch = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                     for a in (low, flow, high)]
            runs = []
            for sharded in (False, True):
                gen = torch.Generator().manual_seed(33)
                model = create_network(cfg.model, generator=gen).cuda()
                crit = LossNet(cfg.loss, 64, 8, 3, losses=cfg.loss.losses)
                state = TS.create_shaded_train_state(
                    cfg, model, crit, TR.make_optimizer(cfg), gen)
                step = TS.make_shaded_train_step(cfg, model, crit)
                if sharded:
                    step = make_sharded_train_step(step, mesh)
                ls = [float(step(state, *batch)[1]) for _ in range(2)]
                runs.append((ls, model.state_dict()))
            rel = max(abs(a - b) / abs(b) for a, b in zip(runs[1][0],
                                                          runs[0][0]))
            worst, share, close = params_close(runs[1][1], runs[0][1], 1e-3)
            ok = rel <= MAX_TRAIN_LOSS_REL and close
            log(f"[sharded step, world 1] 2 shaded steps: losses "
                f"{runs[1][0]} vs the plain step's {runs[0][0]} (max rel "
                f"{rel:.3g}); parameters: largest |diff| {worst:.3g} x lr, "
                f"share beyond {MAX_TRAIN_PARAM} x lr {share:.4f}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError("the world-1 sharded step differs from "
                                   "the plain step")

            cams = [cam_at(2 * math.pi * i / 8) for i in range(8)]
            eyes = torch.stack([c.eye for c in cams])
            looks = torch.stack([c.look_at_pt for c in cams])
            ups = torch.stack([c.up for c in cams])
            render_cameras_sharded(grid, eyes, looks, ups, frame_cfg, mesh)
            frames, sec = counted(lambda: render_cameras_sharded(
                grid, eyes, looks, ups, frame_cfg, mesh),
                "render_cameras_sharded 8 cameras", counters,
                {"sweep_march": 8}, add)
            single = [render_frame_gbuffer(grid, c, c, frame_cfg)
                      for c in cams]
            equal = all(bool(torch.equal(frames[i], single[i]))
                        for i in range(8))
            log(f"[render_cameras_sharded] 8 orbit cameras at 480x270: "
                f"{tuple(frames.shape)} in {sec * 1e3:.1f} ms; bit for bit "
                f"the 8 single renders: {equal}")
            if not equal or tuple(frames.shape) != (8, 270, 480, 12):
                raise RuntimeError("render_cameras_sharded differs from "
                                   "single renders")
            del frames, single

            torus = analytic.torus_volume(256, device="cuda")
            torus_ao = attach_baked_ao(torus, 0.5, 0.1)
            cam = CameraParams.create((0.3, 0.8, -1.7))
            zmesh = make_mesh(1, axis_name="z")
            scan_cfg = frame_cfg.replace(renderer="sweep")
            for tag, g, rcfg in (
                    ("no AO", torus, scan_cfg),
                    ("baked AO", torus_ao,
                     scan_cfg.replace(ao_samples=64, ao_mode="volume"))):
                # the slab sweep reads its grid from the host
                host_g = dataclasses.replace(g, **{
                    f: getattr(g, f).cpu() for f in (
                        "values", "brick_min", "brick_max", "ao_sh")
                    if getattr(g, f) is not None})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                got, sec = counted(lambda: render_gbuffer_sweep_sharded(
                    host_g, cam, cam, rcfg, zmesh),
                    f"sharded sweep D=1 {tag}", counters, {}, add)
                peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
                if got.device.type != "cuda":
                    raise RuntimeError("the slab sweep's frame is not on "
                                       "the card")
                del host_g
                ref, ref_sec = counted(lambda: render_gbuffer_sweep(
                    g, cam, cam, rcfg), f"single scan {tag}", counters, {},
                    add)
                b1_cfg = rcfg.replace(renderer="sweep_pallas")
                b1_ms = time_cuda(lambda: render_gbuffer_sweep(
                    g, cam, cam, b1_cfg), 5)
                got, ref = got.cpu().numpy(), ref.cpu().numpy()
                mism = float(np.mean(got[..., 3] != ref[..., 3]))
                both = (got[..., 3] > 0.5) & (ref[..., 3] > 0.5)
                diffs = {ch: float(np.abs(got[..., ch] - ref[..., ch])[
                    both].max()) for ch in (4, 5, 6, 7, 10)}
                ok = (mism < 0.01 and both.sum() > 1000 and diffs[7] < 1e-3
                      and max(diffs[c] for c in (4, 5, 6)) < 5e-3
                      and np.isfinite(got).all())
                if rcfg.ao_samples:
                    ok = ok and float(np.quantile(np.abs(
                        got[..., 10] - ref[..., 10])[both], 0.95)) < 0.02
                log(f"[sharded sweep D=1 {tag}] 256^3 torus, 480x270, "
                    f"grid on the host: {sec * 1e3:.1f} ms/frame, peak "
                    f"device memory {peak_mb:.1f} MiB (the single scan "
                    f"{ref_sec * 1e3:.1f}, B1's G-buffer frame "
                    f"{b1_ms:.2f}); mask mismatch {mism:.4f} (< 0.01) over "
                    f"{int(both.sum())} hits, max |diff| depth "
                    f"{diffs[7]:.3g} (< 1e-3), normals "
                    f"{max(diffs[c] for c in (4, 5, 6)):.3g} (< 5e-3), AO "
                    f"{diffs[10]:.3g}; bit for bit the scan: "
                    f"{bool(np.array_equal(got, ref))}: "
                    f"{'ok' if ok else 'FAILED'}")
                if not ok:
                    raise RuntimeError(f"sharded sweep {tag} disagrees with "
                                       f"the single-device scan")
            del torus, torus_ao
        finally:
            dist.destroy_process_group()
            shutil.rmtree(rdv, ignore_errors=True)


def orbax_runs(grid, counters: dict, add, frame_cfg) -> None:
    """Phase 34: the orbax run dirs through `LoadedModel` on the card."""
    import torch
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        InferencePipeline)

    with phase("34 orbax run dirs through LoadedModel"):
        for name, step in (("run00020", 23), ("run00022", 70)):
            path = ROOT / "artifacts" / name / name
            t = time.time()
            lm = LoadedModel.from_run_dir(str(path), device="cuda")
            torch.cuda.synchronize()
            sec = time.time() - t
            t = time.time()
            host = LoadedModel.from_run_dir(str(path), device="cpu")
            host_sec = time.time() - t
            want = host.model.state_dict()
            equal = all(bool(torch.equal(v.cpu(), want[k]))
                        for k, v in lm.model.state_dict().items())
            pipe = InferencePipeline(lm.model, lm.cfg, frame_cfg,
                                     device="cuda")
            rgb, launches = drive(lambda i: pipe.frame(grid,
                                                       cam_at(0.03 * i)),
                                  3, f"orbax {name} step {step}", counters)
            check_rgb(rgb, pipe.state.prev_high[..., 0:16] > 0.0,
                      (1080, 1920, 3))
            expect(launches, {"sweep_march": 3}, f"orbax {name}")
            add(launches)
            log(f"[orbax {name}] step {step} read and loaded on the card in "
                f"{sec:.3f} s (on the CPU {host_sec:.3f} s); parameters bit "
                f"for bit the CPU read: {equal}; 3 main-path frames, "
                f"finite")
            if not equal:
                raise RuntimeError(f"{name}: the card's parameters differ "
                                   f"from the CPU read")
            del pipe, lm, host


# --------------------------------------------------------------------------
# phases 35-38: volume and image I/O, the renderer's front ends
# --------------------------------------------------------------------------

# the stats harness card vs CPU (phase 38): the same clips to the march's
# rounding (phase 27: 1e-6 where both hit, masks equal on small clips) and
# run00017 through float32 convolutions in other sum orders (cuDNN against
# oneDNN, 1e-4 a pass): the bounds tests/test_torch_port_frontends.py
# holds the port's harness to against JAX's
MAX_STATS_PSNR_DB = 0.05
MAX_STATS_SSIM = 1e-3
MAX_STATS_L2_REL = 1e-3


def _orbit_eye(ang: float) -> tuple:
    """`cam_at`'s eye as Python floats (sent as text, read back exactly)."""
    return (1.7 * math.sin(ang), 0.9, -1.7 * math.cos(ang))


def _quantized(rgb):
    import numpy as np
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def volume_io(vol_u8, grid, work: Path, counters: dict, add, cfg512,
              frame_cfg) -> dict:
    """Phase 35: the importers, `.vdb`, EXR and `.cvol` at real size.
    Writes ``work/blobs512.dat`` (+ .raw) for phases 37-38."""
    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.apps.render_cli import (
        write_exrs)
    from isosurfacesuperresolution_tpu_torch.data.exr import read_exr
    from isosurfacesuperresolution_tpu_torch.native import build as nbuild
    from isosurfacesuperresolution_tpu_torch.native import vdbio, volumeio
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.volume import importers
    from isosurfacesuperresolution_tpu_torch.volume.grid import BrickGrid
    from isosurfacesuperresolution_tpu_torch.volume.vdb import load_vdb
    from isosurfacesuperresolution_tpu_torch.volume.vdb_write import (
        write_vdb)

    times = {}
    with phase("35 volume I/O at real size"):
        # the native readers: a failed build fails the run
        t = time.time()
        built = nbuild.build()
        for name, sec in built.items():
            log(f"built native {name} ({' '.join(nbuild.SOURCES[name][1])}) "
                f"in {sec:.1f} s")
        log(f"native build {time.time() - t:.1f} s")
        X, Y, Z = vol_u8.shape
        raw = work / "blobs512.raw"
        vol_u8.transpose(2, 1, 0).tofile(raw)      # slice-major on disk
        dat = work / "blobs512.dat"
        dat.write_text("ObjectFileName: blobs512.raw\n"
                       f"Resolution: {X} {Y} {Z}\nFormat: UCHAR\n")
        for ds in (1, 2):
            t = time.time()
            nat = volumeio.load_raw(str(raw), (X, Y, Z), "UCHAR", ds, 0.001)
            t_nat = time.time() - t
            t = time.time()
            ref = importers.box_downsample(importers._load_raw_numpy(
                str(raw), (X, Y, Z), "UCHAR"), ds)
            ref[ref < 0.001] = 0.0
            t_np = time.time() - t
            err = float(np.abs(nat - ref).max())
            times[f"decode native ds{ds}"] = t_nat
            times[f"decode numpy ds{ds}"] = t_np
            log(f"[raw decode 512^3 UCHAR, downsampling {ds}] native "
                f"{t_nat:.3f} s, numpy {t_np:.3f} s, shape {nat.shape}, "
                f"max |native - numpy| {err:.2e} (bound 1e-6)")
            if nat.shape != (X // ds, Y // ds, Z // ds) or err > 1e-6:
                raise RuntimeError("the native and numpy raw decodes "
                                   "disagree")
            del nat, ref
        for native in (True, False):
            t = time.time()
            g = importers.import_raw(str(dat), use_native=native,
                                     device="cuda")
            torch.cuda.synchronize()
            sec = time.time() - t
            times[f"import {'native' if native else 'numpy'}"] = sec
            log(f"[import_raw 512^3 float32 onto the card, "
                f"{'native' if native else 'numpy'} decode] {sec:.2f} s "
                f"(decode, float32 grid, brick pyramid, copy)")
            del g

        # .vdb: a 256^3 float32 volume written (zip) and read natively
        v256 = vol_u8[::2, ::2, ::2].astype(np.float32) / 255.0
        vdb = work / "blobs256.vdb"
        t = time.time()
        write_vdb(str(vdb), v256, compression="zip")
        times["vdb write"] = time.time() - t
        t = time.time()
        dense, vox = vdbio.load(str(vdb))
        times["vdb read"] = time.time() - t
        t = time.time()
        gv, name = load_vdb(str(vdb), device="cuda")
        torch.cuda.synchronize()
        times["load_vdb"] = time.time() - t
        nz = np.nonzero(v256)
        crop = v256[nz[0].min():nz[0].max() + 1, nz[1].min():nz[1].max() + 1,
                    nz[2].min():nz[2].max() + 1]
        same = (np.array_equal(dense, crop)
                and np.array_equal(gv.values.cpu().numpy(), crop))
        log(f"[.vdb 256^3 float32, zip] write {times['vdb write']:.2f} s "
            f"({vdb.stat().st_size / 2**20:.1f} MiB), native read "
            f"{times['vdb read']:.2f} s, load_vdb onto the card "
            f"{times['load_vdb']:.2f} s; grid {name!r} {dense.shape} over "
            f"the active box, bit for bit the array: {same}")
        if not same:
            raise RuntimeError(".vdb round trip differs from the array")
        del v256, dense, gv, crop

        # EXR: one 1920x1080 G-buffer as render_cli --saveExr writes it
        cfg_hd = frame_cfg.replace(width=1920, height=1080)
        fr, _ = counted(lambda: render_frame_gbuffer(
            grid, cam_at(0.0), cam_at(0.03), cfg_hd).cpu().numpy(),
            "exr G-buffer 1920x1080", counters, {"sweep_march": 1}, add)
        base = str(work / "frame")
        t = time.time()
        write_exrs(base, fr)
        times["exr write"] = time.time() - t
        t = time.time()
        back = {s: read_exr(base + s + ".exr")
                for s in ("", "_depth", "_fx", "_flow")}
        times["exr read"] = time.time() - t
        ok = all(np.array_equal(back[s][k], fr[..., c])
                 for s, chans in (("", (0, 1, 2, 3)), ("_depth", (4, 5, 6, 7)),
                                  ("_fx", (10, 11)), ("_flow", (8, 9)))
                 for c, k in zip(chans, "RGBA"))
        size = sum(os.path.getsize(base + s + ".exr") for s in back)
        log(f"[EXR 1920x1080 x 12 channels, 4 files, ZIP float] write "
            f"{times['exr write']:.2f} s ({size / 2**20:.1f} MiB), read "
            f"{times['exr read']:.2f} s; every channel read back exactly: "
            f"{ok}")
        if not ok:
            raise RuntimeError("EXR round trip differs")
        del fr, back

        # .cvol round trip onto the card (the 256^3 import)
        g2 = importers.import_raw(str(dat), downsampling=2, device="cuda")
        cvol = work / "blobs256.cvol.npz"
        t = time.time()
        importers.save_cvol(str(cvol), g2)
        times["cvol save"] = time.time() - t
        t = time.time()
        g3 = importers.load_cvol(str(cvol), device="cuda")
        torch.cuda.synchronize()
        times["cvol load"] = time.time() - t
        same = all(torch.equal(getattr(g2, k), getattr(g3, k))
                   for k in ("values", "brick_min", "brick_max", "bbox_min",
                             "bbox_max")) and g3.device.type == "cuda"
        log(f"[.cvol 256^3 float32] save {times['cvol save']:.2f} s, load "
            f"onto the card {times['cvol load']:.2f} s, equal: {same}")
        if not same:
            raise RuntimeError(".cvol round trip differs")
        del g2, g3

        # the imported 512^3 grid renders on B2 like the grid built
        # directly from the same bytes
        gi = importers.import_raw(str(dat), store_dtype="uint8",
                                  device="cuda")
        gd = BrickGrid.from_dense(vol_u8, store_dtype="uint8", device="cuda")
        same_grid = (torch.equal(gi.values, gd.values)
                     and gi.value_scale == gd.value_scale
                     and gi.value_offset == gd.value_offset
                     and torch.equal(gi.brick_max, gd.brick_max))
        frames = {}
        for tag, g in (("imported", gi), ("direct", gd)):
            frames[tag], _ = counted(
                lambda: render_frame_gbuffer(g, cam_at(0.0), cam_at(0.0),
                                             cfg512),
                f"B2 on the {tag} 512^3 grid", counters,
                {"sweep_march_tiled": 1}, add)
        equal = torch.equal(frames["imported"], frames["direct"])
        log(f"[import vs direct 512^3 uint8] grids equal: {same_grid}; B2 "
            f"480x270 frames bit for bit: {equal}; mask share "
            f"{float((frames['direct'][..., 3] > 0.5).float().mean()):.4f}")
        if not (same_grid and equal):
            raise RuntimeError("the imported grid renders differently")
        del gi, gd, frames
    return {"dat": dat, "times": times}


def pipe_server(counters: dict, add) -> dict:
    """Phase 36: the port's render_server on the card through
    `PipeRenderer`."""
    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.infer.pipe_client import (
        PipeRenderer)
    from isosurfacesuperresolution_tpu_torch.render.api import (
        render_frame_gbuffer)
    from isosurfacesuperresolution_tpu_torch.render.camera import (
        CameraParams)
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    times = {}
    with phase("36 the pipe server on the card"):
        W, H = 480, 270
        n_frames = 20
        t = time.time()
        r = PipeRenderer.local_server("analytic:blobs:256", W, H,
                                      renderer="sweep_pallas", cwd=str(ROOT))
        frames, ms, server_s, eyes = [], [], [], []
        try:
            for i in range(n_frames):
                eye = _orbit_eye(0.03 * i)
                eyes.append(eye)
                r.send_command("cameraOrigin", ",".join(map(repr, eye)))
                t1 = time.perf_counter()
                frames.append(r.render())
                ms.append((time.perf_counter() - t1) * 1e3)
                server_s.append(r.last_time)
                if i == 0:
                    times["server first frame"] = time.time() - t
            r.proc.stdin.write(b"exit\n")
            r.proc.stdin.flush()
            rc = r.proc.wait(timeout=120)
            tail = r.proc.stderr.read()
        finally:
            r.close()
        times["pipe ms"] = statistics.median(ms[2:])
        times["server ms"] = statistics.median(server_s[2:]) * 1e3
        log(f"[pipe server sweep_pallas, analytic:blobs:256, {W}x{H}] start "
            f"and first frame {times['server first frame']:.1f} s; frames "
            f"3-{n_frames}: client {times['pipe ms']:.2f} ms a frame "
            f"(median; min {min(ms[2:]):.2f}, max {max(ms[2:]):.2f}), the "
            f"server's own seconds {times['server ms']:.2f} ms (median); "
            f"exit code {rc}, bytes after exit {len(tail)}; stdout "
            f"{r.output}")
        if rc != 0 or tail != b"" or r.output[:1] != [
                "Enter Pipe mode and wait for commands"] or (
                r.output[-1:] != ["Exit program"]):
            raise RuntimeError("the pipe server's stream or banner is wrong")
        grid = analytic.blobs_volume(256, device="cuda")
        cfg = RenderConfig(width=W, height=H, ao_samples=0,
                           renderer="sweep_pallas")
        cams = [CameraParams.create(e, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                    45.0) for e in eyes[-2:]]
        want, _ = counted(lambda: render_frame_gbuffer(
            grid, cams[1], cams[0], cfg,
            RenderParams.from_config(cfg)).cpu().numpy(),
            "in-process frame", counters, {"sweep_march": 1}, add)
        equal = np.array_equal(frames[-1], want)
        finite = all(np.isfinite(f).all() for f in frames)
        log(f"[pipe server] last frame bit for bit the in-process "
            f"render_frame_gbuffer: {equal}; all {n_frames} frames finite: "
            f"{finite}; mask share {float((want[..., 3] > 0.5).mean()):.4f}")
        if not (equal and finite):
            raise RuntimeError("the pipe frame differs from the in-process "
                               "frame")
        del grid, want, frames
        torch.cuda.empty_cache()

        # the default renderer: the host-steered slice scan
        with PipeRenderer.local_server("analytic:blobs:256", W, H,
                                       cwd=str(ROOT)) as r:
            scan = []
            for i in range(3):
                r.send_command("cameraOrigin",
                               ",".join(map(repr, _orbit_eye(0.03 * i))))
                fr = r.render()
                scan.append(r.last_time)
                if not (np.isfinite(fr).all() and (fr[..., 3] > 0.5).any()):
                    raise RuntimeError("the scan server's frame is empty "
                                       "or not finite")
        times["scan ms"] = statistics.median(scan) * 1e3
        log(f"[pipe server sweep (default)] 3 frames, the server's seconds "
            f"{[round(s * 1e3, 1) for s in scan]} ms")
    return times


def cli_and_converter(dat: Path, work: Path, counters: dict, add) -> dict:
    """Phase 37: render_cli, convert_volume and the trainer's imported
    datasets on the card."""
    import numpy as np
    import torch
    from PIL import Image
    from isosurfacesuperresolution_tpu_torch.apps import (
        convert_volume, main_video_unshaded, render_cli)
    from isosurfacesuperresolution_tpu_torch.data.exr import read_exr
    from isosurfacesuperresolution_tpu_torch.native import vdbio
    from isosurfacesuperresolution_tpu_torch.volume import importers

    times = {}
    name = dat.stem
    with phase("37 render_cli, convert_volume and imported datasets"):
        runs = (("dense", ["--saveExr"],
                 {"sweep_march_tiled", "ao_capture_tiled"}),
                ("sparse", ["--sparse"],
                 {"sweep_march_packed", "ao_capture_packed"}))
        for tag, extra, need in runs:
            out = work / f"cli_{tag}"
            args = ["--volume", str(dat), "--res", "1920,1080", "--ao",
                    "volume", "--animation", "5", "--downscale_factor", "4",
                    "--saveGbuffer", "--renderer", "sweep_pallas",
                    "--isovalue", "0.36", "--output", str(out), *extra]
            _, sec = counted(lambda: render_cli.main(args),
                                  f"render_cli {tag} 512^3 1920x1080 + "
                                  f"480x270, 5 frames", counters, need, add)
            times[f"cli {tag}"] = sec
            worst = 0
            for i in range(5):
                base = out / f"{name}_{i:05d}"
                gb = np.load(f"{base}.npz")["gbuffer"]
                lo = np.load(f"{base}_low.npz")["gbuffer"]
                png = np.asarray(Image.open(f"{base}.png"))
                png_lo = np.asarray(Image.open(f"{base}_low.png"))
                ok = (np.array_equal(png, _quantized(gb[..., :3]
                                                     * gb[..., 10:11]))
                      and np.array_equal(png_lo, _quantized(lo[..., :3])))
                if "--saveExr" in extra:
                    for s, chans in (("", (0, 1, 2, 3)),
                                     ("_depth", (4, 5, 6, 7)),
                                     ("_fx", (10, 11)), ("_flow", (8, 9))):
                        exr = read_exr(f"{base}{s}.exr")
                        ok &= all(np.array_equal(exr[k], gb[..., c])
                                  for c, k in zip(chans, "RGBA"))
                hit = gb[..., 3] > 0.5
                ok &= bool(hit.any()) and bool(np.isfinite(gb).all())
                ok &= bool((gb[..., 10][hit] < 1).any())      # AO present
                worst += not ok
            log(f"[render_cli {tag}] {sec:.2f} s for 5 frames "
                f"({sec / 5:.2f} s a frame, import and bake included); PNGs"
                + (", EXRs" if "--saveExr" in extra else "")
                + f" read back equal to the saved G-buffers: {worst == 0}")
            if worst:
                raise RuntimeError(f"render_cli {tag}: files differ from the "
                                   f"G-buffer")
        out = work / "cli_volume"
        _, sec = counted(lambda: render_cli.main(
            ["--volume", str(dat), "-m", "volume", "--res", "480,270",
             "--isovalue", "0.36", "--saveGbuffer", "--output", str(out)]),
            "render_cli -m volume 512^3 480x270", counters, set(), add)
        times["cli volume"] = sec
        rgba = np.load(out / f"{name}.npz")["rgba"]
        ok = (np.array_equal(np.asarray(Image.open(out / f"{name}.png")),
                             _quantized(rgba))
              and bool(np.isfinite(rgba).all()) and float(rgba[..., 3].max())
              > 0)
        log(f"[render_cli -m volume] {sec:.2f} s a frame; RGBA finite, "
            f"non-empty, PNG equal to it: {ok}")
        if not ok:
            raise RuntimeError("render_cli -m volume: wrong output")

        cvol = work / "blobs256_ao.cvol.npz"
        _, sec = counted(lambda: convert_volume.main(
            [str(dat), str(cvol), "--bakeAO", "--downsample", "2"]),
            "convert_volume .dat -> .cvol --bakeAO --downsample 2",
            counters, set(), add)
        times["convert cvol"] = sec
        g = importers.load_cvol(str(cvol), device="cuda")
        ok = g.ao_sh is not None and tuple(g.ao_sh.shape) == (256, 256, 256,
                                                               4)
        log(f"[convert_volume .dat -> .cvol.npz --bakeAO --downsample 2] "
            f"{sec:.2f} s ({cvol.stat().st_size / 2**20:.1f} MiB); field "
            f"{tuple(g.ao_sh.shape) if g.ao_sh is not None else None}")
        if not ok:
            raise RuntimeError("convert_volume --bakeAO: no field")
        del g
        vdb = work / "blobs512.vdb"
        _, sec = counted(lambda: convert_volume.main([str(dat),
                                                           str(vdb)]),
                              "convert_volume .dat -> .vdb 512^3", counters,
                              set(), add)
        times["convert vdb"] = sec
        bbox, _ = vdbio.probe(str(vdb))
        log(f"[convert_volume .dat -> .vdb] {sec:.2f} s "
            f"({vdb.stat().st_size / 2**20:.1f} MiB), active box {bbox}")

        listing = work / "volumes.txt"
        listing.write_text(f"{dat.name} 0.3 0.45\n")
        for tag, spec in (("descriptor", f"descriptor:{listing}"),
                          ("dat", str(dat))):
            args = main_video_unshaded.build_parser().parse_args(
                ["--dataset", spec, "--numberOfImages", "1", "--numFrames",
                 "2", "--cropSize", "32", "--aoSamples", "0"])
            seqs, sec = counted(lambda: main_video_unshaded.load_sequences(
                args, None, torch.device("cuda")),
                f"load_sequences {tag}", counters, {}, add)
            times[f"load_sequences {tag}"] = sec
            s = seqs[0]
            ok = (len(seqs) == 1 and s["low"].shape == (2, 128, 128, 5)
                  and s["high"].shape == (2, 512, 512, 6)
                  and s["flow"].shape == (2, 128, 128, 2)
                  and all(np.isfinite(s[k]).all() for k in s)
                  and bool((s["low"][..., 0] > 0).any()))
            log(f"[load_sequences {tag}] one clip of 2 frames (512^2 and "
                f"128^2, the scan renderer) in {sec:.2f} s, import "
                f"included; shapes and values right: {ok}")
            if not ok:
                raise RuntimeError(f"load_sequences {tag}: wrong clip")
    return times


def _read_tsv(path: Path) -> tuple:
    lines = path.read_text().splitlines()
    head = lines[0].split("\t")
    return head, {r.split("\t")[0]: [float(x) for x in r.split("\t")[1:]]
                  for r in lines[1:]}


def stats_harness(dat: Path, work: Path, counters: dict, add) -> dict:
    """Phase 38: main_psnr_stats at the reference defaults on the card,
    and card vs CPU on one small clip."""
    from isosurfacesuperresolution_tpu_torch.apps import main_psnr_stats

    times = {}
    run = str(ROOT / "artifacts" / "run00017")
    with phase("38 the stats harness at full width"):
        for spec, vol_name, need in (
                ("analytic:blobs:256", "blobs",
                 {"sweep_march", "sweep_march_ao"}),
                (str(dat), dat.stem,
                 {"sweep_march_tiled", "ao_capture_tiled"})):
            out = work / "stats"
            _, sec = counted(lambda: main_psnr_stats.main(
                ["--volumes", spec, "--models", "bilinear", "bicubic", run,
                 "--output", str(out)]),
                f"main_psnr_stats {vol_name}", counters, need, add)
            times[f"stats {vol_name}"] = sec
            head, rows = _read_tsv(out / f"stats_{vol_name}.tsv")
            ok = (sorted(rows) == ["bicubic", "bilinear", "run00017"]
                  and all(math.isfinite(v) for r in rows.values() for v in r))
            log(f"[main_psnr_stats {vol_name}] {sec:.2f} s a volume (4 clips "
                f"of 10 frames at 256^2 with 64-sample AO, 3 models); "
                f"PSNR color+AO / normal by model: "
                f"{ {m: (round(r[4], 3), round(r[0], 3)) for m, r in rows.items()} }; "
                f"finite: {ok}")
            if not ok:
                raise RuntimeError(f"main_psnr_stats {vol_name}: bad table")
        tables = {}
        for dev in ("cuda", "cpu"):
            out = work / f"stats_{dev}"
            t = time.time()
            main_psnr_stats.main(
                ["--volumes", "analytic:blobs:64", "--models", "bilinear",
                 run, "--numSequences", "1", "--numFrames", "3",
                 "--highRes", "160", "--aoSamples", "16", "--device", dev,
                 "--output", str(out)])
            times[f"stats small {dev}"] = time.time() - t
            tables[dev] = _read_tsv(out / "stats_blobs.tsv")
        head, card = tables["cuda"]
        worst = {}
        for model, row in tables["cpu"][1].items():
            for f, c, h in zip(head[1:], card[model], row):
                d = abs(c - h)
                if f.startswith("PSNR"):
                    bad = d > MAX_STATS_PSNR_DB
                elif f.startswith("SSIM"):
                    bad = d > MAX_STATS_SSIM
                else:
                    bad = d > MAX_STATS_L2_REL * max(abs(h), 1e-3)
                worst[f] = max(worst.get(f, 0.0), d)
                if bad:
                    raise RuntimeError(f"stats card vs CPU: {model} {f} "
                                       f"{c} vs {h}")
        log(f"[main_psnr_stats card vs CPU] analytic:blobs:64, 1 clip of 3 "
            f"frames at 160^2 (40^2 in), bilinear and run00017: card "
            f"{times['stats small cuda']:.1f} s, CPU "
            f"{times['stats small cpu']:.1f} s; max |card - CPU| by field "
            f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (bounds: "
            f"PSNR {MAX_STATS_PSNR_DB} dB, SSIM {MAX_STATS_SSIM}, L2 "
            f"{MAX_STATS_L2_REL} relative)")
    return times


# the viewer card vs CPU (phase 39): check_card_vs_cpu's bounds on the rgb
MAX_VIEWER_FAR_SHARE = 0.01      # share of pixels with |diff| > 0.05
MAX_VIEWER_MEDIAN = 1e-3


def _viewer_frames(viewer, n: int, tag: str, counters: dict, add,
                   want) -> tuple:
    """``n`` orbit frames of ``viewer`` (20 px of drag a frame) as one path
    run: (last frame, host ms a frame over frames 3-n).  Each frame ends
    with its copy to the host, as the viewer's display takes it."""
    import numpy as np
    times = []

    def run():
        out = None
        for i in range(n):
            t = time.time()
            viewer.camera.start_move()
            viewer.camera.move(20, 0)
            out = viewer.render_frame()
            times.append(time.time() - t)
        return out

    rgb, _ = counted(run, tag, counters, want, add)
    ms = 1e3 * sum(times[2:]) / max(n - 2, 1)
    ok = (rgb.shape == (1080, 1920, 3) and bool(np.isfinite(rgb).all())
          and float(rgb.max()) > 0.0)
    log(f"[{tag}] {ms:.2f} ms a frame over frames 3-{n} (host clock, the "
        f"copy to the host included; first frame {1e3 * times[0]:.1f} ms), "
        f"rgb {rgb.shape} finite and not black: {ok}")
    if not ok:
        raise RuntimeError(f"[{tag}] bad frame")
    return rgb, ms


def viewer_and_apps(grid, lm, work: Path, counters: dict, add) -> dict:
    """Phases 39-44: the viewer and the evaluation apps at full width."""
    import numpy as np
    import torch
    from PIL import Image

    from isosurfacesuperresolution_tpu_torch.apps import (
        adv_evidence, discr_test, image_vis, main_comparison,
        main_comparison_video, main_psnr_allangles, train_texenc,
        vgg_analysis)
    from isosurfacesuperresolution_tpu_torch.apps.main_gui import Viewer
    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.data.generation import (
        SequenceConfig, generate_sequences)
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    times = {}
    run = str(ROOT / "artifacts" / "run00017")
    with phase("39 the viewer headless: run00017, gt, bicubic, focus of "
               "context, smoothing"):
        m = lm.cfg.model
        phase_lm = LoadedModel(lm.model, lm.cfg.replace(model=(
            dataclasses.replace(m, compute_dtype="bfloat16",
                                planar_phase_tail=True))))
        viewer = Viewer(grid, {"run00017": lm, "run00017 phase": phase_lm},
                        res_x=480, res_y=270, isovalue=0.5,
                        renderer="sweep_pallas")
        steps = (("run00017", {}, {"sweep_march": 20}),
                 ("run00017 phase", {},
                  {"sweep_march": 20, "phase_conv": 20}),
                 ("gt", {}, {"sweep_march": 20}),
                 ("bicubic", {}, {"sweep_march": 20}),
                 ("run00017", {"foc_enabled": True,
                               "foc_center": (960, 540)},
                  {"sweep_march": 40}),
                 ("run00017", {"temporal_smoothing": 0.5},
                  {"sweep_march": 20}))
        for mode, knobs, want in steps:
            viewer.set_mode(mode)
            viewer.foc_enabled, viewer.temporal_smoothing = False, 0.0
            for k, v in knobs.items():
                setattr(viewer, k, v)
            tag = "viewer " + mode + "".join(f" {k}" for k in knobs)
            _, ms = _viewer_frames(viewer, 20, tag, counters, add, want)
            times[tag + " ms"] = ms
        viewer.set_mode("run00017")
        viewer.channel = "normal"
        _viewer_frames(viewer, 3, "viewer run00017 normal channel",
                       counters, add, {"sweep_march": 3})
        del viewer
        outs = {}
        for dev in ("cuda", "cpu"):
            g = analytic.blobs_volume(64, num_blobs=8, device=dev)
            lm.model.to(dev)
            v = Viewer(g, {"run00017": lm}, res_x=64, res_y=48,
                       isovalue=0.5, renderer="sweep_pallas")
            v.camera.zoom(-3)
            frames = []
            for mode in ("run00017", "run00017", "run00017", "bilinear",
                         "gt"):
                v.mode = mode
                v.camera.start_move()
                v.camera.move(10, 3)
                frames.append(torch.from_numpy(v.render_frame()))
            outs[dev] = frames
        lm.model.to("cuda")
        for i, mode in enumerate(("run00017 frame 1", "run00017 frame 2",
                                  "run00017 frame 3", "bilinear", "gt")):
            d = (outs["cuda"][i] - outs["cpu"][i]).abs()
            far = float((d > 0.05).float().mean())
            med = float(d.median())
            lit = float((outs["cpu"][i] > 0).any(-1).float().mean())
            log(f"[viewer card vs CPU {mode}] 64x48 -> 256x192: rgb median "
                f"|diff| {med:.2e}, share > 0.05: {far:.4f} (bounds "
                f"{MAX_VIEWER_MEDIAN}, {MAX_VIEWER_FAR_SHARE}); max "
                f"{float(d.max()):.2e}, mean {float(d.mean()):.2e}, lit "
                f"pixels {lit:.3f}")
            if far > MAX_VIEWER_FAR_SHARE or med > MAX_VIEWER_MEDIAN:
                raise RuntimeError(f"viewer card and CPU disagree ({mode})")

    with phase("40 main_comparison at its defaults (1920x1080, x4)"):
        out = work / "cmp"
        rows, sec = counted(lambda: main_comparison.main(
            ["--models", "bilinear", run, "--renderer", "sweep_pallas",
             "--saveImages", "--output", str(out)]),
            "main_comparison", counters, {"sweep_march"}, add)
        csv = (out / "timings.csv").read_text()
        log(f"[main_comparison] {sec:.1f} s; timings.csv:\n{csv.strip()}")
        for name, rt, nt, tt in rows:
            times[f"comparison {name} total ms"] = 1e3 * tt
            times[f"comparison {name} rendering ms"] = 1e3 * rt
        pngs = sorted(p.name for p in out.glob("*.png"))
        if (len(rows) != 2 or pngs != ["blobs_bilinear.png",
                                       "blobs_run00017.png"]
                or not all(math.isfinite(tt) and tt > 0
                           for _, _, _, tt in rows)):
            raise RuntimeError(f"main_comparison: rows {rows}, {pngs}")

    with phase("41 main_comparison_video: 8 frames, a script and a preset"):
        out = work / "video"
        for tag, argv in (
                ("script", ["--models", "bilinear", run, "--frames", "8"]),
                ("preset v1", ["--preset", "v1", "--models", "bilinear",
                               run, "--frames", "8"])):
            written, sec = counted(lambda: main_comparison_video.main(
                argv + ["--renderer", "sweep_pallas", "--output",
                        str(out)]),
                f"main_comparison_video {tag}", counters, {"sweep_march"},
                add)
            times[f"video {tag}"] = sec
            for d in written:
                frames = sorted(Path(d).glob("*.png"))
                imgs = [np.asarray(Image.open(f)) for f in frames]
                ok = (len(imgs) == 8 and all(i.shape == imgs[0].shape
                                             and i.max() > 0 for i in imgs))
                log(f"[main_comparison_video {tag}] {Path(d).name}: "
                    f"{len(imgs)} PNGs {imgs[0].shape if imgs else None}, "
                    f"not black: {ok}")
                if not ok:
                    raise RuntimeError(f"main_comparison_video {tag}: {d}")
            if len(written) != (2 if tag == "script" else 4):
                raise RuntimeError(f"main_comparison_video {tag}: wrote "
                                   f"{written}")

    with phase("42 image_vis: one figure"):
        paths, sec = counted(lambda: image_vis.main(
            ["--models", run, "--renderer", "sweep_pallas", "--output",
             str(work / "fig")]), "image_vis", counters, {"sweep_march"},
            add)
        fig = np.asarray(Image.open(paths[0]))
        log(f"[image_vis] {sec:.2f} s, {Path(paths[0]).name} {fig.shape}")
        if fig.shape != (480, 480 + 3 * 96, 3) or fig.max() == 0:
            raise RuntimeError(f"image_vis: figure {fig.shape}")

    with phase("43 main_psnr_allangles: 4 cameras x 2 rolls, without and "
               "with the baked AO field"):
        for ao, need in ((0, {"sweep_march"}), (64, {"sweep_march_ao"})):
            out = work / f"allangles_{ao}"
            _, sec = counted(lambda: main_psnr_allangles.main(
                ["--models", "bilinear", run, "--cameras", "4", "--rolls",
                 "2", "--aoSamples", str(ao), "--renderer", "sweep_pallas",
                 "--output", str(out)]),
                f"main_psnr_allangles ao {ao}", counters, need, add)
            times[f"allangles ao {ao}"] = sec
            head, rows = _read_tsv(out / "allangles_torus.tsv")
            ok = (sorted(rows) == ["bilinear", "run00017"]
                  and all(math.isfinite(v) for r in rows.values()
                          for v in r) and all(r[-1] == 0
                                              for r in rows.values()))
            log(f"[main_psnr_allangles ao {ao}] {sec:.2f} s for 8 views x "
                f"2 models; PSNR normal / color mean: "
                f"{ {k: (r[2], r[6]) for k, r in rows.items()} }; ok: {ok}")
            if not ok:
                raise RuntimeError(f"main_psnr_allangles ao {ao}: {rows}")

    with phase("44 vgg_analysis, discr_test on run00020, train_texenc and "
               "adv_evidence on kernel-made clips"):
        table, sec = counted(lambda: vgg_analysis.main(
            ["--renderer", "sweep_pallas"]), "vgg_analysis", counters,
            {"sweep_march"}, add)
        times["vgg_analysis"] = sec
        log(f"[vgg_analysis] {sec:.2f} s, 16 images at 128^2, 12 layers: "
            f"{[(k, round(w, 4)) for k, _, w in table]}")
        if len(table) != 12 or not all(math.isfinite(w) and w > 0
                                       for _, _, w in table):
            raise RuntimeError("vgg_analysis: bad table")
        (epoch, logits), sec = counted(lambda: discr_test.main(
            [str(ROOT / "artifacts" / "run00020" / "run00020"),
             "--renderer", "sweep_pallas"]), "discr_test", counters,
            {"sweep_march", "sweep_march_ao"}, add)
        times["discr_test"] = sec
        log(f"[discr_test] {sec:.2f} s, epoch {epoch}, logits {logits}")
        if epoch != 23 or len(logits) != 8 or not all(
                math.isfinite(v) for _, _, v in logits):
            raise RuntimeError("discr_test: bad logits")
        clips = work / "clips"
        _, sec = counted(lambda: generate_sequences(
            [(grid, (0.45, 0.55))], 4, SequenceConfig(),
            RenderConfig(renderer="sweep_pallas", step_voxels=0.5), seed=44,
            out_dir=str(clips)), "clips for train_texenc", counters,
            {"sweep_march": 40, "sweep_march_ao": 40}, add)
        times["4 clips"] = sec
        texenc = work / "texenc.npz"
        (losses, _), sec = counted(lambda: train_texenc.main(
            ["--dataset", str(clips), "--samples", "200", "--steps", "20",
             "--output", str(texenc)]), "train_texenc", counters, {}, add)
        times["train_texenc 20 steps"] = sec
        log(f"[train_texenc] {sec:.2f} s for 20 steps (batch 32, crops "
            f"128^2) and the crops; losses {losses[0]:.5f} -> "
            f"{losses[-1]:.5f}")
        if not texenc.exists() or not all(math.isfinite(v) for v in losses):
            raise RuntimeError("train_texenc: no encoder or bad losses")
        rows, sec = counted(lambda: adv_evidence.main(
            ["--dataset", str(clips), "--models", "bilinear", run,
             "--samples", "200", "--output", str(work / "adv")]),
            "adv_evidence", counters, {}, add)
        times["adv_evidence"] = sec
        log(f"[adv_evidence] {sec:.2f} s: {rows}")
        if ([r[0] for r in rows] != ["bilinear", "run00017"] or not all(
                math.isfinite(v) for r in rows for v in r[1:])
                or not (work / "adv" / "panels.png").exists()):
            raise RuntimeError("adv_evidence: bad table or no panels")
    return times


# --------------------------------------------------------------------------
# phase 45: resuming JAX's runs
# --------------------------------------------------------------------------

def _pb_fields(buf: bytes) -> list:
    """(field number, value) of each field of a protobuf message: an int
    for a varint, bytes for a length-delimited or a fixed-size field."""
    out, pos = [], 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n
    while pos < len(buf):
        key = varint()
        wire = key & 7
        if wire == 0:
            value = varint()
        elif wire == 2:
            n = varint()
            value = buf[pos:pos + n]
            pos += n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value = buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"protobuf wire type {wire}")
        out.append((key >> 3, value))
    return out


def read_event_file(path) -> tuple:
    """A TensorBoard event file read back without tensorboard, every
    record's two masked CRC-32Cs checked -> (file_version, [(step, tag,
    value)]), a value a float for a scalar and (height, width,
    colorspace, PNG bytes) for an image."""
    import struct

    from isosurfacesuperresolution_tpu_torch.utils.tensorboard import (
        masked_crc)
    data = Path(path).read_bytes()
    pos, version, values = 0, None, []
    while pos < len(data):
        head = data[pos:pos + 8]
        n = struct.unpack("<Q", head)[0]
        body = data[pos + 12:pos + 12 + n]
        crcs = struct.unpack("<I", data[pos + 8:pos + 12])[0], struct.unpack(
            "<I", data[pos + 12 + n:pos + 16 + n])[0]
        if crcs != (masked_crc(head), masked_crc(body)):
            raise RuntimeError(f"{path}: the record at byte {pos} fails its "
                               f"CRC")
        pos += 16 + n
        event = dict(_pb_fields(body))
        if 3 in event:
            version = event[3].decode()
        for _, value in _pb_fields(event.get(5, b"")):
            v = dict(_pb_fields(value))
            if 2 in v:
                val = struct.unpack("<f", v[2])[0]
            else:
                im = dict(_pb_fields(v[4]))
                val = (im[1], im[2], im[3], im[4])
            values.append((event.get(2, 0), v[1].decode(), val))
    return version, values


def resume_runs(seqs, counters: dict, add) -> dict:
    """Phase 45: JAX's orbax runs resumed on the card in full (parameters,
    optimizer states, step), card vs CPU on the first step after the
    restore, 20 more steps on phase 29's clips, and `main_video_unshaded
    --restore` on run00022 for one cut epoch with its event file read
    back.  Returns seconds and ms by name."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from isosurfacesuperresolution_tpu_torch.apps import main_video_unshaded
    from isosurfacesuperresolution_tpu_torch.config import config_from_json
    from isosurfacesuperresolution_tpu_torch.data.dataset import (
        DatasetFromSamples, VideoDataset)
    from isosurfacesuperresolution_tpu_torch.losses.lossnet_unshaded import (
        LossNetUnshaded)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.train import trainer as TR
    from isosurfacesuperresolution_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from isosurfacesuperresolution_tpu_torch.train.device_data import (
        DeviceVideoDataset)
    from isosurfacesuperresolution_tpu_torch.utils import jax_prng

    times = {}

    def restored(cfg, run, device):
        """A fresh full-width state of ``cfg`` on ``device`` (weights
        other than the run's), the run's newest step restored into it ->
        (state, criterion, epoch, seconds of the restore)."""
        gen = torch.Generator().manual_seed(45)
        model = create_network(cfg.model, generator=gen).to(device)
        crit = LossNetUnshaded(cfg.loss, high_res=cfg.train.crop_size
                               * cfg.model.upscale_factor)
        spec = TR.make_optimizer(cfg)
        state = TR.create_train_state(
            cfg, model, crit, spec, gen,
            discr_optimizer=spec if cfg.train.adv_training else None)
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.time()
        state, epoch = CheckpointManager(str(run)).restore(state)
        if device == "cuda":
            torch.cuda.synchronize()
        return state, crit, epoch, time.time() - t

    def tensors(state, moments: bool = True) -> dict:
        out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
        out.update({f"discr.{k}": v for k, v in
                    state.discriminators.state_dict().items()})
        for tag, opt in (("opt", state.optimizer),
                         ("dopt", state.discr_optimizer)):
            if opt is not None and moments:
                for m, ts in opt.state.items():
                    out.update({f"{tag}.{m}.{n}": t
                                for n, t in zip(opt.names, ts)})
        return out

    def first_round(cfg, state, crit, batch):
        """The first step after the restore: the plain step, or the
        discriminator then the generator step -> the losses."""
        if cfg.train.adv_training:
            d_step, g_step = TR.make_adv_train_steps(cfg, state.model, crit)
            _, dl, _, _ = d_step(state, *batch, jax_prng.prng_key(45))
            _, gl = g_step(state, *batch)
            return [float(dl), float(gl)]
        _, loss = TR.make_train_step(cfg, state.model, crit)(state, *batch)
        return [float(loss)]

    with phase("45 resuming JAX's orbax runs on the card"):
        for name, step in (("run00022", 70), ("run00020", 23)):
            run = ROOT / "artifacts" / name / name
            cfg = config_from_json(str(run / "config.json"))
            t = cfg.train
            state, crit, epoch, sec = restored(cfg, run, "cuda")
            host, hcrit, _, host_sec = restored(cfg, run, "cpu")
            a, b = tensors(state), tensors(host)
            equal = sorted(a) == sorted(b) and all(
                bool(torch.equal(v.cpu(), b[k])) for k, v in a.items())
            opts = [o for o in (state.optimizer, state.discr_optimizer)
                    if o is not None]
            ok = (epoch == step and equal and state.step == host.step
                  and all(o.count == state.step for o in opts))
            times[f"{name} restore s"] = sec
            log(f"[resume {name}] step {epoch} restored in full on the card "
                f"in {sec:.3f} s (on the CPU {host_sec:.3f} s): step "
                f"{state.step}, counts {[o.count for o in opts]}, learning "
                f"rates {[o.learning_rate for o in opts]}; {len(a)} tensors "
                f"bit for bit the CPU restore: {equal}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{name}: the restored state is wrong")

            dd = DeviceVideoDataset(seqs, upscale_factor=4, device="cuda")
            dataset = VideoDataset(seqs)
            samples = dataset.collect_samples(t.samples, t.crop_size,
                                              t.min_fill_rate,
                                              np.random.RandomState(t.seed))
            train_set = DatasetFromSamples(dataset, samples, t.crop_size,
                                           False, t.test_fraction)
            rng = np.random.RandomState(45)

            def batches():
                while True:
                    yield from dd.batches(train_set.samples, t.batch_size,
                                          t.crop_size, rng=rng)
            it = batches()
            first = next(it)
            card = first_round(cfg, state, crit, first)
            cpu = first_round(cfg, host, hcrit, [x.cpu() for x in first])
            rel = max(abs(x - y) / abs(y) for x, y in zip(card, cpu))
            worst, share, close = params_close(
                tensors(state, False), tensors(host, False),
                state.optimizer.learning_rate)
            ok = rel <= MAX_TRAIN_LOSS_REL and close
            log(f"[resume {name}] first step after the restore, card vs "
                f"CPU: losses {card} vs {cpu} (max rel {rel:.3g}, bound "
                f"{MAX_TRAIN_LOSS_REL}); parameters: largest |diff| "
                f"{worst:.3g} x lr (bound {MAX_TRAIN_FAR}), largest share "
                f"of a leaf beyond {MAX_TRAIN_PARAM} x lr {share:.4f} (bound"
                f" {MAX_TRAIN_FAR_SHARE}): {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"{name}: card and CPU disagree after "
                                   f"the restore")
            del host, hcrit
            start = state.step
            if not t.adv_training:
                train_steps(TR.make_train_step(cfg, state.model, crit),
                            state, it, 20, f"resume {name}", counters, add)
                times[f"{name} ms a step"] = FRAME_MS[f"resume {name}"]
            else:
                d_step, g_step = TR.make_adv_train_steps(cfg, state.model,
                                                         crit)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for holder, attr in counters.values():
                    setattr(holder, attr, 0)
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(21)]
                vals = []
                ev[0].record()
                for r in range(20):
                    batch = next(it)
                    _, dl, _, _ = d_step(state, *batch, jax_prng.prng_key(
                        rng.randint(1 << 31)))
                    _, gl = g_step(state, *batch)
                    ev[r + 1].record()
                    vals.append((dl, gl))
                torch.cuda.synchronize()
                launches = {k: getattr(h, a) for k, (h, a) in
                            counters.items()}
                expect(launches, {}, f"resume {name}")
                add(launches)
                vals = [float(v) for row in vals for v in row]
                ms = ev[2].elapsed_time(ev[20]) / 18
                times[f"{name} ms a round"] = ms
                log(f"[resume {name}] {ms:.2f} ms a D+G round over rounds "
                    f"3-20 (first {ev[0].elapsed_time(ev[1]):.1f} ms), peak "
                    f"memory allocated "
                    f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB;"
                    f" every loss finite: "
                    f"{all(math.isfinite(v) for v in vals)}")
                if not all(math.isfinite(v) for v in vals):
                    raise RuntimeError(f"{name}: a loss is not finite")
            if state.step != start + 20:
                raise RuntimeError(f"{name}: {state.step - start} steps of "
                                   f"20 taken")
            del state, crit, dd, it

        run = ROOT / "artifacts" / "run00022" / "run00022"
        cfg = config_from_json(str(run / "config.json"))
        t = cfg.train
        work = Path(tempfile.mkdtemp(prefix="resume_", dir=ROOT / "build"))
        try:
            # the run's own flags, its epoch cut to 2 small clips of 3
            # frames at crop 16 (the train state does not depend on them)
            # and 64 crops (a fifth of them, 13, for the test batches)
            argv = ["--dataset", "analytic:sphere", "--numberOfImages", "2",
                    "--numFrames", "3", "--cropSize", "16", "--samples",
                    "64", "--batchSize", str(t.batch_size),
                    "--aoSamples", "16", "--lossBorderPadding", "4",
                    "--losses", cfg.loss.losses, "--lr",
                    str(t.learning_rate), "--lrStep", str(t.lr_step),
                    "--lrGamma", str(t.lr_gamma), "--gradClip",
                    str(t.grad_clip), "--remat", "--imageEvery", "1",
                    "--epochs", str(t.epochs + 1), "--runDir",
                    str(work / "runs"), "--device", "cuda",
                    "--restore", str(run)]
            out, sec = counted(lambda: main_video_unshaded.main(argv),
                               "main_video_unshaded --restore run00022",
                               counters, {}, add)
            times["main --restore s"] = sec
            payload = torch.load(Path(out) / "checkpoints" / "epoch_71.pt",
                                 map_location="cpu", weights_only=True)
            events = list((Path(out) / "tensorboard").iterdir())
            version, values = read_event_file(events[0])
            scalars = {tag: v for _, tag, v in values
                       if isinstance(v, float)}
            images = {tag: v[:3] for _, tag, v in values
                      if not isinstance(v, float)}
            lr71 = t.learning_rate * t.lr_gamma ** (70 // t.lr_step)
            ok = (len(events) == 1 and version == "brain.Event:2"
                  and {s for s, _, _ in values} == {71}
                  and set(scalars) == {"train/total_loss", "train/lr",
                                       "test/total_loss", "test/psnr"}
                  and all(math.isfinite(v) for v in scalars.values())
                  and abs(scalars["train/lr"] - lr71) <= 1e-6 * lr71
                  and "test/shaded" in images
                  and payload["step"] > 4200
                  and payload["opt_state"]["count"] == payload["step"])
            log(f"[main_video_unshaded --restore run00022] epoch 71 in "
                f"{sec:.1f} s: step {payload['step']} (4200 + "
                f"{payload['step'] - 4200} batches), Adam's count "
                f"{payload['opt_state']['count']}; event file "
                f"{events[0].name}: {version}, step 71 scalars "
                + ", ".join(f"{k} {v:.6g}" for k, v in sorted(
                    scalars.items()))
                + f"; images (h, w, c) {images}: {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError("--restore of a JAX run dir: wrong run "
                                   "dir or event file")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return times


def path_counters() -> dict:
    """Each kernel's launch count: name -> (object, attribute); each
    wrapper adds one where it launches its kernel."""
    from isosurfacesuperresolution_tpu_torch.ops import packed_conv as pk
    from isosurfacesuperresolution_tpu_torch.ops import pallas_conv as p128
    from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
    from isosurfacesuperresolution_tpu_torch.render import sweep_march
    from isosurfacesuperresolution_tpu_torch.render import sweep_tiled
    march = sweep_march.march
    return {"sweep_march": (march, "launches"),
            "sweep_march_ao": (march, "ao_launches"),
            "phase_conv": (pc.phase_conv, "launches"),
            "sweep_march_tiled": (sweep_tiled.march_tiled_kernel,
                                  "launches"),
            "ao_capture_tiled": (sweep_tiled.ao_capture_tiled_kernel,
                                 "launches"),
            "sweep_march_packed": (sweep_tiled.march_packed_kernel,
                                   "launches"),
            "ao_capture_packed": (sweep_tiled.ao_capture_packed_kernel,
                                  "launches"),
            "conv3x3_p128": (p128.conv3x3_p128_kernel, "launches"),
            "packed_conv3x3": (pk.packed_conv3x3_kernel, "launches")}


def main() -> int:
    import torch

    with phase("1 versions and card"):
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: this smoke test "
                               "needs one card")
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")
        print(card_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log("TF32 off for matmuls and convolutions")
        sys.path.insert(0, str(ROOT))
        from isosurfacesuperresolution_tpu_torch import kernels

    with phase("2 build kernels"):
        t = time.time()
        built = kernels.build()
        for name, info in built.items():
            regs = [ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln]
            log(f"built {name} in {info['seconds']:.1f}s; "
                + " | ".join(regs))
        log(f"build {time.time() - t:.1f}s")
        for line in (ptxas_lines(kernels, "sweep_march", MARCH_ENTRIES)
                     + ptxas_lines(kernels, "conv3x3", CONV_ENTRIES)):
            log(f"[ptxas] {line}")

    import torch.nn.functional as F

    from isosurfacesuperresolution_tpu_torch.config import (
        Config, RenderConfig)
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.infer import torch_export
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        FusedFrame, InferencePipeline, fp32_convs, initial_state)
    from isosurfacesuperresolution_tpu_torch.models import (
        generators as gen_mod)
    from isosurfacesuperresolution_tpu_torch.models.generators import (
        create_network)
    from isosurfacesuperresolution_tpu_torch.ops.inpaint import inpaint_flow
    from isosurfacesuperresolution_tpu_torch.render.raycast import (
        gbuffer_to_low_input)
    from isosurfacesuperresolution_tpu_torch import ops as port_ops
    from isosurfacesuperresolution_tpu_torch import profile_convs
    from isosurfacesuperresolution_tpu_torch.infer import planar as planar_mod
    from isosurfacesuperresolution_tpu_torch.ops import packed_conv as pk
    from isosurfacesuperresolution_tpu_torch.ops import pallas_conv as p128
    from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
    from isosurfacesuperresolution_tpu_torch.render import sweep_march
    from isosurfacesuperresolution_tpu_torch.render import sweep_tiled
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)
    from isosurfacesuperresolution_tpu_torch.render.sweep import (
        ao_tile_table, field_zcxy, march_inputs, packed_inputs, plan_sweep,
        render_gbuffer_sweep, tiled_inputs, use_tiled)
    from isosurfacesuperresolution_tpu_torch.volume import analytic
    from isosurfacesuperresolution_tpu_torch.volume.packed import (
        SWEEP_PERMS, SparseBrickGrid)

    march = sweep_march.march
    counters = path_counters()
    frame_cfg = RenderConfig(width=480, height=270, isovalue=0.5,
                             ao_samples=0, renderer="sweep_pallas",
                             sweep_oversample=1.25, sweep_dtype="bfloat16")
    ao_cfg = frame_cfg.replace(ao_samples=64, ao_mode="volume")
    lm = LoadedModel.from_run_dir(str(ROOT / "artifacts" / "run00017"),
                                  device="cuda")
    m = lm.cfg.model
    log(f"EnhanceNet {m.num_residual_blocks} blocks x {m.num_features} "
        f"features, {m.compute_dtype}")
    rows = {}
    with phase("3 kernel vs plain"):
        grid = analytic.blobs_volume(256, num_blobs=8, device="cuda")
        grid_u8 = analytic.blobs_volume(256, num_blobs=8,
                                        store_dtype="uint8", device="cuda")
        torch.cuda.synchronize()
        t = time.time()
        grid_ao = attach_baked_ao(grid, 0.5, 0.1)
        torch.cuda.synchronize()
        bake_s = time.time() - t
        log(f"baked the SH occlusion field of the 256^3 grid (radius 0.1, "
            f"32 directions x 12 steps) in {bake_s:.2f} s")
        cam = cam_at(0.0)
        cases = [("bfloat16", grid, frame_cfg),
                 ("float32", grid, frame_cfg),
                 ("bfloat16 uint8-volume", grid_u8, frame_cfg),
                 ("bfloat16 AO", grid_ao, ao_cfg),
                 ("float32 AO", grid_ao, ao_cfg)]
        for tag, g, base in cases:
            cfg = base.replace(sweep_dtype=tag.split()[0])
            rp = RenderParams.from_config(cfg)
            args = march_inputs(g, plan_sweep(g, cam, cfg, rp), cfg, rp,
                                use_ao_field="AO" in tag)
            # the inputs in the kernel's layout and types, so that the
            # times below are the kernel's and not the wrapper's copies
            args["vol_zxy"] = sweep_march.kernel_volume(args["vol_zxy"],
                                                        args["dtype"])
            if args["ao_zcxy"] is not None:
                args["ao_zcxy"] = sweep_march.kernel_ao_field(
                    args["ao_zcxy"], args["dtype"])
            log(f"[{tag}] K={args['meta'].shape[0]} Sn={args['Sn']} "
                f"Tn={args['Tn']} scale={g.value_scale:.6g} "
                f"offset={g.value_offset:.6g}")
            got = march(**args)
            torch.cuda.synchronize()
            want = sweep_march.march_plain(**args)
            torch.cuda.synchronize()
            err, mismatch = check_march(tag, got, want)
            ms = time_cuda(lambda: march(**args), 7)
            plain_ms = time_cuda(lambda: sweep_march.march_plain(**args), 3)
            bound, bound_by = march_bound_ms(args, got)
            march_line(tag, ms, plain_ms, bound, bound_by, mismatch)
            rows[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": None}
        del grid_u8

        # the phase conv at the phase-tail frame's shape, trained weights
        sd = lm.model.state_dict()
        k3 = sd["post3.weight"].permute(2, 3, 1, 0).contiguous()   # HWIO
        b3 = sd["post3.bias"]
        gen = torch.Generator(device="cuda").manual_seed(0)
        H, W = 540, 960
        # F2's output is post-ReLU: non-negative activations of O(1)
        x = torch.rand((1, H, W, 256), device="cuda", generator=gen,
                       dtype=torch.float32).to(torch.bfloat16)
        xs = x[0].reshape(H, W, 2, 2, 64).permute(4, 0, 2, 1, 3).reshape(
            1, 64, 2 * H, 2 * W).contiguous()      # the shuffled input
        w_lib = k3.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        b_lib = b3.to(torch.bfloat16)
        # the library call in both memory formats, behind a backlog; the
        # faster one is timed in turns with the kernel
        lib = {}
        for fmt in ("contiguous_format", "channels_last"):
            mf = getattr(torch, fmt)
            xs_f = xs.contiguous(memory_format=mf)
            w_f = w_lib.contiguous(memory_format=mf)
            lib[fmt] = (statistics.median(time_samples(
                lambda: F.conv2d(xs_f, w_f, b_lib, padding=1), 7,
                backlog=True)), xs_f, w_f)
        lib_fmt = min(lib, key=lambda k: lib[k][0])
        _, xs_f, w_f = lib[lib_fmt]
        log(f"[phase_conv] library: F.conv2d bf16 with bias on the shuffled "
            f"(1, 64, 1080, 1920) tensor (shuffle excluded; no ReLU), "
            f"behind a backlog: "
            + ", ".join(f"{k} {v[0]:.4f} ms" for k, v in lib.items())
            + f"; {lib_fmt} is timed in turns with the kernel")
        del lib, xs

        def lib_fn():
            return F.conv2d(xs_f, w_f, b_lib, padding=1)

        wr, b4 = pc.kernel_operands(k3, b3)
        flops = 2.0 * (2 * H) * (2 * W) * 64 * 64 * 9
        for out in ("bfloat16", "float32"):
            odt = getattr(torch, out)
            got = pc.phase_conv3x3_amajor_blocked(x, k3, b3, relu=True,
                                                  out_dtype=odt)
            torch.cuda.synchronize()
            want = pc.phase_conv_plain(x, k3, b3, relu=True, out_dtype=odt)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            err = float(d.max())
            rel = float((d / want.float().abs().clamp(min=1.0)).max())
            ok = err <= MAX_PHASE_ABS[out] and rel <= MAX_PHASE_REL[out]
            log(f"[phase_conv {out}] max |diff| {err:.3g} (bound "
                f"{MAX_PHASE_ABS[out]}), max |diff|/max(|ref|, 1) "
                f"{rel:.3g} (bound {MAX_PHASE_REL[out]:.3g}); output mean "
                f"{float(want.float().mean()):.4f}: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"phase_conv disagrees with its plain "
                                   f"version ({out})")

            def kern(odt=odt):
                return pc.phase_conv_kernel(x, wr, b4, True, odt)

            ms, lib_ms, k_turns, lib_turns = time_turns(kern, lib_fn, 7)
            idle_ms = time_cuda(kern, 7)
            plain_ms = time_cuda(lambda: pc.phase_conv_plain(
                x, k3, b3, relu=True, out_dtype=odt), 3)
            bound, bound_by = phase_bound_ms(H, W, got.element_size())
            log(f"[phase_conv {out}] kernel {ms:.4f} ms (turns "
                f"{k_turns[0]:.4f}, {k_turns[1]:.4f}; 7 calls each behind a "
                f"backlog; {flops / ms / 1e9:.1f} TFLOP/s), {bound / ms:.3f} "
                f"of its bound {bound:.4f} ms by {bound_by}; plain "
                f"{plain_ms:.2f} ms (median of 3); library {lib_ms:.4f} ms "
                f"(turns {lib_turns[0]:.4f}, {lib_turns[1]:.4f}); kernel / "
                f"library {ms / lib_ms:.2f}; single calls from an idle "
                f"queue, host launch included: {idle_ms:.4f} ms")
            rows[f"phase_conv {out}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms}
            del got, want, d

        wrap_us = host_us(lambda: pc.phase_conv(x, k3, b3, relu=True))
        entry_us = host_us(lambda: pc.phase_conv_kernel(
            x, wr, b4, True, torch.bfloat16))
        log(f"[phase_conv] host time of one call while the card is busy "
            f"(mean of 200, no sync): the wrapper `phase_conv` "
            f"{wrap_us:.1f} us, its launch entry `phase_conv_kernel` "
            f"{entry_us:.1f} us, against the kernel's "
            f"{rows['phase_conv bfloat16']['ms'] * 1e3:.1f} us on the card")
        del x, xs_f, w_f, wr, b4

    path_launches = {k: 0 for k in counters}

    def add(launches):
        for k, v in launches.items():
            path_launches[k] += v

    with phase("4 non-planar frame: 10 frames of the trained 10x64 net"):
        ff = FusedFrame(lm.model, lm.cfg, frame_cfg, planar="off",
                        device="cuda")
        st = [initial_state(lm.cfg, frame_cfg, planar="off", device="cuda")]

        def nonplanar(i):
            rgb, _, st[0] = ff(grid, cam_at(0.03 * i),
                               cam_at(0.03 * max(i - 1, 0)), st[0])
            return rgb

        rgb, launches = drive(nonplanar, 10, "non-planar", counters)
        check_rgb(rgb, st[0].prev_high[..., 0] > 0.0, (1080, 1920, 3))
        expect(launches, {"sweep_march": 10, "sweep_march_ao": 0,
                          "phase_conv": 0}, "non-planar")
        add(launches)
        del ff, st

    with phase("5 small frames: card vs CPU"):
        small_cfg = frame_cfg.replace(width=64, height=48)
        phase_cfg = Config(model=dataclasses.replace(
            m, compute_dtype="bfloat16", planar_phase_tail=True))
        ao64 = attach_baked_ao(analytic.blobs_volume(64, num_blobs=8,
                                                     device="cuda"),
                               0.5, 0.1)
        variants = [
            ("non-planar", lm.cfg, small_cfg, "off", None),
            ("planar phase-tail bf16 + baked AO", phase_cfg,
             small_cfg.replace(ao_samples=64, ao_mode="volume"), "on",
             ao64.ao_sh)]
        for tag, cfg, rcfg, planar, ao_sh in variants:
            outs = {}
            for dev in ("cuda", "cpu"):
                g = analytic.blobs_volume(64, num_blobs=8, device=dev)
                if ao_sh is not None:
                    g = dataclasses.replace(g, ao_sh=ao_sh.to(dev))
                ff = FusedFrame(lm.model.to(dev), cfg, rcfg, planar=planar,
                                device=dev)
                st = initial_state(cfg, rcfg, planar=planar, device=dev)
                for i in range(3):
                    rgb_s, fr_s, st = ff(g, cam_at(0.03 * i),
                                         cam_at(0.03 * (i - 1)), st)
                outs[dev] = (rgb_s.cpu(), fr_s.cpu())
            lm.model.to("cuda")
            check_card_vs_cpu(tag, outs, ao_sh is not None)
        del ao64

    with phase("6 main path: run00017 through InferencePipeline, 20 frames"):
        pipe = InferencePipeline(lm.model, lm.cfg, frame_cfg, device="cuda")
        if not pipe.use_planar:
            raise RuntimeError("planar 'auto' did not select the planar "
                               "engine for run00017")
        rgb, launches = drive(lambda i: pipe.frame(grid, cam_at(0.03 * i)),
                              20, "planar f32", counters)
        check_rgb(rgb, pipe.state.prev_high[..., 0:16] > 0.0,
                  (1080, 1920, 3))
        expect(launches, {"sweep_march": 20, "sweep_march_ao": 0,
                          "phase_conv": 0}, "planar f32")
        add(launches)
        del pipe

    with phase("7 bench --phase frames: bf16 phase tail, no AO and baked AO"):
        log(f"bake of the AO field: {bake_s:.2f} s (phase 3), not in the "
            f"frame times")
        cfg7 = Config(model=dataclasses.replace(
            m, compute_dtype="bfloat16", planar_phase_tail=True))
        for tag, g, rcfg, want in (
                ("phase bf16", grid, frame_cfg,
                 {"sweep_march": 20, "sweep_march_ao": 0, "phase_conv": 20}),
                ("phase bf16 + AO", grid_ao, ao_cfg,
                 {"sweep_march": 0, "sweep_march_ao": 20,
                  "phase_conv": 20})):
            ff = FusedFrame(lm.model, cfg7, rcfg, planar="on",
                            device="cuda")
            if not ff.planar_net.phase_tail:
                raise RuntimeError("the phase tail is off at 64 features")
            st = [initial_state(cfg7, rcfg, planar="on", device="cuda")]

            def run(i, ff=ff, g=g, st=st):
                rgb, fr, st[0] = ff(g, cam_at(0.03 * i),
                                    cam_at(0.03 * max(i - 1, 0)), st[0])
                return rgb, fr

            (rgb, fr), launches = drive(run, 20, tag, counters)
            check_rgb(rgb, st[0].prev_high[..., 0:16] > 0.0,
                      (3, 1080, 1920))
            expect(launches, want, tag)
            add(launches)
            hit = fr[..., 3] > 0.5
            ao_hit = fr[..., 10][hit]
            log(f"[{tag}] G-buffer AO on hits: min {float(ao_hit.min()):.4f}"
                f", mean {float(ao_hit.mean()):.4f}")
            if "AO" in tag and not bool((ao_hit < 1.0).any()):
                raise RuntimeError("the AO channel is 1 on every hit")
            del ff, st

    with phase("8 the 512^3 volume of bench_volumes.py and its AO fields"):
        t = time.time()
        grid512 = analytic.blobs_volume(512, store_dtype="uint8",
                                        device="cuda")
        torch.cuda.synchronize()
        vol512_u8 = grid512.values.cpu().numpy()      # phase 35's bytes
        log(f"blobs_volume(512) stored uint8 (numpy on the host, the brick "
            f"pyramid included): {time.time() - t:.1f} s; occupied bricks "
            f"at iso 0.36: "
            f"{float((grid512.brick_max >= 0.36).float().mean()):.3f}")
        t = time.time()
        grid512_ao = attach_baked_ao(grid512, 0.36, 0.2,
                                     out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        log(f"full-resolution bf16 field {tuple(grid512_ao.ao_sh.shape)}: "
            f"{time.time() - t:.1f} s")
        t = time.time()
        grid512_c = attach_baked_ao(grid512, 0.36, 0.2, downsample=2,
                                    keep_coarse=True, out_dtype="uint8")
        torch.cuda.synchronize()
        log(f"half-resolution uint8 field kept coarse "
            f"{tuple(grid512_c.ao_sh.shape)}: {time.time() - t:.1f} s")

    cfg512 = RenderConfig(width=480, height=270, isovalue=0.36,
                          ao_samples=0, renderer="sweep_pallas",
                          sweep_oversample=1.25, sweep_dtype="bfloat16")
    ao512 = cfg512.replace(ao_samples=64, ao_mode="volume")
    with phase("9 tiled kernels vs plain at 512^3"):
        rp512 = RenderParams.from_config(cfg512)
        plan = plan_sweep(grid512, cam_at(0.0), cfg512, rp512)
        if not use_tiled(cfg512, plan, grid512):
            raise RuntimeError("the 512^3 view does not take the tiled path")
        args = tiled_inputs(grid512, plan, cfg512, rp512)
        args["vol_zxy"] = sweep_march.kernel_volume(args["vol_zxy"],
                                                    args["dtype"])
        tables = sweep_tiled.march_tables(
            args["vol_zxy"].shape, args["meta"], args["brick_max_p"],
            args["brick_size"], args["iso"], args["tile"])
        TX, TY, occ, counts = tables
        log(f"[B2] K={args['meta'].shape[0]} Sn={args['Sn']} "
            f"Tn={args['Tn']} tile {args['tile']} ({tuple(occ.shape[1:])} "
            f"tiles), working slices {int((counts > 0).sum())}, occupied "
            f"tiles per working slice "
            f"{float(counts.sum()) / max(int((counts > 0).sum()), 1):.2f}")
        plain = {k: v for k, v in args.items() if k != "table"}
        got = sweep_tiled.march_tiled(**args)
        torch.cuda.synchronize()
        want = sweep_tiled.march_tiled_plain(**plain)
        torch.cuda.synchronize()
        err, mismatch = check_march("B2 bf16 uint8-volume", got, want)
        kargs = (args["vol_zxy"], args["meta"], args["s_grid"],
                 args["t_grid"], args["Sn"], args["Tn"], args["table"], TX,
                 TY, args["iso"], args["dtype"], args["scale"],
                 args["offset"])
        ms = time_cuda(lambda: sweep_tiled.march_tiled_kernel(*kargs), 7)
        wrapper_ms = time_cuda(lambda: sweep_tiled.march_tiled(**args), 7)
        plain_ms = time_cuda(lambda: sweep_tiled.march_tiled_plain(**plain),
                             3)
        bound, bound_by = tiled_bound_ms(args, got, tables,
                                         args["vol_zxy"].shape,
                                         args["vol_zxy"].element_size())
        march_line("B2", ms, plain_ms, bound, bound_by, mismatch,
                   wrapper_ms)
        rows["tiled"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": None}
        m_hit = got[0]
        for tag, g in (("full-res bf16 field", grid512_ao),
                       ("coarse uint8 field", grid512_c)):
            ao_args = dict(ao_zcxy=field_zcxy(g.ao_sh, plan.perm),
                           meta=args["meta"], s_grid=args["s_grid"],
                           t_grid=args["t_grid"], Sn=args["Sn"],
                           Tn=args["Tn"], m_hit=m_hit,
                           brick_max_p=args["brick_max_p"],
                           brick_size=args["brick_size"], iso=args["iso"],
                           dtype=args["dtype"], ao_scale=g.ao_scale,
                           ao_offset=g.ao_offset,
                           field_downsample=g.ao_downsample)
            table = ao_tile_table(g, plan.perm)
            sh = sweep_tiled.ao_capture_tiled(**ao_args, table=table)
            torch.cuda.synchronize()
            sh_want = sweep_tiled.ao_capture_tiled_plain(**ao_args)
            torch.cuda.synchronize()
            hit = m_hit >= 0
            d = (sh - sh_want).abs()
            excess = float((d - MAX_SH_REL * sh_want.abs()).max())
            ok = (excess <= 1e-6 and bool((sh[:, ~hit] == 0).all())
                  and bool((sh_want[:, hit] != 0).any()))
            log(f"[B4 {tag}] max |diff| {float(d.max()):.3g}, bound |diff| "
                f"<= 1e-6 + {MAX_SH_REL:.3g} |sh| (excess {excess:.3g}), 0 "
                f"where no hit: {'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"ao_capture_tiled disagrees with its "
                                   f"plain version ({tag})")
            field = ao_args["ao_zcxy"]
            tables = sweep_tiled.ao_tables(
                field.shape, args["meta"], m_hit, args["brick_max_p"],
                args["brick_size"], args["iso"], 128, g.ao_downsample)
            TX, TY = tables[:2]
            kargs = (field, args["meta"], args["s_grid"], args["t_grid"],
                     m_hit, table, TX, TY, args["iso"], args["dtype"],
                     g.ao_scale, g.ao_offset, g.ao_downsample)
            bound, bound_by = ao_tiled_bound_ms(
                field.shape, field.element_size(), args["meta"],
                args["s_grid"], args["t_grid"], m_hit, g.ao_downsample,
                tables, table.numel() * 4)
            rows[f"ao_tiled {tag}"] = capture_row(
                f"B4 {tag}",
                lambda: sweep_tiled.ao_capture_tiled_kernel(*kargs),
                lambda: sweep_tiled.ao_capture_tiled(**ao_args, table=table),
                lambda: sweep_tiled.ao_capture_tiled_plain(**ao_args), bound,
                bound_by, float(d.max()), m_hit)
        b2_dense = got
        del args, want, sh, sh_want, d

    with phase("10 512^3 G-buffer frames (bench_volumes.py), 20 each"):
        for tag, g, rcfg, ao in (
                ("512^3 G-buffer", grid512, cfg512, False),
                ("512^3 G-buffer + full-res bf16 AO", grid512_ao, ao512,
                 True),
                ("512^3 G-buffer + coarse uint8 AO", grid512_c, ao512,
                 True)):
            def run(i, g=g, rcfg=rcfg):
                return render_gbuffer_sweep(g, cam_at(0.05 * i),
                                            cam_at(0.05 * i - 0.03), rcfg)

            fr, launches = drive(run, 20, tag, counters)
            want = {"sweep_march_tiled": 20}
            if ao:
                want["ao_capture_tiled"] = 20
            expect(launches, want, tag)
            add(launches)
            hit = fr[..., 3] > 0.5
            if not bool(torch.isfinite(fr).all()) or not bool(hit.any()):
                raise RuntimeError(f"[{tag}] non-finite or empty G-buffer")
            ao_hit = fr[..., 10][hit]
            log(f"[{tag}] mask share {float(hit.float().mean()):.4f}, AO on "
                f"hits: min {float(ao_hit.min()):.4f}, mean "
                f"{float(ao_hit.mean()):.4f}")
            if ao and not bool((ao_hit < 1.0).any()):
                raise RuntimeError(f"[{tag}] the AO channel is 1 on every "
                                   f"hit")
        del fr

    with phase("11 main path at 512^3: run00015 through InferencePipeline"):
        lm15 = LoadedModel.from_run_dir(str(ROOT / "artifacts" / "run00015"),
                                        device="cuda")
        m15 = lm15.cfg.model
        log(f"run00015: EnhanceNet {m15.num_residual_blocks} blocks x "
            f"{m15.num_features} features, {m15.compute_dtype}")
        pipe = InferencePipeline(lm15.model, lm15.cfg, cfg512,
                                 device="cuda")
        if not pipe.use_planar:
            raise RuntimeError("planar 'auto' did not select the planar "
                               "engine for run00015")
        rgb, launches = drive(
            lambda i: pipe.frame(grid512, cam_at(0.03 * i)), 20,
            "512^3 planar f32 (run00015)", counters)
        check_rgb(rgb, pipe.state.prev_high[..., 0:16] > 0.0,
                  (1080, 1920, 3))
        expect(launches, {"sweep_march_tiled": 20}, "512^3 planar f32")
        add(launches)
        del pipe, grid512_c

    with phase("12 small tiled frames: card vs CPU"):
        tiny = RenderConfig(width=64, height=48, isovalue=0.36,
                            renderer="sweep_pallas", sweep_oversample=1.25,
                            sweep_dtype="bfloat16", sweep_tile=16,
                            ao_samples=64, ao_mode="volume")
        coarse48 = attach_baked_ao(
            analytic.blobs_volume(48, device="cuda"), 0.36, 0.2,
            downsample=2, keep_coarse=True, out_dtype="uint8")
        outs = {}
        for dev in ("cuda", "cpu"):
            g = dataclasses.replace(
                analytic.blobs_volume(48, device=dev),
                ao_sh=coarse48.ao_sh.to(dev), ao_scale=coarse48.ao_scale,
                ao_offset=coarse48.ao_offset, ao_downsample=2)
            ff = FusedFrame(lm15.model.to(dev), lm15.cfg, tiny, planar="off",
                            device=dev)
            st = initial_state(lm15.cfg, tiny, planar="off", device=dev)
            before = sweep_tiled.ao_capture_tiled_kernel.launches
            for i in range(3):
                rgb_s, fr_s, st = ff(g, cam_at(0.05 * i),
                                     cam_at(0.05 * i - 0.03), st)
            if dev == "cuda" and (sweep_tiled.ao_capture_tiled_kernel.launches
                                  != before + 3):
                raise RuntimeError("the small tiled frames did not launch "
                                   "the tiled AO capture")
            outs[dev] = (rgb_s.cpu(), fr_s.cpu())
        check_card_vs_cpu("tiled 48^3, sweep_tile 16, coarse uint8 AO", outs,
                          True)
        lm15.model.to("cuda")

    with phase("13 packed 512^3 volumes (bench_volumes.py --sparse)"):
        def pack(tag, g):
            torch.cuda.synchronize()
            t = time.time()
            sg = SparseBrickGrid.from_brick_grid(g, tolerance=1e-3)
            torch.cuda.synchronize()
            secs = time.time() - t
            dense = sg.dense_bytes()
            vol_bytes = sum(pa.atlas.numel() * pa.atlas.element_size()
                            + pa.slots.numel() * 4 for pa in sg.per_axis)
            log(f"[{tag}] packed in {secs:.2f} s: atlases "
                f"{[pa.atlas.shape[0] for pa in sg.per_axis]} tiles of "
                f"{sg.per_axis[0].tile_shape} {sg.per_axis[0].atlas.dtype}, "
                f"slot occupancy per axis "
                f"{[round(float((pa.slots > 0).float().mean()), 4) for pa in sg.per_axis]}"
                f"; density storage {vol_bytes / dense:.3f}x dense "
                f"({vol_bytes / 1e6:.1f} MB of {dense / 1e6:.1f} MB)")
            if sg.ao_per_axis is not None:
                log(f"[{tag}] AO atlases "
                    f"{[pa.atlas.shape[0] for pa in sg.ao_per_axis]} tiles "
                    f"of {sg.ao_per_axis[0].tile_shape} "
                    f"{sg.ao_per_axis[0].atlas.dtype}, slot occupancy "
                    f"{[round(float((pa.slots > 0).float().mean()), 4) for pa in sg.ao_per_axis]}")
            log(f"[{tag}] storage_bytes() / dense_bytes() = "
                f"{sg.storage_bytes() / dense:.3f} "
                f"({sg.storage_bytes() / 1e6:.1f} MB)")
            return sg

        packed512 = pack("blobs 512^3 uint8", grid512)
        packed512_ao = pack("blobs 512^3 uint8 + full-res bf16 AO",
                            grid512_ao)
        del grid512_ao
        t = time.time()
        ejecta = analytic.ejecta_volume(512, store_dtype="uint8",
                                        device="cuda")
        torch.cuda.synchronize()
        log(f"ejecta_volume(512) stored uint8 (numpy on the host, the brick "
            f"pyramid included): {time.time() - t:.1f} s; occupied bricks at "
            f"iso 0.36: "
            f"{float((ejecta.brick_max >= 0.36).float().mean()):.3f}")
        packed_ej = pack("ejecta 512^3 uint8", ejecta)
        del ejecta

    with phase("14 packed kernels vs plain at 512^3"):
        plan = plan_sweep(packed512, cam_at(0.0), cfg512, rp512)
        args = packed_inputs(packed512, plan, cfg512, rp512)
        pa = args["packed_axis"]
        plain = {k: v for k, v in args.items() if k != "table"}
        got = sweep_tiled.march_packed(**args)
        torch.cuda.synchronize()
        want = sweep_tiled.march_packed_plain(**plain)
        torch.cuda.synchronize()
        err, mismatch = check_march("B3 bf16 uint8-atlas", got, want)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, b2_dense))
        log(f"[B3] the packed uint8 grid against B2 on the dense grid: "
            f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            raise RuntimeError("B3 on the lossless packing differs from B2 "
                               "on the dense grid")
        tables = sweep_tiled.march_tables(
            pa.shape, args["meta"], args["brick_max_p"], args["brick_size"],
            args["iso"], max(pa.tile_shape))
        if tables[:2] != pa.tile_shape:
            raise RuntimeError("the march tables' tiles are not the atlas's")
        atlas = sweep_tiled.kernel_atlas(pa, torch.uint8)
        kargs = (atlas, pa.slots, args["meta"], args["s_grid"],
                 args["t_grid"], args["Sn"], args["Tn"], args["table"],
                 args["iso"], args["dtype"], args["scale"], args["offset"])
        ms = time_cuda(lambda: sweep_tiled.march_packed_kernel(*kargs), 7)
        wrapper_ms = time_cuda(lambda: sweep_tiled.march_packed(**args), 7)
        plain_ms = time_cuda(lambda: sweep_tiled.march_packed_plain(**plain),
                             3)
        bound, bound_by = tiled_bound_ms(args, got, tables, pa.shape,
                                         atlas.element_size(), pa.slots)
        march_line("B3", ms, plain_ms, bound, bound_by, mismatch,
                   wrapper_ms)
        rows["packed"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": None}
        m_hit = got[0]
        pao = packed512_ao.ao_per_axis[SWEEP_PERMS.index(plan.perm)]
        ao_args = dict(packed_ao=pao, meta=args["meta"],
                       s_grid=args["s_grid"], t_grid=args["t_grid"],
                       Sn=args["Sn"], Tn=args["Tn"], m_hit=m_hit,
                       dtype=args["dtype"])
        sh = sweep_tiled.ao_capture_packed(**ao_args)
        torch.cuda.synchronize()
        sh_want = sweep_tiled.ao_capture_packed_plain(**ao_args)
        torch.cuda.synchronize()
        hit = m_hit >= 0
        d = (sh - sh_want).abs()
        excess = float((d - MAX_SH_REL * sh_want.abs()).max())
        ok = (excess <= 1e-6 and bool((sh[:, ~hit] == 0).all())
              and bool((sh_want[:, hit] != 0).any()))
        log(f"[B4p] max |diff| {float(d.max()):.3g}, bound |diff| <= 1e-6 + "
            f"{MAX_SH_REL:.3g} |sh| (excess {excess:.3g}), 0 where no hit: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise RuntimeError("ao_capture_packed disagrees with its plain "
                               "version")
        ao_atlas = sweep_tiled.kernel_atlas(pao, args["dtype"])
        kargs = (ao_atlas, pao.slots, args["meta"], args["s_grid"],
                 args["t_grid"], m_hit, args["dtype"])
        TX, TY, occ, counts, _, _ = sweep_tiled.ao_packed_tables(
            pao, args["meta"], m_hit)
        # the slot entries B4p reads: planes zf and zf + 1 of kept pairs
        k, pid = torch.nonzero(occ.flatten(1), as_tuple=True)
        zf = args["meta"][k, 2].long()
        entries = torch.unique(torch.cat([zf, zf + 1]) * occ[0].numel()
                               + torch.cat([pid, pid])).numel()
        bound, bound_by = ao_tiled_bound_ms(
            (pao.shape[0], 4) + tuple(pao.shape[1:]),
            ao_atlas.element_size(), args["meta"], args["s_grid"],
            args["t_grid"], m_hit, 1, (TX, TY, occ, counts, args["meta"]),
            entries * 4)
        log(f"[B4p] kept pairs {int(occ.sum())} on {int((counts > 0).sum())} "
            f"slices (the wrapper's atlas cast once and kept)")
        rows["ao_packed"] = capture_row(
            "B4p", lambda: sweep_tiled.ao_capture_packed_kernel(*kargs),
            lambda: sweep_tiled.ao_capture_packed(**ao_args),
            lambda: sweep_tiled.ao_capture_packed_plain(**ao_args), bound,
            bound_by, float(d.max()), m_hit)
        del args, got, want, b2_dense, sh, sh_want, d

    with phase("15 packed 512^3 G-buffer frames, 20 each"):
        for tag, g, rcfg, ao in (
                ("packed 512^3 G-buffer", packed512, cfg512, False),
                ("packed 512^3 G-buffer + packed bf16 AO", packed512_ao,
                 ao512, True),
                ("packed ejecta 512^3 G-buffer", packed_ej, cfg512, False)):
            def run(i, g=g, rcfg=rcfg):
                return render_gbuffer_sweep(g, cam_at(0.05 * i),
                                            cam_at(0.05 * i - 0.03), rcfg)

            fr, launches = drive(run, 20, tag, counters)
            want = {"sweep_march_packed": 20}
            if ao:
                want["ao_capture_packed"] = 20
            expect(launches, want, tag)
            add(launches)
            hit = fr[..., 3] > 0.5
            if not bool(torch.isfinite(fr).all()) or not bool(hit.any()):
                raise RuntimeError(f"[{tag}] non-finite or empty G-buffer")
            ao_hit = fr[..., 10][hit]
            log(f"[{tag}] mask share {float(hit.float().mean()):.4f}, AO on "
                f"hits: min {float(ao_hit.min()):.4f}, mean "
                f"{float(ao_hit.mean()):.4f}")
            if ao and not bool((ao_hit < 1.0).any()):
                raise RuntimeError(f"[{tag}] the AO channel is 1 on every "
                                   f"hit")
        log("dense 512^3 G-buffer frames (phase 10) for comparison: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in FRAME_MS.items()
                        if k.startswith("512^3 G-buffer")))
        del fr, packed512_ao, packed_ej

    with phase("16 main path on the packed 512^3 blobs: run00015, 20 frames"):
        pipe = InferencePipeline(lm15.model, lm15.cfg, cfg512,
                                 device="cuda")
        rgb, launches = drive(
            lambda i: pipe.frame(packed512, cam_at(0.03 * i)), 20,
            "packed 512^3 planar f32 (run00015)", counters)
        check_rgb(rgb, pipe.state.prev_high[..., 0:16] > 0.0,
                  (1080, 1920, 3))
        expect(launches, {"sweep_march_packed": 20}, "packed 512^3 planar")
        add(launches)
        copies = {}
        for tag, g in (("dense", grid512), ("packed", packed512)):
            pipe.reset()
            copies[tag] = copy_ms(lambda i, g=g: pipe.frame(
                g, cam_at(0.03 * i)))
        log(f"[512^3 main path] ms/frame: dense (phase 11) "
            f"{FRAME_MS['512^3 planar f32 (run00015)']:.2f}, packed "
            f"{FRAME_MS['packed 512^3 planar f32 (run00015)']:.2f}; device "
            f"ms/frame of copies (of all kernels), torch.profiler over 5 "
            f"frames: " + ", ".join(f"{k} {c:.3f} ({b:.2f})"
                                    for k, (c, b) in copies.items()))
        del pipe, grid512, packed512

    with phase("17 small packed frames: card vs CPU"):
        tiny_p = RenderConfig(width=64, height=48, isovalue=0.36,
                              renderer="sweep_pallas", sweep_oversample=1.25,
                              sweep_dtype="bfloat16", ao_samples=64,
                              ao_mode="volume")
        field48 = attach_baked_ao(analytic.blobs_volume(48, device="cuda"),
                                  0.36, 0.2).ao_sh
        outs = {}
        for dev in ("cuda", "cpu"):
            g = SparseBrickGrid.from_brick_grid(
                dataclasses.replace(analytic.blobs_volume(48, device=dev),
                                    ao_sh=field48.to(dev)),
                tile=16, tolerance=1e-3, ao_tile=16)
            ff = FusedFrame(lm15.model.to(dev), lm15.cfg, tiny_p,
                            planar="off", device=dev)
            st = initial_state(lm15.cfg, tiny_p, planar="off", device=dev)
            before = (sweep_tiled.march_packed_kernel.launches,
                      sweep_tiled.ao_capture_packed_kernel.launches)
            for i in range(3):
                rgb_s, fr_s, st = ff(g, cam_at(0.05 * i),
                                     cam_at(0.05 * i - 0.03), st)
            after = (sweep_tiled.march_packed_kernel.launches,
                     sweep_tiled.ao_capture_packed_kernel.launches)
            if dev == "cuda" and after != (before[0] + 3, before[1] + 3):
                raise RuntimeError("the small packed frames did not launch "
                                   "B3 and B4p once each per frame")
            outs[dev] = (rgb_s.cpu(), fr_s.cpu())
        check_card_vs_cpu("packed 48^3, tiles 16, packed AO", outs, True)
        lm15.model.to("cuda")

    bf16 = torch.bfloat16
    with phase("18 the 3x3 conv kernels B6 and B7 at full width"):
        sd = lm.model.state_dict()

        def hwio(name):
            return sd[f"{name}.weight"].permute(2, 3, 1, 0).contiguous()

        gen = torch.Generator(device="cuda").manual_seed(18)
        # run00017's composed post3 kernel, the one the dense planar tail
        # convolves, on F2's post-ReLU output at 540 x 960
        k3c, b3c = planar_mod._tail_kernel(hwio("post3"), sd["post3.bias"])
        x3 = torch.rand((1, 540, 960, 256), device="cuda", generator=gen
                        ).to(bf16)
        # the trunk at 270 x 480: 64 channels, zero-padded to 128 lanes for
        # B6, pixel pairs packed for B7
        x64 = torch.rand((1, 270, 480, 64), device="cuda", generator=gen
                         ).to(bf16)
        k0, b0 = hwio("block0_conv1"), sd["block0_conv1.bias"]
        x128 = p128.pad_lanes(x64)
        k128 = p128.pad_lanes(p128.pad_lanes(k0, axis=2), axis=3)
        b128 = p128.pad_lanes(b0)
        outs18 = {}
        for tag, x, k, b in (("post3", x3, k3c, b3c),
                             ("trunk", x128, k128, b128)):
            _, h, w, cin = x.shape
            cout = k.shape[3]
            got = p128.conv3x3_pallas_p128(x, k, b, relu=True)
            torch.cuda.synchronize()
            want = p128.conv3x3_p128_plain(x, k, b, relu=True)
            err = check_conv(f"conv3x3_p128 {tag}", got, want)
            outs18[tag] = got
            kb = k.to(bf16).contiguous()
            bf = b.float().contiguous()
            xc = profile_convs.cudnn_input(x)
            kc = profile_convs.cudnn_weight(k)
            bc = b.to(bf16)
            ms, lib_ms, k_turns, lib_turns = time_turns(
                lambda: p128.conv3x3_p128_kernel(x, kb, bf, True, bf16),
                lambda: F.conv2d(xc, kc, bc, padding=1), 7)
            idle_ms = time_cuda(lambda: p128.conv3x3_p128_kernel(
                x, kb, bf, True, bf16), 7)
            plain_ms = time_cuda(lambda: p128.conv3x3_p128_plain(
                x, k, b, relu=True), 3)
            bound, bound_by = conv_bound_ms(h, w, cin, cout, 2)
            flops = 2.0 * h * w * cin * cout * 9
            log(f"[conv3x3_p128 {tag}] ({h}, {w}) {cin} -> {cout}, bf16 out, "
                f"ReLU: kernel {ms:.4f} ms (turns {k_turns[0]:.4f}, "
                f"{k_turns[1]:.4f}; 7 calls each; "
                f"{flops / ms / 1e9:.1f} TFLOP/s), {bound / ms:.3f} of its "
                f"bound {bound:.4f} ms by {bound_by}; plain {plain_ms:.2f} "
                f"ms (median of 3); library (F.conv2d bf16 channels-last "
                f"with bias, no ReLU) {lib_ms:.4f} ms (turns "
                f"{lib_turns[0]:.4f}, {lib_turns[1]:.4f}); kernel / "
                f"library {ms / lib_ms:.2f}; single calls from an idle "
                f"queue, host launch included (as PR 8 timed): "
                f"{idle_ms:.4f} ms")
            rows[f"conv3x3_p128 {tag}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms}
            del got, want, xc, kc

        # post3 with float32 output: two staging passes a tile
        got = p128.conv3x3_pallas_p128(x3, k3c, b3c, relu=True,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = p128.conv3x3_p128_plain(x3, k3c, b3c, relu=True,
                                       out_dtype=torch.float32)
        check_conv("conv3x3_p128 post3 float32 out", got, want)
        del got, want
        kb, bf = k3c.to(bf16).contiguous(), b3c.float().contiguous()
        ms = statistics.median(time_samples(
            lambda: p128.conv3x3_p128_kernel(x3, kb, bf, True,
                                             torch.float32), 7, backlog=True))
        bound, bound_by = conv_bound_ms(540, 960, 256, 256, 4)
        flops = 2.0 * 540 * 960 * 256 * 256 * 9
        log(f"[conv3x3_p128 post3 float32 out] kernel {ms:.4f} ms (median "
            f"of 7 behind a backlog; {flops / ms / 1e9:.1f} TFLOP/s), "
            f"{bound / ms:.3f} of its bound {bound:.4f} ms by {bound_by}")

        got = p128.conv3x3_packed(x64, k0, b0, relu=True)
        torch.cuda.synchronize()
        want = torch.relu(p128.conv3x3_f32(
            x64[0].float(), k0.to(bf16).float()) + b0)[None].to(bf16)
        check_conv("conv3x3_packed block0_conv1", got, want)
        outs18["packed"] = got

        # B7 on each trunk kernel in turn (ReLU after conv1 as in the
        # network), each launch held against its plain version on the
        # same input
        trunk = [(f"block{i}_conv{j}", j == 1)
                 for i in range(m.num_residual_blocks) for j in (1, 2)]
        xp0 = pk.pack_pairs(torch.rand((1, 270, 480, 64), device="cuda",
                                       generator=gen).to(bf16))
        y, b7_err, b7_outs = xp0, 0.0, []
        for name, relu in trunk:
            k, b = hwio(name), sd[f"{name}.bias"]
            got = pk.packed_conv3x3(y, k, b, relu=relu)
            torch.cuda.synchronize()
            want = pk.packed_conv3x3_plain(y, k, b, relu=relu)
            b7_err = max(b7_err, check_conv(f"packed_conv3x3 {name}", got,
                                            want))
            b7_outs.append(got)
            y = got
        kb, bf = k0.to(bf16).contiguous(), b0.float().contiguous()
        xc = profile_convs.cudnn_input(pk.unpack_pairs(xp0))
        kc = profile_convs.cudnn_weight(k0)
        bc = b0.to(bf16)
        ms, lib_ms, k_turns, lib_turns = time_turns(
            lambda: pk.packed_conv3x3_kernel(xp0, kb, bf, True, bf16),
            lambda: F.conv2d(xc, kc, bc, padding=1), 7)
        idle_ms = time_cuda(lambda: pk.packed_conv3x3_kernel(
            xp0, kb, bf, True, bf16), 7)
        plain_ms = time_cuda(lambda: pk.packed_conv3x3_plain(
            xp0, k0, b0, relu=True), 3)
        bound, bound_by = conv_bound_ms(270, 480, 64, 64, 2)
        log(f"[packed_conv3x3] {len(trunk)} trunk kernels held; "
            f"block0_conv1 at (270, 240, 128): kernel {ms:.4f} ms (turns "
            f"{k_turns[0]:.4f}, {k_turns[1]:.4f}; 7 calls each; "
            f"{2.0 * 270 * 480 * 64 * 64 * 9 / ms / 1e9:.1f} TFLOP/s), "
            f"{bound / ms:.3f} of its bound {bound:.4f} ms by {bound_by}; "
            f"plain {plain_ms:.2f} ms (median of 3); library (F.conv2d "
            f"bf16 channels-last with bias, no ReLU) {lib_ms:.4f} ms "
            f"(turns {lib_turns[0]:.4f}, {lib_turns[1]:.4f}); kernel / "
            f"library {ms / lib_ms:.2f}; single calls from an idle queue, "
            f"host launch included (as PR 8 timed): {idle_ms:.4f} ms")
        wrap_us = host_us(lambda: pk.packed_conv3x3(xp0, kb, bf, relu=True))
        entry_us = host_us(lambda: pk.packed_conv3x3_kernel(
            xp0, kb, bf, True, bf16))
        log(f"[packed_conv3x3] host time of one call while the card is "
            f"busy (mean of 200, no sync): the wrapper `packed_conv3x3` "
            f"{wrap_us:.1f} us, its launch entry `packed_conv3x3_kernel` "
            f"{entry_us:.1f} us, against the kernel's {ms * 1e3:.1f} us "
            f"on the card")
        rows["packed_conv3x3"] = {"max_abs_err": b7_err, "ms": ms,
                                  "plain_ms": plain_ms, "bound_ms": bound,
                                  "bound_by": bound_by, "library_ms": lib_ms}
        del xc, kc

        # the 20-conv chain of profile_convs (profile_packed.py's inputs)
        xr, ks, bz = profile_convs.packed_chain_inputs()
        kbs = [k.to(bf16) for k in ks]
        kcs = [profile_convs.cudnn_weight(k) for k in ks]
        xrc = profile_convs.cudnn_input(xr)

        def b7_chain():
            y = pk.pack_pairs(xr)
            for k in kbs:
                y = pk.packed_conv3x3(y, k, bz, relu=True)
            return y

        def cudnn_chain():
            y = xrc
            for k in kcs:
                y = torch.relu(F.conv2d(y, k, padding=1))
            return y

        chain_ms, cudnn_chain_ms, k_turns, lib_turns = time_turns(
            b7_chain, cudnn_chain, 5)
        # as a caller sees them: from an idle queue, the host included
        called = [time_cuda(f, 5) for f in (cudnn_chain, b7_chain,
                                            b7_chain, cudnn_chain)]
        log(f"[packed_conv3x3] chain of 20 at (270, 480) 64 -> 64 with "
            f"ReLU: B7 {chain_ms:.3f} ms (turns {k_turns[0]:.3f}, "
            f"{k_turns[1]:.3f}; 5 chains each), cuDNN (conv + ReLU, bf16 "
            f"channels-last) {cudnn_chain_ms:.3f} ms (turns "
            f"{lib_turns[0]:.3f}, {lib_turns[1]:.3f}); B7 / cuDNN "
            f"{chain_ms / cudnn_chain_ms:.2f}; as called from an idle "
            f"queue, host included: B7 {called[1]:.3f}, {called[2]:.3f} "
            f"ms, cuDNN {called[0]:.3f}, {called[3]:.3f} ms")
        del xr, ks, kbs, kcs, xrc

        # the path: the entry points at these widths, launches counted
        for holder, attr in counters.values():
            setattr(holder, attr, 0)
        y3 = port_ops.conv3x3(x3, k3c, b3c, relu=True)
        y64 = port_ops.conv3x3(x64, k0, b0, relu=True)
        yp = p128.conv3x3_packed(x64, k0, b0, relu=True)
        y, chain = xp0, []
        for name, relu in trunk:
            y = pk.packed_conv3x3(y, hwio(name), sd[f"{name}.bias"],
                                  relu=relu)
            chain.append(y)
        torch.cuda.synchronize()
        launches = {k: getattr(h, a) for k, (h, a) in counters.items()}
        log(f"[conv path] launches {launches}")
        expect(launches, {"conv3x3_p128": 3,
                          "packed_conv3x3": len(trunk)}, "conv path")
        add(launches)
        same = (torch.equal(y3, outs18["post3"])
                and torch.equal(y64, outs18["trunk"][..., :64])
                and torch.equal(yp, outs18["packed"])
                and all(torch.equal(a, b) for a, b in zip(chain, b7_outs)))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (y3, y64, yp, *chain))
        log(f"[conv path] outputs equal the held launches' bit for bit: "
            f"{same}; finite: {finite}")
        if not (same and finite):
            raise RuntimeError("the conv path's outputs differ from the "
                               "held launches' or are not finite")
        del x3, x64, x128, xp0, y3, y64, yp, chain, b7_outs, outs18, got
        del want, y

    with phase("19 bench --int8 frames: run00017 bf16 int8, 20 frames"):
        cfg19 = Config(model=dataclasses.replace(
            m, compute_dtype="bfloat16", planar_int8=True))
        pipe = InferencePipeline(lm.model, cfg19, frame_cfg, device="cuda")
        if not (pipe.use_planar and pipe._frame.planar_net.int8):
            raise RuntimeError("the int8 planar engine did not run")
        rgb8, launches = drive(lambda i: pipe.frame(grid, cam_at(0.03 * i)),
                               20, "int8 bf16", counters)
        check_rgb(rgb8, pipe.state.prev_high[..., 0:16] > 0.0,
                  (1080, 1920, 3))
        expect(launches, {"sweep_march": 20}, "int8 bf16")
        add(launches)
        log(f"[int8 bf16] launches per frame: "
            + ", ".join(f"{k} {v / 20:g}" for k, v in launches.items() if v))
        cfg_f = Config(model=dataclasses.replace(m, compute_dtype="bfloat16"))
        pipe_f = InferencePipeline(lm.model, cfg_f, frame_cfg, device="cuda")
        rgb_f, launches = drive(lambda i: pipe_f.frame(grid,
                                                       cam_at(0.03 * i)),
                                20, "planar bf16", counters)
        expect(launches, {"sweep_march": 20}, "planar bf16")
        add(launches)
        d = (rgb8.float() - rgb_f.float()).abs()
        log(f"[int8 bf16] frame 20 against the float bf16 frame at the same "
            f"cameras: max |diff| {float(d.max()):.4f}, mean "
            f"{float(d.mean()):.5f}, share > 0.05: "
            f"{float((d > 0.05).float().mean()):.4f}; ms/frame int8 "
            f"{FRAME_MS['int8 bf16']:.2f}, float bf16 "
            f"{FRAME_MS['planar bf16']:.2f}")
        del pipe, pipe_f, rgb8, rgb_f, d

    with phase("20 small int8 and use_sn frames: card vs CPU"):
        for tag, cfg in (
                ("planar int8 bf16", Config(model=dataclasses.replace(
                    m, compute_dtype="bfloat16", planar_int8=True))),
                ("planar use_sn f32", Config(model=dataclasses.replace(
                    m, use_sn=True)))):
            outs = {}
            for dev in ("cuda", "cpu"):
                g = analytic.blobs_volume(64, num_blobs=8, device=dev)
                ff = FusedFrame(lm.model.to(dev), cfg, small_cfg,
                                planar="on", device=dev)
                st = initial_state(cfg, small_cfg, planar="on", device=dev)
                for i in range(3):
                    rgb_s, fr_s, st = ff(g, cam_at(0.03 * i),
                                         cam_at(0.03 * (i - 1)), st)
                outs[dev] = (rgb_s.cpu(), fr_s.cpu())
            lm.model.to("cuda")
            check_card_vs_cpu(tag, outs, False)

    run17 = str(ROOT / "artifacts" / "run00017")
    with phase("21 the loader at full width: run00017 fast and unfused, "
               ".pth round trip"):
        lm_fast = LoadedModel.from_run_dir(run17, fast=True, device="cuda")
        if not (lm_fast.cfg.model.fused_upsample and lm_fast.model.fuse):
            raise RuntimeError("fast=True did not select the fused upsample")
        firsts = {}
        for tag, lmx, fast_warp in (
                ("non-planar unfused", lm, True),
                ("non-planar fast", lm_fast, True),
                ("non-planar exact warp", lm, False)):
            ff = FusedFrame(lmx.model, lmx.cfg, frame_cfg, planar="off",
                            device="cuda", fast_warp=fast_warp)
            st = [initial_state(lmx.cfg, frame_cfg, planar="off",
                                device="cuda")]
            firsts[tag] = ff(grid, cam_at(0.0), cam_at(0.0), st[0])[0]

            def nonplanar21(i, ff=ff, st=st):
                rgb, _, st[0] = ff(grid, cam_at(0.03 * i),
                                   cam_at(0.03 * max(i - 1, 0)), st[0])
                return rgb

            rgb, launches = drive(nonplanar21, 10, tag, counters)
            check_rgb(rgb, st[0].prev_high[..., 0] > 0.0, (1080, 1920, 3))
            expect(launches, {"sweep_march": 10}, tag)
            add(launches)
            del ff, st
        d = (firsts["non-planar fast"] - firsts["non-planar unfused"]).abs()
        inner = float(d[8:-8, 8:-8].max())
        log(f"[loader] first frame, fast vs unfused rgb: max |diff| "
            f"{float(d.max()):.3g} overall, {inner:.3g} in the interior "
            f"(8 px border excluded; bound {MAX_FUSED_INTERIOR}); ms/frame "
            f"fast {FRAME_MS['non-planar fast']:.2f}, unfused "
            f"{FRAME_MS['non-planar unfused']:.2f}, unfused with the exact "
            f"gather warp {FRAME_MS['non-planar exact warp']:.2f}")
        if inner > MAX_FUSED_INTERIOR:
            raise RuntimeError("the fused and unfused networks disagree "
                               "in the interior")
        outs21 = []
        for lmx in (lm, lm_fast):
            pipe = InferencePipeline(lmx.model, lmx.cfg, frame_cfg,
                                     device="cuda")
            outs21.append([pipe.frame(grid, cam_at(0.03 * i))
                           for i in range(3)])
            del pipe
        same = all(torch.equal(a, b) for a, b in zip(*outs21))
        log(f"[loader] planar frames of fast=True equal the main path's "
            f"bit for bit (3 frames): {same}")
        if not same:
            raise RuntimeError("fast=True changed the planar frame")
        pth = ROOT / "build" / "run00017.pth"
        pth.parent.mkdir(parents=True, exist_ok=True)
        torch_export.export_reference_pth(lm, str(pth))
        lm_pth = LoadedModel.from_run_dir(str(pth), device="cuda")
        a, b = lm.model.state_dict(), lm_pth.model.state_dict()
        same_w = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                              for k in a)
        rgbs = []
        for lmx in (lm, lm_pth):
            ff = FusedFrame(lmx.model, lmx.cfg, frame_cfg, planar="off",
                            device="cuda")
            rgbs.append(ff(grid, cam_at(0.0), cam_at(0.0), initial_state(
                lmx.cfg, frame_cfg, planar="off", device="cuda"))[0])
        same_f = torch.equal(*rgbs)
        log(f"[loader] {pth.name} ({pth.stat().st_size} bytes) read back "
            f"through from_run_dir: {len(b)} weights equal bit for bit: "
            f"{same_w}; a non-planar frame equal bit for bit: {same_f}")
        if not (same_w and same_f and not lm_pth.bare_input):
            raise RuntimeError("the .pth round trip changed the model")
        del lm_pth, outs21, rgbs, firsts, d

    with phase("22 the GUI's modes: bicubic, and set_render_params on the "
               "main path"):
        pipe = InferencePipeline(lm.model, lm.cfg, frame_cfg,
                                 upscale_mode="bicubic", device="cuda")
        rgb, launches = drive(lambda i: pipe.frame(grid, cam_at(0.03 * i)),
                              20, "bicubic", counters)
        check_rgb(rgb, pipe.state.prev_high[..., 0] > 0.0, (1080, 1920, 3))
        expect(launches, {"sweep_march": 20}, "bicubic")
        add(launches)
        pipe = InferencePipeline(lm.model, lm.cfg, frame_cfg, device="cuda")
        frame22, tables22 = pipe._frame, pipe._frame.planar_tables
        net22 = pipe._frame.planar_net
        shares = {}

        def slider(i):
            if i == 10:
                pipe.set_render_params(isovalue=ISO_SLIDER)
            rgb = pipe.frame(grid, cam_at(0.03 * i))
            if i in (9, 19):
                shares[i] = (pipe.state.prev_high[..., 0:16] > 0.0).float(
                ).mean()
            return rgb

        rgb, launches = drive(slider, 20, "planar f32 + isovalue slider",
                              counters)
        check_rgb(rgb, pipe.state.prev_high[..., 0:16] > 0.0,
                  (1080, 1920, 3))
        expect(launches, {"sweep_march": 20}, "planar f32 + isovalue slider")
        add(launches)
        cam19, cam18 = cam_at(0.03 * 19), cam_at(0.03 * 18)
        g_old = render_gbuffer_sweep(grid, cam19, cam18, frame_cfg)
        g_new = render_gbuffer_sweep(grid, cam19, cam18, frame_cfg,
                                     pipe.render_params)
        m_old, m_new = (float((g[..., 3] > 0.5).float().mean())
                        for g in (g_old, g_new))
        moved = float(((g_old[..., 3] > 0.5) != (g_new[..., 3] > 0.5)
                       ).float().mean())
        s9, s19 = float(shares[9]), float(shares[19])
        kept = (pipe._frame is frame22 and frame22.planar_tables is tables22
                and frame22.planar_net is net22)
        log(f"[slider] isovalue {frame_cfg.isovalue} -> {ISO_SLIDER} after "
            f"frame 10: G-buffer mask share at frame 20's camera {m_old:.4f}"
            f" -> {m_new:.4f} ({moved:.4f} of the pixels changed); the "
            f"state's mask share frame 10 {s9:.4f}, "
            f"frame 20 {s19:.4f}; FusedFrame, planar tables and weights "
            f"kept: {kept}; ms/frame {FRAME_MS['planar f32 + isovalue slider']:.2f}"
            f" (bicubic {FRAME_MS['bicubic']:.2f})")
        if not (kept and moved > 1e-3
                and abs(s19 - m_new) < abs(s19 - m_old)):
            raise RuntimeError("set_render_params did not reach the frame "
                               "or rebuilt it")
        del pipe, frame22, tables22, net22, g_old, g_new

    with phase("23 LoadedModel.inference with the exact warp, 10 steps"):
        lows, flows = [], []
        for i in range(10):
            fr = render_gbuffer_sweep(grid, cam_at(0.03 * i),
                                      cam_at(0.03 * max(i - 1, 0)), frame_cfg)
            lows.append(gbuffer_to_low_input(fr)[None])
            flows.append(inpaint_flow(fr[None, ..., 8:10],
                                      fr[None, ..., 3:4], iterations=8))
        prev = [None]

        def step(i):
            prev[0] = lm.inference(lows[i], prev[0], flows[i])
            return prev[0]

        out, launches = drive(step, 10, "inference exact warp", counters)
        expect(launches, {}, "inference exact warp")
        log(f"[inference] {FRAME_MS['inference exact warp']:.2f} ms a step "
            f"(480x270 -> 1920x1080, steps 3-10; no render, inpaint or "
            f"shading in the step)")
        if tuple(out.shape) != (1, 1080, 1920, 6) or not bool(
                torch.isfinite(out).all()):
            raise RuntimeError(f"inference: {tuple(out.shape)} or "
                               f"non-finite")
        gen = torch.Generator().manual_seed(23)
        lo = [torch.rand((1, 24, 32, 5), generator=gen) * 2 - 1
              for _ in range(2)]
        fl = torch.rand((1, 24, 32, 2), generator=gen) * 0.1 - 0.05
        res = {}
        for dev in ("cuda", "cpu"):
            lm.model.to(dev)
            p = None
            for x in lo:
                p = lm.inference(x.to(dev), p, fl.to(dev))
            res[dev] = p.cpu()
        lm.model.to("cuda")
        err = float((res["cuda"] - res["cpu"]).abs().max())
        log(f"[inference] card vs CPU, 2 steps at 32x24: max |diff| "
            f"{err:.3g} (bound {MAX_INFER_DIFF})")
        if err > MAX_INFER_DIFF:
            raise RuntimeError("inference: card and CPU disagree")
        del lows, flows, prev, out

    with phase("24 model options and the zoo: card vs CPU, full-width "
               "forwards"):
        gen = torch.Generator().manual_seed(24)
        for tag, kw in ZOO_SMALL:
            mcfg = dataclasses.replace(m, num_residual_blocks=2,
                                       num_features=16, **kw)
            torch.manual_seed(24)
            net = (create_network(mcfg) if mcfg.model != "RCAN" else
                   gen_mod.RCAN(mcfg, num_groups=2, num_blocks=2))
            for t in net.state_dict().values():
                if t.dim() == 1:     # biases, BN scales and statistics
                    t.uniform_(0.5, 1.5, generator=gen)
            net.load_state_dict(net.state_dict())   # SN: normalize again
            net.eval().requires_grad_(False)
            x = torch.rand((1, 16, 16, gen_mod.network_input_channels(mcfg)),
                           generator=gen)
            with torch.no_grad(), fp32_convs():
                want = net(x)[0]
                got = net.cuda()(x.cuda())[0].cpu()
            err = float((got - want).abs().max())
            log(f"[zoo {tag}] card vs CPU at 16x16 -> {tuple(got.shape)}: "
                f"max |diff| {err:.3g} (bound {MAX_ZOO_DIFF})")
            if err > MAX_ZOO_DIFF or got.shape != want.shape:
                raise RuntimeError(f"zoo {tag}: card and CPU disagree")
        for name in ("RCAN", "TecoGAN", "SubpixelNet"):
            mcfg = dataclasses.replace(m, model=name)
            torch.manual_seed(24)
            net = create_network(mcfg).cuda().eval().requires_grad_(False)
            x = torch.rand((1, 270, 480,
                            gen_mod.network_input_channels(mcfg)),
                           generator=gen).cuda()
            with torch.no_grad(), fp32_convs():
                ms = time_cuda(lambda: net(x), 3)
                y = net(x)[0]
            torch.cuda.synchronize()
            n_par = sum(t.numel() for t in net.parameters())
            log(f"[zoo {name} full width] {n_par} parameters, 480x270 -> "
                f"{tuple(y.shape)}: {ms:.2f} ms a forward (median of 3, "
                f"float32), finite: {bool(torch.isfinite(y).all())}")
            if tuple(y.shape) != (1, 1080, 1920, 6) or not bool(
                    torch.isfinite(y).all()):
                raise RuntimeError(f"{name} at full width: wrong shape or "
                                   f"non-finite output")
            del net, x, y

    reference_renderers(grid, counters, add, frame_cfg)
    seqs = training(lm.cfg.model, grid, counters, add)
    shaded_training(lm.cfg.model, seqs, counters, add)
    parallel_layer(grid, counters, add, frame_cfg)
    orbax_runs(grid, counters, add, frame_cfg)
    import shutil
    work = ROOT / "build" / "smoke_io"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        io = volume_io(vol512_u8, grid, work, counters, add, cfg512,
                       frame_cfg)
        del vol512_u8
        io_times = {**io["times"], **pipe_server(counters, add),
                    **cli_and_converter(io["dat"], work, counters, add),
                    **stats_harness(io["dat"], work, counters, add)}
        log("phases 35-38, seconds (ms where named): "
            + ", ".join(f"{k} {v:.3f}" for k, v in io_times.items()))
        app_times = viewer_and_apps(grid, lm, work, counters, add)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("phases 39-44, seconds (ms where named): "
        + ", ".join(f"{k} {v:.3f}" for k, v in app_times.items()))
    resume_times = resume_runs(seqs, counters, add)
    del seqs
    log("phase 45, seconds (ms where named): "
        + ", ".join(f"{k} {v:.3f}" for k, v in resume_times.items()))

    log(f"launches over the path runs of phases 4, 6, 7, 10, 11, 15, 16, "
        f"18, 19, 21, 22 and 25-45: {path_launches}")
    kernels_line = []
    for name, source, replaces, row in (
            ("sweep_march", MARCH_SOURCE, MARCH_REPLACES, rows["bfloat16"]),
            ("sweep_march_ao", MARCH_SOURCE,
             "isosurfacesuperresolution_tpu/render/sweep_pallas.py:163",
             rows["bfloat16 AO"]),
            ("phase_conv", CONV_SOURCE, PHASE_REPLACES,
             rows["phase_conv bfloat16"]),
            ("sweep_march_tiled", MARCH_SOURCE, TILED_REPLACES,
             rows["tiled"]),
            ("ao_capture_tiled", MARCH_SOURCE, AO_TILED_REPLACES,
             rows["ao_tiled full-res bf16 field"]),
            ("sweep_march_packed", MARCH_SOURCE, PACKED_REPLACES,
             rows["packed"]),
            ("ao_capture_packed", MARCH_SOURCE, AO_PACKED_REPLACES,
             rows["ao_packed"]),
            ("conv3x3_p128", CONV_SOURCE, P128_REPLACES,
             rows["conv3x3_p128 post3"]),
            ("packed_conv3x3", CONV_SOURCE, PACKED_CONV_REPLACES,
             rows["packed_conv3x3"])):
        kernels_line.append({"name": name, "route": "cuda", "source": source,
                             "replaces": replaces,
                             "launches": path_launches[name], **row})
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
