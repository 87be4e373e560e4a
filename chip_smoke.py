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
   full width (64 features, 480x270 -> 1920x1080), timed.

In phases 4, 6, 7, 10, 11, 15, 16, 18, 19 and 21-23 the launch counts
are zeroed just before each run and read just after it, and frames 3
onwards must make no host sync (`torch.cuda.set_sync_debug_mode`).  Then one JSON line
of kernel numbers, the card line, and last the device line.  Float32
matmuls and convolutions run without TF32 throughout
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    counters = {"sweep_march": (march, "launches"),
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

    log(f"launches over the path runs of phases 4, 6, 7, 10, 11, 15, 16, "
        f"18, 19, 21 and 22: {path_launches}")
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
