#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one CUDA card).

Run from the repository root:  python3 chip_smoke.py

Phases, each announced before it starts and after it ends with the elapsed
seconds; any failure ends the run with a non-zero exit code:

1. versions and the card (`nvidia-smi` name and power limit);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together);
3. each kernel vs its plain PyTorch version on the card at the shapes of
   the interactive frame (256^3 blobs, 480x270, oversample 1.25: K = 512
   slices, Sn x Tn = 600 x 338), with stated bounds, and their times;
4. the main path: the trained 10x64 EnhanceNet (artifacts/run00017) in
   `InferencePipeline` at 480x270 -> 1920x1080, renderer "sweep_pallas",
   bf16 sweep, 20 orbit frames stepping the angle by 0.03; the launch
   counts are zeroed just before and read just after, and frames 3-20
   must make no host sync (`torch.cuda.set_sync_debug_mode`);
5. the same fused frame on the card and on the CPU at a small size, which
   must agree (the CPU path is the one the tests hold against the JAX
   package).

Then one JSON line of kernel numbers, the card line, and last the device
line.  Float32 matmuls and convolutions run without TF32 throughout
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
MARCH_SOURCE = "isosurfacesuperresolution_tpu_torch/csrc/sweep_march.cu"
MARCH_REPLACES = "isosurfacesuperresolution_tpu/render/sweep_pallas.py:46"
# bounds of the kernel-vs-plain comparison: both round the same operands
# at the same points; float32 sums may differ in the last place, which can
# move a crossing where F is within rounding of the isovalue
MAX_HIT_MISMATCH = 1e-3      # share of pixels whose m_hit differs
MAX_FRAC_DIFF = 1e-3         # inverse lerp divides by F - Fm1
MAX_GRAD_DIFF = 1e-4


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


def time_cuda(fn, reps: int):
    """Median milliseconds of ``reps`` calls, each between CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def march_bound_ms(args: dict, outs) -> tuple:
    """Least time for this march on the card: its bytes (volume, table,
    grids read once, five outputs written once) over HBM bandwidth, and its
    float32 operations for THIS data (every pixel samples each kept slice
    up to its hit, plus four neighbour samples at the hit; ~40 flops per
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
    live = torch.where(hit, cum[m_hit.clamp(min=0).long()], cum[-1])
    samples = float(live.sum()) + 4.0 * float(hit.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 40.0 * samples / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_march(got, want) -> dict:
    m_got, m_want = got[0], want[0]
    mismatch = float((m_got != m_want).float().mean())
    same = (m_got == m_want) & (m_got >= 0)
    diffs = {name: float((g - w).abs()[same].max()) if bool(same.any())
             else 0.0
             for name, g, w in zip(("frac", "g_s", "g_t", "g_z"),
                                   got[1:], want[1:])}
    return {"hit_mismatch": mismatch, **diffs}


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

    from isosurfacesuperresolution_tpu_torch.config import RenderConfig
    from isosurfacesuperresolution_tpu_torch.render import sweep_march
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)
    from isosurfacesuperresolution_tpu_torch.render.sweep import (
        march_inputs, plan_sweep)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    frame_cfg = RenderConfig(width=480, height=270, isovalue=0.5,
                             ao_samples=0, renderer="sweep_pallas",
                             sweep_oversample=1.25, sweep_dtype="bfloat16")
    kernel_rows = {}
    with phase("3 kernel vs plain"):
        grid = analytic.blobs_volume(256, num_blobs=8, device="cuda")
        grid_u8 = analytic.blobs_volume(256, num_blobs=8,
                                        store_dtype="uint8", device="cuda")
        cam = cam_at(0.0)
        cases = [("bfloat16", grid), ("float32", grid),
                 ("bfloat16 uint8-volume", grid_u8)]
        for tag, g in cases:
            cfg = frame_cfg.replace(sweep_dtype=tag.split()[0])
            rp = RenderParams.from_config(cfg)
            args = march_inputs(g, plan_sweep(g, cam, cfg, rp), cfg, rp)
            K = args["meta"].shape[0]
            log(f"[{tag}] K={K} Sn={args['Sn']} Tn={args['Tn']} "
                f"scale={g.value_scale:.6g} offset={g.value_offset:.6g}")
            got = sweep_march.march(**args)
            torch.cuda.synchronize()
            want = sweep_march.march_plain(**args)
            torch.cuda.synchronize()
            cmp = compare_march(got, want)
            log(f"[{tag}] hits {float((got[0] >= 0).float().mean()):.4f}, "
                + ", ".join(f"{k} {v:.3g}" for k, v in cmp.items()))
            ok = (cmp["hit_mismatch"] <= MAX_HIT_MISMATCH
                  and cmp["frac"] <= MAX_FRAC_DIFF
                  and max(cmp["g_s"], cmp["g_t"], cmp["g_z"])
                  <= MAX_GRAD_DIFF)
            log(f"[{tag}] bounds: m_hit mismatch <= {MAX_HIT_MISMATCH}, "
                f"|frac| <= {MAX_FRAC_DIFF}, |g_*| <= {MAX_GRAD_DIFF} "
                f"where both hit the same slice: "
                f"{'ok' if ok else 'FAILED'}")
            if not ok:
                raise RuntimeError(f"sweep_march disagrees with its plain "
                                   f"version ({tag})")
            ms = time_cuda(lambda: sweep_march.march(**args), 7)
            plain_ms = time_cuda(lambda: sweep_march.march_plain(**args), 3)
            bound, bound_by = march_bound_ms(args, got)
            log(f"[{tag}] kernel {ms:.3f} ms (median of 7), plain "
                f"{plain_ms:.1f} ms (median of 3), bound {bound:.4f} ms "
                f"by {bound_by}")
            kernel_rows[tag] = {
                "max_abs_err": max(cmp["frac"], cmp["g_s"], cmp["g_t"],
                                   cmp["g_z"]),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by}
        del grid_u8

    with phase("4 main path: 20 frames of the trained 10x64 EnhanceNet"):
        from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
            LoadedModel)
        from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
            InferencePipeline)
        lm = LoadedModel.from_run_dir(str(ROOT / "artifacts" / "run00017"),
                                      device="cuda")
        m = lm.cfg.model
        log(f"EnhanceNet {m.num_residual_blocks} blocks x "
            f"{m.num_features} features, {m.compute_dtype}")
        pipe = InferencePipeline(lm.model, lm.cfg, frame_cfg, device="cuda")
        n_frames = 20
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_frames + 1)]
        sweep_march.march.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            events[0].record()
            for i in range(n_frames):
                if i == 2:      # frames 3-20 must not wait for the card
                    torch.cuda.set_sync_debug_mode("warn")
                rgb = pipe.frame(grid, cam_at(0.03 * i))
                events[i + 1].record()
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = sweep_march.march.launches
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        ms_frame = events[2].elapsed_time(events[n_frames]) / (n_frames - 2)
        first_ms = events[0].elapsed_time(events[1])
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        mask = pipe.state.prev_high[..., 0] > 0.0
        log(f"rgb {tuple(rgb.shape)}, mask share "
            f"{float(mask.float().mean()):.4f}, march launches {launches}")
        log(f"{ms_frame:.2f} ms/frame over frames 3-20 (first frame "
            f"{first_ms:.1f} ms), peak memory allocated {peak_gib:.2f} GiB")
        if tuple(rgb.shape) != (1080, 1920, 3):
            raise RuntimeError(f"rgb shape {tuple(rgb.shape)}")
        if not bool(torch.isfinite(rgb).all()):
            raise RuntimeError("non-finite rgb")
        if not bool(mask.any()):
            raise RuntimeError("empty mask")
        log(f"host syncs in frames 3-20: {len(syncs)}")
        if syncs:
            raise RuntimeError(f"a frame waited for the card: {syncs[0]}")
        if launches != n_frames:
            raise RuntimeError(f"sweep_march launched {launches} times "
                               f"in {n_frames} frames")

    with phase("5 small frame: card vs CPU"):
        from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
            FusedFrame, initial_state)
        small_cfg = frame_cfg.replace(width=64, height=48)
        outs = {}
        for dev in ("cuda", "cpu"):
            g = analytic.blobs_volume(64, num_blobs=8, device=dev)
            net = lm.model.to(dev)
            ff = FusedFrame(net, lm.cfg, small_cfg, device=dev)
            st = initial_state(lm.cfg, small_cfg, device=dev)
            for i in range(3):
                rgb_s, fr_s, st = ff(g, cam_at(0.03 * i),
                                     cam_at(0.03 * (i - 1)), st)
            outs[dev] = (rgb_s.cpu(), fr_s.cpu())
        lm.model.to("cuda")
        d_rgb = (outs["cuda"][0] - outs["cpu"][0]).abs()
        mask_mismatch = float((outs["cuda"][1][..., 3]
                               != outs["cpu"][1][..., 3]).float().mean())
        far = float((d_rgb > 0.05).float().mean())
        log(f"3 chained 64x48 -> 256x192 frames: G-buffer mask mismatch "
            f"{mask_mismatch:.4f}, rgb median |diff| "
            f"{float(d_rgb.median()):.2e}, share > 0.05: {far:.4f}")
        if mask_mismatch > 0.01 or far > 0.01 or float(d_rgb.median()) > 1e-3:
            raise RuntimeError("card and CPU frames disagree (bounds: mask "
                               "mismatch <= 0.01, share of rgb |diff| > "
                               "0.05 <= 0.01, median |diff| <= 1e-3)")

    main_row = kernel_rows["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "sweep_march", "route": "cuda", "source": MARCH_SOURCE,
        "replaces": MARCH_REPLACES, "launches": launches,
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None}]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
