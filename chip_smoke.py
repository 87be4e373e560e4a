#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one CUDA card).

Run from the repository root:  python3 chip_smoke.py

Phases, each announced before it starts and after it ends with the elapsed
seconds; any failure ends the run with a non-zero exit code:

1. versions and the card (`nvidia-smi` name and power limit);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together);
3. each kernel vs its plain PyTorch version on the card at the shapes of
   the interactive frame, with stated bounds, and their times: the march
   (256^3 blobs, 480x270, oversample 1.25: K = 512 slices, Sn x Tn =
   600 x 338) without and with the baked AO field, and the phase conv at
   (1, 540, 960, 256) with the trained post3 weights;
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
   20 on the baked-AO grid (ao_samples 64, ao_mode "volume").

In phases 4, 6 and 7 the launch counts are zeroed just before each run
and read just after it, and frames 3 onwards must make no host sync
(`torch.cuda.set_sync_debug_mode`).  Then one JSON line of kernel numbers,
the card line, and last the device line.  Float32 matmuls and
convolutions run without TF32 throughout
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`).
"""

from __future__ import annotations

import dataclasses
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
BF16_TC_OPS_PER_S = 989e12
PKG = "isosurfacesuperresolution_tpu_torch"
MARCH_SOURCE = f"{PKG}/csrc/sweep_march.cu"
MARCH_REPLACES = "isosurfacesuperresolution_tpu/render/sweep_pallas.py:46"
PHASE_SOURCE = f"{PKG}/csrc/phase_conv.cu"
PHASE_REPLACES = "isosurfacesuperresolution_tpu/ops/phase_conv.py:245"
# bounds of the march comparison: both round the same operands at the same
# points; float32 sums may differ in the last place, which can move a
# crossing where F is within rounding of the isovalue
MAX_HIT_MISMATCH = 1e-3      # share of pixels whose m_hit differs
MAX_FRAC_DIFF = 1e-3         # inverse lerp divides by F - Fm1
MAX_GRAD_DIFF = 1e-4
MAX_SH_DIFF = 1e-4           # SH capture: two-tap sums like F
# phase conv vs plain: exact bf16 products, float32 sums in another order
# (O(1e-5) on these sums); a bf16 output may round the other way, one
# bf16 step, at most 2^-7 of the value
MAX_PHASE_ABS = {"float32": 1e-4, "bfloat16": 0.06}
MAX_PHASE_REL = {"float32": 1e-3, "bfloat16": 2.0 ** -7 + 1e-3}


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
    """Median milliseconds of ``reps`` calls after one warm-up call, each
    between CUDA events."""
    import torch
    fn()
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


def check_march(tag: str, got, want) -> float:
    """Log the comparison of the march with its plain version and raise
    if it is out of bounds; returns the largest difference."""
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
    return max(v for k, v in cmp.items() if k != "hit_mismatch")


def drive(frame_fn, n_frames: int, tag: str, counters: dict):
    """Run ``frame_fn(i)`` for i < n_frames with the launch counts zeroed
    just before and read just after; frames 3 onwards must make no host
    sync.  Logs the times and peak memory; returns (last output,
    launches)."""
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

    import torch.nn.functional as F

    from isosurfacesuperresolution_tpu_torch.config import (
        Config, RenderConfig)
    from isosurfacesuperresolution_tpu_torch.infer.loadedmodel import (
        LoadedModel)
    from isosurfacesuperresolution_tpu_torch.infer.pipeline import (
        FusedFrame, InferencePipeline, initial_state)
    from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
    from isosurfacesuperresolution_tpu_torch.render import sweep_march
    from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
        attach_baked_ao)
    from isosurfacesuperresolution_tpu_torch.render.params import (
        RenderParams)
    from isosurfacesuperresolution_tpu_torch.render.sweep import (
        march_inputs, plan_sweep)
    from isosurfacesuperresolution_tpu_torch.volume import analytic

    march = sweep_march.march
    counters = {"sweep_march": (march, "launches"),
                "sweep_march_ao": (march, "ao_launches"),
                "phase_conv": (pc.phase_conv, "launches")}
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
            err = check_march(tag, got, want)
            ms = time_cuda(lambda: march(**args), 7)
            plain_ms = time_cuda(lambda: sweep_march.march_plain(**args), 3)
            bound, bound_by = march_bound_ms(args, got)
            log(f"[{tag}] kernel {ms:.3f} ms (median of 7), plain "
                f"{plain_ms:.1f} ms (median of 3), bound {bound:.4f} ms "
                f"by {bound_by}")
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
        # the library call in both memory formats; the faster one is kept
        lib = {}
        for fmt in ("contiguous_format", "channels_last"):
            mf = getattr(torch, fmt)
            xs_f = xs.contiguous(memory_format=mf)
            w_f = w_lib.contiguous(memory_format=mf)
            lib[fmt] = time_cuda(
                lambda: F.conv2d(xs_f, w_f, b_lib, padding=1), 7)
            del xs_f
        lib_fmt = min(lib, key=lib.get)
        lib_ms = lib[lib_fmt]
        log(f"[phase_conv] library: F.conv2d bf16 with bias on the shuffled "
            f"(1, 64, 1080, 1920) tensor (shuffle excluded): "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in lib.items())
            + f"; library_ms is the {lib_fmt} time")
        del xs
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
            ms = time_cuda(lambda: pc.phase_conv3x3_amajor_blocked(
                x, k3, b3, relu=True, out_dtype=odt), 7)
            plain_ms = time_cuda(lambda: pc.phase_conv_plain(
                x, k3, b3, relu=True, out_dtype=odt), 3)
            bound, bound_by = phase_bound_ms(H, W, got.element_size())
            log(f"[phase_conv {out}] kernel {ms:.3f} ms (median of 7), "
                f"plain {plain_ms:.2f} ms (median of 3), bound "
                f"{bound:.4f} ms by {bound_by}, library {lib_ms:.3f} ms")
            rows[f"phase_conv {out}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms}
        del x, got, want, d

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
            d_rgb = (outs["cuda"][0] - outs["cpu"][0]).abs()
            fr_c, fr_h = outs["cuda"][1], outs["cpu"][1]
            mask_mismatch = float((fr_c[..., 3] != fr_h[..., 3])
                                  .float().mean())
            far = float((d_rgb > 0.05).float().mean())
            both = (fr_c[..., 3] > 0.5) & (fr_h[..., 3] > 0.5)
            d_ao = float((fr_c[..., 10] - fr_h[..., 10]).abs()[both].max())
            log(f"[{tag}] 3 chained 64x48 -> 256x192 frames: G-buffer mask "
                f"mismatch {mask_mismatch:.4f}, AO |diff| on hits {d_ao:.2e}"
                f", rgb "
                f"median |diff| {float(d_rgb.median()):.2e}, share > 0.05: "
                f"{far:.4f}")
            if (mask_mismatch > 0.01 or far > 0.01
                    or float(d_rgb.median()) > 1e-3 or d_ao > MAX_SH_DIFF):
                raise RuntimeError(
                    f"card and CPU frames disagree ({tag}; bounds: mask "
                    f"mismatch <= 0.01, share of rgb |diff| > 0.05 <= 0.01, "
                    f"median |diff| <= 1e-3, AO |diff| on hits <= "
                    f"{MAX_SH_DIFF})")
            if ao_sh is not None and not bool((fr_c[..., 10][both] < 1)
                                              .any()):
                raise RuntimeError(f"[{tag}] the AO channel is 1 on every "
                                   f"hit")
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

    log(f"launches over the main-path runs of phases 4, 6 and 7: "
        f"{path_launches}")
    kernels_line = []
    for name, source, replaces, row in (
            ("sweep_march", MARCH_SOURCE, MARCH_REPLACES, rows["bfloat16"]),
            ("sweep_march_ao", MARCH_SOURCE,
             "isosurfacesuperresolution_tpu/render/sweep_pallas.py:163",
             rows["bfloat16 AO"]),
            ("phase_conv", PHASE_SOURCE, PHASE_REPLACES,
             rows["phase_conv bfloat16"])):
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
