"""Time the march kernels of this tree against another
``csrc/sweep_march.cu`` on the card: a development tool, not part of the
package.  From the repository root:

    python tools/compare_march.py OTHER.cu [OTHER2.cu ...] [--reps N]
        [--angles A,B,...]

Builds each OTHER.cu with the march library's own nvcc flags into
``build/compare/`` beside this tree's library, then, for each orbit angle
of `chip_smoke.py`'s camera, runs each march at the smoke's shapes with
either library: B1 (bf16, 256^3 blobs, 600 x 338), B1-ao (its bf16 SH
field), B2 (the 512^3 uint8 blobs, tiles of 256) and B3 (that grid packed
with a tolerance of 1e-3).  Every library must agree with this tree's bit
for bit; each march is timed against each other library in turns (other,
this, this, other; ``--reps`` calls a turn, each behind a queued spin, so
the times are the card's), and the medians printed, with each library's
ptxas lines (registers, spills, shared memory) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cam_at, card_line, time_samples
from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import sweep_march as SM
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    march_inputs, packed_inputs, plan_sweep, tiled_inputs)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    SparseBrickGrid)

OUT = kernels.BUILD_DIR.parent / "compare"


def build_other(src: Path, n: int) -> Path:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"sweep_march_other{n}.so"
    cmd = [kernels.find_nvcc(), *kernels.flags("sweep_march"), "-o",
           str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}"
                           f"{done.stderr}")
    lib.with_suffix(".log").write_text(done.stdout + done.stderr)
    return lib


def use(lib: ctypes.CDLL) -> None:
    """Make the wrappers launch the march entries of ``lib``."""
    kernels._LIBS["sweep_march"] = lib
    SM._FN = None
    PT._FNS.clear()


def time_turns(fns: dict, other: str, reps: int) -> dict:
    """Median ms of fns[other] and fns["this"] in turns other, this,
    this, other; ``reps`` calls a turn, each behind a spin."""
    times = {k: [] for k in (other, "this")}
    for name in (other, "this", "this", other):
        times[name] += time_samples(fns[name], reps, backlog=True)
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--angles", default="0,0.3,0.57")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {card_line()}", flush=True)
    kernels.build(["sweep_march"])
    libs = {"this": ctypes.CDLL(str(kernels.library_path("sweep_march")))}
    logs = {"this": kernels.build_log("sweep_march")}
    for n, src in enumerate(a.other):
        lib = build_other(src, n)
        libs[str(src)] = ctypes.CDLL(str(lib))
        logs[str(src)] = lib.with_suffix(".log").read_text()
    for name, log in logs.items():
        for u in kernels.ptxas_usage(log):
            if "march_kernel" in u["entry"]:
                print(f"[ptxas {name}] {u['entry']}: {u['registers']} "
                      f"registers, spills {u['spill_stores']}/"
                      f"{u['spill_loads']} B, {u['static_smem']} B smem")

    t = time.time()
    g256 = analytic.blobs_volume(256, num_blobs=8, device="cuda")
    g256_ao = attach_baked_ao(g256, 0.5, 0.1)
    g512 = analytic.blobs_volume(512, store_dtype="uint8", device="cuda")
    p512 = SparseBrickGrid.from_brick_grid(g512, tolerance=1e-3)
    torch.cuda.synchronize()
    print(f"volumes made in {time.time() - t:.1f} s", flush=True)
    cfg = RenderConfig(width=480, height=270, isovalue=0.5, ao_samples=0,
                       renderer="sweep_pallas", sweep_oversample=1.25,
                       sweep_dtype="bfloat16")
    ao_cfg = cfg.replace(ao_samples=64, ao_mode="volume")
    cfg512 = cfg.replace(isovalue=0.36)
    for ang in (float(x) for x in a.angles.split(",")):
        cam = cam_at(ang)
        calls = {}
        for tag, g, c, ao in (("B1", g256, cfg, False),
                              ("B1-ao", g256_ao, ao_cfg, True)):
            rp = RenderParams.from_config(c)
            args = march_inputs(g, plan_sweep(g, cam, c, rp), c, rp,
                                use_ao_field=ao)
            args["vol_zxy"] = SM.kernel_volume(args["vol_zxy"],
                                               args["dtype"])
            if ao:
                args["ao_zcxy"] = SM.kernel_ao_field(args["ao_zcxy"],
                                                     args["dtype"])
            calls[tag] = lambda args=args: SM.march(**args)
        rp = RenderParams.from_config(cfg512)
        plan = plan_sweep(g512, cam, cfg512, rp)
        args = tiled_inputs(g512, plan, cfg512, rp)
        args["vol_zxy"] = SM.kernel_volume(args["vol_zxy"], args["dtype"])
        TX = PT.pick_tile(args["vol_zxy"].shape[1], args["tile"])
        TY = PT.pick_tile(args["vol_zxy"].shape[2], args["tile"])
        kargs = (args["vol_zxy"], args["meta"], args["s_grid"],
                 args["t_grid"], args["Sn"], args["Tn"], args["table"], TX,
                 TY, args["iso"], args["dtype"], args["scale"],
                 args["offset"])
        calls["B2"] = lambda kargs=kargs: PT.march_tiled_kernel(*kargs)
        pargs = packed_inputs(p512, plan_sweep(p512, cam, cfg512, rp),
                              cfg512, rp)
        pa = pargs["packed_axis"]
        atlas = PT.kernel_atlas(pa, torch.uint8)
        kp = (atlas, pa.slots, pargs["meta"], pargs["s_grid"],
              pargs["t_grid"], pargs["Sn"], pargs["Tn"], pargs["table"],
              pargs["iso"], pargs["dtype"], pargs["scale"], pargs["offset"])
        calls["B3"] = lambda kp=kp: PT.march_packed_kernel(*kp)
        for tag, fn in calls.items():
            outs = {}
            for name, lib in libs.items():
                use(lib)
                outs[name] = fn()
                torch.cuda.synchronize()
            hits = float((outs["this"][0] >= 0).float().mean())

            def bound(name, fn=fn):
                lib = libs[name]
                return lambda: (use(lib), fn())
            for other in libs:
                if other == "this":
                    continue
                same = all(torch.equal(x, y) for x, y in
                           zip(outs["this"], outs[other]))
                ms = time_turns({k: bound(k) for k in (other, "this")},
                                other, a.reps)
                print(f"[angle {ang}] {tag}: {other} {ms[other]:.4f} ms, "
                      f"this {ms['this']:.4f} ms "
                      f"({ms[other] / ms['this']:.2f}x), hits {hits:.3f}, "
                      f"bit for bit {'identical' if same else 'DIFFERENT'}",
                      flush=True)
                if not same:
                    return 1
    use(libs["this"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
