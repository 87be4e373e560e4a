"""Time the march and AO capture kernels of this tree against another
``csrc/sweep_march.cu`` on the card: a development tool, not part of the
package.  From the repository root:

    python tools/compare_march.py OTHER.cu [OTHER2.cu ...] [--reps N]
        [--angles A,B,...] [--kernels B1,B1-ao,B2,B3,B4,B4p]
    python tools/compare_march.py --host OTHER_ROOT [--angles A,B,...]

Builds each OTHER.cu with the march library's own nvcc flags into
``build/compare/`` beside this tree's library, then, for each orbit angle
of `chip_smoke.py`'s camera, runs each kernel at the smoke's shapes with
either library: B1 (bf16, 256^3 blobs, 600 x 338), B1-ao (its bf16 SH
field), B2 (the 512^3 uint8 blobs, tiles of 256), B3 (that grid packed
with a tolerance of 1e-3), and the AO captures at B2's and B3's hits: B4
on the full-res bf16 field and on the coarse uint8 one (half resolution),
B4p on the packed bf16 field.  Every library must agree with this tree's
bit for bit; each kernel is timed against each other library in turns
(other, this, this, other; ``--reps`` calls a turn, each behind a queued
spin, so the times are the card's; the captures with a cold L2, as a
frame runs them after the march), and the medians printed, with each
library's ptxas lines (registers, spills, shared memory) and the card's
name and power limit.  With ``--host`` it times only the captures'
idle-queue time and host cost a call (`host_numbers`) of two packages in
turns (other, this, this, other), each turn a child process that imports
the package from its root: OTHER_ROOT holds another checkout's
``isosurfacesuperresolution_tpu_torch`` (for the parent commit, unpack
``git archive HEAD isosurfacesuperresolution_tpu_torch`` into a directory
under ``build/``), which builds its own kernels there.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cam_at, card_line, host_us, time_cuda, time_samples

# the root a --host turn's child process imports the package from
PACKAGE_ROOT = "COMPARE_MARCH_PACKAGE_ROOT"
PACKAGE = "isosurfacesuperresolution_tpu_torch"
if os.environ.get(PACKAGE_ROOT):
    sys.path.insert(0, os.environ[PACKAGE_ROOT])

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.config import RenderConfig
from isosurfacesuperresolution_tpu_torch.render import sweep_march as SM
from isosurfacesuperresolution_tpu_torch.render import sweep_tiled as PT
from isosurfacesuperresolution_tpu_torch.render.ao_sweep import (
    attach_baked_ao)
from isosurfacesuperresolution_tpu_torch.render.params import RenderParams
from isosurfacesuperresolution_tpu_torch.render.sweep import (
    ao_tile_table, field_zcxy, march_inputs, packed_inputs, plan_sweep,
    tiled_inputs)
from isosurfacesuperresolution_tpu_torch.volume import analytic
from isosurfacesuperresolution_tpu_torch.volume.packed import (
    SWEEP_PERMS, SparseBrickGrid)

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


def bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits (so -0 differs from +0), others as they
    are."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def time_turns(fns: dict, other: str, reps: int, cold: bool) -> dict:
    """Median ms of fns[other] and fns["this"] in turns other, this,
    this, other; ``reps`` calls a turn, each behind a spin (and with
    ``cold`` an L2 flush)."""
    times = {k: [] for k in (other, "this")}
    for name in (other, "this", "this", other):
        times[name] += time_samples(fns[name], reps, backlog=True,
                                    cold=cold)
    return {k: statistics.median(v) for k, v in times.items()}


CFG = RenderConfig(width=480, height=270, isovalue=0.5, ao_samples=0,
                   renderer="sweep_pallas", sweep_oversample=1.25,
                   sweep_dtype="bfloat16")
CFG512 = CFG.replace(isovalue=0.36)


def volumes() -> dict:
    """The smoke's volumes: the 256^3 blobs, with and without its baked
    float32 SH field; the 512^3 uint8 blobs with its full-res bf16 and
    coarse (half-res, uint8) fields; that grid packed with a tolerance of
    1e-3 (its full-res field packed too)."""
    g256 = analytic.blobs_volume(256, num_blobs=8, device="cuda")
    g512 = analytic.blobs_volume(512, store_dtype="uint8", device="cuda")
    g512_ao = attach_baked_ao(g512, 0.36, 0.2, out_dtype=torch.bfloat16)
    out = {"g256": g256, "g256_ao": attach_baked_ao(g256, 0.5, 0.1),
           "g512": g512, "g512_ao": g512_ao,
           "g512_c": attach_baked_ao(g512, 0.36, 0.2, downsample=2,
                                     keep_coarse=True, out_dtype="uint8"),
           "p512": SparseBrickGrid.from_brick_grid(g512_ao, tolerance=1e-3)}
    torch.cuda.synchronize()
    return out


def _tiled_args(vols: dict, cam):
    rp = RenderParams.from_config(CFG512)
    plan = plan_sweep(vols["g512"], cam, CFG512, rp)
    args = tiled_inputs(vols["g512"], plan, CFG512, rp)
    args["vol_zxy"] = SM.kernel_volume(args["vol_zxy"], args["dtype"])
    TX = PT.pick_tile(args["vol_zxy"].shape[1], args["tile"])
    TY = PT.pick_tile(args["vol_zxy"].shape[2], args["tile"])
    kargs = (args["vol_zxy"], args["meta"], args["s_grid"], args["t_grid"],
             args["Sn"], args["Tn"], args["table"], TX, TY, args["iso"],
             args["dtype"], args["scale"], args["offset"])
    return plan, args, kargs


def _packed_args(vols: dict, cam):
    rp = RenderParams.from_config(CFG512)
    plan = plan_sweep(vols["p512"], cam, CFG512, rp)
    pargs = packed_inputs(vols["p512"], plan, CFG512, rp)
    pa = pargs["packed_axis"]
    kp = (PT.kernel_atlas(pa, torch.uint8), pa.slots, pargs["meta"],
          pargs["s_grid"], pargs["t_grid"], pargs["Sn"], pargs["Tn"],
          pargs["table"], pargs["iso"], pargs["dtype"], pargs["scale"],
          pargs["offset"])
    return plan, pargs, kp


def march_calls(vols: dict, ang: float) -> dict:
    """tag -> (call, False, None) for B1, B1-ao, B2 and B3 at orbit angle
    ``ang``, each calling its launch entry on prepared inputs."""
    cam = cam_at(ang)
    calls = {}
    ao_cfg = CFG.replace(ao_samples=64, ao_mode="volume")
    for tag, g, c, ao in (("B1", vols["g256"], CFG, False),
                          ("B1-ao", vols["g256_ao"], ao_cfg, True)):
        rp = RenderParams.from_config(c)
        args = march_inputs(g, plan_sweep(g, cam, c, rp), c, rp,
                            use_ao_field=ao)
        args["vol_zxy"] = SM.kernel_volume(args["vol_zxy"], args["dtype"])
        if ao:
            args["ao_zcxy"] = SM.kernel_ao_field(args["ao_zcxy"],
                                                 args["dtype"])
        calls[tag] = (lambda args=args: SM.march(**args), False, None)
    kargs = _tiled_args(vols, cam)[2]
    calls["B2"] = (lambda kargs=kargs: PT.march_tiled_kernel(*kargs), False,
                   None)
    kp = _packed_args(vols, cam)[2]
    calls["B3"] = (lambda kp=kp: PT.march_packed_kernel(*kp), False, None)
    return calls


def capture_calls(vols: dict, ang: float, wrappers: bool = False) -> dict:
    """tag -> (call, True, m_hit) for B4 on the full-res bf16 field and on
    the coarse uint8 one, and B4p, at orbit angle ``ang``: each calls its
    launch entry on the hits of the library in use (B2's and B3's m_hit
    are the same in every library compared).  With ``wrappers``, tag ->
    (launch entry call, wrapper call) instead."""
    cam = cam_at(ang)
    plan, args, kargs = _tiled_args(vols, cam)
    m_hit = PT.march_tiled_kernel(*kargs)[0]
    calls = {}
    for tag, g in (("B4 full-res bf16", vols["g512_ao"]),
                   ("B4 coarse uint8", vols["g512_c"])):
        field = field_zcxy(g.ao_sh, plan.perm)
        table = ao_tile_table(g, plan.perm)
        ka = (field, args["meta"], args["s_grid"], args["t_grid"], m_hit,
              table, PT.pick_tile(field.shape[2], 128),
              PT.pick_tile(field.shape[3], 128), args["iso"], args["dtype"],
              g.ao_scale, g.ao_offset, g.ao_downsample)
        kw = dict(ao_zcxy=field, meta=args["meta"], s_grid=args["s_grid"],
                  t_grid=args["t_grid"], Sn=args["Sn"], Tn=args["Tn"],
                  m_hit=m_hit, brick_max_p=args["brick_max_p"],
                  brick_size=args["brick_size"], iso=args["iso"],
                  dtype=args["dtype"], ao_scale=g.ao_scale,
                  ao_offset=g.ao_offset, field_downsample=g.ao_downsample,
                  table=table)
        calls[tag] = ((lambda ka=ka: PT.ao_capture_tiled_kernel(*ka),
                       lambda kw=kw: PT.ao_capture_tiled(**kw))
                      if wrappers else
                      (lambda ka=ka: PT.ao_capture_tiled_kernel(*ka), True,
                       m_hit))
    pplan, pargs, kp = _packed_args(vols, cam)
    p_hit = PT.march_packed_kernel(*kp)[0]
    pao = vols["p512"].ao_per_axis[SWEEP_PERMS.index(pplan.perm)]
    kq = (PT.kernel_atlas(pao, pargs["dtype"]), pao.slots, pargs["meta"],
          pargs["s_grid"], pargs["t_grid"], p_hit, pargs["dtype"])
    kw = dict(packed_ao=pao, meta=pargs["meta"], s_grid=pargs["s_grid"],
              t_grid=pargs["t_grid"], Sn=pargs["Sn"], Tn=pargs["Tn"],
              m_hit=p_hit, dtype=pargs["dtype"])
    calls["B4p"] = ((lambda: PT.ao_capture_packed_kernel(*kq),
                     lambda: PT.ao_capture_packed(**kw))
                    if wrappers else
                    (lambda: PT.ao_capture_packed_kernel(*kq), True, p_hit))
    return calls


def block_hits(m_hit) -> tuple:
    """Hit pixels per block of this tree's AO capture kernel, whose warp w
    of block b (of G) takes the 32 pixels of run w * G + b: (the largest
    count, the blocks with a hit, G)."""
    warps = kernels.source_constant("sweep_march", "kCapThreads") // 32
    hit = (m_hit >= 0).flatten().float()
    G = -(-hit.numel() // (32 * warps))
    hit = torch.nn.functional.pad(hit, (0, G * warps * 32 - hit.numel()))
    per = hit.reshape(warps, G, 32).sum((0, 2))
    return int(per.max()), int((per > 0).sum()), G


def host_numbers(vols: dict, angles) -> None:
    """Print, for the package imported, each capture's idle-queue time
    (launch entry and wrapper, median of 7) and the host microseconds of
    one call of each (`chip_smoke.host_us`): the part of a capture's cost
    that its Python carries."""
    for ang in angles:
        for tag, (entry, wrapper) in capture_calls(vols, ang, True).items():
            print(f"[angle {ang}] {tag}: idle queue {time_cuda(entry, 7):.4f}"
                  f" ms, the wrapper {time_cuda(wrapper, 7):.4f} ms; host "
                  f"{host_us(entry):.1f} us a call of the launch entry, "
                  f"{host_us(wrapper):.1f} us of the wrapper", flush=True)


def host_turns(other: Path, angles: str) -> int:
    """`host_numbers` of the package under ``other`` and of this tree's,
    in turns other, this, this, other, each in a child process; prints
    their lines marked with the turn and the package's root."""
    if not (other / PACKAGE).is_dir():
        raise SystemExit(f"{other} holds no {PACKAGE}")
    for turn, root in enumerate((other, ROOT, ROOT, other), 1):
        done = subprocess.run(
            [sys.executable, __file__, "--host-numbers", "--angles", angles],
            env={**os.environ, PACKAGE_ROOT: str(root.resolve())},
            capture_output=True, text=True)
        if done.returncode:
            print(done.stdout + done.stderr, file=sys.stderr, flush=True)
            return done.returncode
        side = "this" if root == ROOT else str(other)
        for line in done.stdout.splitlines():
            print(f"[turn {turn}, {side}] {line}", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="*")
    ap.add_argument("--host", type=Path, metavar="OTHER_ROOT",
                    help="only the captures' idle-queue times and host "
                         "microseconds a call, of the package under "
                         "OTHER_ROOT and of this tree's, in turns")
    ap.add_argument("--host-numbers", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--angles", default="0,0.3,0.57")
    ap.add_argument("--kernels", default="B1,B1-ao,B2,B3,B4,B4p",
                    help="the kernels to run: B1, B1-ao, B2, B3 (marches), "
                         "B4 (both fields), B4p")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    angles = [float(x) for x in a.angles.split(",")]
    if a.host_numbers:
        print(f"package: {Path(kernels.__file__).parent}", flush=True)
        host_numbers(volumes(), angles)
        return 0
    print(f"card: {card_line()}", flush=True)
    if a.host:
        return host_turns(a.host, a.angles)
    if not a.other:
        raise SystemExit("name another sweep_march.cu to compare with")
    kernels.build(["sweep_march"])
    libs = {"this": ctypes.CDLL(str(kernels.library_path("sweep_march")))}
    logs = {"this": kernels.build_log("sweep_march")}
    for n, src in enumerate(a.other):
        lib = build_other(src, n)
        libs[str(src)] = ctypes.CDLL(str(lib))
        logs[str(src)] = lib.with_suffix(".log").read_text()
    for name, log in logs.items():
        for u in kernels.ptxas_usage(log):
            if ("march_kernel" in u["entry"]
                    or "ao_capture_kernel" in u["entry"]):
                print(f"[ptxas {name}] {u['entry']}: {u['registers']} "
                      f"registers, spills {u['spill_stores']}/"
                      f"{u['spill_loads']} B, {u['static_smem']} B smem")

    t = time.time()
    vols = volumes()
    print(f"volumes made in {time.time() - t:.1f} s", flush=True)
    for ang in angles:
        calls = {**march_calls(vols, ang), **capture_calls(vols, ang)}
        keep = a.kernels.split(",")
        calls = {k: v for k, v in calls.items() if k.split()[0] in keep}
        for tag, (fn, cold, hit_of) in calls.items():
            outs = {}
            for name, lib in libs.items():
                use(lib)
                outs[name] = fn()
                torch.cuda.synchronize()
            if hit_of is None:
                hits = float((outs["this"][0] >= 0).float().mean())
            else:
                hits = float((hit_of >= 0).float().mean())
                most, busy, runs = block_hits(hit_of)
                print(f"[angle {ang}] {tag}: at most {most} hits in a "
                      f"block of this tree's kernel, {busy} of {runs} "
                      f"blocks hold one", flush=True)

            def bound(name, fn=fn):
                lib = libs[name]
                return lambda: (use(lib), fn())
            for other in libs:
                if other == "this":
                    continue
                same = all(torch.equal(bits(x), bits(y)) for x, y in
                           zip(outs["this"], outs[other]))
                ms = time_turns({k: bound(k) for k in (other, "this")},
                                other, a.reps, cold)
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
