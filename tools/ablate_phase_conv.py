"""Ablations of the phase conv kernel (B5) on the card: a development
tool, not part of the package.  From the repository root:

    python tools/ablate_phase_conv.py [--reps N]

Builds variants of ``csrc/conv3x3.cu`` side by side (one ``nvcc`` each,
all started together, into ``build/ablate/``), each with one named edit of
the source: a part of B5's work removed (the epilogue, the TMA stores, the
MMAs, the input loads), or another tile width, ring or staging buffer.
Each variant's ``phase_conv`` entry runs
at the phase tail's shape, x (1, 540, 960, 256) bf16 (uniform in [0, 1),
as after ReLU) and random weights, bf16 out with ReLU, timed in turns with
the unedited source (base, variant, variant, base), ``--reps`` calls a
turn, each behind a queued spin (device time).  Printed per variant: its
ptxas registers and spills, whether ptxas serialises its wgmma (warning
C7511), the largest difference from `phase_conv_plain` (the removals do
not compute the function) and the two times, with the card's name and
power limit.  An edit whose text the source no longer holds fails the
run: the variants follow the source.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from isosurfacesuperresolution_tpu_torch import kernels
from isosurfacesuperresolution_tpu_torch.ops import phase_conv as pc
from isosurfacesuperresolution_tpu_torch.ops.pallas_conv import raw_stream

OUT = kernels.BUILD_DIR.parent / "ablate"
_PHASE_TILES = "C == 256 && Cout == 256 && tile_m == 128"
# name -> [(text, replacement), ...]
VARIANTS = {
    "base": [],
    "no epilogue": [(
        "      store_tile<256, 1, OUT_BF16, RELU>(acc,",
        "      if (s.H < 0) store_tile<256, 1, OUT_BF16, RELU>(acc,")],
    "no TMA stores": [(
        "        tma_store_3d(ymap, out + i * kBlockBytes,",
        "        if (bw_log2 < 0) tma_store_3d(ymap, out + i * kBlockBytes,")],
    "no MMAs": [(
        "          wgmma_taps<V>(acc[0], sw128_desc(a + 32 * kk, 16, 1024),",
        "          if (s.H < 0) wgmma_taps<V>(acc[0], sw128_desc(a + 32 * kk,"
        " 16, 1024),")],
    "no input loads": [(
        "            mbar_expect_tx(afull0 + 8 * as, a_bytes);\n"
        "            tma_load_3d(aring + as * G::kABytes, &xmap,"
        " afull0 + 8 * as,\n"
        "                        64 * (V >> 2), q0 + ((V >> 1) & 1) -"
        " ((V >> 2) & 1),\n"
        "                        p0 - (V >> 3));",
        "            mbar_arrive(afull0 + 8 * as);")],
    "BW 8": [(
        "  for (int lg = 3; lg <= 6; ++lg) {",
        f"  for (int lg = 3; lg <= ({_PHASE_TILES} ? 3 : 6); ++lg) {{")],
    "BW 64": [(
        "  for (int lg = 3; lg <= 6; ++lg) {",
        f"  for (int lg = ({_PHASE_TILES} ? 6 : 3); lg <= 6; ++lg) {{")],
    "BW <= 32, 4 input stages": [
        ("  for (int lg = 3; lg <= 6; ++lg) {",
         f"  for (int lg = 3; lg <= ({_PHASE_TILES} ? 5 : 6); ++lg) {{"),
        ("  static constexpr uint32_t kABytes = (128 + 64) * 128;",
         "  static constexpr uint32_t kABytes = (128 + 32) * 128;")],
    "16 KB staging a warpgroup": [(
        "constexpr uint32_t kOutBytes = 32 * 1024;",
        "constexpr uint32_t kOutBytes = 16 * 1024;")],
}
_ENTRY = "phase_conv_kernelILb1ELb1EE"   # bf16 out, ReLU


def build_variants() -> dict:
    """{name: (ctypes entry, ptxas usage, serialised)}; raises if an edit
    does not apply or a build fails."""
    src = (kernels.CSRC / "conv3x3.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = kernels.find_nvcc()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer "
                                   f"holds {old[:60]!r}")
            text = text.replace(old, new)
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        so = OUT / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.flags("conv3x3"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        usage = [u for u in kernels.ptxas_usage(log) if _ENTRY in u["entry"]]
        serial = any("C7511" in ln and _ENTRY in ln
                     for ln in log.splitlines())
        fn = ctypes.CDLL(str(so)).phase_conv
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        out[name] = (fn, usage[0], serial)
    return out


def backlog_ms(fn, reps: int) -> float:
    """Median ms of ``reps`` calls after a warm-up, each between CUDA events
    behind a spin of a few milliseconds."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the ablations run on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    variants = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, W = 540, 960
    x = torch.rand((1, H, W, 256), device="cuda", generator=gen
                   ).to(torch.bfloat16)
    k3 = (torch.rand((3, 3, 64, 64), device="cuda", generator=gen)
          - 0.5) * 0.1
    b3 = torch.rand(64, device="cuda", generator=gen) - 0.5
    w, b4 = pc.kernel_operands(k3, b3)
    want = pc.phase_conv_plain(x, k3, b3, relu=True).float()
    y = torch.empty((1, H, W, 256), dtype=torch.bfloat16, device="cuda")

    def call(fn):
        err = fn(x.data_ptr(), w.data_ptr(), b4.data_ptr(), y.data_ptr(), H,
                 W, 1, 1, raw_stream(x.device))
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(card)
    print(f"B5 at (1, {H}, {W}, 256), bf16 out, ReLU; ms behind a backlog, "
          f"median of {args.reps}, in turns base, variant, variant, base")
    base = variants["base"][0]
    for name, (fn, usage, serial) in variants.items():
        y.zero_()
        call(fn)
        torch.cuda.synchronize()
        diff = float((y.float() - want).abs().max())
        turns = [backlog_ms(lambda: call(base), args.reps),
                 backlog_ms(lambda: call(fn), args.reps),
                 backlog_ms(lambda: call(fn), args.reps),
                 backlog_ms(lambda: call(base), args.reps)]
        print(f"{name}: {statistics.median(turns[1:3]):.4f} ms (base "
              f"{statistics.median([turns[0], turns[3]]):.4f}); "
              f"{usage['registers']} registers, spills "
              f"{usage['spill_stores']} B, wgmma serialised: {serial}; "
              f"max |diff| vs plain {diff:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
