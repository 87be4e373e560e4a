"""Ablations of the AO capture kernels (B4, B4p) on the card: a
development tool, not part of the package.  From the repository root:

    python tools/ablate_capture.py [--reps N] [--angles A,B,...]

Builds variants of ``csrc/sweep_march.cu`` side by side (one ``nvcc``
each, all started together, into ``build/ablate_capture/``), each with
one named edit of `ao_capture_kernel`: another lane shape or block size,
or a part of its work removed (pass B, the gate loads, the zero stores,
the field loads; those do not compute the function).  At each orbit
angle of `chip_smoke.py`'s camera, each variant's B4 (full-res bf16 and
coarse uint8 fields) and B4p run on the smoke's 512^3 inputs
(`compare_march.capture_calls`), timed in turns with the unedited source
(base, variant, variant, base), ``--reps`` calls a turn, each behind a
queued spin with a cold L2 (device time).  Printed per variant and
capture: the two times, whether the output has the base's bits, the
variant's registers and spills.  Then the floors of the same timing: an
empty kernel, a fill of the (4, Sn, Tn) output, a copy of m_hit; and the
base with a warm L2.  An edit whose text the source no longer holds
fails the run: the variants follow the source.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import card_line, time_samples
from compare_march import bits, capture_calls, use, volumes
from isosurfacesuperresolution_tpu_torch import kernels

OUT = kernels.BUILD_DIR.parent / "ablate_capture"


def sub(*edits):
    """An edit of the source: each (text, replacement) pair applied."""
    def edit(src: str) -> str:
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"the source no longer holds {old[:60]!r}")
            src = src.replace(old, new)
        return src
    return edit


# The kernel's pass B as it stood when the lane layouts were timed, for
# kCapCPL channels a lane (4: 8 lanes a hit; 1: 32 lanes a hit, a lane a
# channel) and kCapU groups of hits a warp takes at a time.
_PASS_B_AT = "  // pass B: lane r of a hit's kCapLanes lanes"
_PASS_B_END = ("template <typename S, bool BF16, bool PACKED = false>\n"
               "void launch_ao(")
_GENERIC_PASS_B = r"""  constexpr int kCapCPL = @CPL@;
  constexpr int kCapU = @U@;
  // pass B: lane r of a group of kL lanes holds plane p, x tap a, y tap b
  // (and, kCapCPL == 1, channel r & 3)
  constexpr int kL = 32 / kCapCPL;
  constexpr int kCB = kCapCPL == 1 ? 2 : 0;
  constexpr int OB = 1 << kCB, OA = 2 << kCB, OP = 4 << kCB;
  constexpr int kHits = kCapCPL * kCapU;    // hits a warp takes at a time
  const int grp = lane / kL;
  const int r = lane % kL;
  const int b = (r >> kCB) & 1;
  const int a = (r >> (kCB + 1)) & 1;
  const int p = (r >> (kCB + 2)) & 1;
  const int c1 = r & 3;                     // the channel when kCapCPL == 1
  const float sc1 = pick(scale, c1);
  const float of1 = pick(offset, c1);
  for (int i0 = warp * kHits; i0 < total; i0 += kCapWarps * kHits) {
    float v[kCapU][kCapCPL];
#pragma unroll
    for (int u = 0; u < kCapU; ++u) {
      const int i = i0 + u * (32 / kL) + grp;
#pragma unroll
      for (int j = 0; j < kCapCPL; ++j) v[u][j] = 0.f;
      if (i >= total) continue;
      const CapHit<PACKED>& e = rec[list[i]];
      if (!((e.flags >> (2 * a + b)) & 1)) continue;
      const int jx = e.jx0 + a;
      const int jy = e.jy0 + b;
      const S* q;
      if constexpr (PACKED) {
        q = field + e.slot[2 * (2 * a + b) + p] * sz + (jx - e.ox[a]) * sx +
            (jy - e.oy[b]) * sy;
      } else {
        q = field + static_cast<long long>(e.zf + p) * sz + jx * sx +
            jy * sy;
      }
      if constexpr (kCapCPL == 1) {
        v[u][0] = load_f32(q + c1 * sc);
      } else {
        load_channels(q, sc, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kCapU; ++u) {
      const int i = i0 + u * (32 / kL) + grp;
      const CapHit<PACKED>& e = rec[list[min(i, total - 1)]];
      const bool same_x = e.flags & 16;
      const bool same_y = e.flags & 32;
      const float wxa = a ? e.wx[1] : e.wx[0];
      const float wyb = b ? e.wy[1] : e.wy[0];
#pragma unroll
      for (int j = 0; j < kCapCPL; ++j) {
        const int c = kCapCPL == 1 ? c1 : j;
        const float scc = kCapCPL == 1 ? sc1 : pick(scale, j);
        const float ofc = kCapCPL == 1 ? of1 : pick(offset, j);
        // the z-lerp of the two planes, the dequant, the cast
        const float vo = __shfl_xor_sync(0xffffffffu, v[u][j], OP);
        const float v0 = p ? vo : v[u][j];
        const float v1 = p ? v[u][j] : vo;
        float x = (1.f - e.fz) * v0 + e.fz * v1;
        x = x * scc + ofc;
        if (BF16) x = round_bf16(x);
        // the pair's x taps, summed and rounded
        const float px = wxa * x;
        const float pxo = __shfl_xor_sync(0xffffffffu, px, OA);
        float tmp = 0.f + (same_x && a ? pxo : px);
        if (same_x) tmp += a ? px : pxo;
        if (BF16) tmp = round_bf16(tmp);
        // its y taps
        const float py = tmp * wyb;
        const float pyo = __shfl_xor_sync(0xffffffffu, py, OB);
        float term = 0.f + (same_y && b ? pyo : py);
        if (same_y) term += b ? py : pyo;
        // the kept pairs' terms in increasing pair id, at lanes (0, 0, 0)
        const float t01 = __shfl_down_sync(0xffffffffu, term, OB);
        const float t10 = __shfl_down_sync(0xffffffffu, term, OA);
        const float t11 = __shfl_down_sync(0xffffffffu, term, OA + OB);
        if (r < OB && i < total) {
          float acc = 0.f;
          if (e.flags & 1) acc += term;
          if ((e.flags & 2) && !same_y) acc += t01;
          if ((e.flags & 4) && !same_x) acc += t10;
          if ((e.flags & 8) && !same_x && !same_y) acc += t11;
          sh[c * n + e.o] = acc;
        }
      }
    }
  }
}

"""


def lanes(cpl: int, u: int):
    """The kernel with the generic pass B at ``cpl`` channels a lane and
    ``u`` groups of hits a warp at a time."""
    def edit(src: str) -> str:
        if _PASS_B_AT not in src or _PASS_B_END not in src:
            raise RuntimeError("the source no longer holds pass B's markers")
        at, end = src.index(_PASS_B_AT), src.index(_PASS_B_END)
        body = _GENERIC_PASS_B.replace("@CPL@", str(cpl)).replace(
            "@U@", str(u))
        return src[:at] + body + src[end:]
    return edit


_PREFETCH = (
    "  {\n"
    "    size_t g = static_cast<size_t>(blockIdx.x) * kCapThreads +"
    " threadIdx.x;\n"
    "    const char* tp[4] = {(const char*)meta, (const char*)s_grid,\n"
    "                         (const char*)t_grid,\n"
    "                         PACKED ? (const char*)slots"
    " : (const char*)tab};\n"
    "    const size_t tb[4] = {(size_t)K * kMeta * 4, (size_t)Sn * 4,\n"
    "                          (size_t)Tn * 4, PACKED ? (size_t)Z2 * P"
    " * 4 : (size_t)Zt * (P + 1) * 4};\n"
    "    for (int i = 0; i < 4; ++i) {\n"
    "      const size_t lines = (tb[i] + 127) / 128;\n"
    "      if (g < lines) {\n"
    "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(tp[i] +"
    " g * 128));\n"
    "        break;\n"
    "      }\n"
    "      g -= lines;\n"
    "    }\n"
    "  }\n"
    "  // pass A\n")
# name -> edit of the source
VARIANTS = {
    "base": sub(),
    "32 lanes a hit, 1 hit a warp": lanes(1, 1),
    "32 lanes a hit, 4 hits a warp": lanes(1, 4),
    "32 lanes a hit, 8 hits a warp": lanes(1, 8),
    "8 lanes a hit, 8 hits a warp": lanes(4, 2),
    "pixels in runs of 256, one a block": sub((
        "(static_cast<size_t>(warp) * gridDim.x + blockIdx.x) * 32 + lane;",
        "(static_cast<size_t>(blockIdx.x) * kCapWarps + warp) * 32 + lane;")),
    "blocks of 128 threads": sub((
        "constexpr int kCapThreads = 512;",
        "constexpr int kCapThreads = 128;")),
    "blocks of 256 threads": sub((
        "constexpr int kCapThreads = 512;",
        "constexpr int kCapThreads = 256;")),
    "the small tables prefetched to L2 by the grid's first threads": sub((
        "  // pass A\n", _PREFETCH)),
    "no pass B": sub((
        "  for (int i0 = warp * kCapHits; i0 < total;",
        "  for (int i0 = warp * kCapHits; i0 < total && K < 0;")),
    "no gate loads (every pair kept)": sub(
        ("            const int c0 = __ldg(s0 + c);\n"
         "            const int c1 = __ldg(s0 + P + c);",
         "            const int c0 = 1;\n            const int c1 = 1;"),
        ("            kept = __ldg(tab_k + c) >= iso;",
         "            kept = true;")),
    "no zero stores": sub((
        "  if (o < n && !keep) {", "  if (o < n && !keep && K < 0) {")),
    "no field loads": sub((
        "      load_channels(q, sc, v);",
        "      v[0] = v[1] = v[2] = v[3] = 1.f;")),
}


def build_variants() -> dict:
    """{name: (library, ptxas usage of its capture entries)}; raises if an
    edit does not apply or a build fails."""
    src = (kernels.CSRC / "sweep_march.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = kernels.find_nvcc()
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
        try:
            text = edit(src)
        except RuntimeError as e:
            raise RuntimeError(f"variant {name!r}: {e}") from None
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        so = OUT / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.flags("sweep_march"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        usage = [u for u in kernels.ptxas_usage(log)
                 if "ao_capture_kernel" in u["entry"]]
        out[name] = (ctypes.CDLL(str(so)), usage)
    return out


def cold_ms(fn, reps: int, cold: bool = True) -> float:
    return statistics.median(time_samples(fn, reps, backlog=True,
                                          cold=cold))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--angles", default="0")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the ablations run on a CUDA card")
    print(card_line(), flush=True)
    variants = build_variants()
    for name, (_, usage) in variants.items():
        regs = sorted({u["registers"] for u in usage})
        spills = max(u["spill_stores"] + u["spill_loads"] for u in usage)
        print(f"[ptxas] {name}: {regs[0]}-{regs[-1]} registers, spills "
              f"{spills} B", flush=True)
    vols = volumes()
    base = variants["base"][0]
    print(f"ms behind a backlog with a cold L2, median of {args.reps}, in "
          f"turns base, variant, variant, base", flush=True)
    for ang in (float(x) for x in args.angles.split(",")):
        use(base)
        calls = capture_calls(vols, ang)
        for tag, (fn, _, m_hit) in calls.items():
            use(base)
            want = fn()
            for name, (lib, _) in variants.items():
                if name == "base":
                    continue
                use(lib)
                same = torch.equal(bits(fn()), bits(want))

                def run(lib, fn=fn):
                    return lambda: (use(lib), fn())
                turns = [cold_ms(run(base), args.reps),
                         cold_ms(run(lib), args.reps),
                         cold_ms(run(lib), args.reps),
                         cold_ms(run(base), args.reps)]
                print(f"[angle {ang}] {tag}: {name} "
                      f"{statistics.median(turns[1:3]):.4f} ms (base "
                      f"{statistics.median([turns[0], turns[3]]):.4f}); "
                      f"the base's bits: {'yes' if same else 'no'}",
                      flush=True)
            use(base)
            warm = cold_ms(fn, args.reps, cold=False)
            out = want
            one = torch.zeros(1, device="cuda")
            floors = {"empty kernel": lambda: one.add_(0.0),
                      "fill of the output": lambda: out.fill_(0.0),
                      "copy of m_hit": lambda: m_hit.clone()}
            line = ", ".join(f"{k} {cold_ms(f, args.reps):.4f}"
                             for k, f in floors.items())
            print(f"[angle {ang}] {tag}: base with a warm L2 {warm:.4f} ms; "
                  f"floors (cold L2): {line} ms", flush=True)
    use(base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
