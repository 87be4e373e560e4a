// Sweep march for Hopper (sm_90a): the flat march (B1), the tiled march
// (B2) and the tiled AO capture (B4), and B2 and B4 over packed storage
// (B3, B4p).
//
// B1 replaces the TPU kernel `_march_kernel` behind `march_pallas` in
// isosurfacesuperresolution_tpu/render/sweep_pallas.py, both forms
// (has_ao=False and has_ao=True).  Same contract: a front-to-back march over the K slice planes of a
// (Z, X, Y) slice-major volume; per slice a z-lerp of two (X, Y) planes, the
// affine dequant (* scale + offset), the 2-tap tent resample
// F = wx @ slice @ wy^T onto the (Sn, Tn) intermediate grid, the first
// crossing F >= iso, the inverse-lerp fraction, and the gradients captured
// at the crossing: g_s, g_t = periodic central differences of the previous
// slice's F (Fm1), g_z = F - Fm1.  A slice whose do-flag is 0 is skipped
// and resets Fm1 to 0.  Outputs: m_hit, frac, g_s, g_t, g_z, each (Sn, Tn)
// float32 (m_hit = -1 where no crossing).  With a baked SH occlusion field
// ao (Z, 4, X, Y), stored in the resample type, the kernel also writes
// sh (4, Sn, Tn): the four channels resampled like the density (z-lerp in
// float32 of the stored values, the same bf16 rounding points, no scale or
// offset) at the crossing slice, 0 where the pixel never crosses.
//
// What bounds it on the H100: not bytes (the volume crosses HBM about
// once; at 512^3 uint8 the occupied tiles are ~0.02 ms of HBM time) nor
// tensor-core work.  It is a gather: per pixel and slice four 2 x 2 taps
// on two planes, eight scattered loads and ~100 scalar instructions, over
// K = 2Z slices, and at the timed views 96-99% of the 600 x 338 pixels
// never cross, so nearly every pixel walks all K slices (~100M
// pixel-slices a frame).  The SM's issue and load throughput bound it.
//
// Design (`march_kernel`; B1, B1-ao, B2 and B3 are its instantiations).  A
// block of 256 threads owns an 8 x 32 rectangle of intermediate pixels
// (s rows x t columns), one thread a pixel, and walks the slices in
// chunks (16 slices tiled, 64 flat), one barrier a chunk
// (__syncthreads_count: the block leaves once all its pixels crossed).
// - Block tables.  What is the same for a whole pixel row or the whole
//   block is listed once a slice into shared memory, a chunk ahead, by the
//   first threads while the others march: per slice its values (fz, iso,
//   lam, eye_t, zf or "skipped", its tile-table row), per pixel row its
//   two x taps (offset in the plane, PACKED in the tile, -1 outside the
//   volume; rounded tent weight; TILED its x tile and the occupancy of
//   that tile's row of tiles as a bit mask over y tiles).  A thread reads
//   its slice's and row's records with broadcast 16-byte loads; it finds
//   its column's two taps itself.  Against the per-pixel form this drops
//   the seven meta loads a slice, the row arithmetic, and for B2 and B3
//   the tile-table loads and integer divisions of every tap: occupancy is
//   a bit test, the y tile a multiply (`y_tile`).
// - The resample: the two passes of `sample_slice` in its order, a tap
//   outside the volume or in an unoccupied tile contributing 0 where
//   `sample_slice` skips it: the +0 leaves a float32 sum that starts at +0
//   bit for bit as it was.  So F and m_hit are the per-pixel form's, and
//   B3 equals B2 on lossless packings.
// - At the crossing, once a pixel: the periodic neighbours' Fm1 and
//   B1-ao's SH capture are recomputed from global memory by
//   `sample_slice` (neighbours may lie in other blocks).
// Measured and dropped (PERF.md, findings): the slice footprint's voxels
// staged in shared memory a slice ahead, formed once each, with a
// two-pass resample from there (2.1-2.8x slower: no voxel is shared at
// 2-18 voxels a pixel, and three barriers a slice); tables a slice ahead
// with each pixel's loads issued a slice early (1.3-2.3x slower: the
// barrier a slice, 64 registers).  TMA and cp.async do not fit the taps,
// which are 1-2-voxel gathers at any alignment.  No `wgmma`: the two
// resample matrices have two non-zeros a row, so a dense product would do
// (footprint width / 2) times the work.  Built with --fmad=false so every
// product and sum rounds on its own.
//
// B2 replaces `_tiled_kernel` (dense form) behind `march_pallas_tiled` in
// isosurfacesuperresolution_tpu/render/sweep_pallas_tiled.py.  The slice
// plane is cut into an (NTX, NTY) grid of (TX, TY) tiles, and a tile p
// (pair id xt * NTY + yt, P = NTX * NTY) is occupied on a slice with floor
// zf when tab[zf][p] >= iso: tab is the wrapper's tile table, the brick
// pyramid's largest max per tile over the brick layers of zf and zf + 1,
// with the row's largest in column P; it does not depend on the camera.
// Its function differs from B1's in two places: a slice works only when
// its do-flag is set and a tile is occupied (tab[zf][P] >= iso), otherwise
// Fm1 := 0 and no crossing test runs; and on a working slice a tap (x, y)
// contributes only when its tile (x / TX, y / TY) is occupied, so
//   F = sum_y rnd(sum_x [occ(x, y)] rnd(wx) rnd(sl)) rnd(wy),
// the TPU kernel's row accumulator over occupied tiles.  On the TPU the
// tiling gates DMA and matmul work; here it gates the loads: a tap of an
// unoccupied tile is never loaded (it contributes 0), and a slice with no
// occupied tile costs one read of the table a block.  The periodic
// neighbours' Fm1 is recomputed under slice k-1's occupancy.
//
// B4 replaces `_ao_capture_kernel` (dense form) behind `ao_capture_tiled`.
// A second pass after B2: a pixel whose march hit slice k = m_hit samples
// the 4-channel SH field there (stored uint8, or in the resample type),
// in pairs of field tiles (xt, yt) of its taps that the dilated occupancy
// of slice k keeps (a do-slice, tab[zf][p] >= iso with tab the wrapper's
// table dilated over 3 x 3 tiles, in fine voxels), in increasing pair id
// xt * NTY + yt; per pair the x taps inside xt are summed, rounded, and
// weighted by the y taps inside yt, and the pair terms add up in float32
// in that order.  uint8 fields are lerped in float32 and dequantized per
// channel (scale, offset) before the rounding to the resample type.  A
// coarse field (1/fd per axis) is sampled at the hit position times
// inv_f = 1/fd, between the coarse slabs
// zf2 = clip(floor(zc / fd - 0.5), 0, Z2 - 2) and zf2 + 1 (the TPU
// wrapper's rewrite of the meta z columns).  On the TPU the kernel loops
// over slices and DMAs (2, 4, TX, TY) windows; here a hit reads its own
// row k and at most 2 x 2 x 2 x 4 field values, with no loop over slices.
// The field is read through its strides (a permuted view is not copied).
// What bounds it on the H100: not bytes (m_hit read and sh written are
// 4 MB at 600 x 338, ~1.2 us) but latency: 0.5-4% of the pixels hit, and
// a hit's loads form a chain (m_hit -> meta -> pair gates -> field).  A
// thread a pixel would run that chain, up to ten round trips with the
// pairs one after another, while the other 31 lanes of its warp waited.
// Design (`ao_capture_kernel`, see its note): pass A, a thread a pixel,
// resolves each pixel's taps and gates in two round trips after m_hit and
// stores the zeros of pixels with no kept pair; the block's hits are
// listed in shared memory and pass B spreads each hit's 32 field values
// over eight lanes of a warp (four channels a lane), loaded together,
// summed with shuffles in the per-pixel order (bit for bit that form).
//
// B3 replaces `_tiled_kernel` in its packed form, behind
// `march_pallas_packed` in sweep_pallas_tiled.py: B2's function over a
// volume kept as an atlas of (TX, TY) slice tiles (only the tiles that
// differ from the background) and an int32 slot table slots[z][xt][yt]
// (slot 0: the all-background tile, stored 0).  It is the TILED march with
// a PACKED load: tap (jx, jy) of planes zf and zf + 1 reads
// atlas[slots[z][jx / TX][jy / TY]] at (jx % TX, jy % TY); the tile test
// against the tile table (of the atlas's tiles), the whole-slice skip and
// the neighbours' Fm1 are B2's.  The TPU kernel resolves the slots into
// per-frame (K, P) rows of SMEM outside the kernel; the slot table does not
// depend on the camera, so here each loaded tap reads it directly, once
// a plane (a small table that stays in L1/L2).  On the same
// tiles a lossless atlas gives B2's result bit for bit.
//
// B4p replaces `_ao_capture_kernel` in its packed form, behind
// `ao_capture_packed`: B4 over an AO atlas (N, 4, TX, TY) in the resample
// type and its slot table, at full resolution (no dequant, inv_f = 1).  A
// tile pair is kept when the slice's do-flag is set and its slot is
// non-zero on plane zf or zf + 1; no brick test, no dilation.  The pair's
// two tiles are read at their atlas slots; the sums are B4's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// meta row layout: 0 zc, 1 lam, 2 zf, 3 fz, 4 do-flag, 5 iso, 6 eye_s,
// 7 eye_t (the TPU kernel's layout)
constexpr int kMeta = 8;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ float load_f32(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the tiled march's tile table (Zt rows of P + 1 floats), its isovalue and
// the tile geometry, and for packed storage the (Z, NTX, NTY) slot table
// (null otherwise); all unused (null) by the flat march
struct Tiles {
  const float* tab;
  const int* slots;
  int Zt, P, TX, TY, NTY;
  float iso;
  float inv_ty;   // 1 / TY, rounded (see `y_tile`)
  // the table row of the slice with meta row m
  __device__ const float* row(const float* m) const {
    const int zf = min(max(static_cast<int>(m[2]), 0), Zt - 1);
    return tab + static_cast<size_t>(zf) * (P + 1);
  }
};

// F at pixel (sg, tg) of the slice described by meta row m; plane z of
// the field starts at vol + z * zstride.  TILED: only taps whose tile's
// entry in the slice's tile-table row tab reaches tl.iso contribute.
// PACKED: vol is the atlas, tile s starting at vol + s * zstride, and the
// tile of plane z at (xt, yt) is tl.slots[(z * NTX + xt) * NTY + yt].
template <typename T, bool BF16, bool TILED = false, bool PACKED = false>
__device__ float sample_slice(const T* __restrict__ vol, size_t zstride,
                              int Z, int X, int Y,
                              const float* __restrict__ m, float sg, float tg,
                              float scale, float offset, const Tiles& tl,
                              const float* __restrict__ tab = nullptr) {
  const float lam = m[1];
  const float fz = m[3];
  const float eye_s = m[6];
  const float eye_t = m[7];
  int zf = static_cast<int>(m[2]);
  zf = min(max(zf, 0), Z - 2);
  const float s_pos = eye_s + lam * (sg - eye_s);
  const float t_pos = eye_t + lam * (tg - eye_t);
  // the tent max(0, 1 - |pos - (j + 0.5)|) is non-zero for j0 and j0 + 1
  const int jx0 = static_cast<int>(floorf(s_pos - 0.5f));
  const int jy0 = static_cast<int>(floorf(t_pos - 0.5f));
  const T* p0 = vol + (PACKED ? 0 : static_cast<size_t>(zf) * zstride);
  const T* p1 = p0 + zstride;
  // PACKED: the slot rows of planes zf and zf + 1
  const int* s0 = PACKED ? tl.slots + static_cast<size_t>(zf) * tl.P : nullptr;
  float F = 0.f;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int jy = jy0 + b;
    if (jy < 0 || jy >= Y) continue;
    float tmp = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int jx = jx0 + a;
      if (jx < 0 || jx >= X) continue;
      const int xt = TILED ? jx / tl.TX : 0;
      const int yt = TILED ? jy / tl.TY : 0;
      if (TILED && !(__ldg(tab + xt * tl.NTY + yt) >= tl.iso)) continue;
      float v0, v1;
      if (PACKED) {
        const int c = xt * tl.NTY + yt;
        const size_t i = static_cast<size_t>(jx - xt * tl.TX) * tl.TY +
                         (jy - yt * tl.TY);
        v0 = load_f32(vol + static_cast<size_t>(__ldg(s0 + c)) * zstride + i);
        v1 = load_f32(vol + static_cast<size_t>(__ldg(s0 + tl.P + c)) * zstride +
                      i);
      } else {
        const size_t i = static_cast<size_t>(jx) * Y + jy;
        v0 = load_f32(p0 + i);
        v1 = load_f32(p1 + i);
      }
      float sl = (1.f - fz) * v0 + fz * v1;
      sl = sl * scale + offset;
      float wx = fmaxf(0.f, 1.f - fabsf(s_pos - (static_cast<float>(jx) + 0.5f)));
      if (BF16) {
        sl = round_bf16(sl);
        wx = round_bf16(wx);
      }
      tmp += wx * sl;
    }
    float wy = fmaxf(0.f, 1.f - fabsf(t_pos - (static_cast<float>(jy) + 0.5f)));
    if (BF16) {
      tmp = round_bf16(tmp);
      wy = round_bf16(wy);
    }
    F += tmp * wy;
  }
  return F;
}

// the AO field is stored in the resample type
template <bool BF16>
struct AoStore {
  using type = float;
};
template <>
struct AoStore<true> {
  using type = __nv_bfloat16;
};

// the block of `march_kernel`: kBS pixel rows (s) x kBT pixel columns (t),
// one thread a pixel, warp w on pixel row w
constexpr int kBS = 8;
constexpr int kBT = 32;
constexpr int kThreads = kBS * kBT;

// slices a chunk of tap tables (one barrier a chunk): the tiled marches'
// entries cost more to list (the tile masks), so their chunks are shorter
// (16 and 64 measured best of 8, 16, 32, 64)
template <bool TILED>
__host__ __device__ constexpr int chunk() {
  return TILED ? 16 : 64;
}

// One slice's taps, listed for the block (see the note at the top):
// slice = (fz, iso, lam, eye_t), zf = (zf, or -1 when the slice does not
// work; the offset of its tile-table row); per pixel row i, row[i] =
// (offsets of its taps jx0, jx0 + 1 in the plane (PACKED: in the tile; -1
// outside the volume), their rounded tent weights' bits) and, TILED,
// rtile[i] = (for each of the two taps the occupancy of its x tile's row
// of tiles as a bit mask over y tiles (NTY <= 32), its x tile).
struct Taps {
  float4 slice;
  int2 zf;
  int4 row[kBS];
  int4 rtile[kBS];
};

// Entry i of slice k = k0 + g into tc[g]: pixel row i < kBS, or (i =
// kBS) the slice's values.  A slice past K does not work.
template <bool BF16, bool TILED, bool PACKED>
__device__ void list_entry(Taps* tc, int k0, int g, int i,
                           const float* __restrict__ meta,
                           const float* __restrict__ s_grid, int s0, int K,
                           int Z, int X, int Y, int Sn, const Tiles& tl) {
  const int k = k0 + g;
  Taps& tp = tc[g];
  const float* m = meta + static_cast<size_t>(k) * kMeta;
  if (i == kBS) {
    bool work = k < K && __ldg(m + 4) > 0.5f;
    int tab = 0;
    if (TILED && work) {
      const float* row = tl.row(m);
      work = __ldg(row + tl.P) >= tl.iso;
      tab = static_cast<int>(row - tl.tab);
    }
    if (work) {
      tp.slice = make_float4(__ldg(m + 3), __ldg(m + 5), __ldg(m + 1),
                             __ldg(m + 7));
    }
    tp.zf = make_int2(
        work ? min(max(static_cast<int>(__ldg(m + 2)), 0), Z - 2) : -1, tab);
    return;
  }
  if (k >= K) return;
  const float sg = __ldg(s_grid + min(s0 + i, Sn - 1));
  const float lam = __ldg(m + 1);
  const float eye = __ldg(m + 6);
  const float pos = eye + lam * (sg - eye);
  const int j0 = static_cast<int>(floorf(pos - 0.5f));
  int o[2], tt[2];
  unsigned mask[2] = {0u, 0u};
  float wt[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int j = j0 + a;
    wt[a] = fmaxf(0.f, 1.f - fabsf(pos - (static_cast<float>(j) + 0.5f)));
    if (BF16) wt[a] = round_bf16(wt[a]);
    const bool in = j >= 0 && j < X;
    tt[a] = TILED && in ? j / tl.TX : 0;
    o[a] = in ? (PACKED ? (j - tt[a] * tl.TX) * tl.TY : j * Y) : -1;
    if (TILED && in && tl.NTY <= 32) {
      const float* cells = tl.row(m) + tt[a] * tl.NTY;
      for (int y = 0; y < tl.NTY; ++y) {
        mask[a] |= (__ldg(cells + y) >= tl.iso ? 1u : 0u) << y;
      }
    }
  }
  tp.row[i] = make_int4(o[0], o[1], __float_as_int(wt[0]),
                        __float_as_int(wt[1]));
  if (TILED) {
    tp.rtile[i] = make_int4(static_cast<int>(mask[0]),
                            static_cast<int>(mask[1]), tt[0], tt[1]);
  }
}

// List the taps of slices k0 .. k0 + chunk<TILED> - 1 into tc: per slice
// kBS row entries and one of the slice's values, entry e on thread e (the
// tiled chunk's 144 entries on the first five warps: the other warps
// march on meanwhile, which hides the entries' dependent loads better
// than spreading them over all warps, measured).
template <bool BF16, bool TILED, bool PACKED>
__device__ void list_chunk(Taps* tc, int k0, const float* __restrict__ meta,
                           const float* __restrict__ s_grid, int s0, int K,
                           int Z, int X, int Y, int Sn, const Tiles& tl) {
  constexpr int kPer = kBS + 1;
  for (int e = threadIdx.y * kBT + threadIdx.x; e < chunk<TILED>() * kPer;
       e += kThreads) {
    list_entry<BF16, TILED, PACKED>(tc, k0, e / kPer, e % kPer, meta,
                                    s_grid, s0, K, Z, X, Y, Sn, tl);
  }
}

// The y tile of column j >= 0: floor((j + 0.5) * rnd(1 / TY)) is j / TY
// exactly while (j / TY + 1) TY < 2^22: the fraction of (j + 0.5) / TY
// lies in [0.5 / TY, 1 - 0.5 / TY] and the two roundings move it by less
// than (j / TY + 1) 2^-23.  No integer division.
__device__ __forceinline__ int y_tile(int j, float inv_ty) {
  return static_cast<int>((static_cast<float>(j) + 0.5f) * inv_ty);
}

// F of this pixel on slice tp, its column at grid value tg: the taps
// jy0, jy0 + 1 of the column are found here, the row's from the table;
// planes zf and zf + 1 are read, a tap outside the volume or, TILED, in
// an unoccupied tile contributes 0 (a tap `sample_slice` skips); then the
// two passes of `sample_slice`, in its order.
template <typename T, bool BF16, bool TILED, bool PACKED>
__device__ float resample(const Taps& tp, int zf, float tg,
                          const T* __restrict__ vol, size_t plane, int Y,
                          float scale, float offset, const Tiles& tl) {
  const float4 sl4 = tp.slice;
  const float fz = sl4.x;
  const float lam = sl4.z;
  const float eye = sl4.w;
  const float pos = eye + lam * (tg - eye);
  const int j0 = static_cast<int>(floorf(pos - 0.5f));
  const int4 row = tp.row[threadIdx.y];
  int4 rt = make_int4(0, 0, 0, 0);
  if (TILED) rt = tp.rtile[threadIdx.y];
  const T* p0 = vol + static_cast<size_t>(zf) * plane;
  const float wx[2] = {__int_as_float(row.z), __int_as_float(row.w)};
  float F = 0.f;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int jy = j0 + b;
    float wy = fmaxf(0.f, 1.f - fabsf(pos - (static_cast<float>(jy) + 0.5f)));
    const bool in = jy >= 0 && jy < Y;
    const int yt = TILED && in ? y_tile(jy, tl.inv_ty) : 0;
    const int c = PACKED ? jy - yt * tl.TY : jy;
    float tmp = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = a ? row.y : row.x;
      float v = 0.f;
      bool take = in && r >= 0;
      if (TILED && take) {
        const int xt = a ? rt.w : rt.z;
        const unsigned mask = static_cast<unsigned>(a ? rt.y : rt.x);
        take = tl.NTY <= 32
                   ? (mask >> yt & 1u) != 0
                   : __ldg(tl.tab + tp.zf.y + xt * tl.NTY + yt) >= tl.iso;
      }
      if (take) {
        const size_t i = static_cast<size_t>(r) + c;
        float v0, v1;
        if (PACKED) {
          const int* srow = tl.slots + static_cast<size_t>(zf) * tl.P +
                            (a ? rt.w : rt.z) * tl.NTY + yt;
          v0 = load_f32(vol + static_cast<size_t>(__ldg(srow)) * plane + i);
          v1 = load_f32(vol + static_cast<size_t>(__ldg(srow + tl.P)) *
                                  plane + i);
        } else {
          v0 = load_f32(p0 + i);
          v1 = load_f32(p0 + plane + i);
        }
        v = (1.f - fz) * v0 + fz * v1;
        v = v * scale + offset;
        if (BF16) v = round_bf16(v);
      }
      tmp += wx[a] * v;
    }
    if (BF16) {
      tmp = round_bf16(tmp);
      wy = round_bf16(wy);
    }
    F += tmp * wy;
  }
  return F;
}

// TILED: at most 64 registers (4 blocks an SM); left to itself ptxas gave
// some tiled instantiations 40-48 registers and spilled (measured slower)
template <typename T, bool BF16, bool HAS_AO, bool TILED, bool PACKED = false>
__global__ void __launch_bounds__(kThreads, TILED ? 4 : 1)
march_kernel(const T* __restrict__ vol,
             const typename AoStore<BF16>::type* __restrict__ ao,
             const float* __restrict__ meta,
             const float* __restrict__ s_grid,
             const float* __restrict__ t_grid, int K, int Z, int X, int Y,
             int Sn, int Tn, float scale, float offset, Tiles tl,
             float* __restrict__ m_hit, float* __restrict__ frac,
             float* __restrict__ g_s, float* __restrict__ g_t,
             float* __restrict__ g_z, float* __restrict__ sh) {
  // the tap tables of chunks c and c + 1 at chunk c
  constexpr int kChunk = chunk<TILED>();
  __shared__ Taps taps[2][kChunk];
  const int s0 = static_cast<int>(blockIdx.y) * kBS;
  const int t0 = static_cast<int>(blockIdx.x) * kBT;
  const int s = s0 + static_cast<int>(threadIdx.y);
  const int t = t0 + static_cast<int>(threadIdx.x);
  const bool live = s < Sn && t < Tn;
  // a plane of the volume; PACKED: a tile of the atlas
  const size_t plane = PACKED ? static_cast<size_t>(tl.TX) * tl.TY
                              : static_cast<size_t>(X) * Y;
  const float tg = __ldg(t_grid + min(t, Tn - 1));
  float o_m = -1.f, o_frac = 0.f, o_gs = 0.f, o_gt = 0.f, o_gz = 0.f;
  float o_sh[4] = {0.f, 0.f, 0.f, 0.f};
  float fm1 = 0.f;
  bool done = !live;
  list_chunk<BF16, TILED, PACKED>(taps[0], 0, meta, s_grid, s0, K, Z, X, Y,
                                  Sn, tl);
  __syncthreads();
  const int chunks = (K + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    // the next chunk's tables, listed by 72 threads while all march
    list_chunk<BF16, TILED, PACKED>(taps[(c + 1) & 1], (c + 1) * kChunk,
                                    meta, s_grid, s0, K, Z, X, Y, Sn, tl);
    const Taps* cur = taps[c & 1];
    const int n = min(kChunk, K - c * kChunk);
    for (int g = 0; g < n && !done; ++g) {
      const int k = c * kChunk + g;
      const Taps& tk = cur[g];
      const int zf = tk.zf.x;
      if (zf < 0) {
        // skipped slice (tiled: also one with no occupied tile): no
        // crossing test, Fm1 resets to 0
        fm1 = 0.f;
        continue;
      }
      const float F = resample<T, BF16, TILED, PACKED>(
          tk, zf, tg, vol, plane, Y, scale, offset, tl);
      const float iso = tk.slice.y;
      if (F >= iso) {
        const float sg = __ldg(s_grid + s);
        const float* m = meta + static_cast<size_t>(k) * kMeta;
        const float d = F - fm1;
        const float denom = fabsf(d) > 1e-12f ? d : 1e-12f;
        o_frac = fminf(fmaxf((iso - fm1) / denom, 0.f), 1.f);
        o_m = static_cast<float>(k);
        o_gz = d;
        const float* mp = m - kMeta;
        const float* tab_p = TILED && k > 0 ? tl.row(mp) : nullptr;
        if (k > 0 && mp[4] > 0.5f &&
            (!TILED || __ldg(tab_p + tl.P) >= tl.iso)) {
          // Fm1 of the periodic neighbours: F of slice k-1 recomputed
          // (tiled: under slice k-1's occupancy)
          const int sp = s + 1 == Sn ? 0 : s + 1;
          const int sm = s == 0 ? Sn - 1 : s - 1;
          const int tp = t + 1 == Tn ? 0 : t + 1;
          const int tm = t == 0 ? Tn - 1 : t - 1;
          const float f_sp = sample_slice<T, BF16, TILED, PACKED>(
              vol, plane, Z, X, Y, mp, s_grid[sp], tg, scale, offset, tl,
              tab_p);
          const float f_sm = sample_slice<T, BF16, TILED, PACKED>(
              vol, plane, Z, X, Y, mp, s_grid[sm], tg, scale, offset, tl,
              tab_p);
          const float f_tp = sample_slice<T, BF16, TILED, PACKED>(
              vol, plane, Z, X, Y, mp, sg, t_grid[tp], scale, offset, tl,
              tab_p);
          const float f_tm = sample_slice<T, BF16, TILED, PACKED>(
              vol, plane, Z, X, Y, mp, sg, t_grid[tm], scale, offset, tl,
              tab_p);
          o_gs = 0.5f * (f_sp - f_sm);
          o_gt = 0.5f * (f_tp - f_tm);
        }
        if (HAS_AO) {
          // SH channels at the crossing slice: channel c of slice z is
          // plane z * 4 + c of the field
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            o_sh[ch] = sample_slice<typename AoStore<BF16>::type, BF16>(
                ao + ch * plane, 4 * plane, Z, X, Y, m, sg, tg, 1.f, 0.f,
                tl);
          }
        }
        done = true;
      }
      fm1 = F;
    }
    if (__syncthreads_count(done) == kThreads) break;
  }
  if (!live) return;
  const size_t o = static_cast<size_t>(s) * Tn + t;
  m_hit[o] = o_m;
  frac[o] = o_frac;
  g_s[o] = o_gs;
  g_t[o] = o_gt;
  g_z[o] = o_gz;
  if (HAS_AO) {
    const size_t n = static_cast<size_t>(Sn) * Tn;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) sh[ch * n + o] = o_sh[ch];
  }
}

template <typename T, bool BF16>
void launch(const void* vol, const void* ao, const void* meta,
            const void* s_grid, const void* t_grid, int K, int Z, int X,
            int Y, int Sn, int Tn, float scale, float offset, Tiles tl,
            void* m_hit, void* frac, void* g_s, void* g_t, void* g_z,
            void* sh, cudaStream_t stream) {
  using A = typename AoStore<BF16>::type;
  const dim3 block(kBT, kBS);
  const dim3 grid((Tn + kBT - 1) / kBT, (Sn + kBS - 1) / kBS);
  const T* v = static_cast<const T*>(vol);
  const A* a = static_cast<const A*>(ao);
  const float* mt = static_cast<const float*>(meta);
  const float* sg = static_cast<const float*>(s_grid);
  const float* tg = static_cast<const float*>(t_grid);
  float* o[6] = {static_cast<float*>(m_hit), static_cast<float*>(frac),
                 static_cast<float*>(g_s), static_cast<float*>(g_t),
                 static_cast<float*>(g_z), static_cast<float*>(sh)};
  if (tl.slots != nullptr) {
    march_kernel<T, BF16, false, true, true><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, tl, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  } else if (tl.tab != nullptr) {
    march_kernel<T, BF16, false, true><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, tl, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  } else if (ao != nullptr) {
    march_kernel<T, BF16, true, false><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, tl, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  } else {
    march_kernel<T, BF16, false, false><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, tl, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  }
}

// B4 and B4p (see the note at the top): a block of kCapThreads threads
// owns as many pixels (o = s * Tn + t), in runs of 32, one a warp, the
// runs of a block spread over the image.  Pass A, a thread a pixel:
// m_hit; the hit slice's meta row and the pixel's grid values, loaded
// together; the taps, rounded weights and tiles; the gates of the tap
// pairs, loaded together (B4: the dilated table; B4p: the slot entries of
// both planes).  A pixel with no kept pair stores its four zeros
// (coalesced); the others leave their record in shared memory and are
// listed in pixel order (__ballot_sync + __popc, a count a warp).  Pass
// B: each warp takes kCapHits listed hits at a time, kCapLanes lanes a
// hit; lane r of a hit's lanes holds plane p, x tap a and y tap b and
// loads the tap's four channels, all loads issued together, and the
// values are summed with warp shuffles in the parent's order.
// PACKED: field is the atlas, (sz, sc, sx, sy) its strides per slot,
// channel, x and y, and slots the (Z2, NTX, NTY) slot table; tab is
// unused.  This layout measured fastest of those `tools/ablate_capture.py`
// tries (PERF.md): blocks of 128 and 256 threads, runs of 256 pixels a
// block, 32 lanes a hit (a lane a channel) with 1, 4 or 8 hits a warp, 8
// lanes a hit with 8 hits a warp, the small tables prefetched.
constexpr int kCapThreads = 512;
constexpr int kCapWarps = kCapThreads / 32;
constexpr int kCapLanes = 8;
constexpr int kCapHits = 32 / kCapLanes;

// A listed hit, as pass A leaves it for pass B.  flags: bit 2a + b, the
// pair of taps (a, b) is kept (inside the field, its gate passed); bit 4,
// both x taps lie in one tile (one pair along x); bit 5, likewise y.
// PACKED: ox, oy the origins of the taps' tiles, slot[2 (2a + b) + p] the
// atlas slot of pair (a, b) on plane zf + p.
template <bool PACKED>
struct CapHit {
  int o, zf, jx0, jy0, flags;
  float fz, wx[2], wy[2];
  int ox[PACKED ? 2 : 1], oy[PACKED ? 2 : 1], slot[PACKED ? 8 : 1];
};

__device__ __forceinline__ float pick(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The four channels of a tap at p (channel stride sc) as float32: one
// vector load where they are contiguous and aligned, else four.
template <typename S>
__device__ __forceinline__ void load_channels(const S* p, long long sc,
                                              float v[4]) {
  if (sc == 1 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(S)) == 0) {
    if constexpr (sizeof(S) == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else if constexpr (sizeof(S) == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(x.x << 16);
      v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16);
      v[3] = __uint_as_float(x.y & 0xffff0000u);
    } else {
      const unsigned int x =
          __ldg(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = static_cast<float>((x >> (8 * c)) & 0xffu);
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = load_f32(p + c * sc);
}

template <typename S, bool BF16, bool PACKED = false>
__global__ void __launch_bounds__(kCapThreads)
ao_capture_kernel(const S* __restrict__ field, long long sz, long long sc,
                  long long sx, long long sy, const float* __restrict__ meta,
                  const float* __restrict__ s_grid,
                  const float* __restrict__ t_grid,
                  const float* __restrict__ m_hit,
                  const float* __restrict__ tab,
                  const int* __restrict__ slots, int Zt, int K, int Z2,
                  int X2, int Y2, int Sn, int Tn, int P, int TX, int TY,
                  int NTY, int fd, float iso, float inv_f, float4 scale,
                  float4 offset, float* __restrict__ sh) {
  __shared__ CapHit<PACKED> rec[kCapThreads];     // by thread
  __shared__ int list[kCapThreads];                // the hits' threads
  __shared__ int warp_hits[kCapWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t n = static_cast<size_t>(Sn) * Tn;
  // warp w of block b takes the 32 pixels of run w * gridDim.x + b: the
  // hits of a dense stretch of the image go to neighbouring blocks
  const size_t o =
      (static_cast<size_t>(warp) * gridDim.x + blockIdx.x) * 32 + lane;

  // pass A
  bool keep = false;
  const float mh = o < n ? m_hit[o] : -1.f;
  if (mh >= 0.f) {
    // the march stores the crossing slice as float(k)
    const int k = min(static_cast<int>(mh), K - 1);
    const float* m = meta + static_cast<size_t>(k) * kMeta;
    const int s = static_cast<int>(o / Tn);
    const int t = static_cast<int>(o - static_cast<size_t>(s) * Tn);
    float mk[kMeta];
#pragma unroll
    for (int i = 0; i < kMeta; ++i) mk[i] = __ldg(m + i);
    const float sg = __ldg(s_grid + s);
    const float tg = __ldg(t_grid + t);
    if (mk[4] > 0.5f) {
      CapHit<PACKED> h = {};
      const float lam = mk[1];
      const float eye_s = mk[6];
      const float eye_t = mk[7];
      float fz = mk[3];
      int zf = static_cast<int>(mk[2]);
      // the slice's row of the dilated table (fine voxels)
      const float* tab_k =
          PACKED ? nullptr
                 : tab + static_cast<size_t>(min(max(zf, 0), Zt - 1)) *
                             (P + 1);
      if (fd > 1) {
        // the fine cell-centered z maps to coarse z / fd (coarse voxel j's
        // center sits at fine (j + 0.5) * fd)
        const float zc2 = mk[0] / static_cast<float>(fd);
        const float zf2 = fminf(fmaxf(floorf(zc2 - 0.5f), 0.f),
                                static_cast<float>(Z2 - 2));
        fz = fminf(fmaxf(zc2 - 0.5f - zf2, 0.f), 1.f);
        zf = static_cast<int>(zf2);
      }
      zf = min(max(zf, 0), Z2 - 2);
      const float s_pos = (eye_s + lam * (sg - eye_s)) * inv_f;
      const float t_pos = (eye_t + lam * (tg - eye_t)) * inv_f;
      const int jx0 = static_cast<int>(floorf(s_pos - 0.5f));
      const int jy0 = static_cast<int>(floorf(t_pos - 0.5f));
      // the two taps per axis: rounded weight and tile (-1: outside)
      int xt[2], yt[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int jx = jx0 + a;
        const int jy = jy0 + a;
        xt[a] = (jx >= 0 && jx < X2) ? jx / TX : -1;
        yt[a] = (jy >= 0 && jy < Y2) ? jy / TY : -1;
        float wx = fmaxf(0.f, 1.f - fabsf(s_pos - (static_cast<float>(jx) +
                                                   0.5f)));
        float wy = fmaxf(0.f, 1.f - fabsf(t_pos - (static_cast<float>(jy) +
                                                   0.5f)));
        if (BF16) {
          wx = round_bf16(wx);
          wy = round_bf16(wy);
        }
        h.wx[a] = wx;
        h.wy[a] = wy;
      }
      // the gates of the four tap pairs, loaded together
      const int* s0 = PACKED ? slots + static_cast<size_t>(zf) * P : nullptr;
      int flags = (xt[0] >= 0 && xt[0] == xt[1] ? 16 : 0) |
                  (yt[0] >= 0 && yt[0] == yt[1] ? 32 : 0);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (xt[a] < 0 || yt[b] < 0) continue;
          const int c = xt[a] * NTY + yt[b];
          bool kept;
          if constexpr (PACKED) {
            // slot 0 is the all-zero tile
            const int c0 = __ldg(s0 + c);
            const int c1 = __ldg(s0 + P + c);
            h.slot[2 * (2 * a + b)] = c0;
            h.slot[2 * (2 * a + b) + 1] = c1;
            kept = c0 != 0 || c1 != 0;
          } else {
            kept = __ldg(tab_k + c) >= iso;
          }
          flags |= kept ? 1 << (2 * a + b) : 0;
        }
      }
      if constexpr (PACKED) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          h.ox[a] = xt[a] * TX;
          h.oy[a] = yt[a] * TY;
        }
      }
      h.o = static_cast<int>(o);
      h.zf = zf;
      h.jx0 = jx0;
      h.jy0 = jy0;
      h.fz = fz;
      h.flags = flags;
      keep = (flags & 15) != 0;
      if (keep) rec[threadIdx.x] = h;
    }
  }
  if (o < n && !keep) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sh[c * n + o] = 0.f;
  }
  const unsigned int ball = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_hits[warp] = __popc(ball);
  __syncthreads();
  int first = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kCapWarps; ++w) {
    const int c = warp_hits[w];
    first += w < warp ? c : 0;
    total += c;
  }
  if (keep) list[first + __popc(ball & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();

  // pass B: lane r of a hit's kCapLanes lanes holds plane p, x tap a,
  // y tap b; the shuffle offsets of b, a and p
  constexpr int OB = 1, OA = 2, OP = 4;
  const int grp = lane / kCapLanes;
  const int r = lane % kCapLanes;
  const int b = r & 1;
  const int a = (r >> 1) & 1;
  const int p = (r >> 2) & 1;
  for (int i0 = warp * kCapHits; i0 < total; i0 += kCapWarps * kCapHits) {
    const int i = i0 + grp;
    const CapHit<PACKED>& e = rec[list[min(i, total - 1)]];
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < total && ((e.flags >> (2 * a + b)) & 1)) {
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
      load_channels(q, sc, v);
    }
    const bool same_x = e.flags & 16;
    const bool same_y = e.flags & 32;
    const float wxa = a ? e.wx[1] : e.wx[0];
    const float wyb = b ? e.wy[1] : e.wy[0];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // the z-lerp of the two planes, the dequant, the cast
      const float vo = __shfl_xor_sync(0xffffffffu, v[c], OP);
      const float v0 = p ? vo : v[c];
      const float v1 = p ? v[c] : vo;
      float x = (1.f - e.fz) * v0 + e.fz * v1;
      x = x * pick(scale, c) + pick(offset, c);
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
      // the kept pairs' terms in increasing pair id, at lane (0, 0, 0)
      const float t01 = __shfl_down_sync(0xffffffffu, term, OB);
      const float t10 = __shfl_down_sync(0xffffffffu, term, OA);
      const float t11 = __shfl_down_sync(0xffffffffu, term, OA + OB);
      if (r == 0 && i < total) {
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

template <typename S, bool BF16, bool PACKED = false>
void launch_ao(const void* field, long long sz, long long sc, long long sx,
               long long sy, const void* meta, const void* s_grid,
               const void* t_grid, const void* m_hit, const void* tab,
               const void* slots, int Zt, int K, int Z2, int X2, int Y2,
               int Sn, int Tn, int P, int TX, int TY, int NTY, int fd,
               float iso, float inv_f, float4 scale, float4 offset, void* sh,
               cudaStream_t stream) {
  const size_t n = static_cast<size_t>(Sn) * Tn;
  const unsigned int grid =
      static_cast<unsigned int>((n + kCapThreads - 1) / kCapThreads);
  ao_capture_kernel<S, BF16, PACKED><<<grid, kCapThreads, 0, stream>>>(
      static_cast<const S*>(field), sz, sc, sx, sy,
      static_cast<const float*>(meta), static_cast<const float*>(s_grid),
      static_cast<const float*>(t_grid), static_cast<const float*>(m_hit),
      static_cast<const float*>(tab), static_cast<const int*>(slots), Zt, K,
      Z2, X2, Y2, Sn, Tn, P, TX, TY, NTY, fd, iso, inv_f, scale, offset,
      static_cast<float*>(sh));
}

// B2, or B3 when slots is not null
int march_tiled(const void* vol, int store, int mm_bf16, const void* slots,
                const void* meta, const void* s_grid, const void* t_grid,
                const void* tab, int Zt, int K, int Z, int X, int Y, int Sn,
                int Tn, int P, int TX, int TY, int NTY, float iso, float scale,
                float offset, void* m_hit, void* frac, void* g_s, void* g_t,
                void* g_z, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || Z < 2 || X < 1 || Y < 1 || Sn < 1 || Tn < 1 || tab == nullptr ||
      Zt < 1 || TX < 1 || TY < 1 || X % TX || Y % TY || NTY != Y / TY ||
      P != (X / TX) * NTY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tiles tl = {static_cast<const float*>(tab),
                    static_cast<const int*>(slots), Zt, P, TX, TY, NTY, iso,
                    1.f / static_cast<float>(TY)};
  const void* ao = nullptr;
  void* sh = nullptr;
#define TILED_ARGS vol, ao, meta, s_grid, t_grid, K, Z, X, Y, Sn, Tn, scale, \
    offset, tl, m_hit, frac, g_s, g_t, g_z, sh, st
  switch (store * 2 + (mm_bf16 ? 1 : 0)) {
    case 0: launch<float, false>(TILED_ARGS); break;
    case 1: launch<float, true>(TILED_ARGS); break;
    case 2: launch<__nv_bfloat16, false>(TILED_ARGS); break;
    case 3: launch<__nv_bfloat16, true>(TILED_ARGS); break;
    case 4: launch<uint8_t, false>(TILED_ARGS); break;
    case 5: launch<uint8_t, true>(TILED_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILED_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// store: 0 float32, 1 bfloat16, 2 uint8 volume; mm_bf16: round the
// resample operands to bf16.  ao: null, or the (Z, 4, X, Y) SH field in
// the resample type (float32, or bf16 when mm_bf16), and then sh receives
// the (4, Sn, Tn) capture.  Returns the cudaGetLastError() code.
extern "C" int sweep_march(const void* vol, int store, int mm_bf16,
                           const void* ao, const void* meta,
                           const void* s_grid, const void* t_grid, int K,
                           int Z, int X, int Y, int Sn, int Tn, float scale,
                           float offset, void* m_hit, void* frac, void* g_s,
                           void* g_t, void* g_z, void* sh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || Z < 2 || X < 1 || Y < 1 || Sn < 1 || Tn < 1 ||
      (ao != nullptr && sh == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tiles tl = {nullptr, nullptr, 1, 0, 1, 1, 1, 0.f, 1.f};
#define MARCH_ARGS vol, ao, meta, s_grid, t_grid, K, Z, X, Y, Sn, Tn, scale, \
    offset, tl, m_hit, frac, g_s, g_t, g_z, sh, st
  switch (store * 2 + (mm_bf16 ? 1 : 0)) {
    case 0: launch<float, false>(MARCH_ARGS); break;
    case 1: launch<float, true>(MARCH_ARGS); break;
    case 2: launch<__nv_bfloat16, false>(MARCH_ARGS); break;
    case 3: launch<__nv_bfloat16, true>(MARCH_ARGS); break;
    case 4: launch<uint8_t, false>(MARCH_ARGS); break;
    case 5: launch<uint8_t, true>(MARCH_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MARCH_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The tiled march (B2): the flat march's inputs and outputs (no AO) plus
// tab, the (Zt, P + 1) tile table of (TX, TY) tiles (pair id
// xt * NTY + yt; column P the row's largest), and the physical isovalue
// it is compared with.  Returns the cudaGetLastError() code.
extern "C" int sweep_march_tiled(const void* vol, int store, int mm_bf16,
                                 const void* meta, const void* s_grid,
                                 const void* t_grid, const void* tab, int Zt,
                                 int K, int Z, int X, int Y, int Sn, int Tn,
                                 int P, int TX, int TY, int NTY, float iso,
                                 float scale, float offset, void* m_hit,
                                 void* frac, void* g_s, void* g_t, void* g_z,
                                 void* stream) {
  return march_tiled(vol, store, mm_bf16, nullptr, meta, s_grid, t_grid, tab,
                     Zt, K, Z, X, Y, Sn, Tn, P, TX, TY, NTY, iso, scale, offset,
                     m_hit, frac, g_s, g_t, g_z, stream);
}

// The packed march (B3): B2's arguments with the volume kept as an atlas
// (N, TX, TY) (store 0 / 1 / 2: float32, bfloat16, uint8) and its int32
// slot table slots (Z, X / TX, Y / TY); tab is the tile table of the
// atlas's tiles.  Returns the cudaGetLastError() code.
extern "C" int sweep_march_packed(const void* atlas, int store, int mm_bf16,
                                  const void* slots, const void* meta,
                                  const void* s_grid, const void* t_grid,
                                  const void* tab, int Zt, int K, int Z, int X,
                                  int Y, int Sn, int Tn, int P, int TX, int TY,
                                  int NTY, float iso, float scale,
                                  float offset, void* m_hit, void* frac,
                                  void* g_s, void* g_t, void* g_z,
                                  void* stream) {
  if (slots == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return march_tiled(atlas, store, mm_bf16, slots, meta, s_grid, t_grid, tab,
                     Zt, K, Z, X, Y, Sn, Tn, P, TX, TY, NTY, iso, scale, offset,
                     m_hit, frac, g_s, g_t, g_z, stream);
}

// The tiled AO capture (B4): field (Z2, 4, X2, Y2) addressed through its
// element strides (sz, sc, sx, sy), stored float32, bfloat16 or uint8
// (store 0 / 1 / 2); the march's meta; m_hit (Sn, Tn) from the march;
// tab the (Zt, P + 1) dilated tile table of the field tiles (TX, TY)
// taken in fine voxels, compared with iso; fd the field downsample and
// inv_f = 1 / fd in float32; per-channel scale and offset.  Writes sh
// (4, Sn, Tn).  Returns the cudaGetLastError() code.
extern "C" int ao_capture_tiled(const void* field, int store, int mm_bf16,
                                long long sz, long long sc, long long sx,
                                long long sy, const void* meta,
                                const void* s_grid, const void* t_grid,
                                const void* m_hit, const void* tab, int Zt,
                                int K, int Z2, int X2, int Y2, int Sn, int Tn,
                                int P, int TX, int TY, int NTY, int fd,
                                float iso, float inv_f, float s0, float s1,
                                float s2, float s3, float o0, float o1,
                                float o2, float o3, void* sh, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || Z2 < 2 || X2 < 1 || Y2 < 1 || Sn < 1 || Tn < 1 || TX < 1 ||
      TY < 1 || X2 % TX || Y2 % TY || NTY != Y2 / TY ||
      P != (X2 / TX) * NTY || tab == nullptr || Zt < 1 || fd < 1 ||
      static_cast<long long>(Sn) * Tn > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float4 scale = make_float4(s0, s1, s2, s3);
  const float4 offset = make_float4(o0, o1, o2, o3);
  const void* slots = nullptr;
#define AO_ARGS field, sz, sc, sx, sy, meta, s_grid, t_grid, m_hit, tab, \
    slots, Zt, K, Z2, X2, Y2, Sn, Tn, P, TX, TY, NTY, fd, iso, inv_f, scale, \
    offset, sh, st
  switch (store * 2 + (mm_bf16 ? 1 : 0)) {
    case 0: launch_ao<float, false>(AO_ARGS); break;
    case 1: launch_ao<float, true>(AO_ARGS); break;
    case 2: launch_ao<__nv_bfloat16, false>(AO_ARGS); break;
    case 3: launch_ao<__nv_bfloat16, true>(AO_ARGS); break;
    case 4: launch_ao<uint8_t, false>(AO_ARGS); break;
    case 5: launch_ao<uint8_t, true>(AO_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef AO_ARGS
  return static_cast<int>(cudaGetLastError());
}

// The packed AO capture (B4p): atlas (N, 4, TX, TY) contiguous in the
// resample type (float32, or bfloat16 when mm_bf16), its int32 slot table
// slots (Z, X / TX, Y / TY), the march's meta and m_hit (Sn, Tn).  Writes
// sh (4, Sn, Tn).  Returns the cudaGetLastError() code.
extern "C" int ao_capture_packed(const void* atlas, int mm_bf16,
                                 const void* slots, const void* meta,
                                 const void* s_grid, const void* t_grid,
                                 const void* m_hit, int K, int Z, int X, int Y,
                                 int Sn, int Tn, int TX, int TY, void* sh,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K < 1 || Z < 2 || X < 1 || Y < 1 || Sn < 1 || Tn < 1 || TX < 1 ||
      TY < 1 || X % TX || Y % TY || slots == nullptr ||
      static_cast<long long>(Sn) * Tn > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NTY = Y / TY;
  const long long tile = static_cast<long long>(TX) * TY;
  const float4 one = make_float4(1.f, 1.f, 1.f, 1.f);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#define PACKED_ARGS atlas, 4 * tile, tile, TY, 1, meta, s_grid, t_grid, m_hit, \
    nullptr, slots, 1, K, Z, X, Y, Sn, Tn, (X / TX) * NTY, TX, TY, NTY, 1, \
    0.f, 1.f, one, zero, sh, st
  if (mm_bf16) {
    launch_ao<__nv_bfloat16, true, true>(PACKED_ARGS);
  } else {
    launch_ao<float, false, true>(PACKED_ARGS);
  }
#undef PACKED_ARGS
  return static_cast<int>(cudaGetLastError());
}
