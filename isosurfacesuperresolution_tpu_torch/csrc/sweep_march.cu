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
// What bounds it on the H100: the volume (256^3 bf16 = 32 MB at the
// interactive frame) is re-read for every slice plane from L2, which holds
// it (50 MB), so the march is bound by L2/L1 load latency and the
// K * Sn * Tn two-by-two taps (8 loads, ~30 flops per pixel and live
// slice), not by device-memory bytes: the volume crosses HBM about once.
//
// Design (simple and right first): one thread per intermediate pixel
// (s, t), looping over k with the hit state in registers; neighbouring
// threads take neighbouring t, i.e. neighbouring y addresses, so a warp's
// taps share L1 lines.  Only the two non-zero taps per axis are sampled,
// straight from the volume, and values are rounded to bf16 exactly where
// the TPU kernel casts to its multiply type (slice, wx, tmp, wy), with
// float32 sums; the zero taps of the dense product add nothing.  Fm1 at the
// four periodic neighbours is recomputed only at the crossing (0 when
// slice k-1 was skipped or k = 0), and the thread leaves the loop once it
// has hit, since nothing it outputs changes after that.  The AO capture
// costs four more 2x2 samples per pixel, once, at its crossing.  Built with
// --fmad=false so every product and sum rounds on its own.  Shared-memory
// slice tiles and TMA are the next step.
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
// tiling gates DMA and matmul work; here a thread reads only its 2 x 2
// taps anyway, so the same B1 design carries it: a culled tap is never
// loaded, and an empty slice costs one read of the table.  The
// periodic neighbours' Fm1 is recomputed under slice k-1's occupancy.
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
// over slices and DMAs (2, 4, TX, TY) windows; here one thread per pixel
// reads its own row k and at most 2 x 2 x 2 x 4 field values, with no
// loop over slices.  The field is read through its strides (a permuted
// view is not copied).
// Bound: the field values sampled at the hits; the reads are scattered.
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
// depend on the camera, so here each tap reads it directly (one more load,
// from a small table that stays in L1/L2).  On the same tiles a lossless
// atlas gives B2's result bit for bit.
//
// B4p replaces `_ao_capture_kernel` in its packed form, behind
// `ao_capture_packed`: B4 over an AO atlas (N, 4, TX, TY) in the resample
// type and its slot table, at full resolution (no dequant, inv_f = 1).  A
// tile pair is kept when the slice's do-flag is set and its slot is
// non-zero on plane zf or zf + 1; no brick test, no dilation.  The pair's
// two tiles are read at their atlas slots; the sums are B4's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <typename T, bool BF16, bool HAS_AO, bool TILED, bool PACKED = false>
__global__ void __launch_bounds__(256)
march_kernel(const T* __restrict__ vol,
             const typename AoStore<BF16>::type* __restrict__ ao,
             const float* __restrict__ meta,
             const float* __restrict__ s_grid,
             const float* __restrict__ t_grid, int K, int Z, int X, int Y,
             int Sn, int Tn, float scale, float offset, Tiles tl,
             float* __restrict__ m_hit, float* __restrict__ frac,
             float* __restrict__ g_s, float* __restrict__ g_t,
             float* __restrict__ g_z, float* __restrict__ sh) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (s >= Sn || t >= Tn) return;
  // a plane of the volume; PACKED: a tile of the atlas
  const size_t plane = PACKED ? static_cast<size_t>(tl.TX) * tl.TY
                              : static_cast<size_t>(X) * Y;
  const float sg = s_grid[s];
  const float tg = t_grid[t];
  float o_m = -1.f, o_frac = 0.f, o_gs = 0.f, o_gt = 0.f, o_gz = 0.f;
  float o_sh[4] = {0.f, 0.f, 0.f, 0.f};
  float fm1 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* m = meta + static_cast<size_t>(k) * kMeta;
    // skipped slice (tiled: also one with no occupied tile): no crossing
    // test, Fm1 resets to 0
    const float* tab_k = TILED ? tl.row(m) : nullptr;
    if (!(m[4] > 0.5f) || (TILED && !(__ldg(tab_k + tl.P) >= tl.iso))) {
      fm1 = 0.f;
      continue;
    }
    const float F = sample_slice<T, BF16, TILED, PACKED>(
        vol, plane, Z, X, Y, m, sg, tg, scale, offset, tl, tab_k);
    const float iso = m[5];
    if (F >= iso) {
      const float d = F - fm1;
      const float denom = fabsf(d) > 1e-12f ? d : 1e-12f;
      o_frac = fminf(fmaxf((iso - fm1) / denom, 0.f), 1.f);
      o_m = static_cast<float>(k);
      o_gz = d;
      const float* mp = m - kMeta;
      const float* tab_p = TILED && k > 0 ? tl.row(mp) : nullptr;
      if (k > 0 && mp[4] > 0.5f &&
          (!TILED || __ldg(tab_p + tl.P) >= tl.iso)) {
        // Fm1 of the periodic neighbours: F of slice k-1 recomputed (tiled:
        // under slice k-1's occupancy)
        const int sp = s + 1 == Sn ? 0 : s + 1;
        const int sm = s == 0 ? Sn - 1 : s - 1;
        const int tp = t + 1 == Tn ? 0 : t + 1;
        const int tm = t == 0 ? Tn - 1 : t - 1;
        const float f_sp = sample_slice<T, BF16, TILED, PACKED>(
            vol, plane, Z, X, Y, mp, s_grid[sp], tg, scale, offset, tl, tab_p);
        const float f_sm = sample_slice<T, BF16, TILED, PACKED>(
            vol, plane, Z, X, Y, mp, s_grid[sm], tg, scale, offset, tl, tab_p);
        const float f_tp = sample_slice<T, BF16, TILED, PACKED>(
            vol, plane, Z, X, Y, mp, sg, t_grid[tp], scale, offset, tl, tab_p);
        const float f_tm = sample_slice<T, BF16, TILED, PACKED>(
            vol, plane, Z, X, Y, mp, sg, t_grid[tm], scale, offset, tl, tab_p);
        o_gs = 0.5f * (f_sp - f_sm);
        o_gt = 0.5f * (f_tp - f_tm);
      }
      if (HAS_AO) {
        // SH channels at the crossing slice: channel c of slice z is plane
        // z * 4 + c of the field
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o_sh[c] = sample_slice<typename AoStore<BF16>::type, BF16>(
              ao + c * plane, 4 * plane, Z, X, Y, m, sg, tg, 1.f, 0.f, tl);
        }
      }
      break;
    }
    fm1 = F;
  }
  const size_t o = static_cast<size_t>(s) * Tn + t;
  m_hit[o] = o_m;
  frac[o] = o_frac;
  g_s[o] = o_gs;
  g_t[o] = o_gt;
  g_z[o] = o_gz;
  if (HAS_AO) {
    const size_t n = static_cast<size_t>(Sn) * Tn;
#pragma unroll
    for (int c = 0; c < 4; ++c) sh[c * n + o] = o_sh[c];
  }
}

template <typename T, bool BF16>
void launch(const void* vol, const void* ao, const void* meta,
            const void* s_grid, const void* t_grid, int K, int Z, int X,
            int Y, int Sn, int Tn, float scale, float offset, Tiles tl,
            void* m_hit, void* frac, void* g_s, void* g_t, void* g_z,
            void* sh, cudaStream_t stream) {
  using A = typename AoStore<BF16>::type;
  const dim3 block(32, 8);
  const dim3 grid((Tn + block.x - 1) / block.x, (Sn + block.y - 1) / block.y);
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

// B4 and B4p: see the note at the top.  One thread per intermediate
// pixel.  PACKED: field is the atlas, (sz, sc, sx, sy) its strides per slot,
// channel, x and y, and slots the (Z2, NTX, NTY) slot table; tab is unused.
template <typename S, bool BF16, bool PACKED = false>
__global__ void __launch_bounds__(256)
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
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (s >= Sn || t >= Tn) return;
  const size_t o = static_cast<size_t>(s) * Tn + t;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const float mh = m_hit[o];
  // the march stores the crossing slice as float(k)
  const int k = mh >= 0.f ? min(static_cast<int>(mh), K - 1) : 0;
  const float* m = meta + static_cast<size_t>(k) * kMeta;
  if (mh >= 0.f && m[4] > 0.5f) {
    // the slice's row of the dilated table (fine voxels)
    const float* tab_k =
        PACKED ? nullptr
               : tab + static_cast<size_t>(min(max(static_cast<int>(m[2]), 0),
                                               Zt - 1)) * (P + 1);
    const float lam = m[1];
    const float eye_s = m[6];
    const float eye_t = m[7];
    float fz = m[3];
    int zf = static_cast<int>(m[2]);
    if (fd > 1) {
      // the fine cell-centered z maps to coarse z / fd (coarse voxel j's
      // center sits at fine (j + 0.5) * fd)
      const float zc2 = m[0] / static_cast<float>(fd);
      const float zf2 = fminf(fmaxf(floorf(zc2 - 0.5f), 0.f),
                              static_cast<float>(Z2 - 2));
      fz = fminf(fmaxf(zc2 - 0.5f - zf2, 0.f), 1.f);
      zf = static_cast<int>(zf2);
    }
    zf = min(max(zf, 0), Z2 - 2);
    const float s_pos = (eye_s + lam * (s_grid[s] - eye_s)) * inv_f;
    const float t_pos = (eye_t + lam * (t_grid[t] - eye_t)) * inv_f;
    const int jx0 = static_cast<int>(floorf(s_pos - 0.5f));
    const int jy0 = static_cast<int>(floorf(t_pos - 0.5f));
    // the two taps per axis: rounded weight and tile (-1: outside)
    int xt[2], yt[2];
    float wx[2], wy[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int jx = jx0 + a;
      const int jy = jy0 + a;
      xt[a] = (jx >= 0 && jx < X2) ? jx / TX : -1;
      yt[a] = (jy >= 0 && jy < Y2) ? jy / TY : -1;
      wx[a] = fmaxf(0.f, 1.f - fabsf(s_pos - (static_cast<float>(jx) + 0.5f)));
      wy[a] = fmaxf(0.f, 1.f - fabsf(t_pos - (static_cast<float>(jy) + 0.5f)));
      if (BF16) {
        wx[a] = round_bf16(wx[a]);
        wy[a] = round_bf16(wy[a]);
      }
    }
    const float sc4[4] = {scale.x, scale.y, scale.z, scale.w};
    const float of4[4] = {offset.x, offset.y, offset.z, offset.w};
    // PACKED: the slot rows of planes zf and zf + 1
    const int* s0 = PACKED ? slots + static_cast<size_t>(zf) * P : nullptr;
    // pairs in increasing id xt * NTY + yt: distinct x tiles, then y tiles
    for (int ia = 0; ia < 2; ++ia) {
      const int pxt = xt[ia];
      if (pxt < 0 || (ia == 1 && pxt == xt[0])) continue;
      for (int ib = 0; ib < 2; ++ib) {
        const int pyt = yt[ib];
        if (pyt < 0 || (ib == 1 && pyt == yt[0])) continue;
        // the pair's planes zf and zf + 1, and the field index of their
        // first element
        const S* p0 = field + static_cast<long long>(zf) * sz;
        const S* p1 = p0 + sz;
        int ox = 0, oy = 0;
        if (PACKED) {
          // slot 0 is the all-zero tile
          const int c0 = __ldg(s0 + pxt * NTY + pyt);
          const int c1 = __ldg(s0 + P + pxt * NTY + pyt);
          if (c0 == 0 && c1 == 0) continue;
          p0 = field + c0 * sz;
          p1 = field + c1 * sz;
          ox = pxt * TX;
          oy = pyt * TY;
        } else if (!(__ldg(tab_k + pxt * NTY + pyt) >= iso)) {
          continue;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float term = 0.f;
          for (int b = 0; b < 2; ++b) {
            if (yt[b] != pyt) continue;
            float tmp = 0.f;
            for (int a = 0; a < 2; ++a) {
              if (xt[a] != pxt) continue;
              const long long i =
                  (jx0 + a - ox) * sx + (jy0 + b - oy) * sy + c * sc;
              float v = (1.f - fz) * load_f32(p0 + i) +
                        fz * load_f32(p1 + i);
              v = v * sc4[c] + of4[c];
              if (BF16) v = round_bf16(v);
              tmp += wx[a] * v;
            }
            if (BF16) tmp = round_bf16(tmp);
            term += tmp * wy[b];
          }
          acc[c] += term;
        }
      }
    }
  }
  const size_t n = static_cast<size_t>(Sn) * Tn;
#pragma unroll
  for (int c = 0; c < 4; ++c) sh[c * n + o] = acc[c];
}

template <typename S, bool BF16, bool PACKED = false>
void launch_ao(const void* field, long long sz, long long sc, long long sx,
               long long sy, const void* meta, const void* s_grid,
               const void* t_grid, const void* m_hit, const void* tab,
               const void* slots, int Zt, int K, int Z2, int X2, int Y2,
               int Sn, int Tn, int P, int TX, int TY, int NTY, int fd,
               float iso, float inv_f, float4 scale, float4 offset, void* sh,
               cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((Tn + block.x - 1) / block.x, (Sn + block.y - 1) / block.y);
  ao_capture_kernel<S, BF16, PACKED><<<grid, block, 0, stream>>>(
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
                    static_cast<const int*>(slots), Zt, P, TX, TY, NTY, iso};
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
  const Tiles tl = {nullptr, nullptr, 1, 0, 1, 1, 1, 0.f};
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
      P != (X2 / TX) * NTY || tab == nullptr || Zt < 1 || fd < 1) {
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
      TY < 1 || X % TX || Y % TY || slots == nullptr) {
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
