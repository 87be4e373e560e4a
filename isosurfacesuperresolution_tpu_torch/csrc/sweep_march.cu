// Sweep march for Hopper (sm_90a).
//
// Replaces the TPU kernel `_march_kernel` behind `march_pallas` in
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

// F at pixel (sg, tg) of the slice described by meta row m; plane z of
// the field starts at vol + z * zstride.
template <typename T, bool BF16>
__device__ float sample_slice(const T* __restrict__ vol, size_t zstride,
                              int Z, int X, int Y,
                              const float* __restrict__ m, float sg, float tg,
                              float scale, float offset) {
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
  const T* p0 = vol + static_cast<size_t>(zf) * zstride;
  const T* p1 = p0 + zstride;
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
      const size_t i = static_cast<size_t>(jx) * Y + jy;
      float sl = (1.f - fz) * load_f32(p0 + i) + fz * load_f32(p1 + i);
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

template <typename T, bool BF16, bool HAS_AO>
__global__ void __launch_bounds__(256)
march_kernel(const T* __restrict__ vol,
             const typename AoStore<BF16>::type* __restrict__ ao,
             const float* __restrict__ meta,
             const float* __restrict__ s_grid,
             const float* __restrict__ t_grid, int K, int Z, int X, int Y,
             int Sn, int Tn, float scale, float offset,
             float* __restrict__ m_hit, float* __restrict__ frac,
             float* __restrict__ g_s, float* __restrict__ g_t,
             float* __restrict__ g_z, float* __restrict__ sh) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y * blockDim.y + threadIdx.y;
  if (s >= Sn || t >= Tn) return;
  const size_t plane = static_cast<size_t>(X) * Y;
  const float sg = s_grid[s];
  const float tg = t_grid[t];
  float o_m = -1.f, o_frac = 0.f, o_gs = 0.f, o_gt = 0.f, o_gz = 0.f;
  float o_sh[4] = {0.f, 0.f, 0.f, 0.f};
  float fm1 = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* m = meta + static_cast<size_t>(k) * kMeta;
    if (!(m[4] > 0.5f)) {  // skipped slice: no update, Fm1 resets to 0
      fm1 = 0.f;
      continue;
    }
    const float F = sample_slice<T, BF16>(vol, plane, Z, X, Y, m, sg, tg,
                                          scale, offset);
    const float iso = m[5];
    if (F >= iso) {
      const float d = F - fm1;
      const float denom = fabsf(d) > 1e-12f ? d : 1e-12f;
      o_frac = fminf(fmaxf((iso - fm1) / denom, 0.f), 1.f);
      o_m = static_cast<float>(k);
      o_gz = d;
      const float* mp = m - kMeta;
      if (k > 0 && mp[4] > 0.5f) {
        // Fm1 of the periodic neighbours: F of slice k-1 recomputed
        const int sp = s + 1 == Sn ? 0 : s + 1;
        const int sm = s == 0 ? Sn - 1 : s - 1;
        const int tp = t + 1 == Tn ? 0 : t + 1;
        const int tm = t == 0 ? Tn - 1 : t - 1;
        const float f_sp = sample_slice<T, BF16>(
            vol, plane, Z, X, Y, mp, s_grid[sp], tg, scale, offset);
        const float f_sm = sample_slice<T, BF16>(
            vol, plane, Z, X, Y, mp, s_grid[sm], tg, scale, offset);
        const float f_tp = sample_slice<T, BF16>(
            vol, plane, Z, X, Y, mp, sg, t_grid[tp], scale, offset);
        const float f_tm = sample_slice<T, BF16>(
            vol, plane, Z, X, Y, mp, sg, t_grid[tm], scale, offset);
        o_gs = 0.5f * (f_sp - f_sm);
        o_gt = 0.5f * (f_tp - f_tm);
      }
      if (HAS_AO) {
        // SH channels at the crossing slice: channel c of slice z is plane
        // z * 4 + c of the field
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o_sh[c] = sample_slice<typename AoStore<BF16>::type, BF16>(
              ao + c * plane, 4 * plane, Z, X, Y, m, sg, tg, 1.f, 0.f);
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
            int Y, int Sn, int Tn, float scale, float offset, void* m_hit,
            void* frac, void* g_s, void* g_t, void* g_z, void* sh,
            cudaStream_t stream) {
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
  if (ao != nullptr) {
    march_kernel<T, BF16, true><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  } else {
    march_kernel<T, BF16, false><<<grid, block, 0, stream>>>(
        v, a, mt, sg, tg, K, Z, X, Y, Sn, Tn, scale, offset, o[0], o[1],
        o[2], o[3], o[4], o[5]);
  }
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
#define MARCH_ARGS vol, ao, meta, s_grid, t_grid, K, Z, X, Y, Sn, Tn, scale, \
    offset, m_hit, frac, g_s, g_t, g_z, sh, st
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
