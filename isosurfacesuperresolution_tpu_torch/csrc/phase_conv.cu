// Phase conv for Hopper (sm_90a): conv3x3 after a 2x pixel shuffle, read
// from and written to planar (sub-pixels in channels) tensors.
//
// Replaces the TPU kernels `_kernel_blocked` behind
// `phase_conv3x3_amajor_blocked` and `_kernel` behind `phase_conv3x3_amajor`
// in isosurfacesuperresolution_tpu/ops/phase_conv.py (same function, two
// tilings).  Contract:
//   x    (H, W, 256) bf16, A-major: x[i, j, (a'*2+b')*64 + c] is pixel
//        (2i+a', 2j+b') of the shuffled (2H, 2W, 64) image X;
//   w    (3, 3, 64, 64) bf16 HWIO kernel;
//   bias (64,) float32;
//   y    (H, W, 256) bf16 or float32, B-major:
//        y[i, j, (b*2+a)*64 + co] = act(bias[co] + sum_{d,e,c}
//            w[d, e, c, co] * X[2i+a+d-1, 2j+b+e-1, c]),
//        X zero outside the image (SAME padding at the shuffled size),
//        act = ReLU or identity, sums and bias in float32.
//
// What bounds it on the H100: at the 1080p frame (H = 540, W = 960) the
// conv is 2 * 1080 * 1920 * 64 * 64 * 9 = 152.9 GFLOP of bf16 products,
// 0.155 ms at the 989 TFLOP/s dense tensor-core peak, and it moves 265 MB
// in and 265 MB (bf16) or 531 MB (float32) out, 0.158 / 0.238 ms at
// 3.35 TB/s: operations and bytes bound it about equally.
//
// Design (simple and right first): an implicit GEMM on the tensor cores
// with nvcuda::wmma bf16 16x16x16 fragments and float32 accumulators.
// Persistent blocks (one per SM) stage the 9 x 64 x 64 weights in shared
// memory once and then walk over 8 x 32 tiles of the shuffled output; for
// each tile the (8+2) x (32+2) x 64 input halo is gathered from the A-major
// layout by index arithmetic (no shuffle is materialised), 64 channels =
// 128 B per shuffled pixel.  Each of the 8 warps owns one tile row: two
// 16-pixel A fragments x four 16-channel B fragments, 36 (tap, k-chunk)
// steps of 8 MMAs.  Shared rows are padded to 80 elements (160 B), a
// multiple of the 32 B wmma pointer alignment with a 2-way bank pattern.
// The accumulators go through shared memory (reusing the halo) for the
// bias, ReLU, cast and the B-major store, 16-byte vectors per lane.  Loads
// are not overlapped with the MMAs yet; wgmma, TMA and a double-buffered
// halo are the next step.  bf16 x bf16 products are exact in float32, so
// the result differs from a float32 reference conv on the same bf16
// operands only in the order of the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kF = 64;            // channels per sub-pixel block
constexpr int kC4 = 4 * kF;       // planar channels
constexpr int kLd = 80;           // shared row stride in bf16 elements
constexpr int kTH = 8;            // tile rows (shuffled resolution)
constexpr int kTW = 32;           // tile columns
constexpr int kWarps = kTH;       // one warp per tile row
constexpr int kThreads = kWarps * 32;
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kStageLd = 68;      // float32 epilogue row stride
constexpr size_t kWeightElems = static_cast<size_t>(9) * kF * kLd;
constexpr size_t kHaloElems = static_cast<size_t>(kHaloH) * kHaloW * kLd;
constexpr size_t kSmemBytes =
    (kWeightElems + kHaloElems) * sizeof(__nv_bfloat16);
static_assert(kWarps * 16 * kStageLd * sizeof(float) <=
                  kHaloElems * sizeof(__nv_bfloat16),
              "epilogue staging must fit in the halo buffer");

template <bool OUT_BF16, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
phase_conv_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, void* __restrict__ y,
                  int H, int W) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = ws + kWeightElems;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // weights -> shared once per block: 9 * 64 rows of 64 bf16 (8 x 16 B)
  for (int i = tid; i < 9 * kF * 8; i += kThreads) {
    const int row = i >> 3;
    const int chunk = i & 7;
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(w + row * kF) + chunk);
    *reinterpret_cast<uint4*>(ws + row * kLd + chunk * 8) = v;
  }

  const int Hs = 2 * H;
  const int Ws = 2 * W;
  const int tiles_x = (Ws + kTW - 1) / kTW;
  const int n_tiles = tiles_x * ((Hs + kTH - 1) / kTH);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = (tile / tiles_x) * kTH;
    const int q0 = (tile % tiles_x) * kTW;
    __syncthreads();  // weights staged; the last epilogue left the halo
    // halo -> shared: shuffled pixel (p, q) sits in planar pixel
    // (p / 2, q / 2), A-major block (p % 2) * 2 + q % 2
    for (int i = tid; i < kHaloH * kHaloW * 8; i += kThreads) {
      const int pix = i >> 3;
      const int chunk = i & 7;
      const int p = p0 - 1 + pix / kHaloW;
      const int q = q0 - 1 + pix % kHaloW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0 && p < Hs && q >= 0 && q < Ws) {
        const size_t off =
            (static_cast<size_t>(p >> 1) * W + (q >> 1)) * kC4 +
            (((p & 1) << 1) | (q & 1)) * kF;
        v = __ldg(reinterpret_cast<const uint4*>(x + off) + chunk);
      }
      *reinterpret_cast<uint4*>(hs + pix * kLd + chunk * 8) = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[g][n], 0.f);
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int d = tap / 3;
      const int e = tap % 3;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[4];
        const __nv_bfloat16* wp = ws + (tap * kF + kc * 16) * kLd;
#pragma unroll
        for (int n = 0; n < 4; ++n) wmma::load_matrix_sync(b[n], wp + n * 16, kLd);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          // output pixels (p0 + warp, q0 + g*16 + l) read halo row
          // warp + d, columns g*16 + l + e
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(
              a, hs + ((warp + d) * kHaloW + g * 16 + e) * kLd + kc * 16,
              kLd);
#pragma unroll
          for (int n = 0; n < 4; ++n) wmma::mma_sync(acc[g][n], a, b[n], acc[g][n]);
        }
      }
    }
    __syncthreads();  // every warp is done with the halo: reuse it

    float* stage = reinterpret_cast<float*>(hs) + warp * 16 * kStageLd;
    const int p = p0 + warp;
    const int px = lane >> 1;          // pixel of the 16-pixel group
    const int c0 = (lane & 1) * 32;    // first of this lane's 32 channels
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        wmma::store_matrix_sync(stage + n * 16, acc[g][n], kStageLd,
                                wmma::mem_row_major);
      }
      __syncwarp();
      const int q = q0 + g * 16 + px;
      if (p < Hs && q < Ws) {
        // B-major block (q % 2) * 2 + p % 2 of planar pixel (p/2, q/2)
        const size_t base =
            (static_cast<size_t>(p >> 1) * W + (q >> 1)) * kC4 +
            (((q & 1) << 1) | (p & 1)) * kF + c0;
        const float* src = stage + px * kStageLd + c0;
#pragma unroll
        for (int j = 0; j < 32; j += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float t = src[j + u] + __ldg(bias + c0 + j + u);
            if (RELU) t = fmaxf(t, 0.f);
            v[u] = t;
          }
          if (OUT_BF16) {
            __nv_bfloat162 h[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              h[u] = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
            }
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(y) +
                                      base + j) =
                *reinterpret_cast<const uint4*>(h);
          } else {
            float4* o = reinterpret_cast<float4*>(static_cast<float*>(y) +
                                                  base + j);
            o[0] = make_float4(v[0], v[1], v[2], v[3]);
            o[1] = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool OUT_BF16, bool RELU>
int launch(const void* x, const void* w, const void* bias, void* y, int H,
           int W, cudaStream_t stream) {
  auto kernel = phase_conv_kernel<OUT_BF16, RELU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_tiles =
      ((2 * W + kTW - 1) / kTW) * ((2 * H + kTH - 1) / kTH);
  const int blocks = n_tiles < sms ? n_tiles : sms;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      y, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (H, W, 256) bf16 A-major, w (3, 3, 64, 64) bf16, bias (64,) float32,
// y (H, W, 256) B-major, bf16 when out_bf16 else float32; all contiguous
// and 16-byte aligned.  Returns the CUDA error code of the launch.
extern "C" int phase_conv(const void* x, const void* w, const void* bias,
                          void* y, int H, int W, int relu, int out_bf16,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16) {
    return relu ? launch<true, true>(x, w, bias, y, H, W, st)
                : launch<true, false>(x, w, bias, y, H, W, st);
  }
  return relu ? launch<false, true>(x, w, bias, y, H, W, st)
              : launch<false, false>(x, w, bias, y, H, W, st);
}
