// 3x3 SAME convolutions for Hopper (sm_90a) on NHWC bf16 tensors, batch 1.
//
// Replaces two TPU kernels of isosurfacesuperresolution_tpu/ops:
//  * B6, `_kernel` behind `conv3x3_pallas_p128` (pallas_conv.py): x (H, W, C)
//    and w (3, 3, C, Cout) with C and Cout multiples of 128 (C entry
//    `conv3x3_p128`);
//  * B7, `_kernel` behind `packed_conv3x3` (packed_conv.py): a 64 -> 64 conv
//    on pixel-pair-packed (H, W/2, 128) tensors, which are the memory of the
//    unpacked (H, W, 64) ones, so it is this kernel with C = Cout = 64 at the
//    unpacked width (C entry `packed_conv3x3`).
// Contract of both:
//   y[i, j, co] = act(bias[co] + sum_{dy, dx, c} x[i+dy-1, j+dx-1, c]
//                                                * w[dy, dx, c, co]),
//   x zero outside the image, x and w bf16, float32 products and sums, bias
//   float32, act = ReLU or identity, y bf16 or float32.
//
// What bounds it on the H100: B6 at the planar post3 shape (540 x 960,
// 256 -> 256) is 611.5 GFLOP, 0.618 ms at the 989 TFLOP/s dense bf16
// tensor-core peak, against 531 MB moved (0.159 ms at 3.35 TB/s):
// operations.  B7 at 270 x 480 x 64 is 9.55 GFLOP (0.0097 ms) against
// 33.2 MB (0.0099 ms): bytes and operations about equally.
//
// Design (simple and right first; the TPU kernel's row-band DMAs, float32
// accumulator rolls and B7's zero-block phase matrices are not carried
// over): an implicit GEMM on the tensor cores with nvcuda::wmma bf16
// 16x16x16 fragments and float32 accumulators.  A block owns an 8 x 16
// tile of output pixels (M = 128) and NT output channels (128 for B6, 64
// for B7) and loops over the input channels in steps of 32: per step it
// stages the (8+2) x (16+2) x 32 input halo and the 9 x 32 x NT weight
// slice in shared memory (100 KB for B6, so two blocks fit on an SM; 63 KB
// for B7), then each of the 8 warps multiplies its tile rows (one 16-pixel
// A fragment each) by its 64 output channels (four B fragments) over the
// 9 taps.  Shared rows are padded by 16 elements, keeping the 32-byte wmma
// pointer alignment.  The accumulators go through shared memory for the
// bias, ReLU, cast and 16-byte stores.  Loads are not overlapped with the
// MMAs within a block; wgmma, TMA and a multi-stage pipeline are the next
// step.  bf16 x bf16 products are exact in float32, so the result differs
// from a float32 reference conv on the same operands only in the order of
// the sums (no --fmad=false needed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTH = 8;               // output tile rows
constexpr int kTW = 16;              // output tile columns: one A fragment
constexpr int kHaloH = kTH + 2;
constexpr int kHaloW = kTW + 2;
constexpr int kKC = 32;              // input channels per step
constexpr int kHLd = kKC + 16;       // halo row stride (bf16): 96 B
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageLd = 68;         // float32 epilogue row stride

template <int NT>
struct Tile {
  static constexpr int kWarpsN = NT / 64;           // 64 channels a warp
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kRows = kTH / kWarpsM;       // tile rows a warp
  static constexpr int kWLd = NT + 16;              // weight row stride
  static constexpr int kMinBlocks = NT == 128 ? 2 : 3;
  static constexpr size_t kWeightElems =
      static_cast<size_t>(9) * kKC * kWLd;
  static constexpr size_t kHaloElems =
      static_cast<size_t>(kHaloH) * kHaloW * kHLd;
  static constexpr size_t kSmemBytes =
      (kWeightElems + kHaloElems) * sizeof(bf16);
  static_assert(kWarpsN * kWarpsM == kWarps && kRows * kWarpsM == kTH,
                "warps must tile the block");
  static_assert(kWarps * kRows * 16 * kStageLd * sizeof(float) <=
                    kSmemBytes,
                "epilogue staging must fit in shared memory");
};

template <int NT, bool OUT_BF16, bool RELU>
__global__ void __launch_bounds__(kThreads, Tile<NT>::kMinBlocks)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ bias, void* __restrict__ y, int H,
               int W, int C, int Cout) {
  using T = Tile<NT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* hs = ws + T::kWeightElems;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp % T::kWarpsM;
  const int warp_n = warp / T::kWarpsM;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int p0 = (blockIdx.x / tiles_x) * kTH;
  const int q0 = (blockIdx.x % tiles_x) * kTW;
  const int n0 = blockIdx.y * NT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kRows][4];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
#pragma unroll
    for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[r][n], 0.f);
  }

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the last step's MMAs are done with both buffers
    // weights: 9 taps x kKC input rows x NT output columns, 16-byte chunks
    constexpr int kRowChunks = NT / 8;
    for (int i = tid; i < 9 * kKC * kRowChunks; i += kThreads) {
      const int row = i / kRowChunks;          // tap * kKC + r
      const int chunk = i % kRowChunks;
      const int tap = row / kKC;
      const size_t off =
          (static_cast<size_t>(tap) * C + c0 + row % kKC) * Cout + n0;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + off) + chunk);
      *reinterpret_cast<uint4*>(ws + row * T::kWLd + chunk * 8) = v;
    }
    // input halo: (kTH+2) x (kTW+2) pixels x kKC channels, zero outside
    constexpr int kPixChunks = kKC / 8;
    for (int i = tid; i < kHaloH * kHaloW * kPixChunks; i += kThreads) {
      const int pix = i / kPixChunks;
      const int chunk = i % kPixChunks;
      const int p = p0 - 1 + pix / kHaloW;
      const int q = q0 - 1 + pix % kHaloW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0 && p < H && q >= 0 && q < W) {
        const size_t off = (static_cast<size_t>(p) * W + q) * C + c0;
        v = __ldg(reinterpret_cast<const uint4*>(x + off) + chunk);
      }
      *reinterpret_cast<uint4*>(hs + pix * kHLd + chunk * 8) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            b[4];
        const bf16* wp = ws + (tap * kKC + ks * 16) * T::kWLd + warp_n * 64;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          wmma::load_matrix_sync(b[n], wp + n * 16, T::kWLd);
        }
#pragma unroll
        for (int r = 0; r < T::kRows; ++r) {
          // output pixels (p0 + row, q0 + l), l < 16, read halo row
          // row + dy, columns l + dx
          const int row = warp_m * T::kRows + r;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              a;
          wmma::load_matrix_sync(
              a, hs + ((row + dy) * kHaloW + dx) * kHLd + ks * 16, kHLd);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            wmma::mma_sync(acc[r][n], a, b[n], acc[r][n]);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with shared memory: reuse it

  float* stage = reinterpret_cast<float*>(smem_raw) +
                 warp * T::kRows * 16 * kStageLd;
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::store_matrix_sync(stage + r * 16 * kStageLd + n * 16, acc[r][n],
                              kStageLd, wmma::mem_row_major);
    }
  }
  __syncwarp();
  const int px = lane >> 1;            // pixel of the 16-pixel row
  const int c_half = (lane & 1) * 32;  // first of this lane's 32 channels
  const int co = n0 + warp_n * 64 + c_half;
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int p = p0 + warp_m * T::kRows + r;
    const int q = q0 + px;
    if (p >= H || q >= W) continue;
    const size_t base = (static_cast<size_t>(p) * W + q) * Cout + co;
    const float* src = stage + (r * 16 + px) * kStageLd + c_half;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float t = src[j + u] + __ldg(bias + co + j + u);
        if (RELU) t = fmaxf(t, 0.f);
        v[u] = t;
      }
      if (OUT_BF16) {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          h[u] = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
        }
        *reinterpret_cast<uint4*>(static_cast<bf16*>(y) + base + j) =
            *reinterpret_cast<const uint4*>(h);
      } else {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(y) +
                                              base + j);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

template <int NT, bool OUT_BF16, bool RELU>
int launch_t(const void* x, const void* w, const void* bias, void* y, int H,
             int W, int C, int Cout, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<NT, OUT_BF16, RELU>;
  const int smem = static_cast<int>(Tile<NT>::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW), Cout / NT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), y, H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch(const void* x, const void* w, const void* bias, void* y, int H,
           int W, int C, int Cout, int relu, int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || W < 1 || C < kKC || C % kKC || Cout < NT || Cout % NT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_bf16) {
    return relu ? launch_t<NT, true, true>(x, w, bias, y, H, W, C, Cout, st)
                : launch_t<NT, true, false>(x, w, bias, y, H, W, C, Cout, st);
  }
  return relu ? launch_t<NT, false, true>(x, w, bias, y, H, W, C, Cout, st)
              : launch_t<NT, false, false>(x, w, bias, y, H, W, C, Cout, st);
}

}  // namespace

// B6.  x (H, W, C) bf16, w (3, 3, C, Cout) bf16 HWIO, bias (Cout,) float32,
// y (H, W, Cout), bf16 when out_bf16 else float32; C and Cout multiples of
// 128; all contiguous and 16-byte aligned.  Returns the CUDA error code of
// the launch.
extern "C" int conv3x3_p128(const void* x, const void* w, const void* bias,
                            void* y, int H, int W, int C, int Cout, int relu,
                            int out_bf16, void* stream) {
  if (C % 128 || Cout % 128) return static_cast<int>(cudaErrorInvalidValue);
  return launch<128>(x, w, bias, y, H, W, C, Cout, relu, out_bf16, stream);
}

// B7.  xp (H, W2, 128) bf16, the memory of (H, 2*W2, 64); w (3, 3, 64, 64)
// bf16 HWIO; bias (64,) float32; y (H, W2, 128) packed likewise, bf16 when
// out_bf16 else float32; all contiguous and 16-byte aligned.
extern "C" int packed_conv3x3(const void* xp, const void* w,
                              const void* bias, void* y, int H, int W2,
                              int relu, int out_bf16, void* stream) {
  return launch<64>(xp, w, bias, y, H, 2 * W2, 64, 64, relu, out_bf16,
                    stream);
}
