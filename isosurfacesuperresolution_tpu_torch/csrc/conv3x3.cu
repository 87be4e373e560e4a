// 3x3 SAME convolutions for Hopper (sm_90a) on NHWC bf16 tensors, batch 1,
// and the phase conv (a 3x3 conv after a 2x pixel shuffle) on planar ones.
//
// Replaces three TPU kernels of isosurfacesuperresolution_tpu/ops:
//  * B6, `_kernel` (pallas_conv.py:35) behind `conv3x3_pallas_p128`: x
//    (H, W, C) and w (3, 3, C, Cout) with C and Cout multiples of 128 (C
//    entry `conv3x3_p128`);
//  * B7, `_kernel` (packed_conv.py:80) behind `packed_conv3x3`: a 64 -> 64
//    conv on pixel-pair-packed (H, W/2, 128) tensors, which are the memory
//    of the unpacked (H, W, 64) ones, so it is this kernel with C = Cout =
//    64 at the unpacked width (C entry `packed_conv3x3`);
//  * B5, `_kernel_blocked` (phase_conv.py:245) behind
//    `phase_conv3x3_amajor_blocked` and `_kernel` (phase_conv.py:96) behind
//    `phase_conv3x3_amajor`, one function in two TPU tilings (C entry
//    `phase_conv`).
// Contract of B6 and B7:
//   y[i, j, co] = act(bias[co] + sum_{dy, dx, c} x[i+dy-1, j+dx-1, c]
//                                                * w[dy, dx, c, co]),
//   x zero outside the image, x and w bf16, float32 products and sums, bias
//   float32, act = ReLU or identity, y bf16 or float32.
// Contract of B5: x (H, W, 256) bf16 A-major, x[i, j, (a'*2+b')*64 + c]
//   being pixel (2i+a', 2j+b') of the shuffled (2H, 2W, 64) image X; w
//   (3, 3, 64, 64) bf16 HWIO; bias (64,) float32; y (H, W, 256) B-major,
//   bf16 or float32:
//     y[i, j, (b*2+a)*64 + co] = act(bias[co] + sum_{d, e, c} w[d, e, c, co]
//                                    * X[2i+a+d-1, 2j+b+e-1, c]),
//   X zero outside the image (SAME padding at the shuffled size).  The
//   wrapper hands the bias over once per output channel (below).
//
// What bounds it on the H100: B6 at the planar post3 shape (540 x 960,
// 256 -> 256) is 611.5 GFLOP, 0.618 ms at the 989 TFLOP/s dense bf16
// tensor-core peak, against 531 MB moved (0.159 ms at 3.35 TB/s):
// operations.  B7 at 270 x 480 x 64 is 9.55 GFLOP (0.0097 ms) against
// 33.2 MB (0.0099 ms): bytes, with operations close behind.  B5 at the
// phase-tail frame (H = 540, W = 960) is 152.9 GFLOP (0.155 ms) against
// 531 MB with bf16 output (0.158 ms): both about equally.  So the design
// keeps the tensor cores fed (wgmma on operands that TMA brings ahead, the
// epilogue hidden behind the next tile) and keeps down the bytes each tile
// pulls from L2 (one input box serves two or three taps); device memory
// already sees each input and output element about once.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 taps x C,
// in the shape Hopper's fast kernels take.
//  * Tiles: 128 MB output pixels (a BH x BW block of the image, BW in 8 ...
//    64 chosen on the host to waste the fewest pixels at the edges) by NT
//    output channels (256 when Cout % 256 == 0, else 128; 64 for B7).  MB =
//    2 at NT <= 128: each consumer warpgroup then owns two 64-row blocks,
//    two independent chains of MMAs, which keeps the small m64n64k16 MMAs
//    of B7 closer to the tensor cores' rate than one chain does.
//  * Operands come by TMA, in the 128-byte swizzle (64 bf16 make one
//    128-byte row), so A is a K-major and B an MN-major (Cout contiguous,
//    `tnspB` = 1) wgmma operand as they land.  The input is a 3-D tensor
//    map (C, W, H): per (64-channel chunk, dx) one box of 64 channels x BW
//    x (BH + 2) rows at the tap's offset, whose pixels outside the image
//    (negative coordinates included) TMA fills with zeros, so SAME padding
//    costs no code.  The three dy taps read that box through views shifted
//    by whole image rows (dy BW rows of 128 B, multiples of the swizzle's
//    1024-byte period), which loads each input row from L2 3 (BH + 2) / BH
//    times a chunk instead of 9 times.  The weights are a 2-D map (Cout,
//    9 C), one (tap, chunk) step a 64 x NT box.  Maps are encoded on the
//    host per call (pointers change) and passed as __grid_constant__
//    parameters; `cuTensorMapEncodeTiled` is fetched with
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//  * Warp specialisation: one producer thread keeps two rings in flight,
//    two input boxes and 3-8 weight steps (160 KB), each slot with a
//    full and an empty mbarrier; two consumer warpgroups, 64 MB pixels
//    each, issue wgmma.mma_async m64nNTk16 (bf16 in, float32 accumulators:
//    128 registers a thread at NT = 256 and 128, 64 at NT = 64), keep one
//    step's MMAs in flight, and release a slot when its last MMAs are done.
//    setmaxnreg gives the consumers 232 registers and the producer 40.
//  * Persistent: one block per SM walks the tiles (N blocks innermost, so
//    neighbouring blocks share input rows in L2); a tile's epilogue runs
//    while the producer already loads the next tile's first steps.
//  * Epilogue: bias, ReLU and cast in registers, written to a 32 KB
//    staging buffer per consumer warpgroup in the 128-byte swizzle (no bank
//    conflicts), then TMA stores (a third map, over y) that clip the
//    image's ragged edges by themselves.  The stores drain while the
//    consumers already multiply the next tile; a warpgroup waits for them
//    to have read its buffer only before it refills it.
// B5 on the same engine, in the low-res domain.  With (di, a') =
// divmod(a + d - 1, 2) and (dj, b') = divmod(b + e - 1, 2), output phase
// (a, b)'s tap (d, e) reads input chunk a'*2+b' (64 channels) at the whole
// low-res shift (di, dj).  So the 36 (phase, tap) products are 16 views
// (chunk, di, dj) of the planar tensor, each feeding the 1, 2 or 4 phases
// whose taps reach it: 576 MACs a shuffled output pixel, the minimum.
//  * Tiles of 128 low-res pixels by all 256 output channels: four float32
//    accumulator blocks of 64 channels, one per phase (128 registers a
//    thread).
//  * Per chunk one input box per dj, (BH + 1) rows from the chunk's lower
//    di on, serves both of its di through views shifted by BW rows: 8
//    boxes a tile.  Low-res row i + di leaves [0, H) exactly when the
//    shuffled row leaves [0, 2H), so TMA's zero fill is the SAME padding.
//  * The nine taps stay in shared memory (72 KB, loaded once a block, tap
//    d*3+e from rows (d*3+e)*64 of w read as (9*64, 64)), and each (view,
//    phase) is one m64n64k16 chain of its tap into its phase's block: only
//    the input streams.  (One m64nNk16 per view over its taps side by
//    side, streamed, measured slower: ptxas serialises those MMAs.)
//  * Phase (a, b)'s block lands on channels (b*2+a)*64, so the B-major
//    tile is B6's NT = 256 tile and its epilogue stores it as it stands
//    (with the bias repeated per block).
// bf16 x bf16 products are exact in float32, so the result differs from a
// float32 reference conv on the same operands only in the order of the
// sums (no --fmad=false needed).

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKC = 64;                 // input channels a K step
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kBlockBytes = 64 * 128;       // 64 rows of 128 B
constexpr uint32_t kBBoxBytes = kKC * 64 * 2;    // one 64 x 64 weight box
constexpr uint32_t kOutBytes = 32 * 1024;     // epilogue staging a warpgroup
constexpr uint32_t kSmemMax = 227 * 1024;      // a block's shared memory

template <int NT>
struct Cfg {
  static constexpr int kMB = NT == 256 ? 1 : 2;   // 64-row blocks a consumer
  static constexpr int kTileM = 128 * kMB;         // output pixels a tile
  // an input box: the tile's rows and two halo rows, at BW <= 64
  static constexpr uint32_t kABytes = (kTileM + 2 * 64) * 128;
  static constexpr int kAStages = 2;
  static constexpr uint32_t kBBytes = kKC * NT * 2;   // a weight step
  // 1 KB of slack aligns the rings to the swizzle's 1024-byte period; then
  // the input ring, the weight ring, the staging buffers and the barriers
  static constexpr int kBStages =
      (kSmemMax - 1024 - kAStages * kABytes - kConsumers * kOutBytes - 512) /
      kBBytes;
  static constexpr size_t kSmem =
      1024 + kAStages * kABytes + kBStages * kBBytes +
      kConsumers * kOutBytes + 2 * (kAStages + kBStages) * sizeof(uint64_t);
  static_assert(kBStages >= 3, "the weight ring needs three steps");
};

// B5: 128-pixel tiles of all 256 output channels.  The input ring holds
// boxes of BH + 1 rows (at most 192 rows of 128 B); the nine taps stay
// resident.
struct PhaseCfg {
  static constexpr uint32_t kABytes = (128 + 64) * 128;
  static constexpr uint32_t kWBytes = 9 * kBBoxBytes;
  static constexpr int kAStages =
      (kSmemMax - 1024 - kWBytes - kConsumers * kOutBytes - 512) / kABytes;
  static constexpr size_t kSmem = 1024 + kAStages * kABytes + kWBytes +
                                  kConsumers * kOutBytes +
                                  (2 * kAStages + 1) * sizeof(uint64_t);
  static_assert(kAStages >= 2, "the input ring needs two boxes");
};

// The epilogue's output chunks: a 64-row block's 128-byte rows of 64 bf16
// or 32 float32 channels, at most kOutBytes / kBlockBytes of them staged at
// a time.
template <int NT, int MB, bool OUT_BF16>
struct Out {
  static constexpr int kCols = OUT_BF16 ? 64 : 32;
  static constexpr int kChunks = NT / kCols;      // a block's chunks
  static constexpr int kPerPass = kOutBytes / kBlockBytes;
  static constexpr int kPasses = (MB * kChunks + kPerPass - 1) / kPerPass;
};

struct Shape {
  int H, W, C, Cout;
  int bw_log2;    // tile width log2 (3 ... 6); BH = tile pixels / BW rows
  int tiles_x;    // tiles along W
  int n_blocks;   // output-channel blocks of NT
  int n_tiles;    // tiles_x * tiles along H * n_blocks
};

// ---- B5's views ----
// View v = 4 k + 2 jd + id, in the order the kernel reads them: input
// chunk k holds sub-pixel (a', b') = (k / 2, k % 2) and the view sits at
// low-res shift (di, dj) = (id - a', jd - b').  Output phase p = b*2 + a
// reads it with tap (d, e) = (2 di + a' + 1 - a, 2 dj + b' + 1 - b) when
// both lie in [0, 2]; view_tap gives 3 d + e, or -1.
__host__ __device__ constexpr int view_tap(int v, int p) {
  const int ap = v >> 3, bp = (v >> 2) & 1;
  const int di = (v & 1) - ap, dj = ((v >> 1) & 1) - bp;
  const int d = 2 * di + ap + 1 - (p & 1), e = 2 * dj + bp + 1 - (p >> 1);
  return d >= 0 && d <= 2 && e >= 0 && e <= 2 ? 3 * d + e : -1;
}

// the (phase, tap) products of views 0 ... v - 1
__host__ __device__ constexpr int view_products(int v) {
  int n = 0;
  for (int u = 0; u < v; ++u) {
    for (int p = 0; p < 4; ++p) n += view_tap(u, p) >= 0;
  }
  return n;
}

constexpr int kViews = 16;
static_assert(view_products(kViews) == 36 && view_products(1) == 4,
              "36 (phase, tap) products; view 0 feeds (and zeroes) all "
              "phases");

// the views in order, each as std::integral_constant<int, V>
template <int V = 0, class F>
__device__ __forceinline__ void for_views(F&& f) {
  f(std::integral_constant<int, V>{});
  if constexpr (V + 1 < kViews) for_views<V + 1>(f);
}

__device__ __forceinline__ void advance(int& slot, uint32_t& parity, int n) {
  if (++slot == n) {
    slot = 0;
    parity ^= 1;
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy writes to shared memory become visible to TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, float v0,
                                          float v1, bool bf16_out) {
  if (bf16_out) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                 "r"(*reinterpret_cast<const uint32_t*>(&h))
                 : "memory");
  } else {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0),
                 "f"(v1)
                 : "memory");
  }
}

// the first 1024-byte boundary of the dynamic shared memory (the
// swizzle's period)
__device__ __forceinline__ uint32_t smem_base(const uint8_t* smem) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023u) &
         ~1023u;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs
template <int M, int N>
__device__ __forceinline__ void acc_fence(float (&d)[M][N][32]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        asm volatile("" : "+f"(d[m][n][i])::"memory");
      }
    }
  }
}

// D (64 x N, float32 registers) += A (64 x 16, K-major) * B (16 x N,
// MN-major), both bf16 in shared memory; D is overwritten when scale_d is
// 0.  D is given as N / 64 blocks of 64 columns (32 registers each), which
// may be any registers.
#define ACC8(d, i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)

__device__ __forceinline__ void wgmma_n256(float (&d0)[32], float (&d1)[32],
                                           float (&d2)[32], float (&d3)[32],
                                           uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,"
      "%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,"
      "%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,"
      "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,"
      "%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d0), ACC32(d1), ACC32(d2), ACC32(d3)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d0)[32], float (&d1)[32],
                                           uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,"
      "%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d0), ACC32(d1)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,"
      "%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef ACC32
#undef ACC8

template <int NT>
__device__ __forceinline__ void wgmma_tile(float (&d)[NT / 64][32],
                                           uint64_t da, uint64_t db,
                                           uint32_t scale_d) {
  if constexpr (NT == 256) {
    wgmma_n256(d[0], d[1], d[2], d[3], da, db, scale_d);
  } else if constexpr (NT == 128) {
    wgmma_n128(d[0], d[1], da, db, scale_d);
  } else {
    wgmma_n64(d[0], da, db, scale_d);
  }
}

// B5, view V: one m64n64k16 MMA per phase it feeds, each with its
// resident tap's box at w + tap * kBBoxBytes
template <int V, int P = 0>
__device__ __forceinline__ void wgmma_taps(float (&d)[4][32], uint64_t da,
                                           uint32_t w, uint32_t scale_d) {
  if constexpr (P < 4) {
    constexpr int tap = view_tap(V, P);
    if constexpr (tap >= 0) {
      wgmma_n64(d[P], da, sw128_desc(w + tap * kBBoxBytes, kBBoxBytes, 1024),
                scale_d);
    }
    wgmma_taps<V, P + 1>(d, da, w, scale_d);
  }
}

// Epilogue of one consumer warpgroup wg: bias, ReLU and cast of its MB
// 64-row blocks of NT channels from n0 on, staged in the 128-byte swizzle
// at `out` and written by TMA stores.  Accumulator (16 wi + lane / 4 + 8 h,
// 8 j + 2 (lane % 4) + {0, 1}) of warp wi in block mb is pixel rr = 16 wi +
// lane / 4 + 8 h of the tile's 64-row block ib = wg MB + mb: tile rows
// 64 ib + rr, a (64 / wb) x wb block of the image (wb = min(BW, 64)).
// Flat chunk f = mb kChunks + c of the warpgroup holds block mb's output
// channels n0 + c kCols ... for its 64 pixels, one swizzled 128-byte row
// each, as the TMA store reads them; a pass stages kPerPass.
template <int NT, int MB, bool OUT_BF16, bool RELU>
__device__ __forceinline__ void store_tile(float (&acc)[MB][NT / 64][32],
                                           uint32_t out,
                                           const CUtensorMap* ymap,
                                           const float* __restrict__ bias,
                                           int n0, int q0, int p0,
                                           int bw_log2, int wg) {
  using O = Out<NT, MB, OUT_BF16>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cq = n0 + 2 * (lane & 3);
  const bool leader = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int pass = 0; pass < O::kPasses; ++pass) {
    if (leader) bulk_wait_read();   // the last stores left the buffer
    warpgroup_sync(1 + wg);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int f = mb * O::kChunks + (8 * j) / O::kCols;
        if (f / O::kPerPass != pass) continue;
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(bias + cq + 8 * j));
        // 16-byte group of this lane's two values in the 128-byte row
        const int g = OUT_BF16 ? j % 8 : 2 * (j % 4) + ((lane & 3) >> 1);
        const int in_g = OUT_BF16 ? 4 * (lane & 3) : 8 * (lane & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = (warp & 3) * 16 + (lane >> 2) + 8 * h;
          float v0 = acc[mb][j / 8][4 * (j % 8) + 2 * h] + bb.x;
          float v1 = acc[mb][j / 8][4 * (j % 8) + 2 * h + 1] + bb.y;
          if (RELU) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          st_shared(out + (f % O::kPerPass) * kBlockBytes + rr * 128 +
                        ((g ^ (rr & 7)) << 4) + in_g,
                    v0, v1, OUT_BF16);
        }
      }
    }
    fence_async_shared();
    warpgroup_sync(1 + wg);
    if (leader) {
      for (int i = 0; i < O::kPerPass; ++i) {
        const int f = pass * O::kPerPass + i;
        if (f >= MB * O::kChunks) break;
        const int r = 64 * (wg * MB + f / O::kChunks);  // tile row
        tma_store_3d(ymap, out + i * kBlockBytes,
                     n0 + (f % O::kChunks) * O::kCols,
                     q0 + (r & ((1 << bw_log2) - 1)), p0 + (r >> bw_log2));
      }
      bulk_commit();
    }
  }
}

template <int NT, bool OUT_BF16, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const float* __restrict__ bias, const Shape s) {
  using G = Cfg<NT>;
  extern __shared__ uint8_t smem_raw[];
  // input ring, weight ring, staging, then the barriers: full and empty of
  // each input slot, full and empty of each weight slot
  const uint32_t aring = smem_base(smem_raw);
  const uint32_t bring = aring + G::kAStages * G::kABytes;
  const uint32_t staging = bring + G::kBStages * G::kBBytes;
  const uint32_t afull0 = staging + kConsumers * kOutBytes;
  const uint32_t aempty0 = afull0 + 8 * G::kAStages;
  const uint32_t bfull0 = aempty0 + 8 * G::kAStages;
  const uint32_t bempty0 = bfull0 + 8 * G::kBStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < G::kAStages; ++i) {
      mbar_init(afull0 + 8 * i, 1);
      mbar_init(aempty0 + 8 * i, kConsumers * 4);
    }
    for (int i = 0; i < G::kBStages; ++i) {
      mbar_init(bfull0 + 8 * i, 1);
      mbar_init(bempty0 + 8 * i, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int chunks = s.C / kKC;
  const int bw = 1 << s.bw_log2;
  const int bh = G::kTileM >> s.bw_log2;
  const int warp = threadIdx.x >> 5;

  if (warp >= kConsumers * 4) {
    // producer warpgroup: one thread issues every load, in the consumers'
    // order: per chunk and dx an input box, then its three dy taps' weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      const uint32_t a_bytes = (bh + 2) * bw * 128;
      int as = 0, bs = 0;
      uint32_t aph = 0, bph = 0;
      for (int t = blockIdx.x; t < s.n_tiles; t += gridDim.x) {
        const int m = t / s.n_blocks;
        const int n0 = (t % s.n_blocks) * NT;
        const int p0 = (m / s.tiles_x) * bh;
        const int q0 = (m % s.tiles_x) * bw;
        for (int ch = 0; ch < chunks; ++ch) {
          const int c0 = ch * kKC;
          for (int dx = 0; dx < 3; ++dx) {
            mbar_wait(aempty0 + 8 * as, aph ^ 1);
            mbar_expect_tx(afull0 + 8 * as, a_bytes);
            tma_load_3d(aring + as * G::kABytes, &xmap, afull0 + 8 * as, c0,
                        q0 + dx - 1, p0 - 1);
            advance(as, aph, G::kAStages);
            for (int dy = 0; dy < 3; ++dy) {
              const uint32_t full = bfull0 + 8 * bs;
              mbar_wait(bempty0 + 8 * bs, bph ^ 1);
              mbar_expect_tx(full, G::kBBytes);
#pragma unroll
              for (int j = 0; j < NT / 64; ++j) {
                tma_load_2d(bring + bs * G::kBBytes + j * kBBoxBytes, &wmap,
                            full, n0 + 64 * j, (3 * dy + dx) * s.C + c0);
              }
              advance(bs, bph, G::kBStages);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // warpgroup wg owns the tile's 64-row blocks wg MB ... wg MB + MB - 1
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    float acc[G::kMB][NT / 64][32] = {};
    int as = 0, bs = 0;
    uint32_t aph = 0, bph = 0;
    for (int t = blockIdx.x; t < s.n_tiles; t += gridDim.x) {
      const int m = t / s.n_blocks;
      const int n0 = (t % s.n_blocks) * NT;
      const int p0 = (m / s.tiles_x) * bh;
      const int q0 = (m % s.tiles_x) * bw;
      // slots whose MMAs may still be in flight: released once the next
      // step's wait shows them done (-1: none)
      int held_b = -1, held_a = -1;
      for (int ch = 0; ch < chunks; ++ch) {
        for (int dx = 0; dx < 3; ++dx) {
          mbar_wait(afull0 + 8 * as, aph);
          for (int dy = 0; dy < 3; ++dy) {
            mbar_wait(bfull0 + 8 * bs, bph);
            // tap (dy, dx) reads the box from its row dy on
            const uint32_t a = aring + as * G::kABytes +
                               (dy * bw + wg * G::kMB * 64) * 128;
            const uint32_t b = bring + bs * G::kBBytes;
            acc_fence(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kKC / 16; ++kk) {
              // A: 16 channels = 32 bytes along the swizzled row; 8-row
              // groups 1 KB apart.  B: 16 weight rows = 2 KB down the box;
              // 64-column boxes kBBoxBytes apart, 8-row groups 1 KB apart.
              const uint64_t db =
                  sw128_desc(b + 2048 * kk, kBBoxBytes, 1024);
#pragma unroll
              for (int mb = 0; mb < G::kMB; ++mb) {
                wgmma_tile<NT>(acc[mb],
                               sw128_desc(a + mb * kBlockBytes + 32 * kk, 16,
                                          1024),
                               db, (ch | dx | dy | kk) != 0);
              }
            }
            wgmma_commit();
            acc_fence(acc);
            if (held_b >= 0) {
              wgmma_wait<1>();   // the previous step's MMAs are done
              if (lane == 0) {
                mbar_arrive(bempty0 + 8 * held_b);
                if (held_a >= 0) mbar_arrive(aempty0 + 8 * held_a);
              }
            }
            held_b = bs;
            held_a = dy == 2 ? as : -1;
            advance(bs, bph, G::kBStages);
          }
          advance(as, aph, G::kAStages);
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) {
        mbar_arrive(bempty0 + 8 * held_b);
        mbar_arrive(aempty0 + 8 * held_a);
      }
      store_tile<NT, G::kMB, OUT_BF16, RELU>(acc, staging + wg * kOutBytes,
                                             &ymap, bias, n0, q0, p0,
                                             s.bw_log2, wg);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();
  }
}

// B5.  Per 128-pixel tile (a BH x BW block of the low-res image) the
// producer loads, per chunk k and dj, one input box of BH + 1 rows; the
// consumers run the 16 views in order, each its MMAs into its phases'
// blocks.
template <bool OUT_BF16, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
    phase_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const float* __restrict__ bias, const Shape s) {
  using G = PhaseCfg;
  extern __shared__ uint8_t smem_raw[];
  // input ring, resident taps, staging, then the barriers: full and empty
  // of each input slot, and the resident taps' full
  const uint32_t aring = smem_base(smem_raw);
  const uint32_t wres = aring + G::kAStages * G::kABytes;
  const uint32_t staging = wres + G::kWBytes;
  const uint32_t afull0 = staging + kConsumers * kOutBytes;
  const uint32_t aempty0 = afull0 + 8 * G::kAStages;
  const uint32_t wfull = aempty0 + 8 * G::kAStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < G::kAStages; ++i) {
      mbar_init(afull0 + 8 * i, 1);
      mbar_init(aempty0 + 8 * i, kConsumers * 4);
    }
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int bw = 1 << s.bw_log2;
  const int bh = 128 >> s.bw_log2;
  const int warp = threadIdx.x >> 5;

  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(wfull, G::kWBytes);
      for (int t = 0; t < 9; ++t) {
        tma_load_2d(wres + t * kBBoxBytes, &wmap, wfull, 0, t * 64);
      }
      const uint32_t a_bytes = (bh + 1) * bw * 128;
      int as = 0;
      uint32_t aph = 0;
      for (int t = blockIdx.x; t < s.n_tiles; t += gridDim.x) {
        const int p0 = (t / s.tiles_x) * bh;
        const int q0 = (t % s.tiles_x) * bw;
        for_views([&](auto v) {
          constexpr int V = decltype(v)::value;
          if constexpr ((V & 1) == 0) {
            // chunk V / 4 = a'*2+b' at dj = jd - b', rows from di = -a' on
            mbar_wait(aempty0 + 8 * as, aph ^ 1);
            mbar_expect_tx(afull0 + 8 * as, a_bytes);
            tma_load_3d(aring + as * G::kABytes, &xmap, afull0 + 8 * as,
                        64 * (V >> 2), q0 + ((V >> 1) & 1) - ((V >> 2) & 1),
                        p0 - (V >> 3));
            advance(as, aph, G::kAStages);
          }
        });
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    // warpgroup wg owns the tile's 64-pixel block wg: BW-pixel rows
    // 64 wg / BW on
    const int wg = warp >> 2;
    const int lane = threadIdx.x & 31;
    float acc[1][4][32] = {};   // phase p = b*2 + a: channels 64 p ...
    mbar_wait(wfull, 0);
    int as = 0;
    uint32_t aph = 0;
    for (int t = blockIdx.x; t < s.n_tiles; t += gridDim.x) {
      const int p0 = (t / s.tiles_x) * bh;
      const int q0 = (t % s.tiles_x) * bw;
      // the input slot whose MMAs may still be in flight: released once
      // the next view's wait shows them done (-1: none)
      int held_a = -1;
      for_views([&](auto v) {
        constexpr int V = decltype(v)::value;
        constexpr int id = V & 1;
        if constexpr (id == 0) mbar_wait(afull0 + 8 * as, aph);
        // view (di, dj) reads the box from its row id on
        const uint32_t a = aring + as * G::kABytes + (id * bw + wg * 64) * 128;
        acc_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk) {
          wgmma_taps<V>(acc[0], sw128_desc(a + 32 * kk, 16, 1024),
                        wres + 2048 * kk, (V | kk) != 0);
        }
        wgmma_commit();
        acc_fence(acc);
        if (held_a >= 0) {
          wgmma_wait<1>();   // the previous view's MMAs are done
          if (lane == 0) mbar_arrive(aempty0 + 8 * held_a);
        }
        held_a = id == 1 ? as : -1;
        if constexpr (id == 1) advance(as, aph, G::kAStages);
      });
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) mbar_arrive(aempty0 + 8 * held_a);
      store_tile<256, 1, OUT_BF16, RELU>(acc, staging + wg * kOutBytes,
                                         &ymap, bias, 0, q0, p0, s.bw_log2,
                                         wg);
    }
    if ((threadIdx.x & 127) == 0) bulk_wait();
  }
}

// cuTensorMapEncodeTiled, fetched from the driver once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The SMs of device dev (< 64), asked once per process.
int sm_count(int dev) {
  static int counts[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  return counts[dev];
}

// The current device, or -1 where the tensor maps cannot be encoded.
int current_device() {
  int dev = 0;
  if (encode_tiled() == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      dev >= 64 || sm_count(dev) < 1) {
    return -1;
  }
  return dev;
}

// The tiles of tile_m output pixels: the tile width (8 ... 64) that leaves
// the fewest (ties: the narrower, whose input boxes carry fewer halo rows).
Shape tile_shape(int H, int W, int C, int Cout, int tile_m, int n_blocks) {
  Shape s{H, W, C, Cout, 3, 0, n_blocks, 0};
  long best = -1;
  for (int lg = 3; lg <= 6; ++lg) {
    const long bw = 1L << lg, bh = tile_m >> lg;
    const long n = ((W + bw - 1) / bw) * ((H + bh - 1) / bh);
    if (best < 0 || n < best) {
      best = n;
      s.bw_log2 = lg;
    }
  }
  s.tiles_x = (W + (1 << s.bw_log2) - 1) >> s.bw_log2;
  s.n_tiles = static_cast<int>(best) * n_blocks;
  return s;
}

// The three tensor maps of a launch: x (C, W, H) in boxes of 64 channels x
// BW x (BH + halo) rows; the weights (w_cols, w_rows) in 64 x 64 boxes; y
// (Cout, W, H) in boxes of one 128-byte row of channels x a 64-pixel
// block.  False if one cannot be encoded.
bool encode_maps(CUtensorMap (&maps)[3], const void* x, const void* w,
                 void* y, const Shape& s, int tile_m, int halo,
                 cuuint64_t w_cols, cuuint64_t w_rows, int out_bf16) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(s.C),
                               static_cast<cuuint64_t>(s.W),
                               static_cast<cuuint64_t>(s.H)};
  const cuuint64_t xstrides[2] = {static_cast<cuuint64_t>(s.C) * 2,
                                  static_cast<cuuint64_t>(s.W) * s.C * 2};
  const cuuint32_t xbox[3] = {
      kKC, static_cast<cuuint32_t>(1 << s.bw_log2),
      static_cast<cuuint32_t>((tile_m >> s.bw_log2) + halo)};
  const cuuint64_t wdims[2] = {w_cols, w_rows};
  const cuuint64_t wstrides[1] = {w_cols * 2};
  const cuuint32_t wbox[2] = {64, kKC};
  const cuuint64_t ysize = out_bf16 ? 2 : 4;
  const cuuint64_t ydims[3] = {static_cast<cuuint64_t>(s.Cout),
                               static_cast<cuuint64_t>(s.W),
                               static_cast<cuuint64_t>(s.H)};
  const cuuint64_t ystrides[2] = {static_cast<cuuint64_t>(s.Cout) * ysize,
                                  static_cast<cuuint64_t>(s.W) * s.Cout *
                                      ysize};
  const cuuint32_t ybox[3] = {static_cast<cuuint32_t>(128 / ysize),
                              static_cast<cuuint32_t>(1 << s.bw_log2),
                              static_cast<cuuint32_t>(64 >> s.bw_log2)};
  return encode(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(x), xdims, xstrides, xbox, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(w), wdims, wstrides, wbox, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&maps[2],
                out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, y, ydims, ystrides, ybox, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one instantiation with Smem bytes of dynamic shared memory, one
// block per SM (at most one per tile).
template <auto Kernel, size_t Smem>
int launch_t(const CUtensorMap (&maps)[3], const float* bias, const Shape& s,
             int dev, cudaStream_t stream) {
  // the devices (a bit each) on which the kernel may use that much shared
  // memory: granted once per process
  static uint64_t granted = 0;
  if (!(granted >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted |= 1ull << dev;
  }
  const int sms = sm_count(dev);
  const int grid = s.n_tiles < sms ? s.n_tiles : sms;
  Kernel<<<grid, kThreads, Smem, stream>>>(maps[0], maps[1], maps[2], bias,
                                           s);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool OUT_BF16, bool RELU>
int launch_conv(const CUtensorMap (&maps)[3], const float* bias,
                const Shape& s, int dev, cudaStream_t stream) {
  return launch_t<conv3x3_kernel<NT, OUT_BF16, RELU>, Cfg<NT>::kSmem>(
      maps, bias, s, dev, stream);
}

template <int NT>
int launch(const void* x, const void* w, const void* bias, void* y, int H,
           int W, int C, int Cout, int relu, int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || W < 1 || C < kKC || C % kKC || Cout < NT || Cout % NT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorNotSupported);
  const Shape s = tile_shape(H, W, C, Cout, Cfg<NT>::kTileM, Cout / NT);
  CUtensorMap maps[3];
  if (!encode_maps(maps, x, w, y, s, Cfg<NT>::kTileM, 2,
                   static_cast<cuuint64_t>(Cout),
                   static_cast<cuuint64_t>(9) * C, out_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* b = static_cast<const float*>(bias);
  if (out_bf16) {
    return relu ? launch_conv<NT, true, true>(maps, b, s, dev, st)
                : launch_conv<NT, true, false>(maps, b, s, dev, st);
  }
  return relu ? launch_conv<NT, false, true>(maps, b, s, dev, st)
              : launch_conv<NT, false, false>(maps, b, s, dev, st);
}

template <bool OUT_BF16, bool RELU>
int launch_phase(const CUtensorMap (&maps)[3], const float* bias,
                 const Shape& s, int dev, cudaStream_t stream) {
  return launch_t<phase_conv_kernel<OUT_BF16, RELU>, PhaseCfg::kSmem>(
      maps, bias, s, dev, stream);
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
  if (Cout % 256 == 0) {
    return launch<256>(x, w, bias, y, H, W, C, Cout, relu, out_bf16,
                       stream);
  }
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

// B5.  x (H, W, 256) bf16 A-major; w (3, 3, 64, 64) bf16 HWIO, read as
// (9 * 64, 64); bias (256,) float32, bias[co] at channel p * 64 + co of
// each phase p; y (H, W, 256) B-major, bf16 when out_bf16 else float32;
// all contiguous and 16-byte aligned.  Returns the CUDA error code of the
// launch.
extern "C" int phase_conv(const void* x, const void* w, const void* bias,
                          void* y, int H, int W, int relu, int out_bf16,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int dev = current_device();
  if (dev < 0) return static_cast<int>(cudaErrorNotSupported);
  const Shape s = tile_shape(H, W, 256, 256, 128, 1);
  CUtensorMap maps[3];
  if (!encode_maps(maps, x, w, y, s, 128, 1, 64, 9 * 64, out_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* b = static_cast<const float*>(bias);
  if (out_bf16) {
    return relu ? launch_phase<true, true>(maps, b, s, dev, st)
                : launch_phase<true, false>(maps, b, s, dev, st);
  }
  return relu ? launch_phase<false, true>(maps, b, s, dev, st)
              : launch_phase<false, false>(maps, b, s, dev, st);
}

// Dynamic shared memory of the conv kernel with NT-channel output tiles
// (64, 128 or 256): 1 KB of alignment slack, the two TMA rings, the two
// staging buffers and the barriers; -1 for another NT.  ptxas reports only
// static shared memory, which the kernels do not use.
extern "C" int conv3x3_smem_bytes(int nt) {
  switch (nt) {
    case 64:
      return static_cast<int>(Cfg<64>::kSmem);
    case 128:
      return static_cast<int>(Cfg<128>::kSmem);
    case 256:
      return static_cast<int>(Cfg<256>::kSmem);
    default:
      return -1;
  }
}

// Dynamic shared memory of the phase conv kernel.
extern "C" int phase_conv_smem_bytes() {
  return static_cast<int>(PhaseCfg::kSmem);
}
