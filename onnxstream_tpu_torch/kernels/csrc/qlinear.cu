// Calibrated W8A8 uint8 products for Hopper (sm_90a), with a plain C ABI.
//
// Replaces two TPU kernels:
//
//  * qmatmul (onnxstream_tpu/kernels/qmatmul.py, the pallas_call of
//    _qmm_kernel): u8 A (M, K) x u8 W -> float or requantized u8 (M, N),
//      acc[m, n] = sum_k (A[m, k] - za) (W[k, n] - zw)
//                = dot(A, W) - za colsum(W)[n] - zw rowsum(A)[m] + K za zw,
//    plus an int32 bias, then out = float(acc) * alpha (alpha = sa sw), or
//    clamp(rint(float(acc) * alpha + beta), 0, 255) with alpha = sa sw / so and
//    beta = zo for a requantized output;
//  * qconv (onnxstream_tpu/kernels/qconv.py: an im2col padded with the input
//    zero point, run by XLA, then qmatmul): the same product as an implicit
//    GEMM. A is never materialized: each tile of it is gathered straight
//    from the u8 input, with za where the window falls into the padding, and
//    the output is written in NCHW directly. Channels-last operands (the
//    executor's layout for convs with C % 16 == 0) take the wgmma pipeline
//    below, NCHW / OIHW ones the mma.sync kernel.
//
// Exact integer arithmetic. The products run on the tensor cores as
// wgmma.m64nNk32.s32.u8.u8 or mma.sync.m16n8k32.row.col.s32.u8.u8.s32 (u8
// operands need no shift by 128), accumulating in int32. |acc| <= 255^2 K < 2^31 while K <= kMaxK = 33025;
// a larger K is refused. At K <= 4608 (the SD VAE's largest) each of
// dot(A, W), za colsum(W), zw rowsum(A) and K za zw stays under 3.0e8, so
// the corrections and the bias are subtracted and added in int32 without
// rounding. The one rounding is float(acc) * alpha (__fmul_rn), then the cast
// to the output dtype; the plain twin in kernels/qmatmul.py does the same, so
// the two agree bit for bit. The TPU kernel accumulates in float32 instead and
// differs by about 2^-24 relative above |acc| = 2^24.
//
// Row and column sums. Every block walks the whole K of its rows and columns,
// so it sums its own rows of A and columns of W from the staged tiles and
// needs no separate pass or cached vector.
//
// What bounds it on an H100: a VAE conv is bound by int8 tensor-core
// throughput (2 M N K operations at 1979 TOP/s; the whole 512 x 512 decode is
// 2.48 T operations, about 1.25 ms); the decode's four attention projections
// (4096 x 512 x 512) by their bytes (A, W and the bf16 output, 6.3 MB: about
// 2 us a call at 3.35 TB/s), so at that size launch, the first tile's latency
// and the epilogue's stores decide the time. Two variants, chosen from the
// operands' layouts, K, C and alignment alone (use_wgmma below, mirrored by
// qgemm_variant in kernels/qmatmul.py):
//
//  * qgemm_wgmma_kernel, the pipeline of gemm_sm90.cuh. A loading warpgroup
//    keeps a ring of four stages (two 128 x 128-byte tiles under the 128-byte
//    swizzle, 32 KB a stage) full of 16-byte cp.async copies, zero past the
//    edges, and the hardware arrives on each stage's mbarrier; two consumer
//    warpgroups run wgmma.m64n128k32.s32.u8.u8 on 128 x 128 output tiles.
//    The 8-bit wgmma reads only K-major operands, so both tiles are K-major
//    rows. The sums of the A tile's and of the B tile's rows are n8 wgmmas
//    of each against a tile of ones: exact in s32, in the same commit group
//    as the product. The tile leaves through shared memory in 16-byte pieces,
//    the bias read once per output channel. The loader is a template
//    parameter:
//      - DenseLoader, the MatMul whose weight is given K-major as (N, K) (the
//        executor uploads the calibrated MatMul weights so, through
//        WEIGHT_TRANSFORMS["tnk"]), K % 16 == 0, A and W 16-byte aligned: A
//        is the activation, B the weight;
//      - ConvLoader (kernel 4), the conv with a channels-last input (B, H, W,
//        C) and weight (O, kh, kw, C) (WEIGHT_TRANSFORMS["ohwi"]), C % 16 ==
//        0: K runs over (i, j, c), so a 16-byte piece of a k-tile is 16
//        channels of one tap of one output pixel, one cp.async from the
//        input, or from 16 bytes of za where the tap lies in the padding (no
//        shared-memory store, so no proxy fence), or zero past M and K. The
//        product is computed transposed: A is the weight's rows (output
//        channels), B the 128 output pixels, so the accumulator's rows are
//        output channels and its columns neighbouring pixels, as NCHW lays
//        them out. Where Ho Wo is a multiple of 128 a tile's pixels lie in
//        one image and each channel's row leaves in 16-byte pieces; elsewhere
//        element by element. The row sums are then the weight's (times za),
//        the column sums the pixels' (times zw), and the bias goes with the
//        rows.
//  * qgemm_kernel, every other MatMul (a (K, N) weight, ragged K, unaligned
//    views) and every NCHW conv (conv_in's C = 4, and what a caller passes
//    NCHW): the mma.sync tile of kernel 6 (qmatmul.cu), 64 x 128 x 64 tiles,
//    8 warps of 32 x 32, the next tile loaded into registers while the
//    current one is multiplied, row and column sums by dp4a. The conv gather
//    loads bytes (neighbouring threads take neighbouring output pixels, so a
//    warp's loads of one k are contiguous), which bounds it, and the (K, N)
//    MatMul weight is transposed in registers while it is staged (mma.sync
//    cannot transpose 8-bit elements). Ragged M, N and K (conv_in's K = 36,
//    conv_out's N = 3) are masked in the loads.
//
// Both variants add the same int32 terms and round once in the same way, so
// they give the same bits. Nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kPitch = kBK + 16;  // bytes: rows 20 words apart, fragment loads conflict-free
constexpr uint32_t kOnes = 0x01010101u;
constexpr int kMaxK = 33025;  // the largest K with 255^2 K < 2^31

struct QParams {
  const uint8_t* a;  // dense: (M, K) row-major; conv: x (B, C, H, W)
  const uint8_t* w;  // dense: (K, N), or (N, K) on the wgmma pipeline, row-major; conv: the OIHW weight as (N, K)
  const int* bias;   // (N,) in accumulator units, or nullptr
  void* out;         // dense: (M, N) row-major; conv: (B, N, Ho, Wo)
  int M, K, N;
  int za, zw;
  float alpha, beta;
  // conv geometry: M = B Ho Wo, K = C kh kw
  int C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, Ho, Wo;
  // conv operands channels-last: x as (B, H, W, C), the weight as (O, kh, kw,
  // C), so K runs over (i, j, c); za16 points at 16 bytes of za (the
  // padding's value, copied where a window leaves the input)
  int nhwc;
  const uint8_t* za16;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ uint8_t from_f32<uint8_t>(float x) {
  return static_cast<uint8_t>(static_cast<int>(x));
}

// four bytes W[k][n .. n+3] of a (K, N) byte matrix as one word, byte j =
// column n + j; zero past K and N. VEC: N % 4 == 0 and W 4-byte aligned.
template <bool VEC>
__device__ __forceinline__ uint32_t load_w4(const uint8_t* w, int k, int n, int K, int N) {
  if (k >= K) return 0u;
  const uint8_t* row = w + static_cast<size_t>(k) * N;
  if (VEC) return n < N ? __ldg(reinterpret_cast<const unsigned int*>(row + n)) : 0u;
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) v |= static_cast<uint32_t>(__ldg(row + n + j)) << (8 * j);
  return v;
}

// sixteen bytes row[k .. k+15] of a row of K bytes; zero past K. VEC: the row
// is 16-byte aligned and K % 16 == 0.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int k, int K) {
  if (VEC) return k < K ? __ldg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0, 0, 0, 0);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (k + e < K) wd[e / 4] |= static_cast<uint32_t>(__ldg(row + k + e)) << (8 * (e % 4));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// 4 x 4 byte transpose: r[i] holds row i's bytes (columns 0..3); c[j] gets
// column j's bytes (rows 0..3)
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t sum4(const uint4& v, uint32_t acc) {
  acc = __dp4a(v.x, kOnes, acc);
  acc = __dp4a(v.y, kOnes, acc);
  acc = __dp4a(v.z, kOnes, acc);
  return __dp4a(v.w, kOnes, acc);
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of mma.m16n8k32 (PTX ISA), g = lane / 4, t = lane % 4,
// each register four consecutive k:
//   A (16x32): a0 = (g, 4t..), a1 = (g+8, 4t..), a2 = (g, 16+4t..), a3 = (g+8, 16+4t..)
//   B (32x8):  b0 = (k 4t.., n g), b1 = (k 16+4t.., n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// 8 warps as 2 (M) x 4 (N), each a 32 x 32 tile: 2 x 4 mma per k32 step.
//
// A staging: dense A, thread tid takes row tid / 4, sixteen bytes from
// 16 (tid % 4); conv A, row tid % 64 and sixteen k from 16 (tid / 64), so that
// the 32 lanes of a warp gather one k for 32 neighbouring output pixels. A
// per-k table (input offset, i dh, j dw) of the next tile is built in shared
// memory, double buffered, by threads 0..63.
// W staging: the conv's (N, K) rows like dense A, two sixteen-byte chunks per
// thread; the dense (K, N) weight as 4 x 4 byte blocks u = tid + 256 v (k-quad
// u % 16, column quad u / 16), transposed in registers.
template <typename TO, bool CONV, bool AVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(const QParams p) {
  __shared__ __align__(16) uint8_t sA[kBM * kPitch];  // A, [m][k]
  __shared__ __align__(16) uint8_t sW[kBN * kPitch];  // W transposed, [n][k]
  __shared__ int s_koff[2][kBK], s_di[2][kBK], s_dj[2][kBK];
  __shared__ int s_rs[kBM], s_cs[kBN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  if (tid < kBM) s_rs[tid] = 0;
  if (tid < kBN) s_cs[tid] = 0;

  const int ar = CONV ? tid % kBM : tid / 4;
  const int ac = CONV ? 16 * (tid / kBM) : 16 * (tid % 4);
  const int am = m0 + ar;
  // conv: this thread's output pixel, as the input offset and the top-left
  // corner of its window
  long long abase = 0;
  int ih0 = 0, iw0 = 0;
  if (CONV && am < M) {
    const int hw = p.Ho * p.Wo;
    const int b = am / hw, r = am - b * hw;
    const int oh = r / p.Wo, ow = r - oh * p.Wo;
    ih0 = oh * p.sh - p.ph;
    iw0 = ow * p.sw - p.pw;
    abase = static_cast<long long>(b) * p.C * p.H * p.W + static_cast<long long>(ih0) * p.W + iw0;
  }
  auto build_table = [&](int buf, int k0) {
    if (tid < kBK) {
      const int k = k0 + tid;
      int koff = -1, di = 0, dj = 0;
      if (k < K) {
        const int khw = p.kh * p.kw;
        const int c = k / khw, rem = k - c * khw;
        const int i = rem / p.kw, j = rem - i * p.kw;
        di = i * p.dh;
        dj = j * p.dw;
        koff = c * p.H * p.W + di * p.W + dj;
      }
      s_koff[buf][tid] = koff;
      s_di[buf][tid] = di;
      s_dj[buf][tid] = dj;
    }
  };

  uint4 ra, rwv[2];
  uint32_t rw[2][4];
  auto load_tile = [&](int k0, int buf) {
    if (CONV) {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if (am < M) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int kk = ac + e;
          const int koff = s_koff[buf][kk];
          uint32_t v = 0u;
          if (koff >= 0) {
            const int ih = ih0 + s_di[buf][kk], iw = iw0 + s_dj[buf][kk];
            v = (static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                 static_cast<unsigned>(iw) < static_cast<unsigned>(p.W))
                    ? static_cast<uint32_t>(__ldg(p.a + abase + koff))
                    : static_cast<uint32_t>(p.za);
          }
          wd[e / 4] |= v << (8 * (e % 4));
        }
      }
      ra = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    } else {
      ra = am < M ? load16<AVEC>(p.a + static_cast<size_t>(am) * K, k0 + ac, K) : make_uint4(0, 0, 0, 0);
    }
    if (CONV) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = tid + kThreads * v;
        const int n = n0 + i / 4;
        rwv[v] = n < N ? load16<WVEC>(p.w + static_cast<size_t>(n) * K, k0 + 16 * (i % 4), K)
                       : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int u = tid + kThreads * v;
        const int kk = k0 + 4 * (u % 16), n = n0 + 4 * (u / 16);
#pragma unroll
        for (int r = 0; r < 4; ++r) rw[v][r] = load_w4<WVEC>(p.w, kk + r, n, K, N);
      }
    }
  };
  // partial row sums of A (row ar) and column sums of W, over this thread's bytes
  uint32_t rs = 0u, cs[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  auto store_tile = [&]() {
    *reinterpret_cast<uint4*>(sA + ar * kPitch + ac) = ra;
    rs = sum4(ra, rs);
    if (CONV) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = tid + kThreads * v;
        *reinterpret_cast<uint4*>(sW + (i / 4) * kPitch + 16 * (i % 4)) = rwv[v];
        cs[v][0] = sum4(rwv[v], cs[v][0]);
      }
    } else {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int u = tid + kThreads * v;
        uint32_t c[4];
        transpose4(rw[v], c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(sW + (4 * (u / 16) + j) * kPitch + 4 * (u % 16)) = c[j];
          cs[v][j] = __dp4a(c[j], kOnes, cs[v][j]);
        }
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nkt = (K + kBK - 1) / kBK;
  if (CONV) {
    build_table(0, 0);
    __syncthreads();
  }
  load_tile(0, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile and the table buffer of tile kt + 1 are consumed
    if (CONV && kt + 1 < nkt) build_table((kt + 1) & 1, (kt + 1) * kBK);
    store_tile();
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kBK, (kt + 1) & 1);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* pa = sA + (wm * 32 + i * 16 + g) * kPitch + ks * 32 + 4 * t;
        af[i][0] = ld32(pa);
        af[i][1] = ld32(pa + 8 * kPitch);
        af[i][2] = ld32(pa + 16);
        af[i][3] = ld32(pa + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* pb = sW + (wn * 32 + j * 8 + g) * kPitch + ks * 32 + 4 * t;
        bf[j][0] = ld32(pb);
        bf[j][1] = ld32(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_u8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // the block's row and column sums meet in shared memory (exact integer atomics)
  atomicAdd(&s_rs[ar], static_cast<int>(rs));
  if (CONV) {
#pragma unroll
    for (int v = 0; v < 2; ++v) atomicAdd(&s_cs[(tid + kThreads * v) / 4], static_cast<int>(cs[v][0]));
  } else {
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(&s_cs[4 * ((tid + kThreads * v) / 16) + j], static_cast<int>(cs[v][j]));
  }
  __syncthreads();

  const int kzz = K * p.za * p.zw;
  TO* out = static_cast<TO*>(p.out);
  const int hw = p.Ho * p.Wo;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 32 + i * 16 + g + (e / 2) * 8;
        const int c = wn * 32 + j * 8 + 2 * t + (e % 2);
        const int m = m0 + r, n = n0 + c;
        if (m >= M || n >= N) continue;
        int v = acc[i][j][e] - p.za * s_cs[c] - p.zw * s_rs[r] + kzz;
        if (p.bias) v += p.bias[n];
        float y = __fmul_rn(__int2float_rn(v), p.alpha);
        if constexpr (std::is_same<TO, uint8_t>::value)
          y = fminf(fmaxf(rintf(__fadd_rn(y, p.beta)), 0.f), 255.f);
        size_t idx;
        if (CONV) {
          const int b = m / hw;
          idx = (static_cast<size_t>(b) * N + n) * hw + (m - b * hw);
        } else {
          idx = static_cast<size_t>(m) * N + n;
        }
        out[idx] = from_f32<TO>(y);
      }
}

// ---------------------------------------------------------------------------
// The dense MatMul on the u8 wgmma pipeline (gemm_sm90.cuh)
// ---------------------------------------------------------------------------

struct Q8Cfg {
  static constexpr int kCWG = 2;                              // consumer warpgroups of 64 rows
  static constexpr int kBM = 64 * kCWG, kBN = 128;
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * gemm90::kBK8;          // 128 rows of one 128-byte k-tile
  static constexpr int kStageBytes = kABytes + kBN * gemm90::kBK8;
  static constexpr int kOnesBytes = 512;
  static constexpr int kColBytes = 2 * 4 * kBN;               // the tile's column sums and bias
  // the ring, the tile of ones, the column vectors, the barriers, slack to reach a 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes + kOnesBytes + kColBytes + 16 * kStages + 1024;
  static constexpr int kThreadsWg = (kCWG + 1) * gemm90::kWG;
  static_assert(kCWG * gemm90::OutTile<kBN, 4>::kBytes <= kStages * kStageBytes, "the output tiles reuse the ring");
  static_assert(kSmemBytes <= 232448, "shared memory of a block");
};

// The loader of the dense MatMul: A (M, K) and the weight as (N, K), both
// row-major with K bytes a row, into the A and W tiles of a stage. Output
// tile: rows m0.. of A, columns n0.. of W.
struct DenseLoader {
  static constexpr bool kConv = false;
  int m0, n0;
  __device__ __forceinline__ DenseLoader(const QParams&, int m0_, int n0_, int) : m0(m0_), n0(n0_) {}
  __device__ __forceinline__ void start(const QParams& p, uint32_t stage, int kt, int t) const {
    const int k0 = kt * gemm90::kBK8;
    gemm90::load_kmajor_tile<Q8Cfg::kBM>(stage, p.a, p.K, m0, p.M, k0, p.K, t);
    gemm90::load_kmajor_tile<Q8Cfg::kBN>(stage + Q8Cfg::kABytes, p.w, p.K, n0, p.N, k0, p.K, t);
  }
};

// The gather loader of the conv (kernel 4), channels-last operands. The
// product is computed transposed: the weight rows (O, kh kw C), K-major as
// uploaded, are the A tile (output channels m0..), and the B tile is 128
// output pixels (n0..) x 128 bytes of their windows, K ordered (i, j, c). A
// 16-byte piece of a k-tile holds 16 channels of one tap (C % 16 == 0), so
// each piece is one cp.async from the input, or from za16 where the tap falls
// into the padding, or zero past M and K. Thread t copies piece t % 8 of
// pixel rows t / 8 + 16 r: their window corners are computed once.
struct ConvLoader {
  static constexpr bool kConv = true;
  static constexpr int kRows = Q8Cfg::kBN * 8 / gemm90::kWG;  // pixel rows per loading thread
  int m0;
  unsigned valid;  // bit r: pixel row t / 8 + 16 r lies below M
  long long base[kRows];
  int ih0[kRows], iw0[kRows];
  __device__ __forceinline__ ConvLoader(const QParams& p, int m0_, int n0, int t) : m0(m0_), valid(0u) {
    const int hw = p.Ho * p.Wo;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pix = n0 + t / 8 + 16 * r;
      const int b = pix / hw, rem = pix - b * hw;
      const int oh = rem / p.Wo, ow = rem - oh * p.Wo;
      ih0[r] = oh * p.sh - p.ph;
      iw0[r] = ow * p.sw - p.pw;
      base[r] = static_cast<long long>(b) * p.H * p.W * p.C;
      if (pix < p.M) valid |= 1u << r;
    }
  }
  __device__ __forceinline__ void start(const QParams& p, uint32_t stage, int kt, int t) const {
    const int k0 = kt * gemm90::kBK8;
    gemm90::load_kmajor_tile<Q8Cfg::kBM>(stage, p.w, p.K, m0, p.N, k0, p.K, t);
    const int k = k0 + 16 * (t % 8);
    const int tap = k / p.C, ch = k - tap * p.C;
    const int i = tap / p.kw, j = tap - i * p.kw;
    const int di = i * p.dh, dj = j * p.dw;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ih = ih0[r] + di, iw = iw0[r] + dj;
      const bool inside = static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                          static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
      const uint8_t* src = inside ? p.a + base[r] + (static_cast<long long>(ih) * p.W + iw) * p.C + ch : p.za16;
      gemm90::cp_async16(stage + Q8Cfg::kABytes + gemm90::a_offset(t / 8 + 16 * r, t % 8), src,
                         k < p.K && ((valid >> r) & 1u));
    }
  }
};

template <typename TO> __device__ __forceinline__ void st_pair(uint32_t addr, TO y0, TO y1);
template <> __device__ __forceinline__ void st_pair<float>(uint32_t addr, float y0, float y1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(y0), "f"(y1) : "memory");
}
template <> __device__ __forceinline__ void st_pair<uint8_t>(uint32_t addr, uint8_t y0, uint8_t y1) {
  const unsigned short v = static_cast<unsigned short>(y0 | (y1 << 8));
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
template <typename TO> __device__ __forceinline__ void st_pair(uint32_t addr, TO y0, TO y1) {
  alignas(4) TO pair[2] = {y0, y1};
  gemm90::st_shared4(addr, *reinterpret_cast<const uint32_t*>(pair));
}

__device__ __forceinline__ int ld_shared_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// the exact accumulator, rounded once: float(v) * alpha, then the cast (or
// + beta, round half to even and clip for a uint8 output)
template <typename TO>
__device__ __forceinline__ TO q8_out(int v, const QParams& p) {
  float y = __fmul_rn(__int2float_rn(v), p.alpha);
  if constexpr (std::is_same<TO, uint8_t>::value) y = fminf(fmaxf(rintf(__fadd_rn(y, p.beta)), 0.f), 255.f);
  return from_f32<TO>(y);
}

// The conv's output tile leaves for NCHW: its rows are output channels
// ch0.., its columns 128 pixels from n0, a pixel's plane (b, channel) at
// ((b N + channel) Ho Wo). Where Ho Wo is a multiple of the tile's 128 pixels
// a tile lies in one image and each row leaves in 16-byte pieces; elsewhere
// element by element, neighbouring threads on neighbouring pixels.
template <typename TO, int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void flush_nchw(const uint8_t* tile, const QParams& p, int ch0, int n0, int t) {
  const int hw = p.Ho * p.Wo;
  TO* out = static_cast<TO*>(p.out);
  if (hw % COLS == 0) {
    constexpr int kPerRow = COLS * sizeof(TO) / 16;
    const int b = n0 / hw, p0 = n0 - b * hw;
#pragma unroll
    for (int j = 0; j < ROWS * kPerRow / gemm90::kWG; ++j) {
      const int i = t + gemm90::kWG * j;
      const int r = i / kPerRow, c = (i % kPerRow) * (16 / static_cast<int>(sizeof(TO)));
      if (ch0 + r < p.N && n0 + c < p.M)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * p.N + ch0 + r) * hw + p0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * PITCH + c * sizeof(TO));
    }
  } else {
    for (int i = t; i < ROWS * COLS; i += gemm90::kWG) {
      const int r = i / COLS, c = i % COLS, pix = n0 + c;
      if (ch0 + r < p.N && pix < p.M) {
        const int b = pix / hw;
        out[(static_cast<size_t>(b) * p.N + ch0 + r) * hw + pix - b * hw] =
            *reinterpret_cast<const TO*>(tile + r * PITCH + c * sizeof(TO));
      }
    }
  }
}

// Warpgroups 0 and 1 consume (rows 64 wg .. of the A tile), warpgroup 2
// loads through LOADER. The dense MatMul: blockIdx = (M tile, N tile), A the
// activation, B the weight. The conv (LOADER::kConv): blockIdx = (pixel tile,
// channel tile), A the weight, B the pixels, so the accumulator's rows are
// output channels and its columns pixels, as NCHW lays them out; the row
// sums are then the weight's (times za) and the column sums the pixels'
// (times zw), and the bias goes with the rows.
template <typename TO, typename LOADER>
__global__ void __launch_bounds__(Q8Cfg::kThreadsWg, 1) qgemm_wgmma_kernel(const QParams p) {
  using C = Q8Cfg;
  using Out = gemm90::OutTile<C::kBN, sizeof(TO)>;
  constexpr int kWG = gemm90::kWG;
  constexpr bool kConv = LOADER::kConv;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t stage0 = gemm90::align1024(gemm90::smem_u32(smem_raw));
  const uint32_t ones = stage0 + C::kStages * C::kStageBytes;
  const uint32_t s_cs = ones + C::kOnesBytes, s_bias = s_cs + 4 * C::kBN;
  const uint32_t full0 = s_bias + 4 * C::kBN, empty0 = full0 + 8 * C::kStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int M = p.M, N = p.N;
  const int m0 = (kConv ? blockIdx.y : blockIdx.x) * C::kBM, n0 = (kConv ? blockIdx.x : blockIdx.y) * C::kBN;
  if (tid == 0) {
    gemm90::init_barriers<C::kStages>(full0, empty0, kWG, C::kCWG * kWG);
    gemm90::mbar_init_fence();
  }
  if (tid < C::kOnesBytes / 16) {
    gemm90::st_shared16(ones + 16 * tid, make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u));
    gemm90::fence_proxy_async();
  }
  static_assert(C::kBM == C::kBN, "the bias vector serves rows (conv) or columns (MatMul)");
  if (tid < C::kBN) {  // the bias, read once per output channel
    const int n = (kConv ? m0 : n0) + tid;
    gemm90::st_shared4(s_bias + 4 * tid, static_cast<uint32_t>(p.bias != nullptr && n < N ? p.bias[n] : 0));
  }
  __syncthreads();

  const int nkt = (p.K + gemm90::kBK8 - 1) / gemm90::kBK8;
  if (wg == C::kCWG) {
    const LOADER loader(p, m0, n0, t);
    gemm90::produce<C::kStages>(nkt, full0, empty0, [&](int it, int s) {
      loader.start(p, stage0 + s * C::kStageBytes, it, t);
    });
    return;
  }

  int acc[C::kBN / 2], rs[4] = {0, 0, 0, 0}, cs[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < C::kBN / 2; ++i) acc[i] = 0;
  const uint32_t wtile = stage0 + C::kABytes;
  gemm90::consume_u8<C::kStages>(acc, rs, cs, nkt, stage0 + wg * 64 * gemm90::kBK8, wtile,
                                 wtile + wg * 64 * gemm90::kBK8, C::kStageBytes, ones, full0, empty0);

  const int lrow = (t / 32) * 16 + (t % 32) / 4, lcol = 2 * (t % 4);  // within the warpgroup's tile
  // this warpgroup's sums of B rows are those of columns 64 wg + lrow and + 8
  if (t % 4 == 0) {
    gemm90::st_shared4(s_cs + 4 * (64 * wg + lrow), static_cast<uint32_t>(cs[0]));
    gemm90::st_shared4(s_cs + 4 * (64 * wg + lrow + 8), static_cast<uint32_t>(cs[2]));
  }
  // the column sums are in, and every consumer is past its last wgmma: the
  // ring is free for the output tiles
  gemm90::named_barrier(1, C::kCWG * kWG);
  const uint32_t tile = stage0 + wg * Out::kBytes;
  const int kzz = p.K * p.za * p.zw;
  // the zero points of the A and the B operand
  const int z_a = kConv ? p.zw : p.za, z_b = kConv ? p.za : p.zw;
  int row_term[2];  // - z_b rowsum(A) of the thread's two rows, plus the conv's bias
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_term[h] = -z_b * rs[2 * h];
    if constexpr (kConv) row_term[h] += ld_shared_s32(s_bias + 4 * (64 * wg + lrow + 8 * h));
  }
#pragma unroll
  for (int j = 0; j < C::kBN / 8; ++j) {
    const int c = lcol + 8 * j;
    // - z_a rowsum(B) + K za zw of the two columns, plus the MatMul's bias
    int c0 = kzz - z_a * ld_shared_s32(s_cs + 4 * c), c1 = kzz - z_a * ld_shared_s32(s_cs + 4 * c + 4);
    if constexpr (!kConv) {
      c0 += ld_shared_s32(s_bias + 4 * c);
      c1 += ld_shared_s32(s_bias + 4 * c + 4);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st_pair<TO>(Out::at(tile, lrow + 8 * h, c), q8_out<TO>(acc[4 * j + 2 * h] + row_term[h] + c0, p),
                  q8_out<TO>(acc[4 * j + 2 * h + 1] + row_term[h] + c1, p));
  }
  gemm90::named_barrier(2 + wg, kWG);
  const int mt = m0 + 64 * wg;
  const uint8_t* src = smem_raw + (tile - gemm90::smem_u32(smem_raw));
  if constexpr (kConv) {
    flush_nchw<TO, 64, C::kBN, Out::kPitch>(src, p, mt, n0, t);
  } else if ((static_cast<long long>(N) * sizeof(TO)) % 16 == 0) {
    Out::flush(tile, p.out, mt, n0, M, N, t);
  } else {  // rows that are not whole 16-byte pieces: element by element
    TO* out = static_cast<TO*>(p.out);
    for (int i = t; i < 64 * C::kBN; i += kWG) {
      const int r = i / C::kBN, c = i % C::kBN;
      if (mt + r < M && n0 + c < N)
        out[static_cast<size_t>(mt + r) * N + n0 + c] = *reinterpret_cast<const TO*>(src + r * Out::kPitch + c * sizeof(TO));
    }
  }
}

bool aligned(const void* ptr, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

// the wgmma pipeline takes a MatMul whose weight is K-major (N, K), with
// rows that are whole 16-byte pieces, and a conv with channels-last operands
// whose channels are whole 16-byte pieces; mirrored by qgemm_variant in
// kernels/qmatmul.py
bool use_wgmma(const QParams& p, bool conv, bool w_nk) {
  if (conv)
    return p.nhwc && p.C % 16 == 0 && p.za16 != nullptr && aligned(p.a, 16) && aligned(p.w, 16) && aligned(p.za16, 16);
  return w_nk && p.K % 16 == 0 && aligned(p.a, 16) && aligned(p.w, 16);
}

template <typename TO>
cudaError_t launch_wgmma(const QParams& p, bool conv, cudaStream_t stream) {
  auto kernel = conv ? qgemm_wgmma_kernel<TO, ConvLoader> : qgemm_wgmma_kernel<TO, DenseLoader>;
  static cudaError_t attr = cudaFuncSetAttribute(qgemm_wgmma_kernel<TO, DenseLoader>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Q8Cfg::kSmemBytes);
  static cudaError_t attr_conv = cudaFuncSetAttribute(qgemm_wgmma_kernel<TO, ConvLoader>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, Q8Cfg::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  if (attr_conv != cudaSuccess) return attr_conv;
  // x: tiles of M (the MatMul's rows, the conv's B Ho Wo pixels), y: of N
  const dim3 grid((p.M + Q8Cfg::kBM - 1) / Q8Cfg::kBM, (p.N + Q8Cfg::kBN - 1) / Q8Cfg::kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, Q8Cfg::kThreadsWg, Q8Cfg::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TO, bool CONV, bool AVEC, bool WVEC>
cudaError_t launch(const QParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
  qgemm_kernel<TO, CONV, AVEC, WVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// vector loads where the rows allow them: the conv's (N, K) weight rows by
// sixteen bytes; the dense A rows by sixteen bytes and (K, N) weight rows by four
template <typename TO>
cudaError_t dispatch(const QParams& p, bool conv, bool w_nk, cudaStream_t stream) {
  if (use_wgmma(p, conv, w_nk)) return launch_wgmma<TO>(p, conv, stream);
  // a K-major dense weight, and channels-last conv operands, only on the wgmma pipeline
  if (w_nk || p.nhwc) return cudaErrorInvalidValue;
  if (conv) {
    if (p.K % 16 == 0 && aligned(p.w, 16)) return launch<TO, true, false, true>(p, stream);
    return launch<TO, true, false, false>(p, stream);
  }
  const bool wvec = p.N % 4 == 0 && aligned(p.w, 4);
  if (p.K % 16 == 0 && aligned(p.a, 16))
    return wvec ? launch<TO, false, true, true>(p, stream) : launch<TO, false, true, false>(p, stream);
  return wvec ? launch<TO, false, false, true>(p, stream) : launch<TO, false, false, false>(p, stream);
}

}  // namespace

// conv: null for a MatMul, A u8 (M, K) and W u8 (K, N), or with w_nk != 0
// W as (N, K) (K % 16 == 0, A and W 16-byte aligned: refused otherwise), all
// row-major, out (M, N); or 14 ints C, H, W, kh, kw, stride h, w, pad top,
// left, dilation h, w, Ho, Wo, nhwc for a convolution (M = B Ho Wo, K = C kh
// kw, out (B, N, Ho, Wo), w_nk 0): with nhwc 0, A the u8 (B, C, H, W) input
// and W the u8 OIHW weight as (N, K) row-major; with nhwc 1 both
// channels-last, A as (B, H, W, C) and W as (N, kh, kw, C), and za16 16
// bytes of za (C % 16 == 0, 16-byte aligned: refused otherwise). bias: (N,) int32 in accumulator units, or null. out_kind: 0 =
// float32, 1 = float16, 2 = bfloat16, 3 = uint8. K above kMaxK is refused.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ostt_qgemm(const void* a, const void* w, const void* bias, void* out, int out_kind,
                          int M, int K, int N, int za, int zw, float alpha, float beta,
                          const int* conv, int w_nk, const void* za16, void* stream) {
  if (M <= 0 || K <= 0 || K > kMaxK || N <= 0 || za < 0 || za > 255 || zw < 0 || zw > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  QParams p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w), static_cast<const int*>(bias),
            out, M, K, N, za, zw, alpha, beta};
  if (conv) {
    p.C = conv[0], p.H = conv[1], p.W = conv[2], p.kh = conv[3], p.kw = conv[4];
    p.sh = conv[5], p.sw = conv[6], p.ph = conv[7], p.pw = conv[8], p.dh = conv[9], p.dw = conv[10];
    p.Ho = conv[11], p.Wo = conv[12], p.nhwc = conv[13];
    p.za16 = static_cast<const uint8_t*>(za16);
    if (K != p.C * p.kh * p.kw || M % (p.Ho * p.Wo)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool c = conv != nullptr;
  switch (out_kind) {
    case 0: return static_cast<int>(dispatch<float>(p, c, w_nk != 0, st));
    case 1: return static_cast<int>(dispatch<__half>(p, c, w_nk != 0, st));
    case 2: return static_cast<int>(dispatch<__nv_bfloat16>(p, c, w_nk != 0, st));
    case 3: return static_cast<int>(dispatch<uint8_t>(p, c, w_nk != 0, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
