// Tiled matrix product with float32 accumulation for Hopper (sm_90a), with a
// plain C ABI.
//
// Replaces the TPU kernel matmul_pallas of onnxstream_tpu/kernels/matmul.py
// (the pallas_call of _make_kernel's body): C = A @ B (+ bias), A (M, K) and
// B (K, N) row-major in one dtype (float32, float16 or bfloat16), the products
// accumulated in float32 over the whole K sweep, the bias added in float32,
// one rounding to the output dtype. conv3x3_im2col (kernels/matmul.py) builds
// its operands in PyTorch and calls this for the product, so the small-spatial
// 3x3 convs of the SD UNet (use_pallas_smallconv) run through it with
// K = 9 C = 5760 .. 23040.
//
// What bounds it on an H100, and what the design does about it: at the UNet's
// sites (M = 64 .. 1024 pixels, N = 640 / 1280) the product is bound by the
// bytes of B at M = 64 (a GEMV-like sweep of a 59 MB weight: 17.6 us at 3.35
// TB/s) and sits near the ridge at M = 1024 (2 M N K operations at 989
// TFLOP/s against 19 MB). Two things decide its time: how many SMs pull on
// memory at once, and how many bytes each keeps in flight.
//
//  * mm_wgmma_kernel (16-bit operands whose rows are 16-byte granular: K and
//    N multiples of 8, A and B 16-byte aligned) is the pipeline of
//    gemm_sm90.cuh: a loading warpgroup keeps a ring of 6 swizzled stages
//    full of cp.async loads (144-192 KB in flight an SM), one or two consumer
//    warpgroups run wgmma m64n128k16 on 64 or 128 x 128 output tiles. B lands
//    MN-major as it lies in device memory and is read through wgmma's
//    transpose bit: no transposing store.
//  * Split K. The grid is (M tiles, N tiles, splits), the split chosen by the
//    caller from the shape alone (kernels/matmul.py matmul_plan: M = 64, N =
//    1280 gives 10 tiles x 13 splits for 132 SMs). With splits > 1 every
//    block writes its float32 partial tile to a workspace and
//    mm_splitk_reduce adds the partials in split order, then the bias, then
//    rounds once: the same bits on every run, no float atomics.
//  * Every other shape (ragged K or N, unaligned views) takes mm_mma_kernel:
//    mma.sync.m16n8k16 on 64 x 128 tiles, 8 warps as 2 x 4, one k-tile
//    prefetched into registers, B transposed to [n][k] while it is staged,
//    all edges masked. float32 operands run on the CUDA cores in full float32
//    (no TF32). The choice is a function of dtype, shape and alignment only
//    (use_wgmma below, mirrored by matmul_variant in kernels/matmul.py).
//
// Nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int kThreads = 256;

struct MMParams {
  const void* a;     // (M, K), row-major
  const void* b;     // (K, N), row-major, A's dtype
  const void* bias;  // (N,) in bias_dtype, or nullptr
  int bias_dtype;    // 0 = float32, 1 = float16, 2 = bfloat16
  void* out;         // (M, N) in out_dtype
  int out_dtype;
  int M, K, N;
};

__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  if (dtype == 0) return static_cast<const float*>(p)[i];
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_any(void* p, int dtype, size_t i, float v) {
  if (dtype == 0) static_cast<float*>(p)[i] = v;
  else if (dtype == 1) static_cast<__half*>(p)[i] = __float2half_rn(v);
  else static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// acc + bias in float32, then the one rounding
__device__ __forceinline__ void epilogue(const MMParams& p, int m, int n, float acc) {
  if (p.bias != nullptr) acc += load_any(p.bias, p.bias_dtype, n);
  store_any(p.out, p.out_dtype, static_cast<size_t>(m) * p.N + n, acc);
}

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kPitch = kBK + 8;  // 16-bit elements: rows 36 words apart, fragment loads conflict-free

// four consecutive 16-bit elements B[k][n .. n+3] as two words; zero past K
// and N. VEC: N % 4 == 0 and B 8-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ uint2 load_b4(const T* b, int k, int n, int K, int N) {
  uint2 v = make_uint2(0u, 0u);
  if (k >= K) return v;
  const T* row = b + static_cast<size_t>(k) * N;
  if constexpr (VEC) {
    if (n < N) v = *reinterpret_cast<const uint2*>(row + n);
  } else {
    alignas(8) T e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = n + j < N ? row[n + j] : from_f32<T>(0.f);
    v = *reinterpret_cast<const uint2*>(e);
  }
  return v;
}

// bf16 / fp16 operands on the tensor cores (mma.m16n8k16, f32 accumulate).
// Fragment layouts (PTX ISA), g = lane / 4, t = lane % 4, each register two
// consecutive k:
//   A (16x16): a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8, 8+2t..)
//   B (16x8):  b0 = (k 2t.., n g), b1 = (k 8+2t.., n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// 8 warps as 2 (M) x 4 (N), each a 32 x 32 tile: 2 x 4 mma per k16 step.
template <typename T, bool AVEC, bool BVEC>
__global__ void __launch_bounds__(kThreads) mm_mma_kernel(const MMParams p) {
  __shared__ __align__(16) T sA[kBM * kPitch];  // [m][k]
  __shared__ __align__(16) T sB[kBN * kPitch];  // B transposed, [n][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);

  // staging: A chunks i = tid + 256 v, row i / 8, eight columns from
  // 8 (i % 8); B units u = tid + 256 v: k pair u % 32, column quad u / 32
  uint4 ra[2];
  uint2 rb[4][2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = tid + kThreads * v;
      const int m = m0 + i / 8, k = k0 + 8 * (i % 8);
      if (AVEC) {
        ra[v] = (m < M && k < K) ? *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m) * K + k)
                                 : make_uint4(0, 0, 0, 0);
      } else {
        alignas(16) T e[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          e[x] = (m < M && k + x < K) ? a[static_cast<size_t>(m) * K + k + x] : from_f32<T>(0.f);
        ra[v] = *reinterpret_cast<const uint4*>(e);
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int u = tid + kThreads * v;
      const int kk = k0 + 2 * (u % 32), n = n0 + 4 * (u / 32);
      rb[v][0] = load_b4<T, BVEC>(b, kk, n, K, N);
      rb[v][1] = load_b4<T, BVEC>(b, kk + 1, n, K, N);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = tid + kThreads * v;
      *reinterpret_cast<uint4*>(sA + (i / 8) * kPitch + 8 * (i % 8)) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int u = tid + kThreads * v;
      T* dst = sB + (4 * (u / 32)) * kPitch + 2 * (u % 32);
      // column j of rows k and k + 1 as one word, row k in the low half
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(rb[v][0].x, rb[v][1].x, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kPitch) = __byte_perm(rb[v][0].x, rb[v][1].x, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kPitch) = __byte_perm(rb[v][0].y, rb[v][1].y, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kPitch) = __byte_perm(rb[v][0].y, rb[v][1].y, 0x7632);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nkt = (K + kBK - 1) / kBK;
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile is consumed
    store_tile();
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kBK);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* pa = sA + (wm * 32 + i * 16 + g) * kPitch + ks * 16 + 2 * t;
        af[i][0] = ld32(pa);
        af[i][1] = ld32(pa + 8 * kPitch);
        af[i][2] = ld32(pa + 8);
        af[i][3] = ld32(pa + 8 * kPitch + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* pb = sB + (wn * 32 + j * 8 + g) * kPitch + ks * 16 + 2 * t;
        bf[j][0] = ld32(pb);
        bf[j][1] = ld32(pb + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bf[j][0], bf[j][1], T());
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + g + (e / 2) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e % 2);
        if (m < M && n < N) epilogue(p, m, n, acc[i][j][e]);
      }
}

constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16;
constexpr int kF32Pitch = kF32BM + 4;  // floats; 16-byte aligned rows

// float32 operands: CUDA-core FMAs in full float32. A is staged transposed
// ([k][m]) so that a thread's four rows are one vector load; each thread owns
// a 4 x 4 output tile.
template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(kThreads) mm_fma_kernel(const MMParams p) {
  __shared__ __align__(16) float sA[kF32BK * kF32Pitch];
  __shared__ __align__(16) float sB[kF32BK * kF32Pitch];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kF32BM, n0 = blockIdx.y * kF32BN;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  const int ar = tid / 4, ak = 4 * (tid % 4);    // A: row, first of four k
  const int bk = tid / 16, bn = 4 * (tid % 16);  // B: k row, first of four columns
  float4 ra, rb;
  auto load_tile = [&](int k0) {
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    rb = make_float4(0.f, 0.f, 0.f, 0.f);
    const int m = m0 + ar, k = k0 + ak;
    if (m < M) {
      const float* row = a + static_cast<size_t>(m) * K;
      if (AVEC) {
        if (k < K) ra = *reinterpret_cast<const float4*>(row + k);
      } else {
        if (k < K) ra.x = row[k];
        if (k + 1 < K) ra.y = row[k + 1];
        if (k + 2 < K) ra.z = row[k + 2];
        if (k + 3 < K) ra.w = row[k + 3];
      }
    }
    const int kk = k0 + bk, n = n0 + bn;
    if (kk < K) {
      const float* row = b + static_cast<size_t>(kk) * N;
      if (BVEC) {
        if (n < N) rb = *reinterpret_cast<const float4*>(row + n);
      } else {
        if (n < N) rb.x = row[n];
        if (n + 1 < N) rb.y = row[n + 1];
        if (n + 2 < N) rb.z = row[n + 2];
        if (n + 3 < N) rb.w = row[n + 3];
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nkt = (K + kF32BK - 1) / kF32BK;
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    sA[(ak + 0) * kF32Pitch + ar] = ra.x;
    sA[(ak + 1) * kF32Pitch + ar] = ra.y;
    sA[(ak + 2) * kF32Pitch + ar] = ra.z;
    sA[(ak + 3) * kF32Pitch + ar] = ra.w;
    *reinterpret_cast<float4*>(sB + bk * kF32Pitch + bn) = rb;
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kF32BK);
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sA + k * kF32Pitch + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(sB + k * kF32Pitch + 4 * tx);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) epilogue(p, m, n, acc[i][j]);
    }
  }
}

bool aligned(const void* ptr, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

// ---------------------------------------------------------------------------
// wgmma pipeline (gemm_sm90.cuh): 64 CWG x 128 output tiles, split K
// ---------------------------------------------------------------------------

template <int CWG>
struct WgCfg {
  static constexpr int kBN = 128, kSwz = 128;
  static constexpr int kStages = 6;
  static constexpr int kABytes = CWG * gemm90::kATileBytes;
  static constexpr int kStageBytes = kABytes + gemm90::kBK * kBN * 2;
  // stages, 2 x kStages barriers, and the slack to reach a 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
  static constexpr int kThreadsWg = (CWG + 1) * gemm90::kWG;
};

// two neighbouring columns of one output row: + bias in float32, one rounding
__device__ __forceinline__ void epilogue2(const MMParams& p, int m, int n, float v0, float v1) {
  if (p.bias != nullptr) {
    v0 += load_any(p.bias, p.bias_dtype, n);
    v1 += load_any(p.bias, p.bias_dtype, n + 1);
  }
  const size_t i = static_cast<size_t>(m) * p.N + n;
  if (p.out_dtype == 0) *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) = make_float2(v0, v1);
  else if (p.out_dtype == 1) *reinterpret_cast<__half2*>(static_cast<__half*>(p.out) + i) = __floats2half2_rn(v0, v1);
  else *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + i) = __floats2bfloat162_rn(v0, v1);
}

// blockIdx = (M tile, N tile, K split). ws: (splits, M, N) float32 partials
// when gridDim.z > 1. kt_per_split k-tiles per split; the last may be short.
template <typename T, int CWG>
__global__ void __launch_bounds__(WgCfg<CWG>::kThreadsWg, 1)
    mm_wgmma_kernel(const MMParams p, float* __restrict__ ws, int kt_per_split) {
  using namespace gemm90;
  using C = WgCfg<CWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t stage0 = align1024(smem_u32(smem_raw));
  const uint32_t full0 = stage0 + C::kStages * C::kStageBytes, empty0 = full0 + 8 * C::kStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  if (tid == 0) {
    init_barriers<C::kStages>(full0, empty0, kWG, CWG * kWG);
    mbar_init_fence();
  }
  __syncthreads();

  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * 64 * CWG, n0 = blockIdx.y * C::kBN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(kt_per_split, (K + kBK - 1) / kBK - kt0);

  if (wg == CWG) {
    const T* a = static_cast<const T*>(p.a);
    produce<C::kStages>(
        nkt, full0, empty0,
        [&](int it, int s) {
          const uint32_t sb = stage0 + s * C::kStageBytes;
          const int k0 = (kt0 + it) * kBK;
          load_a_tile<T, CWG>(sb, a, m0, k0, M, K, t);
          load_b_tile<2, C::kBN, C::kSwz>(sb + C::kABytes, p.b, k0, n0, K, N, t);
        });
    return;
  }

  float acc[C::kBN / 2], rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < C::kBN / 2; ++i) acc[i] = 0.f;
  consume<T, C::kBN, C::kSwz, C::kStages, 0, false>(acc, rs, nkt, stage0 + wg * kATileBytes, C::kStageBytes,
                                                    stage0 + C::kABytes, C::kStageBytes, 0u, full0, empty0, 0u, 0u);

  const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
  float* part = ws + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < C::kBN / 8; ++j) {
    const int n = col + 8 * j;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m >= M) continue;
      if (gridDim.z == 1) epilogue2(p, m, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      else *reinterpret_cast<float2*>(part + static_cast<size_t>(m) * N + n) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out = round(sum over splits, in split order, of ws + bias); a thread takes
// four neighbouring columns (N % 4 == 0)
__global__ void __launch_bounds__(kThreads) mm_splitk_reduce(const MMParams p, const float* __restrict__ ws, int splits) {
  const size_t quads = static_cast<size_t>(p.M) * p.N / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= quads) return;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4 s = w4[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = w4[z * quads + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  const int m = static_cast<int>(i * 4 / p.N), n = static_cast<int>(i * 4 % p.N);
  epilogue2(p, m, n, s.x, s.y);
  epilogue2(p, m, n + 2, s.z, s.w);
}

template <typename T, int CWG>
cudaError_t launch_wgmma(const MMParams& p, int splits, float* ws, cudaStream_t stream) {
  using C = WgCfg<CWG>;
  static cudaError_t attr = cudaFuncSetAttribute(mm_wgmma_kernel<T, CWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int nkt = (p.K + gemm90::kBK - 1) / gemm90::kBK;
  const int per = (nkt + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= nkt || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid((p.M + 64 * CWG - 1) / (64 * CWG), (p.N + C::kBN - 1) / C::kBN, splits);
  mm_wgmma_kernel<T, CWG><<<grid, C::kThreadsWg, C::kSmemBytes, stream>>>(p, ws, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t quads = static_cast<size_t>(p.M) * p.N / 4;
  mm_splitk_reduce<<<static_cast<unsigned>((quads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p, ws, splits);
  return cudaGetLastError();
}

// the wgmma pipeline takes 16-bit operands whose rows are whole 16-byte
// pieces; mirrored by matmul_variant in kernels/matmul.py
bool use_wgmma(int dtype, const MMParams& p) {
  return dtype != 0 && p.K % 8 == 0 && p.N % 8 == 0 && aligned(p.a, 16) && aligned(p.b, 16);
}

template <typename T, bool AVEC, bool BVEC>
cudaError_t launch_mma(const MMParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kBM - 1) / kBM, (p.N + kBN - 1) / kBN);
  mm_mma_kernel<T, AVEC, BVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool AVEC, bool BVEC>
cudaError_t launch_fma(const MMParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kF32BM - 1) / kF32BM, (p.N + kF32BN - 1) / kF32BN);
  mm_fma_kernel<AVEC, BVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const MMParams& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const bool avec = p.K % 4 == 0 && aligned(p.a, 16);
    const bool bvec = p.N % 4 == 0 && aligned(p.b, 16);
    if (avec) return bvec ? launch_fma<true, true>(p, stream) : launch_fma<true, false>(p, stream);
    return bvec ? launch_fma<false, true>(p, stream) : launch_fma<false, false>(p, stream);
  } else {
    const bool avec = p.K % 8 == 0 && aligned(p.a, 16);
    const bool bvec = p.N % 4 == 0 && aligned(p.b, 8);
    if (avec) return bvec ? launch_mma<T, true, true>(p, stream) : launch_mma<T, true, false>(p, stream);
    return bvec ? launch_mma<T, false, true>(p, stream) : launch_mma<T, false, false>(p, stream);
  }
}

}  // namespace

// dtype of A and B, bias_dtype and out_dtype: 0 = float32, 1 = float16,
// 2 = bfloat16. A is (M, K) and B (K, N), both row-major and contiguous; bias
// (N,) or null; out (M, N). bm (64 or 128 rows per tile) and splits (K split)
// are the caller's plan for the wgmma pipeline, workspace its (splits, M, N)
// float32 scratch (null when splits == 1); shapes that take the masked
// kernels ignore all three. Returns a cudaError_t: 0 when the launches were
// accepted.
extern "C" int ostt_matmul(int dtype, const void* a, const void* b, const void* bias, int bias_dtype,
                           void* out, int out_dtype, int M, int K, int N, int bm, int splits,
                           void* workspace, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bias_dtype < 0 || bias_dtype > 2 || out_dtype < 0 || out_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const MMParams p{a, b, bias, bias_dtype, out, out_dtype, M, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_wgmma(dtype, p)) {
    if (bm != 64 && bm != 128) return static_cast<int>(cudaErrorInvalidValue);
    float* ws = static_cast<float*>(workspace);
    if (dtype == 1)
      return static_cast<int>(bm == 64 ? launch_wgmma<__half, 1>(p, splits, ws, st) : launch_wgmma<__half, 2>(p, splits, ws, st));
    if (dtype == 2)
      return static_cast<int>(bm == 64 ? launch_wgmma<__nv_bfloat16, 1>(p, splits, ws, st)
                                       : launch_wgmma<__nv_bfloat16, 2>(p, splits, ws, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(p, st));
    case 1: return static_cast<int>(dispatch<__half>(p, st));
    case 2: return static_cast<int>(dispatch<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
