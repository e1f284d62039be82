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
// bytes of B at M = 64 (a GEMV-like sweep of a 59 MB weight) and by bf16
// tensor-core throughput at M = 1024 (2 M N K operations at 989 TFLOP/s). The
// 16-bit kernel uses mma.sync.m16n8k16 on 64 x 128 tiles, 8 warps as 2 x 4,
// the next k-tile prefetched into registers while the current one is
// multiplied. B is N-contiguous, so each tile is transposed to [n][k] while it
// is staged (a thread takes two rows of four columns and writes four (k, k+1)
// pairs); shared rows are padded so that fragment loads are free of bank
// conflicts. float32 operands run on the CUDA cores in full float32 (no TF32).
// M = 64 gives one row of 64 x 128 tiles: N / 128 = 10 blocks for 132 SMs. A
// K split, wgmma and TMA are later work. Ragged M, N and K edges are masked in
// the kernels; nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// (N,) or null; out (M, N). Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int ostt_matmul(int dtype, const void* a, const void* b, const void* bias, int bias_dtype,
                           void* out, int out_dtype, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bias_dtype < 0 || bias_dtype > 2 || out_dtype < 0 || out_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const MMParams p{a, b, bias, bias_dtype, out, out_dtype, M, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(p, st));
    case 1: return static_cast<int>(dispatch<__half>(p, st));
    case 2: return static_cast<int>(dispatch<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
