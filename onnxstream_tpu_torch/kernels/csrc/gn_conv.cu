// Fused GroupNorm + affine + SiLU, alone and in front of a 3x3 convolution,
// for Hopper (sm_90a), with a plain C ABI.
//
// Replaces two TPU kernels:
//
//  * gn_silu_pallas (onnxstream_tpu/kernels/gn_silu.py, body _kernel): per
//    (n, group) the float32 sums of x and x^2 give mean, var = max(E[x^2] -
//    mean^2, 0) and rstd; y = x A_c + B_c with A_c = rstd sg gamma_c and
//    B_c = (sb - mean rstd sg) gamma_c + beta_c; optionally y sigmoid(y); cast
//    to x's dtype. x is (N, C, H, W), any N, H, W, C % G == 0.
//  * gn_silu_conv_pallas (onnxstream_tpu/kernels/gn_conv.py): the same with
//    SiLU, rounded once to the compute dtype, then a 3x3 stride-1 pad-1
//    convolution of the activated slab with zero padding (zero of the
//    activated tensor), float32 accumulation, + bias, cast. The weight arrives
//    tap-major, w9 (9, O, C).
//
// The TPU kernels hold a whole (C, H W) slab in fast memory. A block here has
// 227 KB of shared memory and the VAE's groups hold 2 MB, so the work is split
// into passes that one C call launches back to back on one stream:
//
//  1. gn_moments_kernel: a group is one contiguous span of C/G * H W elements
//     in NCHW. It is cut into chunks of `chunk` elements, one block each,
//     read with 16-byte loads between a scalar head and tail (a span need not
//     start on a 16-byte boundary: H W = 35). Each thread sums its elements in
//     float32, then the warp (shuffles) and the block (shared memory, fixed
//     order) reduce: no running scalar over a whole group. One (sum, sum of
//     squares) pair per chunk goes to a workspace; no float atomics, so the
//     result does not change from run to run.
//  2. gn_finalize_kernel: one thread per (n, c) adds its group's chunk sums
//     in order (in double) and writes (A_c, B_c) as float32.
//  3a. gn_apply_kernel: y = x A_c + B_c [SiLU] over the flat tensor with
//     16-byte loads and stores: bound by bytes, x read twice (once per pass)
//     and y written once. Keeping a group on chip where it fits is later work.
//  3b. gn_conv_mma_kernel (bf16 / fp16) and gn_conv_fma_kernel (float32): an
//     implicit GEMM in the TPU kernel's transposed form, y[o, p] = sum_t sum_c
//     w9[t, o, c] act[c, p + off_t]. The tap slice (O, C) with C contiguous is
//     the row-major A operand of mma.sync.m16n8k16 as it lies. A block owns 64
//     output channels and a TH x TW patch of 128 output pixels; per chunk of
//     32 input channels it stages the nine tap slices and ONE haloed
//     (TH + 2) x (TW + 2) patch of activations, normalised, activated and
//     rounded as it is staged, transposed to [pixel][channel] so that a B
//     fragment is one 32-bit load; the nine taps then read the same patch at
//     nine constant offsets. Positions outside the image are staged as zero,
//     so neither row overflow nor column wrap needs a mask in the inner loop.
//     The output is written NCHW. Ragged O, C, H and W are masked in the loads
//     and stores. Bound by bf16 tensor-core throughput (2 * 9 C O H W
//     operations at 989 TFLOP/s); without wgmma, TMA and a pipelined stage
//     this reaches a fraction of it.
//
// SiLU is y / (1 + exp(-y)) with __expf and __fdividef: a few float32 ulps
// from the plain version's y * sigmoid(y), far inside the tolerances stated
// with the wrappers (2e-5 float32, 2e-2 16-bit).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a parameter vector (sg, sb, gamma, beta, bias) in its own dtype:
// 0 = float32, 1 = float16, 2 = bfloat16
__device__ __forceinline__ float load_any(const void* p, int dtype, size_t i) {
  if (dtype == 0) return static_cast<const float*>(p)[i];
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Pass 1: chunk sums of x and x^2
// ---------------------------------------------------------------------------

// grid (N G, S): block (ng, s) sums elements [s chunk, (s + 1) chunk) of group
// ng's span of L elements and writes partial[(ng S + s) 2 + {0, 1}].
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_moments_kernel(const T* __restrict__ x,
                                                              float* __restrict__ partial,
                                                              long long L, int chunk, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float s_red[2][kThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long g0 = static_cast<long long>(blockIdx.x) * L;
  const long long b = g0 + static_cast<long long>(blockIdx.y) * chunk;
  const long long e = min(g0 + L, b + chunk);
  // vector body [vb, ve) between a scalar head [b, vb) and tail [ve, e)
  long long vb = b, ve = b;
  if (vec_ok) {
    vb = min(e, (b + V - 1) / V * V);
    ve = max(vb, e / V * V);
  }
  float s1 = 0.f, s2 = 0.f;
  for (long long i = b + tid; i < vb; i += kThreads) {
    const float v = to_f32(x[i]);
    s1 += v;
    s2 += v * v;
  }
  for (long long i = ve + tid; i < e; i += kThreads) {
    const float v = to_f32(x[i]);
    s1 += v;
    s2 += v * v;
  }
  for (long long i = vb + static_cast<long long>(tid) * V; i < ve; i += kThreads * V) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + i);
    const T* el = reinterpret_cast<const T*>(&u);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = to_f32(el[j]);
      a1 += v;
      a2 += v * v;
    }
    s1 += a1;
    s2 += a2;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) {
    s_red[0][warp] = s1;
    s_red[1][warp] = s2;
  }
  __syncthreads();
  if (tid < 2) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += s_red[tid][w];
    partial[(static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * 2 + tid] = v;
  }
}

// ---------------------------------------------------------------------------
// Pass 2: (A_c, B_c) per (n, c)
// ---------------------------------------------------------------------------

struct NormParams {
  const void *sg, *sb, *gamma, *beta;  // (G,), (G,), (C,), (C,) in pdtype
  int pdtype;
  int N, C, G, S;
  double count;  // C/G * H * W
  float eps;
};

__global__ void __launch_bounds__(kThreads) gn_finalize_kernel(const NormParams p,
                                                               const float* __restrict__ partial,
                                                               float2* __restrict__ ab) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.N * p.C) return;
  const int n = i / p.C, c = i % p.C;
  const int g = c / (p.C / p.G);
  const float* ps = partial + (static_cast<size_t>(n) * p.G + g) * p.S * 2;
  double s1 = 0.0, s2 = 0.0;
  for (int s = 0; s < p.S; ++s) {
    s1 += static_cast<double>(ps[2 * s]);
    s2 += static_cast<double>(ps[2 * s + 1]);
  }
  const float mean = static_cast<float>(s1 / p.count);
  const float mean2 = static_cast<float>(s2 / p.count);
  const float var = fmaxf(mean2 - mean * mean, 0.f);
  const float rstd = 1.0f / sqrtf(var + p.eps);
  const float ag = rstd * load_any(p.sg, p.pdtype, g);
  const float bg = load_any(p.sb, p.pdtype, g) - mean * ag;
  const float gam = load_any(p.gamma, p.pdtype, c);
  ab[i] = make_float2(ag * gam, bg * gam + load_any(p.beta, p.pdtype, c));
}

// ---------------------------------------------------------------------------
// Pass 3a: y = x A_c + B_c [SiLU] over the flat tensor
// ---------------------------------------------------------------------------

template <typename T, bool SILU>
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                            const float2* __restrict__ ab,
                                                            long long total, int HW, int vec_ok) {
  constexpr int V = 16 / sizeof(T);
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i >= total) return;
  long long r = i / HW;  // the (n, c) row of element i
  int pos = static_cast<int>(i - r * HW);
  float2 q = ab[r];
  const int count = static_cast<int>(min(static_cast<long long>(V), total - i));
  alignas(16) T in[V];
  alignas(16) T res[V];
  if (vec_ok && count == V) {
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + i);
  } else {
    for (int j = 0; j < count; ++j) in[j] = x[i + j];
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < count) {
      if (pos == HW) {  // the next row starts inside this vector
        pos = 0;
        ++r;
        q = ab[r];
      }
      float y = fmaf(to_f32(in[j]), q.x, q.y);
      if (SILU) y = silu(y);
      res[j] = from_f32<T>(y);
      ++pos;
    }
  }
  if (vec_ok && count == V) {
    *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(res);
  } else {
    for (int j = 0; j < count; ++j) out[i + j] = res[j];
  }
}

// ---------------------------------------------------------------------------
// Pass 3b: the 3x3 convolution of the activated slab
// ---------------------------------------------------------------------------

struct ConvParams {
  const void* x;         // (N, C, H, W)
  const void* w9;        // (9, O, C) in x's dtype
  const void* bias;      // (O,) in bias_dtype, or nullptr
  int bias_dtype;
  void* out;             // (N, O, H, W) in x's dtype
  const float2* ab;      // (N, C) pairs (A_c, B_c)
  int N, C, H, W, O;
  int tiles_x, tiles_y;  // patches across and down an image
};

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

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// where patch position i of a block's haloed patch lies in the image: y W + x,
// or -1 outside (zero padding of the activated tensor)
__device__ __forceinline__ int patch_offset(int i, int pw, int y0, int x0, int H, int W) {
  const int y = y0 - 1 + i / pw, x = x0 - 1 + i % pw;
  return (y >= 0 && y < H && x >= 0 && x < W) ? y * W + x : -1;
}

constexpr int kCvBM = 64;             // output channels per block
constexpr int kCvBN = 128;            // output pixels per block, a TH x TW patch
constexpr int kCvBK = 32;             // input channels per stage
constexpr int kCvPitch = kCvBK + 8;   // 16-bit elements: rows 20 words apart, fragment loads conflict-free
constexpr int kCvNP = 180;            // (TH + 2) (TW + 2) for 8 x 16 and 16 x 8
constexpr size_t kCvSmem =
    (9 * kCvBM + kCvNP) * kCvPitch * 2 + kCvNP * sizeof(int);

// bf16 / fp16 on the tensor cores; fragment layouts as in csrc/matmul.cu, A
// rows = output channels, B columns = output pixels. 8 warps as 2 (O) x 4
// (pixels), each a 32 x 32 tile. grid (N tiles, ceil(O / 64)).
// AVEC: C % 8 == 0 and w9 16-byte aligned, so a tap row is read in 16-byte loads.
template <typename T, int TW, bool AVEC>
__global__ void __launch_bounds__(kThreads) gn_conv_mma_kernel(const ConvParams p) {
  constexpr int TH = kCvBN / TW, PW = TW + 2, PH = TH + 2;
  static_assert(PH * PW == kCvNP, "patch size");
  extern __shared__ uint4 smem_cv[];
  T* sA = reinterpret_cast<T*>(smem_cv);               // [tap][o][c]
  T* sB = sA + 9 * kCvBM * kCvPitch;                   // [patch position][c]
  int* s_off = reinterpret_cast<int*>(sB + kCvNP * kCvPitch);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int C = p.C, H = p.H, W = p.W, O = p.O;
  const int HW = H * W;
  const int tiles = p.tiles_x * p.tiles_y;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int y0 = (tile / p.tiles_x) * TH, x0 = (tile % p.tiles_x) * TW;
  const int o0 = blockIdx.y * kCvBM;
  const T* xn = static_cast<const T*>(p.x) + static_cast<size_t>(n) * C * HW;
  const T* w9 = static_cast<const T*>(p.w9);
  const float2* abn = p.ab + static_cast<size_t>(n) * C;

  for (int i = tid; i < kCvNP; i += kThreads) s_off[i] = patch_offset(i, PW, y0, x0, H, W);
  // patch position of this thread's B columns at the centre tap
  int brow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nl = wn * 32 + j * 8 + g;
    brow[j] = (nl / TW + 1) * PW + nl % TW + 1;
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kCvBK) {
    // the nine tap slices: rows (tap, o), chunks of eight channels
    for (int i = tid; i < 9 * kCvBM * (kCvBK / 8); i += kThreads) {
      const int row = i / (kCvBK / 8), ck = 8 * (i % (kCvBK / 8));
      const int tap = row / kCvBM, o = o0 + row % kCvBM, c = c0 + ck;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (o < O && c < C) {
        const T* src = w9 + (static_cast<size_t>(tap) * O + o) * C + c;
        if (AVEC) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          alignas(16) T e[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) e[k] = c + k < C ? src[k] : from_f32<T>(0.f);
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(sA + row * kCvPitch + ck) = v;
    }
    // the haloed patch, activated: a warp takes eight positions x four channel
    // pairs (eight neighbouring pixels per channel from device memory, 32
    // distinct banks in shared memory)
    for (int u = warp; u < (kCvNP + 7) / 8 * (kCvBK / 8); u += kThreads / 32) {
      const int pos = 8 * (u / (kCvBK / 8)) + lane % 8;
      const int cp = 4 * (u % (kCvBK / 8)) + lane / 8;
      if (pos < kCvNP) {
        const int c = c0 + 2 * cp, off = s_off[pos];
        float v0 = 0.f, v1 = 0.f;
        if (off >= 0) {
          if (c < C) {
            const float2 q = abn[c];
            v0 = silu(fmaf(to_f32(xn[static_cast<size_t>(c) * HW + off]), q.x, q.y));
          }
          if (c + 1 < C) {
            const float2 q = abn[c + 1];
            v1 = silu(fmaf(to_f32(xn[static_cast<size_t>(c + 1) * HW + off]), q.x, q.y));
          }
        }
        *reinterpret_cast<uint32_t*>(sB + pos * kCvPitch + 2 * cp) = pack2(v0, v1, T());
      }
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int tapoff = (tap / 3 - 1) * PW + (tap % 3 - 1);
#pragma unroll
      for (int ks = 0; ks < kCvBK / 16; ++ks) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* pa = sA + (tap * kCvBM + wm * 32 + i * 16 + g) * kCvPitch + ks * 16 + 2 * t;
          af[i][0] = ld32(pa);
          af[i][1] = ld32(pa + 8 * kCvPitch);
          af[i][2] = ld32(pa + 8);
          af[i][3] = ld32(pa + 8 * kCvPitch + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* pb = sB + (brow[j] + tapoff) * kCvPitch + ks * 16 + 2 * t;
          bf[j][0] = ld32(pb);
          bf[j][1] = ld32(pb + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[i][j], af[i], bf[j][0], bf[j][1], T());
      }
    }
    __syncthreads();  // the stage is consumed
  }

  T* out = static_cast<T*>(p.out) + static_cast<size_t>(n) * O * HW;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + wm * 32 + i * 16 + g + (e / 2) * 8;
        const int nl = wn * 32 + j * 8 + 2 * t + (e % 2);
        const int y = y0 + nl / TW, x = x0 + nl % TW;
        if (o < O && y < H && x < W) {
          float v = acc[i][j][e];
          if (p.bias != nullptr) v += load_any(p.bias, p.bias_dtype, o);
          out[static_cast<size_t>(o) * HW + y * W + x] = from_f32<T>(v);
        }
      }
}

constexpr int kCfBM = 64;  // output channels per block
constexpr int kCfBN = 64;  // output pixels per block
constexpr int kCfBK = 8;   // input channels per stage
constexpr int kCfPitch = kCfBM + 4;

// float32 on the CUDA cores, full float32 FMAs: the same patches, 64 output
// pixels a block, each thread a 4 (O) x 4 (pixels of one patch row) tile.
template <int TW>
__global__ void __launch_bounds__(kThreads) gn_conv_fma_kernel(const ConvParams p) {
  constexpr int TH = kCfBN / TW, PW = TW + 2, PH = TH + 2, NP = PH * PW;
  __shared__ __align__(16) float sA[9 * kCfBK * kCfPitch];  // [tap][c][o]
  __shared__ float sB[kCfBK * NP];                          // [c][patch position]
  __shared__ int s_off[NP];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int C = p.C, H = p.H, W = p.W, O = p.O;
  const int HW = H * W;
  const int tiles = p.tiles_x * p.tiles_y;
  const int n = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int y0 = (tile / p.tiles_x) * TH, x0 = (tile % p.tiles_x) * TW;
  const int o0 = blockIdx.y * kCfBM;
  const float* xn = static_cast<const float*>(p.x) + static_cast<size_t>(n) * C * HW;
  const float* w9 = static_cast<const float*>(p.w9);
  const float2* abn = p.ab + static_cast<size_t>(n) * C;

  for (int i = tid; i < NP; i += kThreads) s_off[i] = patch_offset(i, PW, y0, x0, H, W);
  // the thread's four pixels lie in one patch row (TW % 4 == 0)
  const int nl0 = 4 * tx;
  const int base = (nl0 / TW + 1) * PW + nl0 % TW + 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kCfBK) {
    for (int i = tid; i < 9 * kCfBK * kCfBM; i += kThreads) {
      const int k = i % kCfBK, m = (i / kCfBK) % kCfBM, tap = i / (kCfBK * kCfBM);
      const int o = o0 + m, c = c0 + k;
      sA[(tap * kCfBK + k) * kCfPitch + m] =
          (o < O && c < C) ? w9[(static_cast<size_t>(tap) * O + o) * C + c] : 0.f;
    }
    for (int i = tid; i < kCfBK * NP; i += kThreads) {
      const int pos = i % NP, c = c0 + i / NP;
      const int off = s_off[pos];
      float v = 0.f;
      if (off >= 0 && c < C) {
        const float2 q = abn[c];
        v = silu(fmaf(xn[static_cast<size_t>(c) * HW + off], q.x, q.y));
      }
      sB[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int at = base + (tap / 3 - 1) * PW + (tap % 3 - 1);
#pragma unroll
      for (int k = 0; k < kCfBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(sA + (tap * kCfBK + k) * kCfPitch + 4 * ty);
        const float ai[4] = {av.x, av.y, av.z, av.w};
        const float* pb = sB + k * NP + at;
        const float bj[4] = {pb[0], pb[1], pb[2], pb[3]};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(p.out) + static_cast<size_t>(n) * O * HW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + 4 * ty + i;
    if (o >= O) continue;
    const float bias = p.bias != nullptr ? load_any(p.bias, p.bias_dtype, o) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nl = nl0 + j;
      const int y = y0 + nl / TW, x = x0 + nl % TW;
      if (y < H && x < W) out[static_cast<size_t>(o) * HW + y * W + x] = acc[i][j] + bias;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool aligned(const void* ptr, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

struct Moments {
  const void* x;
  float* partial;  // (N G, S, 2) workspace
  float2* ab;      // (N, C) workspace
  long long L;     // elements of a group: C/G * H * W
  int chunk, S;
};

template <typename T>
cudaError_t launch_moments(const Moments& m, const NormParams& np, cudaStream_t stream) {
  const dim3 grid(np.N * np.G, m.S);
  gn_moments_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(m.x), m.partial, m.L,
                                                      m.chunk, aligned(m.x, 16) ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nc = np.N * np.C;
  gn_finalize_kernel<<<(nc + kThreads - 1) / kThreads, kThreads, 0, stream>>>(np, m.partial, m.ab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_apply(const Moments& m, const NormParams& np, void* out, int HW, int do_silu,
                         cudaStream_t stream) {
  cudaError_t err = launch_moments<T>(m, np, stream);
  if (err != cudaSuccess) return err;
  constexpr int V = 16 / sizeof(T);
  const long long total = static_cast<long long>(np.N) * np.C * HW;
  const long long blocks = (total + static_cast<long long>(kThreads) * V - 1) / (kThreads * V);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const int vec_ok = aligned(m.x, 16) && aligned(out, 16) ? 1 : 0;
  const T* x = static_cast<const T*>(m.x);
  T* o = static_cast<T*>(out);
  if (do_silu)
    gn_apply_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, o, m.ab, total, HW, vec_ok);
  else
    gn_apply_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, o, m.ab, total, HW, vec_ok);
  return cudaGetLastError();
}

template <typename T, int TW, bool AVEC>
cudaError_t launch_conv_mma(const ConvParams& p, cudaStream_t stream) {
  auto kernel = gn_conv_mma_kernel<T, TW, AVEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kCvSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N * p.tiles_x * p.tiles_y, (p.O + kCvBM - 1) / kCvBM);
  kernel<<<grid, kThreads, kCvSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(ConvParams p, cudaStream_t stream) {
  const bool wide = p.W >= 16;  // 8 x 16 patches, else 16 x 8
  if constexpr (std::is_same<T, float>::value) {
    const int tw = wide ? 16 : 8, th = kCfBN / tw;
    p.tiles_x = (p.W + tw - 1) / tw;
    p.tiles_y = (p.H + th - 1) / th;
    const dim3 grid(p.N * p.tiles_x * p.tiles_y, (p.O + kCfBM - 1) / kCfBM);
    if (wide) gn_conv_fma_kernel<16><<<grid, kThreads, 0, stream>>>(p);
    else gn_conv_fma_kernel<8><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  } else {
    const int tw = wide ? 16 : 8, th = kCvBN / tw;
    p.tiles_x = (p.W + tw - 1) / tw;
    p.tiles_y = (p.H + th - 1) / th;
    const bool avec = p.C % 8 == 0 && aligned(p.w9, 16);
    if (wide) return avec ? launch_conv_mma<T, 16, true>(p, stream) : launch_conv_mma<T, 16, false>(p, stream);
    return avec ? launch_conv_mma<T, 8, true>(p, stream) : launch_conv_mma<T, 8, false>(p, stream);
  }
}

template <typename T>
cudaError_t conv_all(const Moments& m, const NormParams& np, const ConvParams& p, cudaStream_t stream) {
  cudaError_t err = launch_moments<T>(m, np, stream);
  if (err != cudaSuccess) return err;
  return launch_conv<T>(p, stream);
}

bool norm_args_ok(int pdtype, int N, int C, long long HW, int G, int chunk) {
  return pdtype >= 0 && pdtype <= 2 && N > 0 && C > 0 && HW > 0 && G > 0 && C % G == 0 &&
         chunk > 0 && chunk % 8 == 0 && HW <= 2147483647LL &&
         static_cast<long long>(N) * C <= 2147483647LL && static_cast<long long>(N) * G <= 2147483647LL;
}

}  // namespace

// dtype of x and out, pdtype of sg / sb (G,) and gamma / beta (C,):
// 0 = float32, 1 = float16, 2 = bfloat16. x, out (N, C, HW) contiguous.
// partial: workspace of N G ceil(C/G HW / chunk) 2 floats; ab: workspace of
// N C 2 floats (8-byte aligned). chunk: elements per block of the moments
// pass, a multiple of 8. Returns a cudaError_t: 0 when every launch was
// accepted.
extern "C" int ostt_gn_silu(int dtype, const void* x, void* out, const void* sg, const void* sb,
                            const void* gamma, const void* beta, int pdtype, void* partial, void* ab,
                            int N, int C, long long HW, int G, float eps, int do_silu, int chunk,
                            void* stream) {
  if (!norm_args_ok(pdtype, N, C, HW, G, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const long long L = static_cast<long long>(C / G) * HW;
  const long long S = (L + chunk - 1) / chunk;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Moments m{x, static_cast<float*>(partial), static_cast<float2*>(ab), L, chunk, static_cast<int>(S)};
  const NormParams np{sg, sb, gamma, beta, pdtype, N, C, G, static_cast<int>(S), static_cast<double>(L), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = static_cast<int>(HW);
  switch (dtype) {
    case 0: return static_cast<int>(launch_apply<float>(m, np, out, hw, do_silu, st));
    case 1: return static_cast<int>(launch_apply<__half>(m, np, out, hw, do_silu, st));
    case 2: return static_cast<int>(launch_apply<__nv_bfloat16>(m, np, out, hw, do_silu, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As above, then the 3x3 stride-1 pad-1 convolution: x (N, C, H, W), w9
// (9, O, C) in x's dtype, bias (O,) in bias_dtype or null, out (N, O, H, W).
extern "C" int ostt_gn_silu_conv(int dtype, const void* x, void* out, const void* sg, const void* sb,
                                 const void* gamma, const void* beta, int pdtype, const void* w9,
                                 const void* bias, int bias_dtype, void* partial, void* ab, int N, int C,
                                 int H, int W, int O, int G, float eps, int chunk, void* stream) {
  const long long HW = static_cast<long long>(H) * W;
  if (H <= 0 || W <= 0 || O <= 0 || !norm_args_ok(pdtype, N, C, HW, G, chunk) || bias_dtype < 0 ||
      bias_dtype > 2 || (O + kCvBM - 1) / kCvBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long patches = static_cast<long long>(N) * ((H + 3) / 4) * ((W + 7) / 8);
  if (patches > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const long long L = static_cast<long long>(C / G) * HW;
  const long long S = (L + chunk - 1) / chunk;
  if (S > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Moments m{x, static_cast<float*>(partial), static_cast<float2*>(ab), L, chunk, static_cast<int>(S)};
  const NormParams np{sg, sb, gamma, beta, pdtype, N, C, G, static_cast<int>(S), static_cast<double>(L), eps};
  const ConvParams p{x, w9, bias, bias_dtype, out, static_cast<const float2*>(ab), N, C, H, W, O, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(conv_all<float>(m, np, p, st));
    case 1: return static_cast<int>(conv_all<__half>(m, np, p, st));
    case 2: return static_cast<int>(conv_all<__nv_bfloat16>(m, np, p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
