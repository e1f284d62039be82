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
// The TPU kernels hold a whole (C, H W) slab in fast memory. A group here is
// one contiguous span of C/G * H W elements in NCHW (it need not start on a
// 16-byte boundary: H W = 35), and a block has 227 KB of shared memory.
//
// Kernel 7 is one launch, gn_silu_cluster_kernel. Its bound is bytes: x read
// once and y written once (chip_smoke.py _gn_cost), no operation rate near
// its own. Each (n, group) gets a thread-block cluster of K CTAs, K a pure
// function of the shape (kernels/gn_silu.py gn_silu_plan): 1 for a group of
// at most 24 KB (the UNet's 8 x 8 and 16 x 16 levels, where the latency of
// one CTA's load, sum and store is the cost), else the most CTAs, up to 16 (a
// non-portable cluster size, which the card places), whose pieces keep at
// least 4 KB. Each CTA brings up to 32 KB of its piece into shared memory
// with one 1-D bulk copy (cp.async.bulk, no tensor map) that completes on an
// mbarrier, and sums the rest of the piece from global memory while the
// copy lands. The K (sum, sum of squares) pairs meet through distributed
// shared memory, added in rank order in every CTA: the same mean and rstd
// everywhere, the same bits on every run, no atomics, no workspace. Each CTA
// then applies y = x A_c + B_c [SiLU] from shared memory and writes y with
// 16-byte stores. So the UNet's groups (5 to 240 KB) cross HBM once, where
// the three passes before it (moments, finalize, a flat apply) read x twice
// and launched three kernels. The VAE's 1 to 4 MB groups need 64 to 256 KB a
// CTA at K = 16: the part past 32 KB is read again for the apply, mostly
// from the 50 MB L2. Keeping 224 KB resident instead leaves one CTA an SM
// and is slower on the H100 (PERF.md, kernel 7), so residency is capped and
// several CTAs share an SM.
//
// Kernel 8 keeps three passes that one C call launches back to back on one
// stream:
//
//  1. gn_moments_kernel: the span is cut into chunks of `chunk` elements, one
//     block each, read with 16-byte loads between a scalar head and tail.
//     Each thread sums its elements in float32, then the warp (shuffles) and
//     the block (shared memory, fixed order) reduce: no running scalar over a
//     whole group. One (sum, sum of squares) pair per chunk goes to a
//     workspace; no float atomics, so the result does not change from run
//     to run.
//  2. gn_finalize_kernel: one thread per (n, c) adds its group's chunk sums
//     in order (in double) and writes (A_c, B_c) as float32.
//  3. The convolution, an implicit GEMM in the TPU kernel's transposed form,
//     y[o, p] = sum_t sum_c w9[t, o, c] act[p + off_t, c], bound by 16-bit
//     tensor-core throughput (2 * 9 C O H W operations at 989 TFLOP/s) at the
//     UNet's and the VAE's sites. Three variants, chosen from dtype, C and the
//     weight's alignment alone (use_conv_wgmma below, mirrored by
//     gn_conv_variant in kernels/gn_conv.py):
//      - bf16 / fp16 with C % 8 == 0 and a 16-byte aligned w9: the wgmma
//        pipeline of gemm_sm90.cuh. gn_apply_nhwc_kernel first writes the
//        activated slab, rounded to x's dtype, channels-last (N, H, W, C) into
//        a workspace (a transpose through shared memory: 16-byte reads along
//        H W, 16-byte writes along C). This is the one place where the port
//        writes the activated tensor to device memory, which the TPU kernel
//        never does: at the UNet's sizes the slab (2.6 - 5.2 MB) stays in the
//        50 MB L2; at the VAE's 512 x 512 sites it costs one write and one
//        read of it. gn_conv_wgmma_kernel then runs the product with M =
//        output channels and N = output pixels (flat over N H W), K ordered
//        (tap, c) in k-tiles of 64 channels of one tap (ceil(C / 64) per tap,
//        channels past C zero). Both operands are K-major 128-byte rows: the
//        A tile is rows o of the tap's (O, C) slice as uploaded (t9oc), the B
//        tile 128 pixels x 64 channels of the slab, each 16-byte piece (8
//        channels of one tap of one pixel) one cp.async, zero-filled where the
//        tap falls into the padding (which is exactly the activated tensor's
//        zero padding) or past the pixels and channels. A loading warpgroup
//        keeps a ring of four stages full, the hardware arrives on each
//        stage's mbarrier, one or two consumer warpgroups run wgmma
//        m64n128k16 with f32 accumulators. Without a split the bias is added,
//        the tile rounded and it leaves through shared memory along NCHW's
//        contiguous pixel axis, in 16-byte pieces where H W is a multiple of
//        128. Where the tiles alone leave SMs idle (the 8 x 8, 16 x 16 and 32 x
//        32 levels) the caller splits K (kernels/gn_conv.py gn_conv_plan, kernel
//        9's split_plan): float32 partials go to a workspace and
//        gn_conv_splitk_reduce adds them in split order, then the bias and the
//        cast: the same bits on every run.
//      - other bf16 / fp16 shapes: gn_conv_mma_kernel, mma.sync m16n8k16 on
//        64 (O) x 128 (pixel) tiles; per chunk of 32 input channels it stages
//        the nine tap slices and ONE haloed (TH + 2) x (TW + 2) patch of
//        activations, normalised, activated and rounded as it is staged,
//        transposed to [pixel][channel]; the nine taps read the patch at nine
//        constant offsets. Positions outside the image are staged as zero.
//      - float32: gn_conv_fma_kernel, the same patches on the CUDA cores in
//        full float32 (the JAX kernel's HIGHEST; wgmma has no float32 form).
//     Ragged O, C, H and W are masked in the loads and stores.
//
// SiLU is y / (1 + exp(-y)) with __expf and __fdividef: a few float32 ulps
// from the plain version's y * sigmoid(y), far inside the tolerances stated
// with the wrappers (2e-5 float32, 2e-2 16-bit).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"

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
// Kernel 8, pass 1: chunk sums of x and x^2
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
// Kernel 8, pass 2: (A_c, B_c) per (n, c)
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
// Kernel 7: GroupNorm + affine [+ SiLU], one cluster of K CTAs per (n, group)
// ---------------------------------------------------------------------------

constexpr int kGnThreads = 256;
constexpr int kGnResidentBytes = 229376;  // dynamic shared memory of a CTA at most: resident piece + channel table
constexpr int kGnMaxCluster = 16;         // above 8 a non-portable cluster size
constexpr int kGnMaxGroupChannels = 4096; // the (A_c, B_c) table of a group: 32 KB at most

struct GnClusterParams {
  const void* x;                      // (N, C, HW), 16-byte aligned
  void* out;                          // the same, 16-byte aligned
  const void *sg, *sb, *gamma, *beta; // (G,), (G,), (C,), (C,) in pdtype
  int pdtype;
  long long L;                        // elements of a group: Cg HW < 2^31
  int HW, Cg, G;
  int K;                              // CTAs of a cluster
  int resident;                       // 16-byte vectors of its piece a CTA keeps in shared memory
  float eps;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// the float2 at `local` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float2 ld_cluster_f2(const float2* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(gemm90::smem_u32(local)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; the mbarrier at `bar` counts them as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(gemm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& u, float& s1, float& s2) {
  constexpr int V = 16 / sizeof(T);
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

// y = x A_c + B_c [SiLU] of the V elements of u, the first of which is element
// li of its group; tab holds the group's (A_c, B_c)
template <typename T, bool SILU>
__device__ __forceinline__ uint4 apply_vec(const uint4& u, int li, int HW, const float2* tab) {
  constexpr int V = 16 / sizeof(T);
  int cg = li / HW, pos = li - cg * HW;
  float2 q = tab[cg];
  const T* el = reinterpret_cast<const T*>(&u);
  uint4 r;
  T* o = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (pos == HW) {  // the next channel starts inside this vector
      pos = 0;
      q = tab[++cg];
    }
    float y = fmaf(to_f32(el[j]), q.x, q.y);
    if (SILU) y = silu(y);
    o[j] = from_f32<T>(y);
    ++pos;
  }
  return r;
}

template <typename T, bool SILU>
__device__ __forceinline__ T apply_one(T v, int li, int HW, const float2* tab) {
  const float2 q = tab[li / HW];
  float y = fmaf(to_f32(v), q.x, q.y);
  if (SILU) y = silu(y);
  return from_f32<T>(y);
}

// grid N G K, clusters of K along x: cluster ng = blockIdx.x / K normalises
// group ng, a contiguous span of L elements. Its 16-byte body is cut into K
// runs of whole vectors, one a CTA (rank 0 also takes the group's ragged
// head, rank K - 1 its tail). A CTA bulk-copies the first `resident` vectors
// of its run into shared memory on an mbarrier and sums what it reads from
// global memory (head, tail, the run past the resident part) while they
// land, then the resident part. The CTAs exchange their (sum, sum of
// squares) through distributed shared memory and every one adds the K pairs
// in rank order, so all of them find the same mean and rstd, in the same
// bits on every run. The resident part is then applied from shared memory;
// only the rest is read from global memory again (from L2, where it still
// is).
template <typename T, bool SILU>
__global__ void __launch_bounds__(kGnThreads) gn_silu_cluster_kernel(const GnClusterParams p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) uint4 smem_gn[];
  __shared__ __align__(8) uint64_t s_bar;  // the bulk copy lands on it
  __shared__ float s_red[2][kGnThreads / 32];
  __shared__ float2 s_part;  // this CTA's (sum, sum of squares): the cluster reads it
  __shared__ float2 s_coef;  // the group's rstd sg and sb - mean rstd sg
  uint4* s_x = smem_gn;
  float2* s_tab = reinterpret_cast<float2*>(smem_gn + p.resident);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = p.K, rank = blockIdx.x % K;
  const long long ng = blockIdx.x / K;
  const int g = static_cast<int>(ng % p.G);
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  // the group [g0, g1), its body of whole vectors [gb, ge), this CTA's run of
  // it [vb, ve) (resident up to rb) and its piece [b, e)
  const long long g0 = ng * p.L, g1 = g0 + p.L;
  const long long gb = min(g1, (g0 + V - 1) / V * V);
  const long long ge = max(gb, g1 / V * V);
  const long long nv = (ge - gb) / V;
  const long long vb = gb + nv * rank / K * V, ve = gb + nv * (rank + 1) / K * V;
  const long long b = rank == 0 ? g0 : vb, e = rank == K - 1 ? g1 : ve;
  const int nres = static_cast<int>(min(static_cast<long long>(p.resident), (ve - vb) / V));
  const long long rb = vb + static_cast<long long>(nres) * V;
  const uint32_t bar = gemm90::smem_u32(&s_bar);

  if (tid == 0 && nres > 0) {
    gemm90::mbar_init(bar, 1);
    gemm90::mbar_init_fence();
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(16 * nres) : "memory");
    bulk_load(s_x, x + vb, 16 * nres, bar);
  }
  // the group's parameters, read while the copies land
  float sgv = 0.f, sbv = 0.f, gam0 = 0.f, bet0 = 0.f;
  if (tid == 0) {
    sgv = load_any(p.sg, p.pdtype, g);
    sbv = load_any(p.sb, p.pdtype, g);
  }
  if (tid < p.Cg) {
    gam0 = load_any(p.gamma, p.pdtype, static_cast<size_t>(g) * p.Cg + tid);
    bet0 = load_any(p.beta, p.pdtype, static_cast<size_t>(g) * p.Cg + tid);
  }
  float s1 = 0.f, s2 = 0.f;
  for (long long i = b + tid; i < vb; i += kGnThreads) {
    const float v = to_f32(x[i]);
    s1 += v;
    s2 += v * v;
  }
  for (long long i = ve + tid; i < e; i += kGnThreads) {
    const float v = to_f32(x[i]);
    s1 += v;
    s2 += v * v;
  }
#pragma unroll 4
  for (long long i = rb + static_cast<long long>(tid) * V; i < ve; i += kGnThreads * V)
    accumulate<T>(*reinterpret_cast<const uint4*>(x + i), s1, s2);
  __syncthreads();  // the mbarrier is initialised before anyone waits on it
  if (nres > 0) gemm90::mbar_wait(bar, 0);
  for (int j = tid; j < nres; j += kGnThreads) accumulate<T>(s_x[j], s1, s2);
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
  if (tid == 0) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int w = 0; w < kGnThreads / 32; ++w) {
      a1 += s_red[0][w];
      a2 += s_red[1][w];
    }
    s_part = make_float2(a1, a2);
  }
  if (K > 1) {  // every CTA's pair is written
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (warp == 0) {
    float2 v = s_part;  // K == 1: this CTA's own pair
    if (K > 1) v = lane < K ? ld_cluster_f2(&s_part, lane) : make_float2(0.f, 0.f);
    double t1 = 0.0, t2 = 0.0;
    for (int r = 0; r < K; ++r) {  // rank order, in every CTA of the cluster
      t1 += static_cast<double>(__shfl_sync(0xffffffffu, v.x, r));
      t2 += static_cast<double>(__shfl_sync(0xffffffffu, v.y, r));
    }
    if (lane == 0) {
      const float mean = static_cast<float>(t1 / static_cast<double>(p.L));
      const float mean2 = static_cast<float>(t2 / static_cast<double>(p.L));
      const float var = fmaxf(mean2 - mean * mean, 0.f);
      const float rstd = 1.0f / sqrtf(var + p.eps);
      const float ag = rstd * sgv;
      s_coef = make_float2(ag, sbv - mean * ag);
    }
  }
  __syncthreads();
  if (K > 1) cluster_arrive();  // this CTA has read its neighbours' pairs; their wait is at the end
  const float2 cf = s_coef;
  for (int cg = tid; cg < p.Cg; cg += kGnThreads) {
    const size_t c = static_cast<size_t>(g) * p.Cg + cg;
    const float gam = cg == tid ? gam0 : load_any(p.gamma, p.pdtype, c);
    const float bet = cg == tid ? bet0 : load_any(p.beta, p.pdtype, c);
    s_tab[cg] = make_float2(cf.x * gam, cf.y * gam + bet);
  }
  __syncthreads();

  const int HW = p.HW;
  const int lv = static_cast<int>(vb - g0);
  for (int j = tid; j < nres; j += kGnThreads)
    *reinterpret_cast<uint4*>(out + vb + static_cast<long long>(j) * V) =
        apply_vec<T, SILU>(s_x[j], lv + j * V, HW, s_tab);
#pragma unroll 4
  for (long long i = rb + static_cast<long long>(tid) * V; i < ve; i += kGnThreads * V)
    *reinterpret_cast<uint4*>(out + i) =
        apply_vec<T, SILU>(*reinterpret_cast<const uint4*>(x + i), static_cast<int>(i - g0), HW, s_tab);
  for (long long i = b + tid; i < vb; i += kGnThreads)
    out[i] = apply_one<T, SILU>(x[i], static_cast<int>(i - g0), HW, s_tab);
  for (long long i = ve + tid; i < e; i += kGnThreads)
    out[i] = apply_one<T, SILU>(x[i], static_cast<int>(i - g0), HW, s_tab);
  if (K > 1) cluster_wait();  // no CTA leaves while a neighbour may still read its pair
}

// ---------------------------------------------------------------------------
// Kernel 8, pass 3: the 3x3 convolution of the activated slab
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
// Pass 3 on the wgmma pipeline: the activated slab channels-last, then the
// implicit GEMM over it
// ---------------------------------------------------------------------------

constexpr int kApTile = 64;  // channels and pixels of one transpose tile

// slab[(n H W + p) C + c] = silu(x[n, c, p] A_c + B_c), rounded to T.
// grid (ceil(HW / 64), ceil(C / 64), N); C % 8 == 0. A thread reads 8 pixels
// of a channel pair (two 16-byte loads where VEC: HW % 8 == 0 and x 16-byte
// aligned) and stores them as 8 channel-pair words, [pixel][pair] in shared
// memory (a warp's 32 pairs: 32 banks); then 8 threads write one pixel's 64
// channels as 16-byte pieces.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) gn_apply_nhwc_kernel(const T* __restrict__ x, T* __restrict__ slab,
                                                                 const float2* __restrict__ ab, int C, int HW) {
  constexpr int kPitch = kApTile / 2 + 4;  // words: 144-byte rows, 16-byte aligned
  __shared__ __align__(16) uint32_t s[kApTile * kPitch];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kApTile, c0 = blockIdx.y * kApTile, n = blockIdx.z;
  {
    const int pair = tid % (kApTile / 2), pl = 8 * (tid / (kApTile / 2));
    const int c = c0 + 2 * pair, p = p0 + pl;
    if (c < C) {
      float v[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const T* src = x + (static_cast<size_t>(n) * C + c + h) * HW + p;
        alignas(16) T e[8];
        if (VEC && p + 8 <= HW) {
          *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = p + j < HW ? src[j] : from_f32<T>(0.f);
        }
        const float2 q = ab[static_cast<size_t>(n) * C + c + h];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[h][j] = silu(fmaf(to_f32(e[j]), q.x, q.y));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s[(pl + j) * kPitch + pair] = pack2(v[0][j], v[1][j], T());
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < kApTile * 8; i += kThreads) {
    const int pl = i / 8, piece = i % 8;
    const int p = p0 + pl, c = c0 + 8 * piece;
    if (p < HW && c < C)
      *reinterpret_cast<uint4*>(slab + (static_cast<size_t>(n) * HW + p) * C + c) =
          *reinterpret_cast<const uint4*>(s + pl * kPitch + 4 * piece);
  }
}

struct WgConvParams {
  const void* slab;   // (N, H, W, C) activated, in x's dtype
  const void* w9;     // (9, O, C) in x's dtype, 16-byte aligned
  const void* bias;   // (O,) in bias_dtype, or nullptr
  int bias_dtype;
  void* out;          // (N, O, H, W)
  float* part;        // (splits, O, P) float32 partials, or nullptr without a split
  int C, H, W, O, P;  // P = N H W output pixels
  int cchunks;        // k-tiles per tap: ceil(C / 64)
};

template <int CWG>
struct CvWgCfg {
  static constexpr int kBM = 64 * CWG, kBN = 128;  // output channels x output pixels
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * 128;       // kBM rows of one 64-channel k-tile
  static constexpr int kStageBytes = kABytes + kBN * 128;
  // the ring, the barriers, slack to reach a 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages + 1024;
  static constexpr int kThreadsWg = (CWG + 1) * gemm90::kWG;
  static_assert(CWG * gemm90::OutTile<kBN, 2>::kBytes <= kStages * kStageBytes, "the output tiles reuse the ring");
  static_assert(kSmemBytes <= 232448, "shared memory of a block");
};

// The loader: thread t copies piece t % 8 (channels 8 (t % 8) .. of the
// k-tile) of pixel rows t / 8 + 16 r of the B tile; their coordinates are
// computed once.
template <typename T, int CWG>
struct GnConvLoader {
  static constexpr int kRows = CvWgCfg<CWG>::kBN * 8 / gemm90::kWG;
  unsigned valid;       // bit r: pixel row t / 8 + 16 r lies below P
  int pix[kRows];       // the row's pixel, flat over (n, y, x)
  short y[kRows], x[kRows];
  __device__ __forceinline__ GnConvLoader(const WgConvParams& p, int n0, int t) : valid(0u) {
    const int hw = p.H * p.W;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q = n0 + t / 8 + 16 * r;
      const int rem = q % hw;
      pix[r] = q;
      y[r] = static_cast<short>(rem / p.W);
      x[r] = static_cast<short>(rem % p.W);
      if (q < p.P) valid |= 1u << r;
    }
  }
  __device__ __forceinline__ void start(const WgConvParams& p, uint32_t stage, int o0, int kt, int t) const {
    const int tap = kt / p.cchunks, c0 = (kt - tap * p.cchunks) * 64;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const T* w9 = static_cast<const T*>(p.w9) + static_cast<size_t>(tap) * p.O * p.C;
    gemm90::load_kmajor_tile<CvWgCfg<CWG>::kBM>(stage, w9, 2LL * p.C, o0, p.O, 2 * c0, 2 * p.C, t);
    const int c = c0 + 8 * (t % 8);
    const T* slab = static_cast<const T*>(p.slab);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int yy = y[r] + dy, xx = x[r] + dx;
      const bool ok = ((valid >> r) & 1u) && c < p.C && static_cast<unsigned>(yy) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(xx) < static_cast<unsigned>(p.W);
      const T* src = ok ? slab + static_cast<size_t>(pix[r] + dy * p.W + dx) * p.C + c : slab;
      gemm90::cp_async16(stage + CvWgCfg<CWG>::kABytes + gemm90::a_offset(t / 8 + 16 * r, t % 8), src, ok);
    }
  }
};

// Warpgroups 0 .. CWG - 1 consume (output channels 64 wg .. of the tile),
// warpgroup CWG loads. blockIdx = (pixel tile, channel tile, K split);
// kt_per_split k-tiles per split, the last may be short.
template <typename T, int CWG>
__global__ void __launch_bounds__(CvWgCfg<CWG>::kThreadsWg, 1)
    gn_conv_wgmma_kernel(const WgConvParams p, int kt_per_split) {
  using namespace gemm90;
  using Cfg = CvWgCfg<CWG>;
  using Out = OutTile<Cfg::kBN, 2>;
  extern __shared__ __align__(16) uint8_t smem_cv_wg[];
  const uint32_t stage0 = align1024(smem_u32(smem_cv_wg));
  const uint32_t full0 = stage0 + Cfg::kStages * Cfg::kStageBytes, empty0 = full0 + 8 * Cfg::kStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int n0 = blockIdx.x * Cfg::kBN, o0 = blockIdx.y * Cfg::kBM;
  if (tid == 0) {
    init_barriers<Cfg::kStages>(full0, empty0, kWG, CWG * kWG);
    mbar_init_fence();
  }
  __syncthreads();

  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(kt_per_split, 9 * p.cchunks - kt0);
  if (wg == CWG) {
    const GnConvLoader<T, CWG> loader(p, n0, t);
    produce<Cfg::kStages>(nkt, full0, empty0, [&](int it, int s) {
      loader.start(p, stage0 + s * Cfg::kStageBytes, o0, kt0 + it, t);
    });
    return;
  }

  float acc[Cfg::kBN / 2];
#pragma unroll
  for (int i = 0; i < Cfg::kBN / 2; ++i) acc[i] = 0.f;
  consume_kmajor<Cfg::kStages>(acc, nkt, stage0 + wg * 64 * 128, stage0 + Cfg::kABytes, Cfg::kStageBytes, full0,
                               empty0, [](float(&d)[Cfg::kBN / 2], uint64_t da, uint64_t db) {
                                 wgmma_ss<T, Cfg::kBN, 0>(d, da, db, 1);
                               });

  const int lrow = (t / 32) * 16 + (t % 32) / 4, lcol = 2 * (t % 4);  // within the warpgroup's tile
  const int ob = o0 + 64 * wg;
  if (gridDim.z > 1) {  // float32 partials, (split, O, P)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = ob + lrow + 8 * h;
      if (o >= p.O) continue;
      float* part = p.part + (static_cast<size_t>(blockIdx.z) * p.O + o) * p.P;
#pragma unroll
      for (int j = 0; j < Cfg::kBN / 8; ++j) {
        const int q = n0 + lcol + 8 * j;
        if (q + 1 < p.P && p.P % 2 == 0) {
          *reinterpret_cast<float2*>(part + q) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (q < p.P) part[q] = acc[4 * j + 2 * h];
          if (q + 1 < p.P) part[q + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
    return;
  }
  // every consumer is past its last wgmma: the ring is free for the output tiles
  named_barrier(1, CWG * kWG);
  const uint32_t tile = stage0 + wg * Out::kBytes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = ob + lrow + 8 * h;
    const float b = p.bias != nullptr && o < p.O ? load_any(p.bias, p.bias_dtype, o) : 0.f;
#pragma unroll
    for (int j = 0; j < Cfg::kBN / 8; ++j)
      st_shared4(Out::at(tile, lrow + 8 * h, lcol + 8 * j),
                 pack2(acc[4 * j + 2 * h] + b, acc[4 * j + 2 * h + 1] + b, T()));
  }
  named_barrier(2 + wg, kWG);
  // rows are output channels, columns pixels: a row of the tile is a run of
  // one channel plane of NCHW
  const int hw = p.H * p.W;
  T* out = static_cast<T*>(p.out);
  const uint8_t* src = smem_cv_wg + (tile - smem_u32(smem_cv_wg));
  if (hw % Cfg::kBN == 0) {  // the tile lies in one image: 16-byte pieces
    constexpr int kPerRow = Cfg::kBN * 2 / 16;
    const int img = n0 / hw, q0 = n0 - img * hw;
#pragma unroll
    for (int j = 0; j < 64 * kPerRow / kWG; ++j) {
      const int i = t + kWG * j;
      const int r = i / kPerRow, c = (i % kPerRow) * 8;
      if (ob + r < p.O && n0 + c < p.P)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(img) * p.O + ob + r) * hw + q0 + c) =
            *reinterpret_cast<const uint4*>(src + r * Out::kPitch + 2 * c);
    }
  } else {
    for (int i = t; i < 64 * Cfg::kBN; i += kWG) {
      const int r = i / Cfg::kBN, c = i % Cfg::kBN, q = n0 + c;
      if (ob + r < p.O && q < p.P) {
        const int img = q / hw;
        out[(static_cast<size_t>(img) * p.O + ob + r) * hw + q - img * hw] =
            *reinterpret_cast<const T*>(src + r * Out::kPitch + 2 * c);
      }
    }
  }
}

// out = round(sum over splits, in split order, of the partials + bias), one
// thread per (o, pixel)
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_conv_splitk_reduce(const WgConvParams p, int splits) {
  const size_t total = static_cast<size_t>(p.O) * p.P;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int o = static_cast<int>(i / p.P), q = static_cast<int>(i % p.P);
  float s = p.part[i];
  for (int z = 1; z < splits; ++z) s += p.part[z * total + i];
  if (p.bias != nullptr) s += load_any(p.bias, p.bias_dtype, o);
  const int hw = p.H * p.W, img = q / hw;
  static_cast<T*>(p.out)[(static_cast<size_t>(img) * p.O + o) * hw + q - img * hw] = from_f32<T>(s);
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

// the kernel may take 224 KB of dynamic shared memory and clusters of 16
template <typename T, bool SILU>
cudaError_t gn_cluster_attributes() {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(gn_silu_cluster_kernel<T, SILU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kGnResidentBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gn_silu_cluster_kernel<T, SILU>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return attr;
}

cudaLaunchAttribute cluster_dim(int K) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = static_cast<unsigned>(K);
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

template <typename T, bool SILU>
cudaError_t launch_gn_cluster(const GnClusterParams& p, unsigned groups, cudaStream_t stream) {
  auto kernel = gn_silu_cluster_kernel<T, SILU>;
  const cudaError_t attr = gn_cluster_attributes<T, SILU>();
  if (attr != cudaSuccess) return attr;
  const size_t smem = 16 * static_cast<size_t>(p.resident) + (static_cast<size_t>(p.Cg) * 8 + 15) / 16 * 16;
  const unsigned blocks = groups * static_cast<unsigned>(p.K);
  if (p.K == 1) {
    kernel<<<blocks, kGnThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1] = {cluster_dim(p.K)};
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);  // a cluster the card cannot place is refused here
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t gn_cluster(const GnClusterParams& p, unsigned groups, int do_silu, cudaStream_t stream) {
  return do_silu ? launch_gn_cluster<T, true>(p, groups, stream) : launch_gn_cluster<T, false>(p, groups, stream);
}

// clusters of K CTAs with smem bytes of dynamic shared memory each that the
// card can hold at once (cudaOccupancyMaxActiveClusters), or -1
template <typename T, bool SILU>
int active_clusters(int K, int smem) {
  if (gn_cluster_attributes<T, SILU>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(K));
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute cluster[1] = {cluster_dim(K)};
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, gn_silu_cluster_kernel<T, SILU>, &cfg) == cudaSuccess ? n : -1;
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

// the wgmma pipeline takes 16-bit x whose channels are whole 16-byte pieces
// and a 16-byte aligned tap-major weight; mirrored by gn_conv_variant in
// kernels/gn_conv.py
bool use_conv_wgmma(int dtype, const ConvParams& p) {
  return dtype != 0 && p.C % 8 == 0 && aligned(p.w9, 16);
}

template <typename T, int CWG>
cudaError_t launch_conv_wgmma(const WgConvParams& p, int splits, cudaStream_t stream) {
  using Cfg = CvWgCfg<CWG>;
  static cudaError_t attr = cudaFuncSetAttribute(gn_conv_wgmma_kernel<T, CWG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int nkt = 9 * p.cchunks;
  const int per = (nkt + splits - 1) / splits;
  if (splits < 1 || splits > 65535 || (splits - 1) * per >= nkt || (splits > 1 && p.part == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((p.P + Cfg::kBN - 1) / Cfg::kBN, (p.O + Cfg::kBM - 1) / Cfg::kBM, splits);
  gn_conv_wgmma_kernel<T, CWG><<<grid, Cfg::kThreadsWg, Cfg::kSmemBytes, stream>>>(p, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(p.O) * p.P;
  gn_conv_splitk_reduce<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

// The wgmma variant: the activated slab channels-last into `slab`, then the
// product (bm 64 or 128 output channels a tile, K split in `splits`).
template <typename T>
cudaError_t conv_wgmma(const ConvParams& cp, void* slab, int bm, int splits, float* part, cudaStream_t stream) {
  const int HW = cp.H * cp.W;
  const dim3 grid((HW + kApTile - 1) / kApTile, (cp.C + kApTile - 1) / kApTile, cp.N);
  const T* x = static_cast<const T*>(cp.x);
  if (HW % 8 == 0 && aligned(cp.x, 16))
    gn_apply_nhwc_kernel<T, true><<<grid, kThreads, 0, stream>>>(x, static_cast<T*>(slab), cp.ab, cp.C, HW);
  else
    gn_apply_nhwc_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, static_cast<T*>(slab), cp.ab, cp.C, HW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const WgConvParams p{slab, cp.w9, cp.bias, cp.bias_dtype, cp.out, part, cp.C, cp.H, cp.W, cp.O, cp.N * HW,
                       (cp.C + 63) / 64};
  if (bm == 64) return launch_conv_wgmma<T, 1>(p, splits, stream);
  if (bm == 128) return launch_conv_wgmma<T, 2>(p, splits, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t conv_all(int dtype, const Moments& m, const NormParams& np, const ConvParams& p, void* slab, int bm,
                     int splits, float* part, cudaStream_t stream) {
  cudaError_t err = launch_moments<T>(m, np, stream);
  if (err != cudaSuccess) return err;
  if constexpr (!std::is_same<T, float>::value) {
    if (use_conv_wgmma(dtype, p)) return conv_wgmma<T>(p, slab, bm, splits, part, stream);
  }
  return launch_conv<T>(p, stream);
}

bool norm_args_ok(int pdtype, int N, int C, long long HW, int G, int chunk) {
  return pdtype >= 0 && pdtype <= 2 && N > 0 && C > 0 && HW > 0 && G > 0 && C % G == 0 &&
         chunk > 0 && chunk % 8 == 0 && HW <= 2147483647LL &&
         static_cast<long long>(N) * C <= 2147483647LL && static_cast<long long>(N) * G <= 2147483647LL;
}

}  // namespace

// Kernel 7 in one launch. dtype of x and out, pdtype of sg / sb (G,) and
// gamma / beta (C,): 0 = float32, 1 = float16, 2 = bfloat16. x, out (N, C, HW)
// contiguous, both 16-byte aligned. cluster (K, the CTAs of a group) and
// resident (16-byte vectors of its piece a CTA keeps in shared memory) are
// the caller's plan (kernels/gn_silu.py gn_silu_plan); refused when C / G >
// 4096, a group holds 2^31 elements or more, K is outside 1..16, a piece
// would be empty, or the resident vectors and the group's (A_c, B_c) table
// exceed 224 KB. Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ostt_gn_silu(int dtype, const void* x, void* out, const void* sg, const void* sb,
                            const void* gamma, const void* beta, int pdtype, int N, int C, long long HW, int G,
                            float eps, int do_silu, int cluster, int resident, void* stream) {
  if (dtype < 0 || dtype > 2 || pdtype < 0 || pdtype > 2 || N <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Cg = C / G;
  const long long L = static_cast<long long>(Cg) * HW, V = dtype == 0 ? 4 : 8;
  const long long groups = static_cast<long long>(N) * G;
  const long long table = (static_cast<long long>(Cg) * 8 + 15) / 16 * 16;
  if (Cg > kGnMaxGroupChannels || L > 2147483647LL || cluster < 1 || cluster > kGnMaxCluster ||
      groups * cluster > 2147483647LL || resident < 0 || 16LL * resident + table > kGnResidentBytes ||
      (cluster > 1 && L / V - 1 < cluster) || !aligned(x, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const GnClusterParams p{x, out, sg, sb, gamma, beta, pdtype, L, static_cast<int>(HW), Cg, G, cluster, resident, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned ng = static_cast<unsigned>(groups);
  switch (dtype) {
    case 0: return static_cast<int>(gn_cluster<float>(p, ng, do_silu, st));
    case 1: return static_cast<int>(gn_cluster<__half>(p, ng, do_silu, st));
    default: return static_cast<int>(gn_cluster<__nv_bfloat16>(p, ng, do_silu, st));
  }
}

// How many clusters of `cluster` CTAs, each with smem_bytes of dynamic
// shared memory, the card holds at once for kernel 7 in this dtype; -1 when
// the query fails or the arguments are out of range.
extern "C" int ostt_gn_silu_active_clusters(int dtype, int do_silu, int cluster, int smem_bytes) {
  if (dtype < 0 || dtype > 2 || cluster < 1 || cluster > kGnMaxCluster || smem_bytes < 0 ||
      smem_bytes > kGnResidentBytes)
    return -1;
  const int K = cluster, b = smem_bytes;
  switch (dtype) {
    case 0: return do_silu ? active_clusters<float, true>(K, b) : active_clusters<float, false>(K, b);
    case 1: return do_silu ? active_clusters<__half, true>(K, b) : active_clusters<__half, false>(K, b);
    default: return do_silu ? active_clusters<__nv_bfloat16, true>(K, b) : active_clusters<__nv_bfloat16, false>(K, b);
  }
}

// As above, then the 3x3 stride-1 pad-1 convolution: x (N, C, H, W), w9
// (9, O, C) in x's dtype, bias (O,) in bias_dtype or null, out (N, O, H, W).
// Where the wgmma variant takes the call (16-bit x, C % 8 == 0, w9 16-byte
// aligned): slab is a 16-byte aligned workspace of N H W C elements of x's
// dtype, bm (64 or 128 output channels a tile) and splits (the K split) the
// caller's plan, part a float32 workspace of splits O N H W values (null when
// splits == 1); the other variants ignore these four.
extern "C" int ostt_gn_silu_conv(int dtype, const void* x, void* out, const void* sg, const void* sb,
                                 const void* gamma, const void* beta, int pdtype, const void* w9,
                                 const void* bias, int bias_dtype, void* partial, void* ab, int N, int C,
                                 int H, int W, int O, int G, float eps, int chunk, void* slab, int bm,
                                 int splits, void* part, void* stream) {
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
  if (use_conv_wgmma(dtype, p) && (slab == nullptr || !aligned(slab, 16) || N > 65535 ||
                                   static_cast<long long>(N) * HW > 2147483647LL))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  switch (dtype) {
    case 0: return static_cast<int>(conv_all<float>(dtype, m, np, p, slab, bm, splits, pt, st));
    case 1: return static_cast<int>(conv_all<__half>(dtype, m, np, p, slab, bm, splits, pt, st));
    case 2: return static_cast<int>(conv_all<__nv_bfloat16>(dtype, m, np, p, slab, bm, splits, pt, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
