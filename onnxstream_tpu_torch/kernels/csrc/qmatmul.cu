// Weight-quantized matrix products for Hopper (sm_90a), with a plain C ABI.
//
// Replaces two TPU kernels of onnxstream_tpu/kernels/qmatmul.py:
//
//  * w8a8_dyn_matmul (pallas_call of _w8a8_dyn_kernel, and its stock-XLA twin
//    w8a8_dyn_matmul_xla that the JAX executor dispatches to): float A (M, K)
//    x symmetric int8 W (K, N) -> (M, N) in A's dtype. A is quantized per row
//    inside the launch, sa = max(amax, 1e-12) * (1/127), aq = clip(rint(a / sa),
//    -127, 127); the dot runs s8 x s8 -> s32 (exact); the epilogue is
//    float(acc) * sa * ws with ws a scalar or an (N,) vector. The division is
//    IEEE (__fdiv_rn), rintf rounds half to even and no FMA is contracted into
//    the epilogue, so the result equals the plain version bit for bit.
//  * w8_matmul (pallas_call of _w8mm_kernel): float A (M, K) x uint8 W (K, N)
//    -> (M, N) in A's dtype, sw * (A @ W - zw * rowsum(A)), the uint8 weight
//    converted to A's dtype in shared memory (exact for 0..255) and never
//    materialized as a float copy in device memory; products accumulate in
//    float32 (tensor cores for bf16 / fp16, full float32 FMAs for float32:
//    no TF32, as JAX's Precision.HIGHEST); sw, zw scalars or (N,) vectors.
//
// What bounds them on an H100, and what the design does about it:
//
//  * w8a8_dyn_matmul's weight comes in one of two layouts. The LLM route's
//    weights are uploaded K-major, as (N, K) (the planner's "tnk" transform
//    after the per-channel quantization, kernels/qmatmul.py weight_nk), since
//    8-bit wgmma takes K-major operands only and a GEMV over K-major rows
//    reads each output column's weights contiguously. Which kernel runs is a
//    function of the layout, M, K and the weight's alignment (dyn_variant in
//    kernels/qmatmul.py mirrors dyn_nk_dispatch and dyn_dispatch below):
//      - (N, K), M <= 16 (decode): dyn_gemv_nk_kernel, bound by the weight's
//        bytes (1 byte per weight at 3.35 TB/s) and, at a few MB a call, by
//        the latency of a call. A block quantizes the M rows of A once into
//        shared memory (one row: each thread keeps its pieces in registers
//        from the row maximum to the s8 bytes), then walks column groups:
//        each warp owns one output column at a time and reads its row along K
//        in chunks of 16-byte loads (32 lanes, 512 contiguous bytes a load),
//        the next chunk's loads in flight while it multiplies the current
//        one, four dp4a per piece and row of A; the lanes' sums meet by warp
//        shuffles. No K split over blocks, no atomics, no workspace. The grid
//        is what the SMs hold at once, so A is quantized a few hundred times
//        per call, not once per column group; the first chunk's loads are
//        issued before the work on A.
//      - (N, K), M > 16 (prefill): dyn_quant_rows_held_kernel (one block a
//        row, the row in registers) quantizes A into an s8 scratch (skipped
//        where the caller's previous call quantized the same, unchanged A:
//        the q / k / v and gate / up projections read one activation), then
//        dyn_wgmma_kernel runs the pipeline of gemm_sm90.cuh
//        in its s8 form: a loading warpgroup keeps a ring of four stages (A
//        and W tiles, 128-byte K-major rows, 16-byte cp.async copies, zero past
//        the edges), one or two consumer warpgroups run wgmma
//        m64n128k32.s32.s8.s8, bound by int8 tensor-core throughput (2 M N K
//        operations at 1979 TOP/s) in principle and by the rate at which L2
//        delivers the tiles in practice, so the tallest tile that fills the
//        card is taken (64, 128 or 256 rows: one, two or four consumer
//        warpgroups). No zero points, so no row or column sums.
//        Where the tiles alone leave SMs idle (the k / v projections, N = 256)
//        the caller splits K (kernels/qmatmul.py dyn_plan): int32 partials
//        (exact in any order) go to a workspace and dyn_splitk_reduce adds
//        them before the one epilogue. Without a split the tile leaves through
//        shared memory in 16-byte pieces where N allows; the LM head's rows
//        (N = 32003) are not 16-byte granular and leave element by element.
//      - (K, N), M <= 16: dyn_gemv_kernel gives each lane 4 neighbouring
//        columns (a warp reads 128 contiguous bytes of a weight row) and
//        splits K over the 8 warps of a block and, where the columns alone
//        give too few blocks (N = 256), over blocks: the partial int32 sums of
//        a K split meet in an int32 workspace through atomics and the last
//        block of a column tile writes the output and zeroes the workspace
//        again. Four rows of a lane's four columns are transposed in
//        registers (byte_perm) so that one dp4a does four multiply-adds.
//      - (K, N), M > 16: dyn_mma_kernel, mma.sync.m16n8k32 on 64 x 128 tiles
//        with the next tile prefetched into registers; the weight is
//        N-contiguous and ldmatrix cannot transpose 8-bit elements, so each
//        tile is transposed in 4 x 4 byte blocks while it is staged.
//    A (K, N) weight is what a caller passes directly, or a tied one.
//  * w8_matmul with 16-bit A is bound by bf16 tensor-core throughput at the
//    UNet's sites (2 M N K operations at 989 TFLOP/s; the weight is 1 byte
//    per value), by how often a weight tile is converted, and, at its 130
//    short calls a step (K = 320 .. 1280: 5 to 20 k-tiles), by the latency
//    of one k-tile's way through the block. w8_wgmma_kernel is the pipeline
//    of gemm_sm90.cuh with three roles: a loading warpgroup keeps a ring of
//    six stages (A tile + the uint8 tile as it lies) full of cp.async
//    copies; a converting warpgroup turns each landed uint8 tile into A's
//    dtype without an int-to-float conversion (bf16: a byte permute into
//    0x4B0000xx = 8388608 + x, one subtraction, a packed cvt; fp16: 0x64xx =
//    1024 + x, one packed subtraction) and writes it straight into a
//    swizzled MN-major B tile of a ring of three, then fences it for the async
//    proxy; one or two consumer warpgroups run wgmma m64n160k16 on 64 or
//    128 x 160 output tiles (160 divides N = 320, 640, 1280, 2560; a
//    converted tile serves 128 rows). rowsum(A) is one more n8 wgmma against
//    a tile of ones. The output tile leaves through shared memory as whole
//    16-byte pieces of a row, the scales and zero points of its columns
//    staged once. Where the tiles alone leave SMs idle the caller splits K
//    (kernels/qmatmul.py w8_plan): float32 partial sums and partial row sums
//    go to a workspace and w8_splitk_reduce adds them in split order before
//    the one epilogue: the same bits on every run. It takes K a multiple of
//    8, N a multiple of 16 and 16-byte aligned operands; every other shape
//    takes w8_mma_kernel (mma.sync on 64 x 128 tiles, edges masked), float32
//    A the full-float32 FMA kernel. The choice is a function of dtype, shape
//    and alignment only (w8_use_wgmma, mirrored by w8_variant in
//    kernels/qmatmul.py).
//  * A weight row with an odd length (the LM head, N = 32003) is not 4-byte
//    aligned: the dispatcher picks a variant that loads weight bytes one by one
//    from the shape and the pointer. Ragged M, N and K edges are masked in the
//    kernels; nothing is padded in device memory.

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

constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four consecutive elements of a row of A as floats; zero past K. VEC: the
// row is 16-byte aligned and K % 4 == 0, so one vector load serves.
template <typename T, bool VEC>
__device__ __forceinline__ float4 load4(const T* row, int k, int K) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (k < K) {
      if constexpr (std::is_same<T, float>::value) {
        v = *reinterpret_cast<const float4*>(row + k);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(row + k);
        const T* e = reinterpret_cast<const T*>(&u);
        v = make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
      }
    }
  } else {
    if (k < K) v.x = to_f32(row[k]);
    if (k + 1 < K) v.y = to_f32(row[k + 1]);
    if (k + 2 < K) v.z = to_f32(row[k + 2]);
    if (k + 3 < K) v.w = to_f32(row[k + 3]);
  }
  return v;
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

// the symmetric s8 quantization of w8a8_dyn_matmul_xla, as one byte
__device__ __forceinline__ uint32_t quant_s8(float x, float sa) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(x, sa)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ uint32_t pack_s8(float4 v, float sa) {
  return quant_s8(v.x, sa) | (quant_s8(v.y, sa) << 8) | (quant_s8(v.z, sa) << 16) |
         (quant_s8(v.w, sa) << 24);
}

__device__ __forceinline__ uint32_t ld32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// ---------------------------------------------------------------------------
// Kernel 6, w8a8_dyn_matmul
// ---------------------------------------------------------------------------

struct DynParams {
  const void* a;       // (M, K), row-major
  const uint8_t* w;    // (K, N) int8, row-major, or K-major (N, K)
  const float* ws;     // (N,) weight scales, or nullptr: ws_scalar
  float ws_scalar;
  void* out;           // (M, N) in A's dtype
  int* acc;            // M <= 16: (M, N) int32 K-split workspace, zero on entry and on exit
  unsigned* count;     // M <= 16: per column tile arrival counts, zero on entry and on exit
  uint8_t* aq;         // M > 16: (M, K) int8 scratch, the quantized A
  float* sa;           // M > 16: (M,) scratch, the row scales
  int* part;           // M > 16, (N, K) weight, split K: (splits, M, N) int32 partials, or nullptr
  int M, K, N;
};

__device__ __forceinline__ float col_scale(const float* v, float s, int n) { return v ? v[n] : s; }

constexpr int kGemvCols = 128;    // 32 lanes x 4 columns
constexpr int kGemvMaxM = 16;
constexpr int kGemvMaxChunk = 2048;

// M <= MR rows; block (x, y) owns columns [128 x, 128 x + 128) and K rows
// [y kchunk, (y + 1) kchunk)
template <typename T, int MR, bool WVEC>
__global__ void __launch_bounds__(kThreads) dyn_gemv_kernel(const DynParams p, int kchunk) {
  extern __shared__ int gemv_smem[];
  const int kc4 = kchunk / 4;
  uint32_t* s_aq = reinterpret_cast<uint32_t*>(gemv_smem);  // MR x kc4 words of 4 s8
  int* s_red = gemv_smem + MR * kc4;                          // MR x 128 block sums
  float* s_sa = reinterpret_cast<float*>(s_red + MR * kGemvCols);
  float* s_max = s_sa + MR;                                   // 8 warps x MR
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int M = p.M, K = p.K, N = p.N;
  const T* a = static_cast<const T*>(p.a);

  // the first batch of weight rows is requested before the work on A, so
  // its latency overlaps the row scales and the quantization: warp w takes
  // k-quads w, w + 8, ... of this block's chunk, U quads (4 rows each) per
  // batch, the next batch in flight while one is multiplied
  constexpr int U = 4;
  const int kb = blockIdx.y * kchunk;
  const int n0 = blockIdx.x * kGemvCols + 4 * lane;
  const int nq = (min(K, kb + kchunk) - kb + 3) / 4;
  uint32_t cur[U][4], nxt[U][4];
  auto load_batch = [&](uint32_t (&rw)[U][4], int q0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = kb + 4 * (q0 + 8 * u);
      const bool in = q0 + 8 * u < nq;
#pragma unroll
      for (int r = 0; r < 4; ++r) rw[u][r] = in ? load_w4<WVEC>(p.w, k + r, n0, K, N) : 0u;
    }
  };
  load_batch(cur, warp);

  // 1. row scales from the whole rows
  float mx[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) mx[m] = 0.f;
#pragma unroll 4
  for (int k = tid; k < K; k += kThreads) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < M) mx[m] = fmaxf(mx[m], fabsf(to_f32(a[static_cast<size_t>(m) * K + k])));
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float v = warp_max(mx[m]);
    if (lane == 0) s_max[warp * MR + m] = v;
  }
  for (int i = tid; i < MR * kGemvCols; i += kThreads) s_red[i] = 0;
  __syncthreads();
  if (tid < MR) {
    float v = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) v = fmaxf(v, s_max[w * MR + tid]);
    s_sa[tid] = fmaxf(v, 1e-12f) * kInv127;
  }
  __syncthreads();

  // 2. this block's K chunk of A, quantized (rows past M are zero)
  for (int i = tid; i < MR * kc4; i += kThreads) {
    const int m = i / kc4, k = kb + 4 * (i % kc4);
    uint32_t q = 0u;
    if (m < M) q = pack_s8(load4<T, false>(a + static_cast<size_t>(m) * K, k, K), s_sa[m]);
    s_aq[i] = q;
  }
  __syncthreads();

  // 3. dot products: four weight rows of a lane's four columns transposed in
  // registers, one dp4a per row of A and column
  int acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
  for (int q0 = warp; q0 < nq; q0 += 8 * U) {
    const bool more = q0 + 8 * U < nq;
    if (more) load_batch(nxt, q0 + 8 * U);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = q0 + 8 * u;
      if (q < nq) {
        uint32_t wt[4];
        transpose4(cur[u], wt);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int av = static_cast<int>(s_aq[m * kc4 + q]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(av, static_cast<int>(wt[j]), acc[m][j]);
        }
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[u][r] = nxt[u][r];
    }
  }

  // 4. the 8 warps' sums meet in shared memory (exact integer atomics)
#pragma unroll
  for (int m = 0; m < MR; ++m)
    if (m < M)
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&s_red[m * kGemvCols + 4 * lane + j], acc[m][j]);
  __syncthreads();

  // 5. epilogue, directly or by the last block of a K split
  T* out = static_cast<T*>(p.out);
  const int nb = blockIdx.x * kGemvCols;
  if (gridDim.y == 1) {
    for (int i = tid; i < M * kGemvCols; i += kThreads) {
      const int m = i / kGemvCols, n = nb + i % kGemvCols;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] =
            from_f32<T>(static_cast<float>(s_red[i]) * s_sa[m] * col_scale(p.ws, p.ws_scalar, n));
    }
    return;
  }
  for (int i = tid; i < M * kGemvCols; i += kThreads) {
    const int m = i / kGemvCols, n = nb + i % kGemvCols;
    if (n < N) atomicAdd(&p.acc[static_cast<size_t>(m) * N + n], s_red[i]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.count[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = tid; i < M * kGemvCols; i += kThreads) {
    const int m = i / kGemvCols, n = nb + i % kGemvCols;
    if (n < N) {
      const int v = atomicExch(&p.acc[static_cast<size_t>(m) * N + n], 0);
      out[static_cast<size_t>(m) * N + n] =
          from_f32<T>(static_cast<float>(v) * s_sa[m] * col_scale(p.ws, p.ws_scalar, n));
    }
  }
  if (tid == 0) atomicExch(&p.count[blockIdx.x], 0u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// M > 16: the rows of A are quantized once, by one block each, into a
// scratch of M x K int8 and M row scales; the tiled product then reads 1 byte
// per element of A and divides nothing
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) dyn_quant_rows_kernel(const DynParams p) {
  __shared__ float s_max[kThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = p.K, m = blockIdx.x;
  const T* row = static_cast<const T*>(p.a) + static_cast<size_t>(m) * K;
  float mx = 0.f;
  for (int k = 4 * tid; k < K; k += 4 * kThreads) {
    const float4 v = load4<T, VEC>(row, k, K);
    mx = fmaxf(mx, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  mx = warp_max(mx);
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  mx = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) mx = fmaxf(mx, s_max[w]);
  const float sa = fmaxf(mx, 1e-12f) * kInv127;
  if (tid == 0) p.sa[m] = sa;
  uint8_t* q = p.aq + static_cast<size_t>(m) * K;
  for (int k = 4 * tid; k < K; k += 4 * kThreads) {
    const uint32_t v = pack_s8(load4<T, VEC>(row, k, K), sa);
    if (VEC) {
      *reinterpret_cast<uint32_t*>(q + k) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < K) q[k + e] = static_cast<uint8_t>(v >> (8 * e));
    }
  }
}

constexpr int kDynBM = 64, kDynBN = 128, kDynBK = 64;
constexpr int kDynPitch = kDynBK + 16;  // bytes: rows 20 words apart, fragment loads conflict-free

// Fragment layouts of mma.m16n8k32 .s8 (PTX ISA), g = lane / 4, t = lane % 4,
// each register four consecutive k:
//   A (16x32): a0 = (g, 4t..), a1 = (g+8, 4t..), a2 = (g, 16+4t..), a3 = (g+8, 16+4t..)
//   B (32x8):  b0 = (k 4t.., n g), b1 = (k 16+4t.., n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// 8 warps as 2 (M) x 4 (N), each a 32 x 32 tile: 2 x 4 mma per k32 step.
// AVEC: K % 16 == 0, so a row of the int8 A tile is 4 vector loads.
template <typename T, bool AVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads) dyn_mma_kernel(const DynParams p) {
  __shared__ __align__(16) uint8_t sA[kDynBM * kDynPitch];  // quantized A, [m][k]
  __shared__ __align__(16) uint8_t sW[kDynBN * kDynPitch];  // W transposed, [n][k]
  __shared__ float s_sa[kDynBM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kDynBM, n0 = blockIdx.y * kDynBN;
  if (tid < kDynBM) s_sa[tid] = m0 + tid < M ? p.sa[m0 + tid] : 0.f;

  // staging: A row tid / 4, sixteen bytes from 16 (tid % 4); W 4 x 4 blocks
  // u = tid + 256 v (k-quad u % 16, column quad u / 16)
  uint4 ra;
  uint32_t rw[2][4];
  const int ar = tid / 4, ac = 16 * (tid % 4);
  auto load_tile = [&](int k0) {
    const int m = m0 + ar, k = k0 + ac;
    const uint8_t* src = p.aq + static_cast<size_t>(m) * K + k;
    if (AVEC) {
      ra = (m < M && k < K) ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (m < M && k + e < K) wd[e / 4] |= static_cast<uint32_t>(src[e]) << (8 * (e % 4));
      ra = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int u = tid + kThreads * v;
      const int kk = k0 + 4 * (u % 16), n = n0 + 4 * (u / 16);
#pragma unroll
      for (int r = 0; r < 4; ++r) rw[v][r] = load_w4<WVEC>(p.w, kk + r, n, K, N);
    }
  };
  auto store_tile = [&]() {
    *reinterpret_cast<uint4*>(sA + ar * kDynPitch + ac) = ra;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int u = tid + kThreads * v;
      uint32_t c[4];
      transpose4(rw[v], c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sW + (4 * (u / 16) + j) * kDynPitch + 4 * (u % 16)) = c[j];
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nkt = (K + kDynBK - 1) / kDynBK;
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile is consumed
    store_tile();
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kDynBK);
#pragma unroll
    for (int ks = 0; ks < kDynBK / 32; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* pa = sA + (wm * 32 + i * 16 + g) * kDynPitch + ks * 32 + 4 * t;
        af[i][0] = ld32(pa);
        af[i][1] = ld32(pa + 8 * kDynPitch);
        af[i][2] = ld32(pa + 16);
        af[i][3] = ld32(pa + 8 * kDynPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* pb = sW + (wn * 32 + j * 8 + g) * kDynPitch + ks * 32 + 4 * t;
        bf[j][0] = ld32(pb);
        bf[j][1] = ld32(pb + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 32 + i * 16 + g + (e / 2) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e % 2);
        if (m0 + r < M && n < N)
          out[static_cast<size_t>(m0 + r) * N + n] = from_f32<T>(
              static_cast<float>(acc[i][j][e]) * s_sa[r] * col_scale(p.ws, p.ws_scalar, n));
      }
}

// ---- kernel 6 on a K-major (N, K) weight ----------------------------------

// float(acc) * sa * ws in the twin's order, each product rounded (no FMA)
template <typename T>
__device__ __forceinline__ T dyn_out(int acc, float sa, float ws) {
  return from_f32<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc), sa), ws));
}

// eight consecutive elements of a row of A as floats (K % 16 == 0, so never
// past K); VEC: the row is 16-byte aligned
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* row, int k, float (&v)[8]) {
  if constexpr (VEC && std::is_same<T, float>::value) {
    const float4 lo = *reinterpret_cast<const float4*>(row + k), hi = *reinterpret_cast<const float4*>(row + k + 4);
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else if constexpr (VEC) {
    alignas(16) T e[8];
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = to_f32(row[k + j]);
  }
}

constexpr int kNkARegs = 3;  // pieces of 8 elements of a row of A a thread holds: K <= 6144

// One row of A (K % 8 == 0, K <= 8 kThreads kNkARegs) quantized by a whole
// block into dst (shared or device memory), the arithmetic of
// dyn_quant_rows_kernel: each thread holds its pieces of 8 elements in
// registers from the row maximum to the s8 bytes, every thread reduces the
// warps' maxima itself (one read of A, one barrier). Returns sa. s_max: 8
// floats of shared memory; the caller synchronizes before reading dst.
template <typename T, bool AVEC>
__device__ __forceinline__ float quantize_row_held(const T* row, int K, uint8_t* dst, float* s_max) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float v[kNkARegs][8];
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < kNkARegs; ++j) {
    const int k = 8 * (tid + kThreads * j);
    if (k < K) {
      load8<T, AVEC>(row, k, v[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[j][e]));
    }
  }
  mx = warp_max(mx);
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  mx = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) mx = fmaxf(mx, s_max[w]);
  const float sa = fmaxf(mx, 1e-12f) * kInv127;
#pragma unroll
  for (int j = 0; j < kNkARegs; ++j) {
    const int k = 8 * (tid + kThreads * j);
    if (k < K)
      *reinterpret_cast<uint2*>(dst + k) = make_uint2(pack_s8(make_float4(v[j][0], v[j][1], v[j][2], v[j][3]), sa),
                                                      pack_s8(make_float4(v[j][4], v[j][5], v[j][6], v[j][7]), sa));
  }
  return sa;
}

// The quantization in front of the wgmma form, one block a row (K % 16 == 0,
// K <= 8 kThreads kNkARegs): quantize_row_held into the (M, K) s8 scratch.
template <typename T, bool AVEC>
__global__ void __launch_bounds__(kThreads) dyn_quant_rows_held_kernel(const DynParams p) {
  __shared__ float s_max[kThreads / 32];
  const int m = blockIdx.x;
  const float sa = quantize_row_held<T, AVEC>(static_cast<const T*>(p.a) + static_cast<size_t>(m) * p.K, p.K,
                                              p.aq + static_cast<size_t>(m) * p.K, s_max);
  if (threadIdx.x == 0) p.sa[m] = sa;
}

constexpr int kNkCols = kThreads / 32;  // columns of a GEMV block at a time, one a warp
constexpr int kNkPieces = 4;            // 16-byte weight pieces of a lane per chunk: 2 KB a warp

// M <= MR rows, W (N, K) with K % 16 == 0 and W 16-byte aligned. Block b
// takes column groups b, b + gridDim.x, ...; warp w column 8 g + w of group
// g, read in chunks of 32 x kNkPieces 16-byte pieces along K. A warp walks
// its chunks with the next one's loads in flight while it multiplies the
// current one. Shared memory: the quantized rows of A (MR x K bytes), their
// scales, the warps' row maxima.
template <typename T, int MR, bool AVEC>
__global__ void __launch_bounds__(kThreads) dyn_gemv_nk_kernel(const DynParams p) {
  extern __shared__ uint4 gemv_nk_smem[];
  const int M = p.M, K = p.K, N = p.N;
  uint8_t* s_aq = reinterpret_cast<uint8_t*>(gemv_nk_smem);
  float* s_sa = reinterpret_cast<float*>(s_aq + MR * K);
  float* s_max = s_sa + MR;  // [warp][MR]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* a = static_cast<const T*>(p.a);
  const int kv = K / 16;                                       // 16-byte pieces of a weight row
  const int cpc = (kv + 32 * kNkPieces - 1) / (32 * kNkPieces);  // chunks a column
  const int groups = (N + kNkCols - 1) / kNkCols;
  const int chunks = cpc * ((groups - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x);

  // chunk c of this warp: column 8 (blockIdx.x + (c / cpc) gridDim.x) + warp, pieces from 32 kNkPieces (c % cpc)
  auto load = [&](uint4 (&wv)[kNkPieces], int c) {
    const int col = kNkCols * (blockIdx.x + (c / cpc) * gridDim.x) + warp, v0 = 32 * kNkPieces * (c % cpc);
    const uint4* row = reinterpret_cast<const uint4*>(p.w + static_cast<size_t>(col) * K);
#pragma unroll
    for (int u = 0; u < kNkPieces; ++u) {
      const int v = v0 + 32 * u + lane;
      wv[u] = col < N && v < kv ? __ldg(row + v) : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 cur[kNkPieces], nxt[kNkPieces];
  // the first chunk is in flight while A is quantized
  load(cur, 0);

  if (MR == 1 && K <= 8 * kThreads * kNkARegs) {
    const float sa = quantize_row_held<T, AVEC>(a, K, s_aq, s_max);
    if (tid == 0) s_sa[0] = sa;
    __syncthreads();
  } else {
    // 1. row scales
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
      float mx = 0.f;
      for (int k = 8 * tid; k < K; k += 8 * kThreads) {
        float v[8];
        load8<T, AVEC>(a + static_cast<size_t>(m) * K, k, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(v[j]));
      }
      mx = warp_max(mx);
      if (lane == 0) s_max[warp * MR + m] = mx;
    }
    __syncthreads();
    if (tid < M) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) v = fmaxf(v, s_max[w * MR + tid]);
      s_sa[tid] = fmaxf(v, 1e-12f) * kInv127;
    }
    __syncthreads();
    // 2. the rows of A, quantized, eight bytes a thread at a time
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
      const float sa = s_sa[m];
      for (int k = 8 * tid; k < K; k += 8 * kThreads) {
        float v[8];
        load8<T, AVEC>(a + static_cast<size_t>(m) * K, k, v);
        const uint2 q = make_uint2(pack_s8(make_float4(v[0], v[1], v[2], v[3]), sa),
                                   pack_s8(make_float4(v[4], v[5], v[6], v[7]), sa));
        *reinterpret_cast<uint2*>(s_aq + static_cast<size_t>(m) * K + k) = q;
      }
    }
    __syncthreads();
  }

  // 3. the chunks: 16 weight bytes x 16 bytes of each row of A, four dp4a;
  // after a column's last chunk the lanes' sums meet by shuffles
  int acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) acc[m] = 0;
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(nxt, c + 1);
    const int v0 = 32 * kNkPieces * (c % cpc);
#pragma unroll
    for (int u = 0; u < kNkPieces; ++u) {
      const int v = v0 + 32 * u + lane;
      if (v < kv) {
        const uint4 w = cur[u];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m < M) {
            const uint4 q = *reinterpret_cast<const uint4*>(s_aq + static_cast<size_t>(m) * K + 16 * v);
            int s = __dp4a(static_cast<int>(q.x), static_cast<int>(w.x), acc[m]);
            s = __dp4a(static_cast<int>(q.y), static_cast<int>(w.y), s);
            s = __dp4a(static_cast<int>(q.z), static_cast<int>(w.z), s);
            acc[m] = __dp4a(static_cast<int>(q.w), static_cast<int>(w.w), s);
          }
        }
      }
    }
    if (c + 1 < chunks) {
#pragma unroll
      for (int u = 0; u < kNkPieces; ++u) cur[u] = nxt[u];
    }
    if (c % cpc == cpc - 1) {
      const int col = kNkCols * (blockIdx.x + (c / cpc) * gridDim.x) + warp;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      }
      if (col < N) {
        const float ws = col_scale(p.ws, p.ws_scalar, col);
        T* out = static_cast<T*>(p.out);
#pragma unroll
        for (int m = 0; m < MR; ++m)
          if (m < M && lane == m) out[static_cast<size_t>(m) * N + col] = dyn_out<T>(acc[m], s_sa[m], ws);
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] = 0;
    }
  }
}

template <int CWG>
struct DynWgCfg {
  static constexpr int kBM = 64 * CWG, kBN = 128;
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * gemm90::kBK8;  // kBM rows of one 128-byte k-tile
  static constexpr int kStageBytes = kABytes + kBN * gemm90::kBK8;
  // the ring, the tile's row and column scales, the barriers, slack to reach a 1024-byte boundary
  static constexpr int kSmemBytes = kStages * kStageBytes + 4 * (kBM + kBN) + 16 * kStages + 1024;
  static constexpr int kThreadsWg = (CWG + 1) * gemm90::kWG;
  static_assert(CWG * gemm90::OutTile<kBN, 4>::kBytes <= kStages * kStageBytes, "the output tiles reuse the ring");
  static_assert(kSmemBytes <= 232448, "shared memory of a block");
};

// two neighbouring outputs into the shared-memory output tile
template <typename T>
__device__ __forceinline__ void st_out2(uint32_t addr, T y0, T y1) {
  if constexpr (std::is_same<T, float>::value) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(y0), "f"(y1) : "memory");
  } else {
    alignas(4) T pair[2] = {y0, y1};
    gemm90::st_shared4(addr, *reinterpret_cast<const uint32_t*>(pair));
  }
}

// blockIdx = (M tile, N tile, K split): the quantized A (aq, M x K s8) times
// the (N, K) weight, warpgroups 0 .. CWG - 1 consume, warpgroup CWG loads.
// With gridDim.z > 1 the int32 partials go to part (splits, M, N) and
// dyn_splitk_reduce finishes; kt_per_split k-tiles per split.
template <typename T, int CWG>
__global__ void __launch_bounds__(DynWgCfg<CWG>::kThreadsWg, 1)
    dyn_wgmma_kernel(const DynParams p, int kt_per_split) {
  using namespace gemm90;
  using Cfg = DynWgCfg<CWG>;
  using Out = OutTile<Cfg::kBN, sizeof(T)>;
  extern __shared__ __align__(16) uint8_t smem_dyn[];
  const uint32_t stage0 = align1024(smem_u32(smem_dyn));
  const uint32_t s_sa = stage0 + Cfg::kStages * Cfg::kStageBytes, s_ws = s_sa + 4 * Cfg::kBM;
  const uint32_t full0 = s_ws + 4 * Cfg::kBN, empty0 = full0 + 8 * Cfg::kStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * Cfg::kBM, n0 = blockIdx.y * Cfg::kBN;
  if (tid == 0) {
    init_barriers<Cfg::kStages>(full0, empty0, kWG, CWG * kWG);
    mbar_init_fence();
  }
  if (tid < Cfg::kBM) st_shared4(s_sa + 4 * tid, __float_as_uint(m0 + tid < M ? p.sa[m0 + tid] : 0.f));
  if (tid < Cfg::kBN) st_shared4(s_ws + 4 * tid, __float_as_uint(col_scale(p.ws, p.ws_scalar, min(n0 + tid, N - 1))));
  __syncthreads();

  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(kt_per_split, (K + kBK8 - 1) / kBK8 - kt0);
  if (wg == CWG) {
    produce<Cfg::kStages>(nkt, full0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * Cfg::kStageBytes;
      const int k0 = (kt0 + it) * kBK8;
      load_kmajor_tile<Cfg::kBM>(sb, p.aq, K, m0, M, k0, K, t);
      load_kmajor_tile<Cfg::kBN>(sb + Cfg::kABytes, p.w, K, n0, N, k0, K, t);
    });
    return;
  }

  int acc[Cfg::kBN / 2];
#pragma unroll
  for (int i = 0; i < Cfg::kBN / 2; ++i) acc[i] = 0;
  consume_kmajor<Cfg::kStages>(acc, nkt, stage0 + wg * 64 * kBK8, stage0 + Cfg::kABytes, Cfg::kStageBytes, full0,
                               empty0, [](int(&d)[Cfg::kBN / 2], uint64_t da, uint64_t db) {
                                 wgmma_m64n128k32_s8(d, da, db);
                               });

  const int lrow = (t / 32) * 16 + (t % 32) / 4, lcol = 2 * (t % 4);  // within the warpgroup's tile
  if (gridDim.z > 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + lrow + 8 * h;
      if (m >= M) continue;
      int* part = p.part + (static_cast<size_t>(blockIdx.z) * M + m) * N;
#pragma unroll
      for (int j = 0; j < Cfg::kBN / 8; ++j) {
        const int n = n0 + lcol + 8 * j;
        if (n + 1 < N && N % 2 == 0) {
          *reinterpret_cast<int2*>(part + n) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (n < N) part[n] = acc[4 * j + 2 * h];
          if (n + 1 < N) part[n + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
    return;
  }
  // every consumer is past its last wgmma: the ring is free for the output tiles
  named_barrier(1, CWG * kWG);
  const uint32_t tile = stage0 + wg * Out::kBytes;
#pragma unroll
  for (int j = 0; j < Cfg::kBN / 8; ++j) {
    const int c = lcol + 8 * j;
    float ws0, ws1;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(ws0), "=f"(ws1) : "r"(s_ws + 4 * c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lrow + 8 * h;
      float sa;
      asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(sa) : "r"(s_sa + 4 * (64 * wg + r)));
      st_out2<T>(Out::at(tile, r, c), dyn_out<T>(acc[4 * j + 2 * h], sa, ws0),
                 dyn_out<T>(acc[4 * j + 2 * h + 1], sa, ws1));
    }
  }
  named_barrier(2 + wg, kWG);
  const int mt = m0 + 64 * wg;
  if ((static_cast<long long>(N) * sizeof(T)) % 16 == 0) {
    Out::flush(tile, p.out, mt, n0, M, N, t);
  } else {  // rows that are not whole 16-byte pieces (the LM head): element by element
    const uint8_t* src = smem_dyn + (tile - smem_u32(smem_dyn));
    T* out = static_cast<T*>(p.out);
    for (int i = t; i < 64 * Cfg::kBN; i += kWG) {
      const int r = i / Cfg::kBN, c = i % Cfg::kBN;
      if (mt + r < M && n0 + c < N)
        out[static_cast<size_t>(mt + r) * N + n0 + c] = *reinterpret_cast<const T*>(src + r * Out::kPitch + c * sizeof(T));
    }
  }
}

// out = the epilogue of the sum of the int32 partials (exact), one thread an output
template <typename T>
__global__ void __launch_bounds__(kThreads) dyn_splitk_reduce(const DynParams p, int splits) {
  const size_t total = static_cast<size_t>(p.M) * p.N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  int s = p.part[i];
  for (int z = 1; z < splits; ++z) s += p.part[z * total + i];
  const int m = static_cast<int>(i / p.N), n = static_cast<int>(i % p.N);
  static_cast<T*>(p.out)[i] = dyn_out<T>(s, p.sa[m], col_scale(p.ws, p.ws_scalar, n));
}

// K split of the GEMV: enough blocks for ~4 per SM, chunks of at least 128
// and at most kGemvMaxChunk rows (a multiple of 32: 8 warps x 4 rows)
void gemv_geometry(int K, int N, int* ksplit, int* kchunk) {
  const int col_tiles = (N + kGemvCols - 1) / kGemvCols;
  int split = (4 * 132 + col_tiles - 1) / col_tiles;
  const int most = (K + 127) / 128;
  if (split > most) split = most;
  if (split < 1) split = 1;
  int chunk = (K + split - 1) / split;
  chunk = (chunk + 31) / 32 * 32;
  if (chunk > kGemvMaxChunk) chunk = kGemvMaxChunk;
  *kchunk = chunk;
  *ksplit = (K + chunk - 1) / chunk;
}

template <typename T, int MR, bool WVEC>
cudaError_t launch_gemv(const DynParams& p, cudaStream_t stream) {
  int ksplit, kchunk;
  gemv_geometry(p.K, p.N, &ksplit, &kchunk);
  const size_t smem = sizeof(int) * (MR * kchunk / 4 + MR * kGemvCols + MR + 8 * MR);
  const dim3 grid((p.N + kGemvCols - 1) / kGemvCols, ksplit);
  dyn_gemv_kernel<T, MR, WVEC><<<grid, kThreads, smem, stream>>>(p, kchunk);
  return cudaGetLastError();
}

bool aligned(const void* ptr, unsigned long long bytes) {
  return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

template <typename T, bool WVEC>
cudaError_t launch_dyn_mma(const DynParams& p, cudaStream_t stream) {
  if (p.K % 4 == 0 && aligned(p.a, 16) && aligned(p.aq, 16))
    dyn_quant_rows_kernel<T, true><<<p.M, kThreads, 0, stream>>>(p);
  else
    dyn_quant_rows_kernel<T, false><<<p.M, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kDynBM - 1) / kDynBM, (p.N + kDynBN - 1) / kDynBN);
  if (p.K % 16 == 0 && aligned(p.aq, 16))
    dyn_mma_kernel<T, true, WVEC><<<grid, kThreads, 0, stream>>>(p);
  else
    dyn_mma_kernel<T, false, WVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dyn_dispatch(const DynParams& p, cudaStream_t stream) {
  const bool wvec = p.N % 4 == 0 && aligned(p.w, 4);
  if (p.M <= kGemvMaxM) {
    if (p.M == 1) return wvec ? launch_gemv<T, 1, true>(p, stream) : launch_gemv<T, 1, false>(p, stream);
    return wvec ? launch_gemv<T, kGemvMaxM, true>(p, stream) : launch_gemv<T, kGemvMaxM, false>(p, stream);
  }
  return wvec ? launch_dyn_mma<T, true>(p, stream) : launch_dyn_mma<T, false>(p, stream);
}

// SMs of the current device, asked once
int sm_count() {
  static int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

template <typename T, int MR>
cudaError_t launch_gemv_nk(const DynParams& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(MR) * p.K + 4 * MR + 4 * (kThreads / 32) * MR;
  const bool avec = aligned(p.a, 16);
  auto kernel = avec ? dyn_gemv_nk_kernel<T, MR, true> : dyn_gemv_nk_kernel<T, MR, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // at most the blocks an SM holds at once: each quantizes A once and walks column groups
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int groups = (p.N + kNkCols - 1) / kNkCols;
  const int blocks = min(groups, max(1, per_sm) * sm_count());
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// quantize == 0: the scratch already holds this A's s8 rows and row scales
// (the caller's previous call read the same, unchanged A), so only the
// product is launched
template <typename T, int CWG>
cudaError_t launch_dyn_wgmma(const DynParams& p, int splits, bool quantize, cudaStream_t stream) {
  using Cfg = DynWgCfg<CWG>;
  static cudaError_t attr = cudaFuncSetAttribute(dyn_wgmma_kernel<T, CWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Cfg::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int nkt = (p.K + gemm90::kBK8 - 1) / gemm90::kBK8;
  const int per = (nkt + splits - 1) / splits;
  if (splits < 1 || splits > 65535 || (splits - 1) * per >= nkt || (splits > 1 && p.part == nullptr))
    return cudaErrorInvalidValue;
  if (quantize) {
    const bool avec = aligned(p.a, 16);  // K % 16 == 0 and aq is 16-byte aligned
    if (p.K > 8 * kThreads * kNkARegs) {  // rows longer than the registers hold: read twice
      if (avec) dyn_quant_rows_kernel<T, true><<<p.M, kThreads, 0, stream>>>(p);
      else dyn_quant_rows_kernel<T, false><<<p.M, kThreads, 0, stream>>>(p);
    } else if (avec) {
      dyn_quant_rows_held_kernel<T, true><<<p.M, kThreads, 0, stream>>>(p);
    } else {
      dyn_quant_rows_held_kernel<T, false><<<p.M, kThreads, 0, stream>>>(p);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + Cfg::kBM - 1) / Cfg::kBM, (p.N + Cfg::kBN - 1) / Cfg::kBN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  dyn_wgmma_kernel<T, CWG><<<grid, Cfg::kThreadsWg, Cfg::kSmemBytes, stream>>>(p, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(p.M) * p.N;
  dyn_splitk_reduce<T><<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

// the K-major forms take an (N, K) weight whose rows are whole 16-byte
// pieces: mirrored by dyn_variant in kernels/qmatmul.py
bool dyn_nk_ok(const DynParams& p) { return p.K % 16 == 0 && aligned(p.w, 16); }

template <typename T>
cudaError_t dyn_nk_dispatch(const DynParams& p, int bm, int splits, bool quantize, cudaStream_t stream) {
  if (p.M <= kGemvMaxM) return p.M == 1 ? launch_gemv_nk<T, 1>(p, stream) : launch_gemv_nk<T, kGemvMaxM>(p, stream);
  if (bm == 64) return launch_dyn_wgmma<T, 1>(p, splits, quantize, stream);
  if (bm == 128) return launch_dyn_wgmma<T, 2>(p, splits, quantize, stream);
  if (bm == 256) return launch_dyn_wgmma<T, 4>(p, splits, quantize, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Kernel 5, w8_matmul
// ---------------------------------------------------------------------------

struct W8Params {
  const void* a;     // (M, K), row-major
  const uint8_t* w;  // (K, N) uint8, row-major
  const float* sw;   // (N,) scales, or nullptr: sw_scalar
  const float* zw;   // (N,) zero points, or nullptr: zw_scalar
  float sw_scalar, zw_scalar;
  void* out;         // (M, N) in A's dtype
  int M, K, N;
};

// sw * (acc - zw * rowsum) in the twin's order: the product rounds before the
// difference (no FMA contraction)
__device__ __forceinline__ float w8_epilogue(const W8Params& p, float acc, float rs, int n) {
  const float zw = col_scale(p.zw, p.zw_scalar, n);
  const float sw = col_scale(p.sw, p.sw_scalar, n);
  return __fmul_rn(__fsub_rn(acc, __fmul_rn(zw, rs)), sw);
}

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

// two bytes -> one register of two 16-bit values (exact for 0..255), `lo` low
__device__ __forceinline__ uint32_t pack2_u8(uint32_t lo, uint32_t hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2_u8(uint32_t lo, uint32_t hi, __half) {
  __half2 v = __floats2half2_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kW8BM = 64, kW8BN = 128, kW8BK = 64;
constexpr int kW8Pitch = kW8BK + 8;  // halfs: rows 36 words apart, fragment loads conflict-free

// bf16 / fp16 A on the tensor cores (mma.m16n8k16, f32 accumulate), the
// fragment layouts of csrc/flash_attention.cu. 8 warps as 2 (M) x 4 (N), each
// a 32 x 32 tile. The u8 tile is converted and transposed to [n][k] while it
// is staged: a thread takes two weight rows of four columns and writes four
// (k, k+1) pairs. rowsum(A) for the zero-point term is summed in float32 from
// the staging registers: 8 values per thread, then over the 8 threads of a
// row with shuffles.
template <typename T, bool AVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads) w8_mma_kernel(const W8Params p) {
  __shared__ __align__(16) T sA[kW8BM * kW8Pitch];
  __shared__ __align__(16) T sW[kW8BN * kW8Pitch];
  __shared__ float s_rs[kW8BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kW8BM, n0 = blockIdx.y * kW8BN;
  const T* a = static_cast<const T*>(p.a);

  // staging: A chunks i = tid + 256 v, row i / 8, eight columns from
  // 8 (i % 8); W units u = tid + 256 v: k pair u % 32, column quad u / 32
  uint4 ra[2];
  uint32_t rw[4][2];
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
      rw[v][0] = load_w4<WVEC>(p.w, kk, n, K, N);
      rw[v][1] = load_w4<WVEC>(p.w, kk + 1, n, K, N);
    }
  };
  float rs[2] = {0.f, 0.f};  // partial row sums of rows tid / 8 and 32 + tid / 8
  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int i = tid + kThreads * v;
      *reinterpret_cast<uint4*>(sA + (i / 8) * kW8Pitch + 8 * (i % 8)) = ra[v];
      const T* e = reinterpret_cast<const T*>(&ra[v]);
#pragma unroll
      for (int x = 0; x < 8; ++x) rs[v] += to_f32(e[x]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int u = tid + kThreads * v;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sW + (4 * (u / 32) + j) * kW8Pitch + 2 * (u % 32)) =
            pack2_u8((rw[v][0] >> (8 * j)) & 0xffu, (rw[v][1] >> (8 * j)) & 0xffu, T());
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nkt = (K + kW8BK - 1) / kW8BK;
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    store_tile();
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kW8BK);
#pragma unroll
    for (int ks = 0; ks < kW8BK / 16; ++ks) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* pa = sA + (wm * 32 + i * 16 + g) * kW8Pitch + ks * 16 + 2 * t;
        af[i][0] = ld32(pa);
        af[i][1] = ld32(pa + 8 * kW8Pitch);
        af[i][2] = ld32(pa + 8);
        af[i][3] = ld32(pa + 8 * kW8Pitch + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* pb = sW + (wn * 32 + j * 8 + g) * kW8Pitch + ks * 16 + 2 * t;
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
  for (int v = 0; v < 2; ++v) {
    float r = rs[v];
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    r += __shfl_xor_sync(0xffffffffu, r, 4);
    if (tid % 8 == 0) s_rs[(tid + kThreads * v) / 8] = r;
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 32 + i * 16 + g + (e / 2) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e % 2);
        if (m0 + r < M && n < N)
          out[static_cast<size_t>(m0 + r) * N + n] = from_f32<T>(w8_epilogue(p, acc[i][j][e], s_rs[r], n));
      }
}

// ---- kernel 5 on the wgmma pipeline (gemm_sm90.cuh) -----------------------

template <int CWG>
struct W8Cfg {
  static constexpr int kBN = 160, kSwz = 64;
  static constexpr int kStages = 6;                           // landing ring: A tile + raw uint8 tile
  static constexpr int kBStages = 3;                          // ring of converted B tiles
  static constexpr int kABytes = CWG * gemm90::kATileBytes;
  static constexpr int kRawBytes = gemm90::kBK * kBN;         // the uint8 tile as it lies
  static constexpr int kBBytes = gemm90::kBK * kBN * 2;       // converted, swizzled MN-major
  static constexpr int kStageBytes = kABytes + kRawBytes;
  static constexpr int kOnesBytes = 512;
  static constexpr int kScaleBytes = 2 * kBN * 4;             // the tile's scales and zero points
  // both rings, the tile of ones, the scales, the barriers of both rings, slack to reach a 1024-byte boundary
  static constexpr int kSmemBytes =
      kStages * kStageBytes + kBStages * kBBytes + kOnesBytes + kScaleBytes + 16 * (kStages + kBStages) + 1024;
  static_assert(CWG * gemm90::OutTile<kBN, 2>::kBytes <= kStages * kStageBytes, "the output tiles reuse the landing ring");
  static constexpr int kThreadsWg = (CWG + 2) * gemm90::kWG;  // consumers, loaders, converters
  static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle alignment");
  static_assert(kSmemBytes <= 232448, "shared memory of a block");
};

// four bytes -> four 16-bit values as two words, byte 0 lowest (exact)
__device__ __forceinline__ void cvt4_u8(uint32_t w, uint32_t& lo, uint32_t& hi, __nv_bfloat16) {
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388608.f;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388608.f;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542)) - 8388608.f;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7543)) - 8388608.f;
  __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1), b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<uint32_t*>(&a);
  hi = *reinterpret_cast<uint32_t*>(&b);
}
__device__ __forceinline__ void cvt4_u8(uint32_t w, uint32_t& lo, uint32_t& hi, __half) {
  const uint32_t bias = 0x64006400u;  // (1024, 1024)
  uint32_t a = __byte_perm(w, bias, 0x7150), b = __byte_perm(w, bias, 0x7352);
  __half2 ha = __hsub2(*reinterpret_cast<__half2*>(&a), *reinterpret_cast<const __half2*>(&bias));
  __half2 hb = __hsub2(*reinterpret_cast<__half2*>(&b), *reinterpret_cast<const __half2*>(&bias));
  lo = *reinterpret_cast<uint32_t*>(&ha);
  hi = *reinterpret_cast<uint32_t*>(&hb);
}

// blockIdx = (M tile, N tile, K split). With gridDim.z > 1 the float32
// partials go to ws (splits, M, N) and the partial row sums to wsr (splits,
// M); w8_splitk_reduce finishes. kt_per_split k-tiles per split. Warpgroups
// 0 .. CWG - 1 consume, the next one loads, the last one converts.
template <typename T, int CWG>
__global__ void __launch_bounds__(W8Cfg<CWG>::kThreadsWg, 1)
    w8_wgmma_kernel(const W8Params p, float* __restrict__ ws, float* __restrict__ wsr, int kt_per_split) {
  using namespace gemm90;
  using C = W8Cfg<CWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t stage0 = align1024(smem_u32(smem_raw));
  const uint32_t bt0 = stage0 + C::kStages * C::kStageBytes;
  const uint32_t ones = bt0 + C::kBStages * C::kBBytes;
  const uint32_t scales = ones + C::kOnesBytes;
  // landing ring: `landed` by the loaders, `empty` by consumers and converters;
  // converted ring: `bfull` by the converters, `bempty` by the consumers
  const uint32_t landed0 = scales + C::kScaleBytes, empty0 = landed0 + 8 * C::kStages;
  const uint32_t bfull0 = empty0 + 8 * C::kStages, bempty0 = bfull0 + 8 * C::kBStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  if (tid == 0) {
    init_barriers<C::kStages>(landed0, empty0, kWG, (CWG + 1) * kWG);
    init_barriers<C::kBStages>(bfull0, bempty0, kWG, CWG * kWG);
    mbar_init_fence();
  }
  if (tid < C::kBN) {  // this tile's (scale, zero point) pairs, read by the epilogue
    const int n = min(static_cast<int>(blockIdx.y) * C::kBN + tid, p.N - 1);
    st_shared4(scales + 8 * tid, __float_as_uint(col_scale(p.sw, p.sw_scalar, n)));
    st_shared4(scales + 8 * tid + 4, __float_as_uint(col_scale(p.zw, p.zw_scalar, n)));
  }
  if (tid < C::kOnesBytes / 16) {
    const T one = from_f32<T>(1.f);
    const uint32_t w = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&one)) * 0x10001u;
    st_shared16(ones + 16 * tid, make_uint4(w, w, w, w));
    fence_proxy_async();
  }
  __syncthreads();

  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * 64 * CWG, n0 = blockIdx.y * C::kBN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nkt = min(kt_per_split, (K + kBK - 1) / kBK - kt0);

  if (wg == CWG) {  // loaders
    const T* a = static_cast<const T*>(p.a);
    produce<C::kStages>(nkt, landed0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * C::kStageBytes;
      const int k0 = (kt0 + it) * kBK;
      load_a_tile<T, CWG>(sb, a, m0, k0, M, K, t);
      load_b_tile<1, C::kBN, C::kSwz>(sb + C::kABytes, p.w, k0, n0, K, N, t);
    });
    return;
  }
  if (wg == CWG + 1) {  // converters: the raw tile of stage s -> the B tile of slot it % kBStages
    constexpr int kPerRow = C::kBN / 16;
    static_assert(kBK * kPerRow % kWG == 0, "16-byte pieces divide over the warpgroup");
    for (int it = 0; it < nkt; ++it) {
      const int s = it % C::kStages, sb = it % C::kBStages;
      mbar_wait(landed0 + 8 * s, (it / C::kStages) & 1);
      mbar_wait(bempty0 + 8 * sb, ((it / C::kBStages) & 1) ^ 1);
      const uint32_t raw = stage0 + s * C::kStageBytes + C::kABytes, bt = bt0 + sb * C::kBBytes;
#pragma unroll
      for (int j = 0; j < kBK * kPerRow / kWG; ++j) {
        const int i = t + kWG * j;  // piece i: 16 columns of k row i / kPerRow
        const int r = i / kPerRow, n = 16 * (i % kPerRow);
        const uint4 v = ld_shared16(raw + 16 * i);
        uint4 lo, hi;
        cvt4_u8(v.x, lo.x, lo.y, T());
        cvt4_u8(v.y, lo.z, lo.w, T());
        cvt4_u8(v.z, hi.x, hi.y, T());
        cvt4_u8(v.w, hi.z, hi.w, T());
        st_shared16(bt + BTile<C::kSwz>::offset(r, n), lo);
        st_shared16(bt + BTile<C::kSwz>::offset(r, n + 8), hi);
      }
      fence_proxy_async();  // the stores above, for the wgmma that reads them
      mbar_arrive(bfull0 + 8 * sb);
      mbar_arrive(empty0 + 8 * s);
    }
    return;
  }

  float acc[C::kBN / 2], rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < C::kBN / 2; ++i) acc[i] = 0.f;
  consume<T, C::kBN, C::kSwz, C::kStages, C::kBStages, true>(acc, rs, nkt, stage0 + wg * kATileBytes, C::kStageBytes,
                                                             bt0, C::kBBytes, ones, landed0, empty0, bfull0, bempty0);

  const int lrow = (t / 32) * 16 + (t % 32) / 4, lcol = 2 * (t % 4);  // within the warpgroup's tile
  if (gridDim.z > 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + lrow + 8 * h;
      if (m >= M) continue;
      if (blockIdx.y == 0 && t % 4 == 0) wsr[static_cast<size_t>(blockIdx.z) * M + m] = rs[2 * h];
      float* part = ws + (static_cast<size_t>(blockIdx.z) * M + m) * N;
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j) {
        const int n = n0 + lcol + 8 * j;
        if (n < N) *reinterpret_cast<float2*>(part + n) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }
  // every consumer is past its last wgmma: the landing ring is free for the output tiles
  using Out = OutTile<C::kBN, 2>;
  named_barrier(1, CWG * kWG);
  const uint32_t tile = stage0 + wg * Out::kBytes;
#pragma unroll
  for (int j = 0; j < C::kBN / 8; ++j) {
    const int c = lcol + 8 * j;
    float sw0, zw0, sw1, zw1;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(sw0), "=f"(zw0), "=f"(sw1), "=f"(zw1)
                 : "r"(scales + 8 * c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // sw * (acc - zw * rowsum) in the twin's order, no FMA contraction
      const float v0 = __fmul_rn(__fsub_rn(acc[4 * j + 2 * h], __fmul_rn(zw0, rs[2 * h])), sw0);
      const float v1 = __fmul_rn(__fsub_rn(acc[4 * j + 2 * h + 1], __fmul_rn(zw1, rs[2 * h])), sw1);
      alignas(4) T pair[2] = {from_f32<T>(v0), from_f32<T>(v1)};
      st_shared4(Out::at(tile, lrow + 8 * h, c), *reinterpret_cast<const uint32_t*>(pair));
    }
  }
  named_barrier(2 + wg, kWG);
  Out::flush(tile, p.out, m0 + wg * 64, n0, M, N, t);
}

// out = epilogue(sum of the partials, sum of the partial row sums), both in
// split order; a thread takes two neighbouring columns (N % 2 == 0)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    w8_splitk_reduce(const W8Params p, const float* __restrict__ ws, const float* __restrict__ wsr, int splits) {
  const size_t pairs = static_cast<size_t>(p.M) * p.N / 2;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= pairs) return;
  const int m = static_cast<int>(i * 2 / p.N), n = static_cast<int>(i * 2 % p.N);
  const float2* w2 = reinterpret_cast<const float2*>(ws);
  float2 s = w2[i];
  float rs = wsr[m];
  for (int z = 1; z < splits; ++z) {
    const float2 v = w2[z * pairs + i];
    s.x += v.x, s.y += v.y;
    rs += wsr[static_cast<size_t>(z) * p.M + m];
  }
  alignas(4) T pair[2] = {from_f32<T>(w8_epilogue(p, s.x, rs, n)), from_f32<T>(w8_epilogue(p, s.y, rs, n + 1))};
  *reinterpret_cast<uint32_t*>(static_cast<T*>(p.out) + i * 2) = *reinterpret_cast<const uint32_t*>(pair);
}

constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16;
constexpr int kF32Pitch = kF32BM + 4;  // floats; 16-byte aligned rows

// float32 A: CUDA-core FMAs in full float32. A is staged transposed ([k][m])
// so that a thread's four rows are one vector load; each thread owns a 4 x 4
// output tile. Threads 0..63 keep the row sums, in k order.
template <bool AVEC, bool WVEC>
__global__ void __launch_bounds__(kThreads) w8_fma_kernel(const W8Params p) {
  __shared__ __align__(16) float sA[kF32BK * kF32Pitch];
  __shared__ __align__(16) float sW[kF32BK * kF32Pitch];
  __shared__ float s_rs[kF32BM];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int M = p.M, K = p.K, N = p.N;
  const int m0 = blockIdx.x * kF32BM, n0 = blockIdx.y * kF32BN;
  const float* a = static_cast<const float*>(p.a);

  const int ar = tid / 4, ak = 4 * (tid % 4);    // A: row, first of four k
  const int wk = tid / 16, wn = 4 * (tid % 16);  // W: k row, first of four columns
  float4 ra;
  uint32_t rw;
  auto load_tile = [&](int k0) {
    ra = m0 + ar < M ? load4<float, AVEC>(a + static_cast<size_t>(m0 + ar) * K, k0 + ak, K)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    rw = load_w4<WVEC>(p.w, k0 + wk, n0 + wn, K, N);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float rs = 0.f;

  const int nkt = (K + kF32BK - 1) / kF32BK;
  load_tile(0);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    sA[(ak + 0) * kF32Pitch + ar] = ra.x;
    sA[(ak + 1) * kF32Pitch + ar] = ra.y;
    sA[(ak + 2) * kF32Pitch + ar] = ra.z;
    sA[(ak + 3) * kF32Pitch + ar] = ra.w;
    *reinterpret_cast<float4*>(sW + wk * kF32Pitch + wn) =
        make_float4(static_cast<float>(rw & 0xffu), static_cast<float>((rw >> 8) & 0xffu),
                    static_cast<float>((rw >> 16) & 0xffu), static_cast<float>(rw >> 24));
    __syncthreads();
    if (kt + 1 < nkt) load_tile((kt + 1) * kF32BK);
    if (tid < kF32BM) {
#pragma unroll
      for (int k = 0; k < kF32BK; ++k) rs += sA[k * kF32Pitch + tid];
    }
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(sA + k * kF32Pitch + 4 * ty);
      const float4 wv = *reinterpret_cast<const float4*>(sW + k * kF32Pitch + 4 * tx);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], wj[j], acc[i][j]);
    }
  }
  if (tid < kF32BM) s_rs[tid] = rs;
  __syncthreads();

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (m0 + r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) out[static_cast<size_t>(m0 + r) * N + n] = w8_epilogue(p, acc[i][j], s_rs[r], n);
    }
  }
}

template <typename T, bool AVEC, bool WVEC>
cudaError_t launch_w8_mma(const W8Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + kW8BM - 1) / kW8BM, (p.N + kW8BN - 1) / kW8BN);
  w8_mma_kernel<T, AVEC, WVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool AVEC, bool WVEC>
cudaError_t launch_w8_fma(const W8Params& p, cudaStream_t stream) {
  const dim3 grid((p.M + kF32BM - 1) / kF32BM, (p.N + kF32BN - 1) / kF32BN);
  w8_fma_kernel<AVEC, WVEC><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int CWG>
cudaError_t launch_w8_wgmma(const W8Params& p, int splits, float* ws, cudaStream_t stream) {
  using C = W8Cfg<CWG>;
  static cudaError_t attr = cudaFuncSetAttribute(w8_wgmma_kernel<T, CWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int nkt = (p.K + gemm90::kBK - 1) / gemm90::kBK;
  const int per = (nkt + splits - 1) / splits;
  if (splits < 1 || (splits - 1) * per >= nkt || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  float* wsr = ws == nullptr ? nullptr : ws + static_cast<size_t>(splits) * p.M * p.N;
  const dim3 grid((p.M + 64 * CWG - 1) / (64 * CWG), (p.N + C::kBN - 1) / C::kBN, splits);
  w8_wgmma_kernel<T, CWG><<<grid, C::kThreadsWg, C::kSmemBytes, stream>>>(p, ws, wsr, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t pairs = static_cast<size_t>(p.M) * p.N / 2;
  w8_splitk_reduce<T><<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(p, ws, wsr, splits);
  return cudaGetLastError();
}

// the wgmma pipeline takes 16-bit A whose rows, and weight rows, are whole
// 16-byte pieces; mirrored by w8_variant in kernels/qmatmul.py
bool w8_use_wgmma(int dtype, const W8Params& p) {
  return dtype != 0 && p.K % 8 == 0 && p.N % 16 == 0 && aligned(p.a, 16) && aligned(p.w, 16);
}

template <typename T>
cudaError_t w8_dispatch(const W8Params& p, cudaStream_t stream) {
  const bool wvec = p.N % 4 == 0 && aligned(p.w, 4);
  if constexpr (std::is_same<T, float>::value) {
    const bool avec = p.K % 4 == 0 && aligned(p.a, 16);
    if (avec) return wvec ? launch_w8_fma<true, true>(p, stream) : launch_w8_fma<true, false>(p, stream);
    return wvec ? launch_w8_fma<false, true>(p, stream) : launch_w8_fma<false, false>(p, stream);
  } else {
    const bool avec = p.K % 8 == 0 && aligned(p.a, 16);
    if (avec) return wvec ? launch_w8_mma<T, true, true>(p, stream) : launch_w8_mma<T, true, false>(p, stream);
    return wvec ? launch_w8_mma<T, false, true>(p, stream) : launch_w8_mma<T, false, false>(p, stream);
  }
}

}  // namespace

// dtype of A and of the output: 0 = float32, 1 = float16, 2 = bfloat16.
// A is (M, K), row-major and contiguous; W (K, N) row-major, or with w_nk
// != 0 K-major as (N, K) (K % 16 == 0 and W 16-byte aligned: refused
// otherwise). ws: (N,) float32 scales or null (then ws_scalar). workspace:
// for a (K, N) weight and M <= 16, ceil(N / 128) zeroed counters followed by
// M * N zeroed int32, left zeroed; for M > 16, a scratch of M * K bytes
// (16-byte aligned) followed by M floats, A quantized (the s8 rows, the row
// scales); for w_nk and M <= 16 none (null). bm (64, 128 or 256 rows a tile),
// splits and part (splits * M * N int32, the K split's partials; null when
// splits == 1) are the caller's plan for the wgmma form (w_nk, M > 16), and
// quantize == 0 tells it that the workspace already holds this A quantized;
// the other forms ignore all four. Returns a cudaError_t: 0 when the
// launches were accepted.
extern "C" int ostt_w8a8_dyn_matmul(int dtype, const void* a, const void* w, const void* ws,
                                    float ws_scalar, void* out, void* workspace, int M, int K,
                                    int N, int w_nk, int bm, int splits, void* part, int quantize, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DynParams p{a, static_cast<const uint8_t*>(w), static_cast<const float*>(ws), ws_scalar, out,
              nullptr, nullptr, nullptr, nullptr, static_cast<int*>(part), M, K, N};
  if (w_nk && !dyn_nk_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= kGemvMaxM && !w_nk) {
    if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.count = static_cast<unsigned*>(workspace);
    p.acc = reinterpret_cast<int*>(p.count + (N + kGemvCols - 1) / kGemvCols);
  } else if (M > kGemvMaxM) {
    if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.aq = static_cast<uint8_t*>(workspace);
    p.sa = reinterpret_cast<float*>(p.aq + (static_cast<size_t>(M) * K + 15) / 16 * 16);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q = quantize != 0;
  switch (dtype) {
    case 0: return static_cast<int>(w_nk ? dyn_nk_dispatch<float>(p, bm, splits, q, st) : dyn_dispatch<float>(p, st));
    case 1: return static_cast<int>(w_nk ? dyn_nk_dispatch<__half>(p, bm, splits, q, st) : dyn_dispatch<__half>(p, st));
    case 2:
      return static_cast<int>(w_nk ? dyn_nk_dispatch<__nv_bfloat16>(p, bm, splits, q, st)
                                   : dyn_dispatch<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above; W (K, N) uint8; sw / zw: (N,) float32 or null (then the
// scalars). bm (64 or 128 rows per tile) and splits (K split) are the caller's
// plan for the wgmma pipeline, workspace its float32 scratch of splits *
// (M * N + M) values (null when splits == 1); shapes that take the masked
// kernels ignore all three.
extern "C" int ostt_w8_matmul(int dtype, const void* a, const void* w, const void* sw,
                              const void* zw, float sw_scalar, float zw_scalar, void* out, int M,
                              int K, int N, int bm, int splits, void* workspace, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const W8Params p{a, static_cast<const uint8_t*>(w), static_cast<const float*>(sw),
                   static_cast<const float*>(zw), sw_scalar, zw_scalar, out, M, K, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w8_use_wgmma(dtype, p)) {
    if (bm != 64 && bm != 128) return static_cast<int>(cudaErrorInvalidValue);
    float* ws = static_cast<float*>(workspace);
    if (dtype == 1)
      return static_cast<int>(bm == 64 ? launch_w8_wgmma<__half, 1>(p, splits, ws, st)
                                       : launch_w8_wgmma<__half, 2>(p, splits, ws, st));
    if (dtype == 2)
      return static_cast<int>(bm == 64 ? launch_w8_wgmma<__nv_bfloat16, 1>(p, splits, ws, st)
                                       : launch_w8_wgmma<__nv_bfloat16, 2>(p, splits, ws, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0: return static_cast<int>(w8_dispatch<float>(p, st));
    case 1: return static_cast<int>(w8_dispatch<__half>(p, st));
    case 2: return static_cast<int>(w8_dispatch<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
