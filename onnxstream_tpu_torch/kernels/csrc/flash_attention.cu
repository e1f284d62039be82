// Flash attention for Hopper (sm_90a), with a plain C ABI.
//
// Replaces both TPU flash kernels of onnxstream_tpu/kernels/flash_attention.py:
//   * flash_attention_packed -> _flash_call_packed -> _fa_kernel (packed heads,
//     no mask), and
//   * flash_attention -> _flash_call -> _fa_kernel (head-major, additive mask
//     in groups, K optionally given transposed).
// One kernel family serves both: every operand is read through explicit batch,
// head and row strides, so the packed (B, L, heads*D) form is the special case
// head stride = D. It computes what _fa_kernel computes:
//   out[b, h, m, :] = softmax(scale * q_bh k_bhk^T + mask[b, h]) v_bhk,  hk = h / (H / Hkv)
// with an online softmax in the log2 domain, float32 running max, sum and
// accumulator, the probabilities cast to V's dtype before the PV product,
// causal masking with offset N - M, and rows that see no valid key (causal
// with M > N, or a mask of -inf) written as exactly 0. A row masked only by a
// finite additive mask (-1e9) is not zeroed: it is the softmax of the masked
// scores, as in the TPU kernel.
//
// Layout. Q, V and O need a unit column stride; K may have any strides (a K
// given as (B, Hkv, D, N) is read in place). The additive mask is read in its
// own dtype (float32, float16 or bfloat16) through batch, head, row and column
// strides, 0 where it broadcasts, and added as mask*log2(e) in float32: no
// broadcast or float32 copy of it is ever made. Nothing is padded in device
// memory: head dims that are not a power of two are zero-filled in shared
// memory, and the QK^T loop runs over the real D only.
//
// Grid. One CTA per (q-tile, head, batch); the CTA walks the KV axis in a loop
// (the sequential grid axis of the TPU kernel), with K/V tiles staged in
// shared memory and the running max, sum and output accumulator in registers.
// The C entry takes the form explicitly (0 = packed, 1 = head-major): the
// variant is never inferred from the strides. Four variants, chosen by form,
// dtype, head dim and alignment in dispatch_head_major() / dispatch():
//
//  * fa_wgmma_kernel (the head-major entry only, kernel 2: bf16 / fp16, head
//    dims <= 128, 16-byte aligned Q/K/V/O rows, K read by rows), the shape of
//    Hopper's fast attention kernels: a loading warpgroup keeps Q and a ring
//    of two stages of K, V and mask tiles in flight with cp.async under
//    mbarriers (gemm_sm90.cuh), two consumer warpgroups of 64 query rows run
//    S = Q K^T and O += P V as wgmma, P in registers as the A operand and V
//    read MN-major through the transpose bit (described at the kernel). At
//    the TinyLlama prefill site (32 heads x 1024 x 64, a (1, 1, 1024, 1024)
//    mask) the work is 8.6 GFLOP against 12.7 MB: bound by the tensor cores
//    (8.7 us at 989 TFLOP/s). The design keeps the tensor cores fed from
//    shared memory that the loaders fill ahead of the consumers, and stages
//    the mask tile by 16-byte copies (one (1, 1, L, L) mask serves all heads
//    from L2). What holds it at about 8x that bound: the softmax between the
//    two products of a warpgroup, which nothing overlaps yet, and the mask
//    step, whose copies and 4-byte shared loads cost about as much as the
//    rest (ptxas also serializes the wgmma issue of the masked d <= 64
//    variants, note C7515: it packs P into the registers of S);
//  * fa_mma_kernel (bf16 / fp16, head dims <= 128, 16-byte aligned Q/V/O
//    rows): tensor-core products with mma.sync m16n8k16, f32 accumulate. Each
//    warp owns 16 query rows; the score tile stays in registers and is reused
//    as the A operand of the PV product (the FlashAttention-2 layout), so P
//    never touches shared memory. The softmax scale is applied in float32
//    (one FMA per score) instead of rounding a scaled Q to bf16.
//  * fa_mma_wide_kernel (bf16 / fp16, head dims 257..512, aligned rows, no
//    mask): the same instructions with D split across 8 warps (below);
//  * fa_fma_kernel (fp32, any head dim up to 512, up to 256 with a mask, any
//    alignment): CUDA-core FMAs on float32 tiles; each thread owns an
//    RM x (BN/8) score tile and an RM x (KD/8) accumulator, the 8 threads
//    sharing rows reduce with shuffles.
//    float32 inputs keep full float32 products, the parity path.
//
// What bounds the others. The score matrix never reaches device memory, which
// is what every variant saves over the plain version. The mma variant (kernel
// 1 at the SD UNet sites, and what the head-major entry takes for K given
// transposed or a mask whose rows are not 16-byte granular) is bound by the
// rate of mma.sync and its unpipelined K / V^T staging (two barriers a tile,
// V transposed element by element); its mask costs one scalar load per
// score. The FMA variant is bound by the FMA rate and
// shared-memory loads (about 2.7 FMAs per shared load). The wide variant runs
// one 183 KB CTA per SM, and at the VAE's 4096 tokens only 128 of them, each
// walking all keys with four barriers per tile: it is latency-bound (splitting
// the keys over CTAs is the next step for kernel 1).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* mask;  // nullptr: no mask
  int B, M, N, H, Hkv, D, Dv;
  long long sqb, sqh, sqm;       // Q batch, head and row strides, in elements
  long long skb, skh, skn, skd;  // K batch, head, key and column strides
  long long svb, svh, svn;       // V
  long long sob, soh, som;       // O
  long long smb, smh, smm, smn;  // mask; 0 on the dims it broadcasts over
  int mask_dtype;                // 0 = float32, 1 = float16, 2 = bfloat16
  float scale_log2;              // scale * log2(e)
  int causal;
};

__device__ __forceinline__ float load_mask(const Params& p, long long i) {
  switch (p.mask_dtype) {
    case 1: return __half2float(static_cast<const __half*>(p.mask)[i]);
    case 2: return __bfloat162float(static_cast<const __nv_bfloat16*>(p.mask)[i]);
    default: return static_cast<const float*>(p.mask)[i];
  }
}

constexpr int kThreads = 128;
constexpr int kTX = 8;                  // threads sharing one row group
constexpr int kTY = kThreads / kTX;     // row groups

// Row pitch of the probability tile: rows owned by neighbouring row groups
// (rm rows apart) start 8 banks apart, so the stores of one warp do not
// collide.
__host__ __device__ constexpr int p_pitch(int rm, int bn) {
  int pad = 0;
  while ((rm * (bn + pad)) % 32 != 8) ++pad;
  return bn + pad;
}

template <int KD, int BM, int BN>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (KD + 1) + 2 * BN * (KD + 1) + BM * p_pitch(BM / kTY, BN));
}

template <typename T, int KD, int BM, int BN, bool MASK>
__global__ void __launch_bounds__(kThreads) fa_fma_kernel(const Params p) {
  constexpr int RM = BM / kTY;  // query rows per thread
  constexpr int CN = BN / kTX;  // score columns per thread
  constexpr int CD = KD / kTX;  // output columns per thread
  constexpr int LD = KD + 1;    // shared row pitch of Q, K, V (conflict-free column reads)
  constexpr int LP = p_pitch(RM, BN);

  extern __shared__ float smem[];
  float* sQ = smem;            // BM x LD, pre-scaled by scale*log2(e)
  float* sK = sQ + BM * LD;    // BN x LD
  float* sV = sK + BN * LD;    // BN x LD
  float* sP = sV + BN * LD;    // BM x LP

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  const int cdv = p.Dv / kTX;  // output columns in use per thread (Dv % 8 == 0)

  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
  T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
  const long long mbase = b * p.smb + h * p.smh;

  for (int i = tid; i < BM * KD; i += kThreads) {
    const int r = i / KD, c = i % KD;
    float x = 0.f;
    if (m0 + r < p.M && c < p.D) x = to_f32(q[(m0 + r) * p.sqm + c]) * p.scale_log2;
    sQ[r * LD + c] = x;
  }

  // keys past the tile's last row + offset are masked for every row: skip them
  int n_end = p.N;
  if (p.causal) n_end = min(p.N, m0 + BM + offset);

  float m_i[RM], l_i[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // Q is staged; the previous tile's K, V and P are consumed
    for (int i = tid; i < BN * KD; i += kThreads) {
      const int r = i / KD, c = i % KD;
      const int n = n0 + r;
      float kx = 0.f, vx = 0.f;
      if (n < p.N) {
        if (c < p.D) kx = to_f32(k[n * p.skn + c * p.skd]);
        if (c < p.Dv) vx = to_f32(v[n * p.svn + c]);
      }
      sK[r * LD + c] = kx;
      sV[r * LD + c] = vx;
    }
    __syncthreads();

    // scores (log2 domain): s = (scale*log2e * q) . k over the real head dim
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < p.D; d0 += 8) {
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const int d = d0 + dd;
        float qa[RM], kb[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qa[i] = sQ[(ty * RM + i) * LD + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) kb[j] = sK[(tx + j * kTX) * LD + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

    // online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = m0 + ty * RM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = n0 + tx + j * kTX;
        const bool ok = col < p.N && (!p.causal || col <= row + offset);
        if (!ok) s[i][j] = -INFINITY;
        if constexpr (MASK) {
          if (ok && row < p.M) s[i][j] += kLog2e * load_mask(p, mbase + row * p.smm + col * p.smn);
        }
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      // a row with no valid key so far keeps p = 0, corr = 0 and l = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f(m_i[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pj = exp2f(s[i][j] - m_use);
        rs += pj;
        // P in V's dtype for the PV product, as the TPU kernel does
        sP[(ty * RM + i) * LP + tx + j * kTX] = to_f32(from_f32<T>(pj));
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V over this tile's keys
    const int nk = min(BN, n_end - n0);
    for (int n = 0; n < nk; ++n) {
      float pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = sP[(ty * RM + i) * LP + n];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        if (c < cdv) {
          const float vb = sV[n * LD + tx + c * kTX];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + ty * RM + i;
    if (row >= p.M) continue;
    const float denom = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      if (c < cdv) o[row * p.som + tx + c * kTX] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16 / fp16)
// ---------------------------------------------------------------------------

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

// two floats -> one register of two 16-bit values, `lo` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// V^T staging of the tensor-core variants: keys n0 .. n0 + BN - 1 of V
// (ntiles 8-column chunks a row) into sVt[column][key] (row pitch LV), zero
// past N. A warp takes two neighbouring chunks of 16 keys, so its loads are
// whole 32-byte sectors and its transposed stores meet at most two to a bank;
// a warp of one key's chunks would meet up to 32 to a bank (chunks are 8 V^T
// rows, a multiple of 32 words, apart).
template <typename T, int BN, int NTHREADS>
__device__ __forceinline__ void stage_vt(T* sVt, int LV, const T* v, long long svn, int n0, int N, int ntiles,
                                         int tid) {
  const int npair = (ntiles + 1) / 2;
  for (int i = tid; i < BN * 2 * npair; i += NTHREADS) {
    const int li = i % 32, blk = i / 32;
    const int r = blk % (BN / 16) * 16 + li % 16;
    const int c = blk / (BN / 16) * 2 + li / 16;
    if (c >= ntiles) continue;
    const int c8 = 8 * c;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (n0 + r < N) x = *reinterpret_cast<const uint4*>(v + (n0 + r) * svn + c8);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int u = 0; u < 8; ++u) sVt[(c8 + u) * LV + r] = e[u];
  }
}

constexpr int kMmaBM = 64;  // 4 warps x 16 query rows
constexpr int kMmaBN = 64;  // keys per staged tile

template <int KD>
constexpr size_t mma_smem_bytes() {
  // Q and K rows of KD + 8 halfs, V^T rows of BN + 8 halfs: the 8-half pad
  // shifts consecutive rows by 4 banks, so fragment loads are conflict-free
  return 2 * ((kMmaBM + kMmaBN) * (KD + 8) + KD * (kMmaBN + 8));
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B (16x8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// Two neighbouring C tiles of the scores are exactly one A fragment of P.
template <typename T, int KD, bool MASK>
__global__ void __launch_bounds__(kThreads) fa_mma_kernel(const Params p) {
  constexpr int BM = kMmaBM, BN = kMmaBN;
  constexpr int LQ = KD + 8;  // shared row pitch (halfs) of Q and K
  constexpr int LV = BN + 8;  // shared row pitch of V^T
  constexpr int NT = KD / 8;  // most output column tiles

  extern __shared__ uint4 smem_h[];
  T* sQ = reinterpret_cast<T*>(smem_h);  // BM x LQ
  T* sK = sQ + BM * LQ;                  // BN x LQ
  T* sVt = sK + BN * LQ;                 // KD x LV, V transposed: [column][key]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  const int dq = (p.D + 15) / 16 * 16;  // head dim padded to the mma depth
  const int q8 = dq / 8;                // 16-byte chunks per staged Q/K row
  const int ntiles = p.Dv / 8;          // output column tiles in use
  const float c = p.scale_log2;
  // with a mask the scores are moved to the log2 domain before the softmax;
  // without one the scale is folded into the exp2 argument
  const float cs = MASK ? 1.f : c;

  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
  T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
  const long long mbase = b * p.smb + h * p.smh;

  for (int i = tid; i < BM * q8; i += kThreads) {
    const int r = i / q8, c8 = i % q8 * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (m0 + r < p.M && c8 < p.D) x = *reinterpret_cast<const uint4*>(q + (m0 + r) * p.sqm + c8);
    *reinterpret_cast<uint4*>(sQ + r * LQ + c8) = x;
  }

  int n_end = p.N;
  if (p.causal) n_end = min(p.N, m0 + BM + offset);

  const int row0 = m0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // Q is staged; the previous tile's K and V^T are consumed
    if (p.skd == 1) {
      for (int i = tid; i < BN * q8; i += kThreads) {
        const int r = i / q8, c8 = i % q8 * 8;
        const int n = n0 + r;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (n < p.N && c8 < p.D) x = *reinterpret_cast<const uint4*>(k + n * p.skn + c8);
        *reinterpret_cast<uint4*>(sK + r * LQ + c8) = x;
      }
    } else {
      // K given transposed: element loads, neighbouring threads on neighbouring keys
      for (int i = tid; i < BN * dq; i += kThreads) {
        const int r = i % BN, cc = i / BN;
        const int n = n0 + r;
        T x = from_f32<T>(0.f);
        if (n < p.N && cc < p.D) x = k[n * p.skn + cc * p.skd];
        sK[r * LQ + cc] = x;
      }
    }
    stage_vt<T, BN, kThreads>(sVt, LV, v, p.svn, n0, p.N, ntiles, tid);
    __syncthreads();

    // raw scores q . k of this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kc = 0; kc < dq / 16; ++kc) {
      const T* qa = sQ + (warp * 16 + g) * LQ + kc * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LQ), ld32(qa + 8), ld32(qa + 8 * LQ + 8)};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const T* kb = sK + (j * 8 + g) * LQ + kc * 16 + 2 * t;
        mma16816(s[j], a, ld32(kb), ld32(kb + 8), T());
      }
    }

    if constexpr (MASK) {
      // log2-domain scores: scale*log2e * s + log2e * mask; -inf where masked
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e / 2) * 8;
          const int col = n0 + j * 8 + 2 * t + (e % 2);
          const bool ok = col < p.N && (!p.causal || col <= row + offset);
          float mv = 0.f;
          if (ok && row < p.M) mv = load_mask(p, mbase + row * p.smm + col * p.smn);
          s[j][e] = ok ? fmaf(s[j][e], c, kLog2e * mv) : -INFINITY;
        }
    } else if (p.causal || n0 + BN > p.N) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e / 2) * 8;
          const int col = n0 + j * 8 + 2 * t + (e % 2);
          if (col >= p.N || (p.causal && col > row + offset)) s[j][e] = -INFINITY;
        }
    }

    // online softmax on rows row0 (elements 0, 1) and row0 + 8 (elements 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      // a row with no valid key so far keeps p = 0, corr = 0 and l = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f((m_r[r] - m_use) * cs);
      const float mc = m_use * cs;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], cs, -mc));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], cs, -mc));
        rs += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + rs;
      m_r[r] = m_new;
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        acc[jt][2 * r] *= corr;
        acc[jt][2 * r + 1] *= corr;
      }
    }

    // acc += P V, P rounded to V's dtype straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1], T()),
                             pack2(s[2 * kk][2], s[2 * kk][3], T()),
                             pack2(s[2 * kk + 1][0], s[2 * kk + 1][1], T()),
                             pack2(s[2 * kk + 1][2], s[2 * kk + 1][3], T())};
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        if (jt < ntiles) {
          const T* vb = sVt + (jt * 8 + g) * LV + kk * 16 + 2 * t;
          mma16816(acc[jt], a, ld32(vb), ld32(vb + 8), T());
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = row0 + 8 * r;
    if (row >= p.M) continue;
#pragma unroll
    for (int jt = 0; jt < NT; ++jt) {
      if (jt < ntiles) {
        *reinterpret_cast<uint32_t*>(o + row * p.som + jt * 8 + 2 * t) =
            pack2(acc[jt][2 * r] / denom, acc[jt][2 * r + 1] / denom, T());
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core variant for wide heads (bf16 / fp16, head dims 257..512: the SD
// VAE's mid-block attention, 1 head of 512)
// ---------------------------------------------------------------------------
//
// A 64 x 512 float32 output tile would need 256 accumulator registers per
// thread in fa_mma_kernel's layout, where a warp owns its rows' whole D. Here
// the block takes 32 query rows and its 8 warps split D instead: each warp owns
// a 64-column slice of O for all 32 rows (64 registers). The scores of a key
// tile (32 x 64) are computed by the 8 warps as 16 x 16 tiles over the full
// head dim and meet in shared memory, where 8 threads per row run the online
// softmax and write P in V's dtype (the A operand of every warp's PV product)
// and the row's rescale factor. Q, K, V^T, S and P live in about 183 KB of
// shared memory.

constexpr int kWideBM = 32;
constexpr int kWideBN = 64;
constexpr int kWideThreads = 256;

template <int KD>
constexpr size_t wide_smem_bytes() {
  return 2 * ((kWideBM + kWideBN) * (KD + 8) + KD * (kWideBN + 8) + kWideBM * (kWideBN + 8)) +
         4 * (kWideBM * (kWideBN + 4) + 3 * kWideBM);
}

template <typename T, int KD>
__global__ void __launch_bounds__(kWideThreads) fa_mma_wide_kernel(const Params p) {
  constexpr int BM = kWideBM, BN = kWideBN;
  constexpr int LQ = KD + 8;  // shared row pitch (halfs) of Q and K
  constexpr int LV = BN + 8;  // shared row pitch of V^T and P
  constexpr int LS = BN + 4;  // shared row pitch (floats) of S
  constexpr int CW = KD / 8;  // output columns per warp
  constexpr int NT = CW / 8;  // output column tiles per warp

  extern __shared__ uint4 smem_w[];
  T* sQ = reinterpret_cast<T*>(smem_w);  // BM x LQ
  T* sK = sQ + BM * LQ;                  // BN x LQ
  T* sVt = sK + BN * LQ;                 // KD x LV, V transposed: [column][key]
  T* sP = sVt + KD * LV;                 // BM x LV, probabilities in V's dtype
  float* sS = reinterpret_cast<float*>(sP + BM * LV);  // BM x LS, log2-domain scores
  float* s_m = sS + BM * LS;             // running row max
  float* s_l = s_m + BM;                 // running row sum
  float* s_c = s_l + BM;                 // this tile's rescale factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  const int dq = (p.D + 15) / 16 * 16;
  const int q8 = dq / 8;
  const int ntiles = p.Dv / 8;
  const float c = p.scale_log2;

  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
  T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  for (int i = tid; i < BM * q8; i += kWideThreads) {
    const int r = i / q8, c8 = i % q8 * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (m0 + r < p.M && c8 < p.D) x = *reinterpret_cast<const uint4*>(q + (m0 + r) * p.sqm + c8);
    *reinterpret_cast<uint4*>(sQ + r * LQ + c8) = x;
  }
  if (tid < BM) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  int n_end = p.N;
  if (p.causal) n_end = min(p.N, m0 + BM + offset);

  // scores: warp (rt, ct) owns rows 16 rt.. and keys 16 ct..; output: warp w
  // owns columns CW w .. CW w + CW - 1 of all BM rows
  const int rt = warp / 4, ct = warp % 4;
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
    __syncthreads();  // Q is staged; the previous tile's K, V^T and P are consumed
    if (p.skd == 1) {
      for (int i = tid; i < BN * q8; i += kWideThreads) {
        const int r = i / q8, c8 = i % q8 * 8;
        const int n = n0 + r;
        uint4 x = make_uint4(0, 0, 0, 0);
        if (n < p.N && c8 < p.D) x = *reinterpret_cast<const uint4*>(k + n * p.skn + c8);
        *reinterpret_cast<uint4*>(sK + r * LQ + c8) = x;
      }
    } else {
      for (int i = tid; i < BN * dq; i += kWideThreads) {
        const int r = i % BN, cc = i / BN;
        const int n = n0 + r;
        T x = from_f32<T>(0.f);
        if (n < p.N && cc < p.D) x = k[n * p.skn + cc * p.skd];
        sK[r * LQ + cc] = x;
      }
    }
    stage_vt<T, BN, kWideThreads>(sVt, LV, v, p.svn, n0, p.N, ntiles, tid);
    __syncthreads();

    // raw scores of this warp's 16 rows x 16 keys over the whole head dim
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kc = 0; kc < dq / 16; ++kc) {
      const T* qa = sQ + (rt * 16 + g) * LQ + kc * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LQ), ld32(qa + 8), ld32(qa + 8 * LQ + 8)};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const T* kb = sK + (ct * 16 + j * 8 + g) * LQ + kc * 16 + 2 * t;
        mma16816(s[j], a, ld32(kb), ld32(kb + 8), T());
      }
    }
    // to the log2 domain, -inf past the keys and the causal diagonal
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rt * 16 + g + (e / 2) * 8;
        const int cl = ct * 16 + j * 8 + 2 * t + (e % 2);
        const int row = m0 + r, col = n0 + cl;
        const bool ok = col < p.N && (!p.causal || col <= row + offset);
        sS[r * LS + cl] = ok ? s[j][e] * c : -INFINITY;
      }
    __syncthreads();

    // online softmax: 8 neighbouring threads per row, 8 keys each
    {
      const int r = tid / 8, part = tid % 8;
      float x[BN / 8];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        x[j] = sS[r * LS + part + 8 * j];
        mx = fmaxf(mx, x[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with no valid key so far keeps p = 0, corr = 0 and l = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float pj = exp2f(x[j] - m_use);
        rs += pj;
        sP[r * LV + part + 8 * j] = from_f32<T>(pj);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      __syncwarp();
      if (part == 0) {
        const float corr = exp2f(m_old - m_use);
        s_c[r] = corr;
        s_l[r] = s_l[r] * corr + rs;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V over this warp's column slice
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float c0 = s_c[i * 16 + g], c1 = s_c[i * 16 + g + 8];
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        acc[i][jt][0] *= c0;
        acc[i][jt][1] *= c0;
        acc[i][jt][2] *= c1;
        acc[i][jt][3] *= c1;
      }
    }
    const int nk = min(BN, n_end - n0);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if (kk * 16 >= nk) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* pa = sP + (i * 16 + g) * LV + kk * 16 + 2 * t;
        const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * LV), ld32(pa + 8), ld32(pa + 8 * LV + 8)};
#pragma unroll
        for (int jt = 0; jt < NT; ++jt) {
          const int col = warp * CW + jt * 8;
          if (col < p.Dv) {
            const T* vb = sVt + (col + g) * LV + kk * 16 + 2 * t;
            mma16816(acc[i][jt], a, ld32(vb), ld32(vb + 8), T());
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * 16 + g + 8 * hh;
      const int row = m0 + r;
      if (row >= p.M) continue;
      const float l = s_l[r];
      const float denom = l == 0.f ? 1.f : l;
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        const int col = warp * CW + jt * 8 + 2 * t;
        if (col < p.Dv)
          *reinterpret_cast<uint32_t*>(o + row * p.som + col) =
              pack2(acc[i][jt][2 * hh] / denom, acc[i][jt][2 * hh + 1] / denom, T());
      }
    }
}

// ---------------------------------------------------------------------------
// wgmma variant (bf16 / fp16, head dims <= 128, the head-major entry only)
// ---------------------------------------------------------------------------
//
// A block takes 128 query rows of one (batch, head): two consumer warpgroups
// of 64 rows and a loading warpgroup. The loaders put Q into shared memory
// once and keep a ring of two stages full with cp.async copies: the key tile
// K (BN keys x KD, K-major), the value tile V (the same rows, read MN-major by
// wgmma's transpose bit: V is never transposed) and, where the mask's rows are
// whole 16-byte pieces, the mask tile (128 rows x BN keys in the mask's own
// dtype); the hardware arrives on the stage's mbarrier when they land. Per key
// tile a consumer warpgroup runs S = Q K^T as wgmma m64nBNk16 from shared
// memory, the online softmax on S in float32 registers (scores in the log2
// domain, mask * log2(e) added in float32), then O += P V as wgmma m64nKDk16
// with P, rounded to V's dtype, as the register A operand: the accumulator
// layout of S is the register layout of A. The stage goes back to the
// loaders when the next tile's S product has retired, so the next tile's
// copies and the PV product overlap the softmax. Head dims below KD are zero
// in the tiles. A mask whose rows are not 16-byte granular is not taken here:
// fa_mma_kernel reads such a mask element by element.

__device__ __forceinline__ float2 mask_pair(const uint8_t* at, int dtype) {
  if (dtype == 0) return *reinterpret_cast<const float2*>(at);
  if (dtype == 1) return __half22float2(*reinterpret_cast<const __half2*>(at));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}

template <int KD>
struct FaWgCfg {
  static constexpr int kBM = 128;                  // query rows: two consumer warpgroups
  static constexpr int kBN = KD == 64 ? 128 : 64;  // keys per staged tile
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBM * KD * 2;
  static constexpr int kKBytes = kBN * KD * 2;     // the K tile; the V tile the same
  static constexpr int kThreads = 3 * gemm90::kWG;
  // the mask tile: kBM rows of kBN keys, 16 bytes of padding a row (the
  // consumers' pair loads of 8 rows then meet no bank twice), rounded up to
  // 1024 bytes
  static constexpr int mask_bytes(int elt) { return elt ? (kBM * (kBN * elt + 16) + 1023) / 1024 * 1024 : 0; }
  static constexpr int stage_bytes(int elt) { return 2 * kKBytes + mask_bytes(elt); }
  // Q, the ring, the barriers, slack to reach a 1024-byte boundary
  static constexpr int smem_bytes(int elt) { return 1024 + kQBytes + kStages * stage_bytes(elt) + 8 * (2 * kStages + 1); }
};
static_assert(FaWgCfg<64>::smem_bytes(4) <= 232448 && FaWgCfg<128>::smem_bytes(4) <= 232448,
              "shared memory of a block");

template <typename T, int KD, bool MASK>
__global__ void __launch_bounds__(FaWgCfg<KD>::kThreads, 1)
    fa_wgmma_kernel(const Params p, int stage_bytes, int mask_pitch) {
  using C = FaWgCfg<KD>;
  constexpr int BM = C::kBM, BN = C::kBN, kWG = gemm90::kWG;
  extern __shared__ __align__(16) uint8_t fa_smem[];
  const uint32_t smem_base = gemm90::smem_u32(fa_smem);
  const uint32_t q_s = gemm90::align1024(smem_base);
  const uint32_t stage0 = q_s + C::kQBytes;
  const uint32_t full0 = stage0 + C::kStages * stage_bytes, empty0 = full0 + 8 * C::kStages;
  const uint32_t q_full = empty0 + 8 * C::kStages;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  // keys past the tile's last row + offset are masked for every row: skipped
  const int n_end = p.causal ? max(0, min(p.N, m0 + BM + offset)) : p.N;
  const int ntiles = (n_end + BN - 1) / BN;
  const int elt = p.mask_dtype == 0 ? 4 : 2;
  const long long mbase = b * p.smb + h * p.smh;
  if (tid == 0) {
    gemm90::init_barriers<C::kStages>(full0, empty0, kWG, 2 * kWG);
    gemm90::mbar_init(q_full, kWG);
    gemm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // loaders
    const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
    const uint8_t* mask = MASK ? static_cast<const uint8_t*>(p.mask) + mbase * elt : nullptr;
#pragma unroll
    for (int kc = 0; kc < KD / 64; ++kc)
      gemm90::load_kmajor_tile<BM>(q_s + kc * BM * 128, q, 2 * p.sqm, m0, p.M, 128 * kc, 2 * p.D, t);
    gemm90::cp_async_arrive(q_full);
    gemm90::produce<C::kStages>(ntiles, full0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * stage_bytes;
      const int n0 = it * BN;
#pragma unroll
      for (int kc = 0; kc < KD / 64; ++kc) {
        gemm90::load_kmajor_tile<BN>(sb + kc * BN * 128, k, 2 * p.skn, n0, p.N, 128 * kc, 2 * p.D, t);
        gemm90::load_kmajor_tile<BN>(sb + C::kKBytes + kc * BN * 128, v, 2 * p.svn, n0, p.N, 128 * kc, 2 * p.Dv, t);
      }
      if constexpr (MASK) {
        const int per_row = BN * elt / 16;  // 16-byte pieces of a mask row
        const uint32_t mt = sb + 2 * C::kKBytes;
        for (int i = t; i < BM * per_row; i += kWG) {
          const int r = i / per_row, c = i % per_row;
          const int row = m0 + r, col = n0 + c * (16 / elt);
          const bool ok = row < p.M && col < p.N;
          const uint8_t* src = ok ? mask + (row * p.smm + col) * elt : mask;
          gemm90::cp_async16(mt + r * mask_pitch + 16 * c, src, ok);
        }
      }
    });
    return;
  }

  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int lrow = 64 * wg + 16 * warp + g;  // this thread's rows of the block's tile: lrow and lrow + 8
  const int row0 = m0 + lrow;
  const float c = p.scale_log2;
  // with a mask the scores are moved to the log2 domain before the softmax;
  // without one the scale is folded into the exp2 argument
  const float cs = MASK ? 1.f : c;

  float o[KD / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < KD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
  uint32_t pa[BN / 16][4];  // P in V's dtype, the register A operand of the PV product

  if (ntiles > 0) gemm90::mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % C::kStages;
    const uint32_t sb = stage0 + st * stage_bytes;
    gemm90::mbar_wait(full0 + 8 * st, (it / C::kStages) & 1);

    // raw scores q . k of this warpgroup's 64 rows x BN keys (the register
    // fences keep the softmax's writes of S, and below the rescale of O and
    // the packing of P, ahead of wgmma.fence)
    gemm90::fence_regs(s);
    gemm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KD / 16; ++ks) {
      const uint32_t qt = q_s + (ks / 4) * BM * 128 + wg * 64 * 128;
      const uint32_t kt = sb + (ks / 4) * BN * 128;
      gemm90::wgmma_ss<T, BN, 0>(s, gemm90::a_desc(qt, ks % 4), gemm90::kmajor_desc(kt, ks % 4), ks > 0);
    }
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<0>();  // S, and the previous tile's PV product, are done
    gemm90::fence_regs(s);
    gemm90::fence_regs(o);
    if (it > 0) gemm90::mbar_arrive(empty0 + 8 * ((it - 1) % C::kStages));

    const int n0 = it * BN;
    const uint8_t* mt = fa_smem + (sb + 2 * C::kKBytes - smem_base);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + 8 * hh, cl = 8 * j + 2 * tq;
        float2 mv = make_float2(0.f, 0.f);
        if constexpr (MASK) mv = mask_pair(mt + (lrow + 8 * hh) * mask_pitch + cl * elt, p.mask_dtype);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + cl + e;
          const bool ok = col < p.N && (!p.causal || col <= row + offset);
          float& x = s[4 * j + 2 * hh + e];
          if constexpr (MASK) {
            const float m = e ? mv.y : mv.x;
            // log2-domain scores: scale*log2e * s + log2e * mask; -inf where masked
            x = ok ? fmaf(x, c, kLog2e * m) : -INFINITY;
          } else if (!ok) {
            x = -INFINITY;
          }
        }
      }

    // online softmax on rows row0 (elements 0, 1 of each n8 block) and row0 + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      // a row with no valid key so far keeps p = 0, corr = 0 and l = 0
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = exp2f((m_r[r] - m_use) * cs);
      const float mc = m_use * cs;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j + 2 * r] = exp2f(fmaf(s[4 * j + 2 * r], cs, -mc));
        s[4 * j + 2 * r + 1] = exp2f(fmaf(s[4 * j + 2 * r + 1], cs, -mc));
        rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + rs;
      m_r[r] = m_new;
#pragma unroll
      for (int jt = 0; jt < KD / 8; ++jt) {
        o[4 * jt + 2 * r] *= corr;
        o[4 * jt + 2 * r + 1] *= corr;
      }
    }

    // O += P V: P rounded to V's dtype straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack2(s[8 * kk + 0], s[8 * kk + 1], T());
      pa[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3], T());
      pa[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5], T());
      pa[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7], T());
    }
    gemm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) gemm90::fence_regs(pa[kk]);
    gemm90::wgmma_fence();
    const uint32_t vt = sb + C::kKBytes;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) gemm90::wgmma_rs<T, KD>(o, pa[kk], gemm90::BTile<128, BN>::desc(vt, kk));
    gemm90::wgmma_commit();
  }
  gemm90::wgmma_wait<0>();
  gemm90::fence_regs(o);

  T* out = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = row0 + 8 * r;
    if (row >= p.M) continue;
#pragma unroll
    for (int jt = 0; jt < KD / 8; ++jt) {
      const int col = 8 * jt + 2 * tq;
      if (col < p.Dv)
        *reinterpret_cast<uint32_t*>(out + row * p.som + col) = pack2(o[4 * jt + 2 * r] / denom, o[4 * jt + 2 * r + 1] / denom, T());
    }
  }
}

template <typename T, int KD, bool MASK>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using C = FaWgCfg<KD>;
  auto kernel = fa_wgmma_kernel<T, KD, MASK>;
  static cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::smem_bytes(MASK ? 4 : 0));
  if (attr != cudaSuccess) return attr;
  const int elt = MASK ? (p.mask_dtype == 0 ? 4 : 2) : 0;
  const dim3 grid((p.M + C::kBM - 1) / C::kBM, p.H, p.B);
  kernel<<<grid, C::kThreads, C::smem_bytes(elt), stream>>>(p, C::stage_bytes(elt), C::kBN * elt + 16);
  return cudaGetLastError();
}

template <typename T, int KD>
cudaError_t launch_mma_wide(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = wide_smem_bytes<KD>();
  auto kernel = fa_mma_wide_kernel<T, KD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kWideBM - 1) / kWideBM, p.H, p.B);
  kernel<<<grid, kWideThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int KD, bool MASK>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<KD>();
  auto kernel = fa_mma_kernel<T, KD, MASK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + kMmaBM - 1) / kMmaBM, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte vector loads and 4-byte stores of whole head rows need every row
// start aligned: base pointers to 16 bytes and strides to 8 elements. K only
// when it is read by rows (unit column stride).
bool rows_aligned16(const Params& p) {
  unsigned long long ptrs = reinterpret_cast<unsigned long long>(p.q) |
                            reinterpret_cast<unsigned long long>(p.v) |
                            reinterpret_cast<unsigned long long>(p.o);
  long long strides = p.sqb | p.sqh | p.sqm | p.svb | p.svh | p.svn | p.sob | p.soh | p.som;
  if (p.skd == 1) {
    ptrs |= reinterpret_cast<unsigned long long>(p.k);
    strides |= p.skb | p.skh | p.skn;
  }
  return ptrs % 16 == 0 && strides % 8 == 0;
}

template <typename T, int KD, int BM, int BN, bool MASK>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KD, BM, BN>();
  auto kernel = fa_fma_kernel<T, KD, BM, BN, MASK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + BM - 1) / BM, p.H, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16 / fp16 take the tensor cores where the rows are aligned and the head
// dims fit the 128-wide tiles, or the wide variant for head dims above 256.
// Otherwise the FMA kernel, with tile shapes by padded head dim: its float32
// accumulator (RM x KD/8 per thread) stays at or under 64 registers, and
// shared memory at or under 103 KB. Head dims above 256 only without a mask:
// the SD VAE's 1 x 512 head is the one such site, and it has none.
template <typename T, bool MASK>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int kd = p.D > p.Dv ? p.D : p.Dv;
  if constexpr (!std::is_same<T, float>::value) {
    if (rows_aligned16(p)) {
      if (kd <= 64) return launch_mma<T, 64, MASK>(p, stream);
      if (kd <= 128) return launch_mma<T, 128, MASK>(p, stream);
      if constexpr (!MASK) {
        if (kd > 256 && kd <= 512) return launch_mma_wide<T, 512>(p, stream);
      }
    }
  }
  if (kd <= 32) return launch_fma<T, 32, 64, 64, MASK>(p, stream);
  if (kd <= 64) return launch_fma<T, 64, 64, 64, MASK>(p, stream);
  if (kd <= 128) return launch_fma<T, 128, 64, 32, MASK>(p, stream);
  if (kd <= 256) return launch_fma<T, 256, 32, 32, MASK>(p, stream);
  if constexpr (!MASK) {
    if (kd <= 512) return launch_fma<T, 512, 16, 16, false>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_mask(const Params& p, cudaStream_t stream) {
  return p.mask ? dispatch<T, true>(p, stream) : dispatch<T, false>(p, stream);
}

// the wgmma variant: 16-bit head-major operands whose rows are whole 16-byte
// pieces, K read by rows, head dims up to 128, and no mask or one whose rows
// are 16-byte granular (staged by 16-byte copies). Mirrored by flash_variant
// in kernels/flash_attention.py.
bool mask_staged(const Params& p) {
  const long long elt = p.mask_dtype == 0 ? 4 : 2;
  return p.smn == 1 && reinterpret_cast<unsigned long long>(p.mask) % 16 == 0 && (p.smb * elt) % 16 == 0 &&
         (p.smh * elt) % 16 == 0 && (p.smm * elt) % 16 == 0 && (p.N * elt) % 16 == 0;
}
bool use_wgmma(const Params& p) {
  return p.skd == 1 && rows_aligned16(p) && p.D <= 128 && p.Dv <= 128 && (p.mask == nullptr || mask_staged(p));
}

template <typename T, int KD>
cudaError_t launch_wgmma_mask(const Params& p, cudaStream_t stream) {
  return p.mask ? launch_wgmma<T, KD, true>(p, stream) : launch_wgmma<T, KD, false>(p, stream);
}

// the head-major entry: the wgmma variant where it takes the operands, else
// the variants the packed entry has
template <typename T>
cudaError_t dispatch_head_major(const Params& p, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (use_wgmma(p))
      return p.D <= 64 && p.Dv <= 64 ? launch_wgmma_mask<T, 64>(p, stream) : launch_wgmma_mask<T, 128>(p, stream);
  }
  return dispatch_mask<T>(p, stream);
}

}  // namespace

// form: 0 = the packed entry (flash_attention_packed), 1 = the head-major
// entry (flash_attention), which alone may take the wgmma variant. dtype: 0 =
// float32, 1 = float16, 2 = bfloat16 (q, k, v and o share it); mask_dtype
// likewise, read only when mask is not null. strides holds 17 element
// strides: q (batch, head, row), k (batch, head, key, column), v (batch,
// head, row), o (batch, head, row), mask (batch, head, row, column). Returns
// a cudaError_t: 0 when the launch was accepted.
extern "C" int ostt_flash_attention(int form, int dtype, const void* q, const void* k, const void* v,
                                    void* o, const void* mask, int mask_dtype, int B, int M,
                                    int N, int H, int Hkv, int D, int Dv,
                                    const long long* strides, float scale_log2, int causal,
                                    void* stream) {
  if (form < 0 || form > 1 || B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D % 8 || Dv % 8 ||
      D <= 0 || Dv <= 0 || mask_dtype < 0 || mask_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Params p{q,     k,     v,     o,     mask,  B,     M,     N,     H,         Hkv,
                 D,     Dv,    s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],      s[7],
                 s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15], s[16],     mask_dtype,
                 scale_log2, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_mask<float>(p, st));
    case 1: return static_cast<int>(form ? dispatch_head_major<__half>(p, st) : dispatch_mask<__half>(p, st));
    case 2: return static_cast<int>(form ? dispatch_head_major<__nv_bfloat16>(p, st) : dispatch_mask<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
