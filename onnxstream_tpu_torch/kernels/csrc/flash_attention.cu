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
// Three variants, chosen by dtype, head dim and alignment in dispatch():
//
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
// What bounds it. The score matrix never reaches device memory, which is what
// the kernel saves over the plain version. The mma variant is bound by
// mma.sync issue and the unpipelined K/V staging (no cp.async / TMA double
// buffering yet); the FMA variant by FMA issue and shared-memory loads (about
// 2.7 FMAs per shared load). The wide variant runs one 183 KB CTA per SM, and
// at the VAE's 4096 tokens only 128 of them, each walking all keys with four
// barriers per tile: it is latency-bound (splitting the keys over CTAs is the
// next step). The mask costs one scalar load per score (L2 serves the re-reads
// across heads). wgmma, TMA and tile tuning are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
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

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (q, k, v and o share it);
// mask_dtype likewise, read only when mask is not null. strides holds 17
// element strides: q (batch, head, row), k (batch, head, key, column),
// v (batch, head, row), o (batch, head, row), mask (batch, head, row, column).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ostt_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const void* mask, int mask_dtype, int B, int M,
                                    int N, int H, int Hkv, int D, int Dv,
                                    const long long* strides, float scale_log2, int causal,
                                    void* stream) {
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D % 8 || Dv % 8 || D <= 0 || Dv <= 0 ||
      mask_dtype < 0 || mask_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Params p{q,     k,     v,     o,     mask,  B,     M,     N,     H,         Hkv,
                 D,     Dv,    s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],      s[7],
                 s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15], s[16],     mask_dtype,
                 scale_log2, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_mask<float>(p, st));
    case 1: return static_cast<int>(dispatch_mask<__half>(p, st));
    case 2: return static_cast<int>(dispatch_mask<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
