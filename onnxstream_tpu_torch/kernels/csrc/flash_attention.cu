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
// shared memory and the running max, sum and output accumulator in registers
// (the wide wgmma variant also splits the keys over CTAs). Both entries share
// one dispatcher: the variant follows from dtype, head dims, mask and
// alignment in dispatch_all(), never from the entry or from the strides'
// meaning. Five variants:
//
//  * fa_wgmma_kernel (bf16 / fp16, head dims <= 128, 16-byte aligned Q/K/V/O
//    rows, K read by rows, no mask or one whose rows are 16-byte granular):
//    the shape of Hopper's fast attention kernels, described at the kernel.
//    Kernel 1 takes it at the SD1.5 UNet sites (8 heads of 40 and of 80,
//    packed, no mask) with tile widths of their own, the two consumer
//    warpgroups taking turns on the tensor cores so that one's softmax runs
//    beside the other's products; kernel 2 at the TinyLlama prefill (32
//    heads x 1024 x 64, a (1, 1, 1024, 1024) mask tile staged by 16-byte
//    copies), where the softmax between the two products and the mask step
//    hold it at about 8x its tensor bound;
//  * fa_tf32_kernel (float32 with the operands fa_wgmma_kernel takes: head
//    dims <= 128, 16-byte aligned rows, K read by rows, no mask or a staged
//    one): fa_wgmma_kernel's pipeline with each product as three TF32 wgmma
//    products of split operands (hi hi + hi lo + lo hi), the counterpart of
//    the TPU kernel's Precision.HIGHEST; the float32 Whisper, SD1.5 and
//    TinyLlama sites. TF32 wgmma reads K-major operands only, so a pre-pass
//    writes Q, K and V^T split into a workspace; described at the kernel;
//  * fa_wgmma_wide_kernel (bf16 / fp16, head dims 257..512, aligned rows, no
//    mask): kernel 1 at the SD VAE's mid-block site (1 head of 512 x 4096
//    tokens), O split by columns over two warpgroups, the keys over CTAs and
//    a fixed-order combine;
//  * fa_mma_kernel (bf16 / fp16, head dims <= 128, 16-byte aligned Q/V/O
//    rows): tensor-core products with mma.sync m16n8k16, f32 accumulate. Each
//    warp owns 16 query rows; the score tile stays in registers and is reused
//    as the A operand of the PV product (the FlashAttention-2 layout), so P
//    never touches shared memory. The softmax scale is applied in float32
//    (one FMA per score) instead of rounding a scaled Q to bf16. Taken for K
//    given transposed or a mask whose rows are not 16-byte granular;
//  * fa_fma_kernel (any dtype, any head dim up to 512, up to 256 with a mask,
//    any alignment, where no variant above takes the operands: float32 with
//    misaligned rows, K given transposed, head dims 129..512 or a mask that
//    is not staged; bf16 / fp16 with misaligned rows or K given transposed
//    at head dims 257..512): CUDA-core FMAs on float32 tiles; each thread
//    owns an RM x (BN/8) score tile and an RM x (KD/8) accumulator, the 8
//    threads sharing rows reduce with shuffles; full float32 products.
// The C entry's `wgmma` argument set to 0 keeps the wgmma variants out, so
// that a caller can time the variants they replaced on the same operands.
//
// What bounds them. The score matrix never reaches device memory, which is
// what every variant saves over the plain version. At head dim 40 a score
// costs 160 tensor operations and one exp2: the special-function units (16
// exp2 a clock per SM) take longer than the tensor cores, so the SD1.5 UNet
// sites are bound by the softmax's exponentials, which the wgmma variant
// overlaps with the products. The mma variant is bound by the rate of
// mma.sync and its unpipelined K / V^T staging (two barriers a tile, V
// transposed element by element); its mask costs one scalar load per score.
// The FMA variant is bound by the FMA rate and shared-memory loads (about 2.7
// FMAs per shared load), at about 7 % of the FMA peak. The tf32x3 variant
// does three tensor-core products for each one (495 / 3 TFLOP/s, 2.5x the 67
// TFLOP/s of FMAs) and splits P into two TF32 parts on the CUDA cores; its
// pre-pass moves three times each operand's bytes.

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

// two floats to neighbouring elements of a row (8- or 4-byte aligned)
__device__ __forceinline__ void store_pair(float* at, float x, float y) {
  *reinterpret_cast<float2*>(at) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__half* at, float x, float y) {
  *reinterpret_cast<uint32_t*>(at) = pack2(x, y, __half());
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* at, float x, float y) {
  *reinterpret_cast<uint32_t*>(at) = pack2(x, y, __nv_bfloat16());
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
// wgmma variants (bf16 / fp16: head dims <= 128 with or without a mask, head
// dims 257..512 without one)
// ---------------------------------------------------------------------------
//
// fa_wgmma_kernel: a block takes 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows and a loading warpgroup. The loaders put Q
// into shared memory once and keep a ring of stages full with cp.async
// copies: the key tile K (BN keys x KD, K-major), the value tile V (the same
// rows, read MN-major by wgmma's transpose bit: V is never transposed) and,
// where the mask's rows are whole 16-byte pieces, the mask tile (128 rows x
// BN keys in the mask's own dtype); the hardware arrives on the stage's
// mbarrier when they land. Per key tile a consumer warpgroup runs S = Q K^T as
// wgmma m64nBNk16 from shared memory over DQ (the head dim rounded up to 16:
// 48 for d = 40, 80 for d = 80), the online softmax on S in float32 registers
// (scores in the log2 domain, mask * log2(e) added in float32), then O += P V
// as wgmma m64nDVk16 (DV = the head dim: 40 and 80 are wgmma widths) with P,
// rounded to V's dtype, as the register A operand: the accumulator layout of
// S is the register layout of A. The tiles keep 128-byte rows under the
// 128-byte swizzle; the products read only the columns of the real head dim
// (the loads zero-fill a row past it without reading memory).
//
// The softmax costs one exp2 per score on the special-function units (16 a
// clock per SM): at d = 40 that takes longer than both products on the
// tensor cores, so the unmasked forms overlap the two. The consumer
// warpgroups take turns on the tensor cores through named barriers: in its
// turn a warpgroup issues the S product of tile j + 1 and the PV product of
// tile j (P of tile j already packed), waits for both, and runs tile j + 1's
// softmax while the other warpgroup's products run. Reading S while this
// warpgroup's own PV product was still in flight (wgmma.wait_group 1) made
// ptxas serialize every wgmma of the kernel (note C7514), which cost more
// than that overlap gave. The ring has three stages,
// so that tile j + 1's K lands while tile j's V is still read; where the
// query tiles leave SMs idle (the d = 80 site: 64 blocks) the keys are split
// over blocks as in the wide form below. The masked forms (kernel 2's
// prefill) run S, softmax and PV in turn within each warpgroup, with two
// stages (their mask tiles fill shared memory). A mask whose rows are not
// 16-byte granular is not taken here: fa_mma_kernel reads such a mask element
// by element.
//
// fa_wgmma_wide_kernel (the SD VAE's mid-block attention, 1 head of 512): a
// 64 x 512 float32 O accumulator would need 256 registers a thread, so the
// two consumer warpgroups share 64 query rows and split O by columns: each
// owns 64 rows x 256 (128 registers, setmaxnreg gives them 232 and the
// loaders 40). Each warpgroup computes the whole score tile itself rather
// than sharing S or P through shared memory: the duplicate S product costs
// half again the tensor work, where sharing would cost two block-wide
// barriers a tile and a 64 x 32 P round trip through shared memory. Key
// tiles are 32 keys (two stages of K and V, 64 KB each, beside 64 KB of Q).
// 4096 query rows give only 64 blocks of 64 rows, so the keys are split over
// `splits` blocks (the wrapper picks them to fill the SMs once): each writes
// its unnormalized float32 O and its row max and sum, and a second small
// kernel combines the splits in a fixed order, so a call gives the same bits
// every time.

// exp2 on the special-function unit with subnormal results flushed to 0:
// the online softmax's probabilities (exp2f wraps the same instruction in a
// subnormal fix-up)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One row of a wgmma accumulator O (r: the thread's first or second row;
// columns col0 + 8 jt + 2 tq, + 1) out: normalized in T, or as a key split's
// unnormalized float32 partial at part[split][b][h][row][:Dv], with (the row
// max in the log2 domain, the row sum) after all the partials, written by
// the threads with tq == 0 where `stats`.
template <typename T, int NO>
__device__ __forceinline__ void store_row(const Params& p, const float (&o)[NO], int r, int b, int h, int row,
                                          int col0, int tq, float l, float m_log2, int splits, int split,
                                          float* part, bool stats) {
  if (splits == 1) {
    T* out = static_cast<T*>(p.o) + b * p.sob + h * p.soh + row * p.som;
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int jt = 0; jt < NO / 4; ++jt) {
      const int col = col0 + 8 * jt + 2 * tq;
      if (col < p.Dv) store_pair(out + col, o[4 * jt + 2 * r] / denom, o[4 * jt + 2 * r + 1] / denom);
    }
    return;
  }
  const long long rows = static_cast<long long>(p.B) * p.H * p.M;
  const long long ri = (static_cast<long long>(b) * p.H + h) * p.M + row;
  float* po = part + (split * rows + ri) * p.Dv;
#pragma unroll
  for (int jt = 0; jt < NO / 4; ++jt) {
    const int col = col0 + 8 * jt + 2 * tq;
    if (col < p.Dv) *reinterpret_cast<float2*>(po + col) = make_float2(o[4 * jt + 2 * r], o[4 * jt + 2 * r + 1]);
  }
  if (stats && tq == 0) {
    float* ml = part + static_cast<long long>(splits) * rows * p.Dv + 2 * (split * rows + ri);
    ml[0] = m_log2;  // -inf: no key of this split
    ml[1] = l;
  }
}

// setmaxnreg of the unmasked wgmma forms and the wide one: the loading
// warpgroup gives registers to the two consumer warpgroups, which hold a
// score tile, P and O (up to 64 + 32 + 64 registers, 128 + 8 + 16 in the
// wide form)
constexpr int kLoaderRegs = 56, kConsumerRegs = 224;
constexpr int kMaxSplits = 256;  // key splits of one query tile (fa_combine_kernel's weights)
__device__ __forceinline__ void loader_regs() { asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n"); }
__device__ __forceinline__ void consumer_regs() { asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n"); }
static_assert(gemm90::kWG * kLoaderRegs + 2 * gemm90::kWG * kConsumerRegs <= 65536, "the register file");

__device__ __forceinline__ float2 mask_pair(const uint8_t* at, int dtype) {
  if (dtype == 0) return *reinterpret_cast<const float2*>(at);
  if (dtype == 1) return __half22float2(*reinterpret_cast<const __half2*>(at));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}

// What a consumer thread's softmax needs of its rows: row0 and row0 + 8 of
// the problem (lrow and lrow + 8 of the block's tile), its column pair 2 tq
// of each n8 block, the causal offset N - M, the staged mask's row pitch and
// element bytes, c = scale * log2(e) and cs (1 with a mask, whose scores are
// moved to the log2 domain before the softmax; c without one, whose scale is
// folded into the exp2 argument)
struct SoftmaxRows {
  int row0, lrow, tq, offset, mask_pitch, elt;
  float c, cs;
};

// The mask and the online softmax of one key tile (keys n0 ..) of the wgmma
// variants: S in s (the thread's part of a 64 x BN accumulator) becomes the
// unnormalized P (float32); m_r, l_r are its two rows' running max and
// partial sum, corr gets the rescale factor of O's two rows; mt is the
// tile's staged mask.
template <int BN, bool MASK>
__device__ __forceinline__ void tile_softmax(const Params& p, const SoftmaxRows& w, float (&s)[BN / 2], int n0,
                                             const uint8_t* mt, float (&m_r)[2], float (&l_r)[2], float (&corr)[2]) {
  // without a mask only the tiles past N or across the diagonal need it
  if (MASK || p.causal || n0 + BN > p.N)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = w.row0 + 8 * hh, cl = 8 * j + 2 * w.tq;
        float2 mv = make_float2(0.f, 0.f);
        if constexpr (MASK) mv = mask_pair(mt + (w.lrow + 8 * hh) * w.mask_pitch + cl * w.elt, p.mask_dtype);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + cl + e;
          const bool ok = col < p.N && (!p.causal || col <= row + w.offset);
          float& x = s[4 * j + 2 * hh + e];
          if constexpr (MASK) {
            const float m = e ? mv.y : mv.x;
            // log2-domain scores: scale*log2e * s + log2e * mask; -inf where masked
            x = ok ? fmaf(x, w.c, kLog2e * m) : -INFINITY;
          } else if (!ok) {
            x = -INFINITY;
          }
        }
      }
  // rows row0 (elements 0, 1 of each n8 block) and row0 + 8 (2, 3)
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
    corr[r] = fast_exp2((m_r[r] - m_use) * w.cs);
    const float mc = m_use * w.cs;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j + 2 * r] = fast_exp2(fmaf(s[4 * j + 2 * r], w.cs, -mc));
      s[4 * j + 2 * r + 1] = fast_exp2(fmaf(s[4 * j + 2 * r + 1], w.cs, -mc));
      rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l_r[r] = l_r[r] * corr[r] + rs;
    m_r[r] = m_new;
  }
}

template <int KD, bool MASK>
struct FaWgCfg {
  static constexpr int kBM = 128;  // query rows: two consumer warpgroups
  static constexpr int kBN = KD == 64 ? 128 : 64;  // keys per staged tile
  static constexpr int kStages = MASK ? 2 : 3;
  static constexpr int kQBytes = kBM * KD * 2;
  static constexpr int kKBytes = kBN * KD * 2;  // the K tile; the V tile the same
  static constexpr int kThreads = 3 * gemm90::kWG;
  // the mask tile: kBM rows of kBN keys, 16 bytes of padding a row (the
  // consumers' pair loads of 8 rows then meet no bank twice), rounded up to
  // 1024 bytes
  static constexpr int mask_bytes(int elt) { return elt ? (kBM * (kBN * elt + 16) + 1023) / 1024 * 1024 : 0; }
  static constexpr int stage_bytes(int elt) { return 2 * kKBytes + mask_bytes(elt); }
  // Q, the ring, the barriers, slack to reach a 1024-byte boundary
  static constexpr int smem_bytes(int elt) { return 1024 + kQBytes + kStages * stage_bytes(elt) + 8 * (2 * kStages + 1); }
};
static_assert(FaWgCfg<64, true>::smem_bytes(4) <= 232448 && FaWgCfg<128, true>::smem_bytes(4) <= 232448 &&
                  FaWgCfg<64, false>::smem_bytes(0) <= 232448 && FaWgCfg<128, false>::smem_bytes(0) <= 232448,
              "shared memory of a block");

template <typename T, int KD, int DQ, int DV, bool MASK>
__global__ void __launch_bounds__(FaWgCfg<KD, MASK>::kThreads, 1)
    fa_wgmma_kernel(const Params p, int stage_bytes, int mask_pitch, int splits, float* part) {
  using C = FaWgCfg<KD, MASK>;
  constexpr int BM = C::kBM, BN = C::kBN, S = C::kStages, kWG = gemm90::kWG;
  static_assert(DQ % 16 == 0 && DQ <= KD && DV % 8 == 0 && DV <= KD, "tile widths");
  constexpr int kQC = (DQ + 63) / 64;  // 128-byte chunks of a Q / K row that the S product reads
  constexpr int kVC = (DV + 63) / 64;  // and of a V row that the PV product reads
  extern __shared__ __align__(16) uint8_t fa_smem[];
  const uint32_t smem_base = gemm90::smem_u32(fa_smem);
  const uint32_t q_s = gemm90::align1024(smem_base);
  const uint32_t stage0 = q_s + C::kQBytes;
  const uint32_t full0 = stage0 + S * stage_bytes, empty0 = full0 + 8 * S;
  const uint32_t q_full = empty0 + 8 * S;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  // keys past the tile's last row + offset are masked for every row: skipped
  const int n_end = p.causal ? max(0, min(p.N, m0 + BM + offset)) : p.N;
  // this split's key tiles: an equal share of all N keys, cut at n_end
  const int tiles = (p.N + BN - 1) / BN, per = (tiles + splits - 1) / splits;
  const int it0 = split * per;
  const int ntiles = max(0, min(min(tiles, it0 + per), (n_end + BN - 1) / BN) - it0);
  const int elt = p.mask_dtype == 0 ? 4 : 2;
  const long long mbase = b * p.smb + h * p.smh;
  if (tid == 0) {
    gemm90::init_barriers<S>(full0, empty0, kWG, 2 * kWG / 32);  // empty: one arrival a consumer warp
    gemm90::mbar_init(q_full, kWG);
    gemm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // loaders
    if constexpr (!MASK) loader_regs();
    const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
    const uint8_t* mask = MASK ? static_cast<const uint8_t*>(p.mask) + mbase * elt : nullptr;
#pragma unroll
    for (int kc = 0; kc < kQC; ++kc)
      gemm90::load_kmajor_tile<BM>(q_s + kc * BM * 128, q, 2 * p.sqm, m0, p.M, 128 * kc, 2 * p.D, t);
    gemm90::cp_async_arrive(q_full);
    gemm90::produce<S>(ntiles, full0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * stage_bytes;
      const int n0 = (it0 + it) * BN;
#pragma unroll
      for (int kc = 0; kc < kQC; ++kc)
        gemm90::load_kmajor_tile<BN>(sb + kc * BN * 128, k, 2 * p.skn, n0, p.N, 128 * kc, 2 * p.D, t);
#pragma unroll
      for (int kc = 0; kc < kVC; ++kc)
        gemm90::load_kmajor_tile<BN>(sb + C::kKBytes + kc * BN * 128, v, 2 * p.svn, n0, p.N, 128 * kc, 2 * p.Dv, t);
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

  if constexpr (!MASK) consumer_regs();
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int lrow = 64 * wg + 16 * warp + g;  // this thread's rows of the block's tile: lrow and lrow + 8
  const int row0 = m0 + lrow;
  const float c = p.scale_log2;
  // with a mask the scores are moved to the log2 domain before the softmax;
  // without one the scale is folded into the exp2 argument
  const float cs = MASK ? 1.f : c;
  // a warp's reads of a stage are done: one arrival on its empty barrier
  auto release = [&](int it) {
    if (lane == 0) gemm90::mbar_arrive(empty0 + 8 * (it % S));
  };

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
  uint32_t pa[BN / 16][4];    // P in V's dtype, the register A operand of the PV product

  // S = Q K^T of key tile `it` into s: one commit group (the register fences
  // keep the softmax's writes of S, and below the rescale of O and the
  // packing of P, ahead of wgmma.fence)
  auto issue_s = [&](float (&s)[BN / 2], int it) {
    const uint32_t kt = stage0 + (it % S) * stage_bytes;
    gemm90::fence_regs(s);
    gemm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DQ / 16; ++ks)
      gemm90::wgmma_ss<T, BN, 0>(s, gemm90::a_desc(q_s + (ks / 4) * BM * 128 + wg * 64 * 128, ks % 4),
                                 gemm90::kmajor_desc(kt + (ks / 4) * BN * 128, ks % 4), ks > 0);
    gemm90::wgmma_commit();
  };
  // the mask and the online softmax of key tile `it` (tile_softmax)
  const SoftmaxRows rows{row0, lrow, tq, offset, mask_pitch, elt, c, cs};
  auto softmax = [&](float (&s)[BN / 2], int it, float (&corr)[2]) {
    tile_softmax<BN, MASK>(p, rows, s, (it0 + it) * BN,
                           fa_smem + (stage0 + (it % S) * stage_bytes + 2 * C::kKBytes - smem_base), m_r, l_r, corr);
  };
  // P rounded to V's dtype straight from the score registers
  auto pack = [&](const float (&s)[BN / 2]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack2(s[8 * kk + 0], s[8 * kk + 1], T());
      pa[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3], T());
      pa[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5], T());
      pa[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7], T());
    }
  };
  // O = corr O, while no product is in flight
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int jt = 0; jt < DV / 8; ++jt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * jt + 2 * r] *= corr[r];
        o[4 * jt + 2 * r + 1] *= corr[r];
      }
  };
  // O += P V of key tile `it`: one commit group
  auto issue_pv = [&](int it) {
    gemm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) gemm90::fence_regs(pa[kk]);
    gemm90::wgmma_fence();
    const uint32_t vt = stage0 + (it % S) * stage_bytes + C::kKBytes;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) gemm90::wgmma_rs<T, DV>(o, pa[kk], gemm90::BTile<128, BN>::desc(vt, kk));
    gemm90::wgmma_commit();
  };

  if (ntiles > 0) {
    gemm90::mbar_wait(q_full, 0);
    float s[BN / 2], corr[2];
    if constexpr (MASK) {
      for (int it = 0; it < ntiles; ++it) {
        gemm90::mbar_wait(full0 + 8 * (it % S), (it / S) & 1);
        issue_s(s, it);
        gemm90::wgmma_wait<0>();  // S, and the previous tile's PV product, are done
        gemm90::fence_regs(s);
        gemm90::fence_regs(o);
        if (it > 0) release(it - 1);
        softmax(s, it, corr);
        pack(s);
        rescale(corr);
        issue_pv(it);
      }
      gemm90::wgmma_wait<0>();
    } else {
      // The two consumer warpgroups take turns on the tensor cores (named
      // barriers 1 and 2, warpgroup 0 first): in its turn a warpgroup issues
      // the S product of tile it + 1 and the PV product of tile it, waits for
      // both, then runs tile it + 1's softmax while the other warpgroup's
      // products run (no accumulator is read while a product is in flight:
      // ptxas would serialize the pipeline).
      gemm90::mbar_wait(full0, 0);
      issue_s(s, 0);
      gemm90::wgmma_wait<0>();
      gemm90::fence_regs(s);
      softmax(s, 0, corr);
      pack(s);
      if (wg == 1) gemm90::named_barrier_arrive(1, 2 * kWG);
      for (int it = 0; it < ntiles; ++it) {
        const bool next = it + 1 < ntiles;
        rescale(corr);  // tile it's factor
        if (next) gemm90::mbar_wait(full0 + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
        gemm90::named_barrier(1 + wg, 2 * kWG);  // this warpgroup's turn
        if (next) issue_s(s, it + 1);
        issue_pv(it);
        gemm90::named_barrier_arrive(2 - wg, 2 * kWG);  // the other's turn
        gemm90::wgmma_wait<0>();  // both products are done
        gemm90::fence_regs(s);
        gemm90::fence_regs(o);
        release(it);
        if (next) {
          softmax(s, it + 1, corr);
          pack(s);
        }
      }
    }
    gemm90::fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row < p.M) store_row<T>(p, o, r, b, h, row, 0, tq, l, m_r[r] * cs, splits, split, part, true);
  }
}

template <typename T>
__global__ void fa_combine_kernel(const Params p, int splits, const float* part);

// splits > 1 (unmasked forms only): the keys split over splits blocks per
// query tile, partials in `part`, then fa_combine_kernel
template <typename T, int KD, int DQ, int DV, bool MASK>
cudaError_t launch_wgmma(const Params& p, int splits, float* part, cudaStream_t stream) {
  using C = FaWgCfg<KD, MASK>;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && (MASK || part == nullptr)) ||
      static_cast<long long>(p.B) * splits > 65535)
    return cudaErrorInvalidValue;
  auto kernel = fa_wgmma_kernel<T, KD, DQ, DV, MASK>;
  static cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::smem_bytes(MASK ? 4 : 0));
  if (attr != cudaSuccess) return attr;
  const int elt = MASK ? (p.mask_dtype == 0 ? 4 : 2) : 0;
  const dim3 grid((p.M + C::kBM - 1) / C::kBM, p.H, p.B * splits);
  kernel<<<grid, C::kThreads, C::smem_bytes(elt), stream>>>(p, C::stage_bytes(elt), C::kBN * elt + 16, splits, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fa_combine_kernel<T><<<dim3(p.M, p.H, p.B), 128, 0, stream>>>(p, splits, part);
  return cudaGetLastError();
}

struct FaWideCfg {
  static constexpr int kKD = 512;
  static constexpr int kBM = 64;  // query rows, shared by the two consumer warpgroups
  static constexpr int kBN = 32;  // keys per staged tile
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kBM * kKD * 2;
  static constexpr int kKBytes = kBN * kKD * 2;  // the K tile; the V tile the same
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kThreads = 3 * gemm90::kWG;
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
};
static_assert(FaWideCfg::kSmemBytes <= 232448, "shared memory of a block");

// blockIdx = (64-row query tile, head, batch * splits + split). With one
// split the block writes O; with more it writes its unnormalized float32 O
// to part[split][b][h][row][:Dv] and (row max in the log2 domain, row sum)
// after all of those, for fa_combine_kernel.
template <typename T>
__global__ void __launch_bounds__(FaWideCfg::kThreads, 1)
    fa_wgmma_wide_kernel(const Params p, int splits, float* part) {
  using C = FaWideCfg;
  constexpr int BM = C::kBM, BN = C::kBN, S = C::kStages, KD = C::kKD, kWG = gemm90::kWG;
  constexpr int DVW = KD / 2;  // output columns per consumer warpgroup
  extern __shared__ __align__(16) uint8_t fa_smem[];
  const uint32_t q_s = gemm90::align1024(gemm90::smem_u32(fa_smem));
  const uint32_t stage0 = q_s + C::kQBytes;
  const uint32_t full0 = stage0 + S * C::kStageBytes, empty0 = full0 + 8 * S;
  const uint32_t q_full = empty0 + 8 * S;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  const int n_end = p.causal ? max(0, min(p.N, m0 + BM + offset)) : p.N;
  // this split's key tiles: an equal share of all N keys, cut at n_end
  const int tiles = (p.N + BN - 1) / BN, per = (tiles + splits - 1) / splits;
  const int it0 = split * per;
  const int ntiles = max(0, min(min(tiles, it0 + per), (n_end + BN - 1) / BN) - it0);
  if (tid == 0) {
    gemm90::init_barriers<S>(full0, empty0, kWG, 2 * kWG / 32);  // empty: one arrival a consumer warp
    gemm90::mbar_init(q_full, kWG);
    gemm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // loaders
    loader_regs();
    const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
#pragma unroll
    for (int kc = 0; kc < KD / 64; ++kc)
      gemm90::load_kmajor_tile<BM>(q_s + kc * BM * 128, q, 2 * p.sqm, m0, p.M, 128 * kc, 2 * p.D, t);
    gemm90::cp_async_arrive(q_full);
    gemm90::produce<S>(ntiles, full0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * C::kStageBytes;
      const int n0 = (it0 + it) * BN;
#pragma unroll
      for (int kc = 0; kc < KD / 64; ++kc) {
        gemm90::load_kmajor_tile<BN>(sb + kc * BN * 128, k, 2 * p.skn, n0, p.N, 128 * kc, 2 * p.D, t);
        gemm90::load_kmajor_tile<BN>(sb + C::kKBytes + kc * BN * 128, v, 2 * p.svn, n0, p.N, 128 * kc, 2 * p.Dv, t);
      }
    });
    return;
  }
  consumer_regs();

  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int lrow = 16 * warp + g;  // this thread's rows of the block's 64: lrow and lrow + 8
  const int row0 = m0 + lrow;
  const float c = p.scale_log2;
  float o[DVW / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < DVW / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  uint32_t pa[BN / 16][4];

  if (ntiles > 0) gemm90::mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % S;
    const uint32_t sb = stage0 + st * C::kStageBytes;
    gemm90::mbar_wait(full0 + 8 * st, (it / S) & 1);
    gemm90::fence_regs(s);
    gemm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KD / 16; ++ks)
      gemm90::wgmma_ss<T, BN, 0>(s, gemm90::a_desc(q_s + (ks / 4) * BM * 128, ks % 4),
                                 gemm90::kmajor_desc(sb + (ks / 4) * BN * 128, ks % 4), ks > 0);
    gemm90::wgmma_commit();
    gemm90::wgmma_wait<0>();  // S, and the previous tile's PV product, are done
    gemm90::fence_regs(s);
    gemm90::fence_regs(o);
    if (it > 0 && lane == 0) gemm90::mbar_arrive(empty0 + 8 * ((it - 1) % S));

    const int n0 = (it0 + it) * BN;
    if (p.causal || n0 + BN > p.N)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2), col = n0 + 8 * j + 2 * tq + (e % 2);
        if (col >= p.N || (p.causal && col > row + offset)) s[4 * j + e] = -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = fast_exp2((m_r[r] - m_use) * c);
      const float mc = m_use * c;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        s[4 * j + 2 * r] = fast_exp2(fmaf(s[4 * j + 2 * r], c, -mc));
        s[4 * j + 2 * r + 1] = fast_exp2(fmaf(s[4 * j + 2 * r + 1], c, -mc));
        rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + rs;
      m_r[r] = m_new;
#pragma unroll
      for (int jt = 0; jt < DVW / 8; ++jt) {
        o[4 * jt + 2 * r] *= corr;
        o[4 * jt + 2 * r + 1] *= corr;
      }
    }
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
    // this warpgroup's columns: chunks 4 wg .. 4 wg + 3 of the V tile
    const uint32_t vt = sb + C::kKBytes + wg * (DVW / 64) * BN * 128;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) gemm90::wgmma_rs<T, DVW>(o, pa[kk], gemm90::BTile<128, BN>::desc(vt, kk));
    gemm90::wgmma_commit();
  }
  gemm90::wgmma_wait<0>();
  gemm90::fence_regs(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row < p.M) store_row<T>(p, o, r, b, h, row, DVW * wg, tq, l, m_r[r] * c, splits, split, part, wg == 0);
  }
}

// one block per (row, head, batch): O = sum_s w_s O_s / sum_s w_s l_s with
// w_s = exp2(m_s - max_s m_s), the splits taken in order; a row that no split
// saw a key of is 0
template <typename T>
__global__ void fa_combine_kernel(const Params p, int splits, const float* part) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_den;
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long rows = static_cast<long long>(p.B) * p.H * p.M;
  const long long ri = (static_cast<long long>(b) * p.H + h) * p.M + row;
  const float* ml = part + static_cast<long long>(splits) * rows * p.Dv;
  if (threadIdx.x == 0) {
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * (s * rows + ri)]);
    float den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = mx == -INFINITY ? 0.f : exp2f(ml[2 * (s * rows + ri)] - mx);
      s_w[s] = w;
      den += w * ml[2 * (s * rows + ri) + 1];
    }
    s_den = den == 0.f ? 1.f : den;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.o) + b * p.sob + h * p.soh + row * p.som;
  for (int col = 2 * threadIdx.x; col < p.Dv; col += 2 * blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 x = *reinterpret_cast<const float2*>(part + (s * rows + ri) * p.Dv + col);
      a0 = fmaf(s_w[s], x.x, a0);
      a1 = fmaf(s_w[s], x.y, a1);
    }
    store_pair(out + col, a0 / s_den, a1 / s_den);
  }
}

template <typename T>
cudaError_t launch_wgmma_wide(const Params& p, int splits, float* part, cudaStream_t stream) {
  using C = FaWideCfg;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && part == nullptr) ||
      static_cast<long long>(p.B) * splits > 65535)
    return cudaErrorInvalidValue;
  auto kernel = fa_wgmma_wide_kernel<T>;
  static cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.M + C::kBM - 1) / C::kBM, p.H, p.B * splits);
  kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(p, splits, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fa_combine_kernel<T><<<dim3(p.M, p.H, p.B), 128, 0, stream>>>(p, splits, part);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tf32x3 variant (float32: head dims <= 128, rows as the wgmma variant's)
// ---------------------------------------------------------------------------
//
// fa_tf32_kernel is fa_wgmma_kernel's pipeline for float32 operands: a
// loading warpgroup keeps a ring of K and V^T tiles full with cp.async
// copies, consumer warpgroups of 64 query rows run S = Q K^T and O += P V as
// wgmma on the tensor cores with the online softmax between them, and where
// there are two consumer warpgroups they take turns on the tensor cores, with
// a mask too (a tile's mask is read in the softmax after the other
// warpgroup's turn, while its stage is still held: the turns and a third
// stage took the float32 TinyLlama prefill site from 0.2066 to 0.1836-0.1874
// ms on an H100). Each product is three TF32 products: every float32 operand x
// is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, 10 mantissa bits
// each) and the product is hi hi + hi lo + lo hi, summed in float32 (lo lo,
// about 2^-22 of it, is dropped), which is what the TPU kernel's
// Precision.HIGHEST products give. One TF32 product alone misses the float32
// bar of 1e-4.
//
// TF32 wgmma reads both operands K-major only. S's are K-major as stored
// (Q's and K's rows run along the head dim). For P V the B operand
// is V^T, keys contiguous, so V is transposed once, before the kernel: a
// pre-pass (fa_tf32_split_rows, fa_tf32_split_vt) writes Q's and K's hi and
// lo planes and V^T's into a workspace the wrapper allocates, and the
// loaders copy tiles of those planes (no conversion on the loading side).
// P's hi and lo parts are made in registers from the score accumulator: the
// accumulator gives a thread columns 2 t and 2 t + 1 of each n8 block, where
// the register A operand of a k8 step holds columns t and t + 4
// (wgmma_tf32_rs), so V^T's keys are stored permuted within each group of 8
// (tf32_key_at) rather than P's registers moved between threads.
//
// Shared memory holds Q's two planes (kBM rows) and, a stage, K's and V^T's
// two planes: 8 bytes an element of each operand, twice the 16-bit kernel's,
// so the key tiles are 64 keys at head dims up to 64 and 32 above (and with
// a mask, whose tile shares the stage), and head dims above 80 take one
// consumer warpgroup. The pre-pass reads each operand once and writes twice
// its bytes; the sites are bound by the tensor cores (three products) and
// the softmax, not by bytes.

// the key that position pos of V^T's group of 8 holds (within the group):
// A register e of a k8 step holds columns t and t + 4 (e / 2), which are the
// score accumulator's columns 2 t and 2 t + 1
__host__ __device__ constexpr int tf32_key_at(int pos) { return pos < 4 ? 2 * pos : 2 * (pos - 4) + 1; }
// the score register (of a thread's 4 in an n8 block: (g, 2 t), (g, 2 t + 1),
// (g + 8, 2 t), (g + 8, 2 t + 1)) that goes to A register e of a k8 step
// ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) in V^T's key order)
__host__ __device__ constexpr int tf32_frag(int e) { return e == 1 ? 2 : e == 2 ? 1 : e; }

__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = __uint_as_float(gemm90::tf32_rna(x));
  lo = __uint_as_float(gemm90::tf32_rna(x - hi));
}

// The workspace of a tf32x3 launch, in floats: Q's planes [B][H][hi, lo][M][D],
// then K's [B][Hkv][hi, lo][N][D], then V^T's [B][Hkv][hi, lo][Dv][Np], Np = N
// rounded up to 64 (keys past N are 0). Mirrored by _tf32_workspace_floats in
// kernels/flash_attention.py.
struct TfPlanes {
  long long q, k, v;
  int np;
};
__host__ __device__ inline TfPlanes tf_planes(const Params& p) {
  const long long k = 2LL * p.B * p.H * p.M * p.D;
  return {0, k, k + 2LL * p.B * p.Hkv * p.N * p.D, (p.N + 63) / 64 * 64};
}

// x[b][h][row][:D] (element strides, unit column stride, 16-byte aligned rows)
// -> out[b][h][hi, lo][row][:D]; 4 values a thread
__global__ void fa_tf32_split_rows(const float* x, long long sb, long long sh, long long sr, int H, int L, int D,
                                   float* out) {
  const long long n = static_cast<long long>(L) * D;
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = static_cast<int>(i / D), c = static_cast<int>(i % D);
  const float4 v = *reinterpret_cast<const float4*>(x + b * sb + h * sh + r * sr + c);
  float4 hi, lo;
  tf32_split(v.x, hi.x, lo.x);
  tf32_split(v.y, hi.y, lo.y);
  tf32_split(v.z, hi.z, lo.z);
  tf32_split(v.w, hi.w, lo.w);
  float* o = out + (static_cast<long long>(b) * H + h) * 2 * n + i;
  *reinterpret_cast<float4*>(o) = hi;
  *reinterpret_cast<float4*>(o + n) = lo;
}

// v[b][h][key][:Dv] -> out[b][h][hi, lo][column][position]: a block moves 32
// keys x 32 columns through shared memory (grid: Np / 32, H * cb, B with cb
// 32-column blocks a head); position 8 j + pos of a row holds key 8 j +
// tf32_key_at(pos), 0 past N
__global__ void fa_tf32_split_vt(const float* v, long long sb, long long sh, long long sn, int H, int cb, int N,
                                 int Dv, int Np, float* out) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, h = blockIdx.y / cb, c0 = blockIdx.y % cb * 32, b = blockIdx.z;
  const float* src = v + b * sb + h * sh;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int n = n0 + j, c = c0 + threadIdx.x;
    tile[j][threadIdx.x] = n < N && c < Dv ? src[n * sn + c] : 0.f;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(Dv) * Np;
  float* dst = out + (static_cast<long long>(b) * H + h) * 2 * plane + n0 + threadIdx.x;
  const int key = threadIdx.x / 8 * 8 + tf32_key_at(threadIdx.x % 8);
  for (int j = threadIdx.y; j < 32 && c0 + j < Dv; j += 8) {
    float hi, lo;
    tf32_split(tile[key][j], hi, lo);
    dst[static_cast<long long>(c0 + j) * Np] = hi;
    dst[plane + static_cast<long long>(c0 + j) * Np] = lo;
  }
}

template <int DQ, int DV, bool MASK>
struct FaTfCfg {
  static constexpr int kNWG = DQ <= 80 ? 2 : 1;                 // consumer warpgroups of 64 query rows
  static constexpr int kBM = 64 * kNWG;
  static constexpr int kBN = MASK || DQ > 64 ? 32 : 64;         // keys per staged tile
  static constexpr int kStages = DQ <= 40 || (MASK && DQ <= 64) ? 3 : 2;  // as many as fit
  static constexpr int kQC = (DQ + 31) / 32;                    // 128-byte chunks (32 floats) of a Q / K row
  static constexpr int kQPlane = kBM * kQC * 128;               // one plane (hi or lo) of the Q tile
  static constexpr int kKPlane = kBN * kQC * 128;               // of the K tile
  static constexpr int kVPlane = DV * kBN * 4;                  // of the V^T tile: kBN / 32 chunks of DV rows
  static constexpr int kThreads = (kNWG + 1) * gemm90::kWG;
  // the mask tile: kBM rows of kBN keys, 16 bytes of padding a row, rounded up to 1024 bytes
  static constexpr int mask_bytes(int elt) { return elt ? (kBM * (kBN * elt + 16) + 1023) / 1024 * 1024 : 0; }
  static constexpr int stage_bytes(int elt) { return 2 * (kKPlane + kVPlane) + mask_bytes(elt); }
  static constexpr int smem_bytes(int elt) {
    return 1024 + 2 * kQPlane + kStages * stage_bytes(elt) + 8 * (2 * kStages + 1);
  }
};
static_assert(FaTfCfg<40, 40, false>::smem_bytes(0) <= 232448 && FaTfCfg<64, 64, false>::smem_bytes(0) <= 232448 &&
                  FaTfCfg<80, 80, false>::smem_bytes(0) <= 232448 &&
                  FaTfCfg<128, 128, false>::smem_bytes(0) <= 232448 && FaTfCfg<64, 64, true>::smem_bytes(4) <= 232448 &&
                  FaTfCfg<128, 128, true>::smem_bytes(4) <= 232448,
              "shared memory of a block");

template <int DQ, int DV, bool MASK>
__global__ void __launch_bounds__(FaTfCfg<DQ, DV, MASK>::kThreads, 1)
    fa_tf32_kernel(const Params p, const float* ws, int stage_bytes, int mask_pitch, int splits, float* part) {
  using C = FaTfCfg<DQ, DV, MASK>;
  constexpr int NWG = C::kNWG, BM = C::kBM, BN = C::kBN, S = C::kStages, kWG = gemm90::kWG;
  constexpr bool kTurns = NWG == 2;  // two consumer warpgroups take turns on the tensor cores
  static_assert(DQ % 8 == 0 && DQ <= 128 && DV % 8 == 0 && DV <= 128, "tile widths");
  extern __shared__ __align__(16) uint8_t fa_smem[];
  const uint32_t smem_base = gemm90::smem_u32(fa_smem);
  const uint32_t q_s = gemm90::align1024(smem_base);  // Q's hi plane, then its lo plane
  const uint32_t stage0 = q_s + 2 * C::kQPlane;     // a stage: K hi, K lo, V^T hi, V^T lo, the mask tile
  const uint32_t full0 = stage0 + S * stage_bytes, empty0 = full0 + 8 * S;
  const uint32_t q_full = empty0 + 8 * S;

  const int tid = threadIdx.x, wg = tid / kWG, t = tid % kWG;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int hk = h / (p.H / p.Hkv);
  const int offset = p.N - p.M;
  const int n_end = p.causal ? max(0, min(p.N, m0 + BM + offset)) : p.N;
  const int tiles = (p.N + BN - 1) / BN, per = (tiles + splits - 1) / splits;
  const int it0 = split * per;
  const int ntiles = max(0, min(min(tiles, it0 + per), (n_end + BN - 1) / BN) - it0);
  const int elt = p.mask_dtype == 0 ? 4 : 2;
  const long long mbase = b * p.smb + h * p.smh;
  if (tid == 0) {
    gemm90::init_barriers<S>(full0, empty0, kWG, NWG * kWG / 32);  // empty: one arrival a consumer warp
    gemm90::mbar_init(q_full, kWG);
    gemm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // loaders
    if constexpr (kTurns) loader_regs();
    const TfPlanes w = tf_planes(p);
    const long long qn = static_cast<long long>(p.M) * p.D, kn = static_cast<long long>(p.N) * p.D;
    const long long vn = static_cast<long long>(p.Dv) * w.np;
    const float* qs = ws + w.q + (static_cast<long long>(b) * p.H + h) * 2 * qn;
    const float* ks = ws + w.k + (static_cast<long long>(b) * p.Hkv + hk) * 2 * kn;
    const float* vs = ws + w.v + (static_cast<long long>(b) * p.Hkv + hk) * 2 * vn;
    const uint8_t* mask = MASK ? static_cast<const uint8_t*>(p.mask) + mbase * elt : nullptr;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int kc = 0; kc < C::kQC; ++kc)
        gemm90::load_kmajor_tile<BM>(q_s + pl * C::kQPlane + kc * BM * 128, qs + pl * qn, 4LL * p.D, m0, p.M,
                                     128 * kc, 4 * p.D, t);
    gemm90::cp_async_arrive(q_full);
    gemm90::produce<S>(ntiles, full0, empty0, [&](int it, int s) {
      const uint32_t sb = stage0 + s * stage_bytes;
      const int n0 = (it0 + it) * BN;
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
        for (int kc = 0; kc < C::kQC; ++kc)
          gemm90::load_kmajor_tile<BN>(sb + pl * C::kKPlane + kc * BN * 128, ks + pl * kn, 4LL * p.D, n0, p.N,
                                       128 * kc, 4 * p.D, t);
        // V^T: DV rows of BN keys in chunks of 32 keys (the workspace holds
        // whole tiles of keys), rows past Dv zero
        const uint32_t vt = sb + 2 * C::kKPlane + pl * C::kVPlane;
        for (int i = t; i < DV * BN / 4; i += kWG) {
          const int c = i / (DV * 8), r = i / 8 % DV, pc = i % 8;
          const bool ok = r < p.Dv;
          const float* src = ok ? vs + pl * vn + static_cast<long long>(r) * w.np + n0 + 32 * c + 4 * pc : vs;
          gemm90::cp_async16(vt + c * DV * 128 + gemm90::a_offset(r, pc), src, ok);
        }
      }
      if constexpr (MASK) {
        const int per_row = BN * elt / 16;  // 16-byte pieces of a mask row
        const uint32_t mt = sb + 2 * (C::kKPlane + C::kVPlane);
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

  if constexpr (kTurns) consumer_regs();
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int lrow = 64 * wg + 16 * warp + g;  // this thread's rows of the block's tile: lrow and lrow + 8
  const int row0 = m0 + lrow;
  const float c = p.scale_log2;
  // with a mask the scores are moved to the log2 domain before the softmax;
  // without one the scale is folded into the exp2 argument
  const float cs = MASK ? 1.f : c;
  auto release = [&](int it) {
    if (lane == 0) gemm90::mbar_arrive(empty0 + 8 * (it % S));
  };

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
  uint32_t ph[BN / 8][4], pl[BN / 8][4];  // P's hi and lo parts: the register A operands of the PV products

  // S = Q K^T of key tile `it` into s, three TF32 products a k8 step: one commit group
  auto issue_s = [&](float (&s)[BN / 2], int it) {
    const uint32_t kt = stage0 + (it % S) * stage_bytes, qa = q_s + wg * 64 * 128;
    gemm90::fence_regs(s);
    gemm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DQ / 8; ++ks) {
      const uint32_t qo = (ks / 4) * BM * 128, ko = (ks / 4) * BN * 128;
      const uint64_t qh = gemm90::a_desc(qa + qo, ks % 4), ql = gemm90::a_desc(qa + C::kQPlane + qo, ks % 4);
      const uint64_t kh = gemm90::kmajor_desc(kt + ko, ks % 4), kl = gemm90::kmajor_desc(kt + C::kKPlane + ko, ks % 4);
      gemm90::wgmma_tf32_ss<BN>(s, qh, kl, ks > 0);
      gemm90::wgmma_tf32_ss<BN>(s, ql, kh, 1);
      gemm90::wgmma_tf32_ss<BN>(s, qh, kh, 1);
    }
    gemm90::wgmma_commit();
  };
  // the mask and the online softmax of key tile `it` (tile_softmax)
  const SoftmaxRows rows{row0, lrow, tq, offset, mask_pitch, elt, c, cs};
  auto softmax = [&](float (&s)[BN / 2], int it, float (&corr)[2]) {
    tile_softmax<BN, MASK>(p, rows, s, (it0 + it) * BN,
                           fa_smem + (stage0 + (it % S) * stage_bytes + 2 * (C::kKPlane + C::kVPlane) - smem_base),
                           m_r, l_r, corr);
  };
  // P's hi and lo TF32 parts straight from the score registers
  auto pack = [&](const float (&s)[BN / 2]) {
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * kk + tf32_frag(e)];
        ph[kk][e] = gemm90::tf32_rna(x);
        pl[kk][e] = gemm90::tf32_rna(x - __uint_as_float(ph[kk][e]));
      }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int jt = 0; jt < DV / 8; ++jt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * jt + 2 * r] *= corr[r];
        o[4 * jt + 2 * r + 1] *= corr[r];
      }
  };
  // O += P V of key tile `it`, three TF32 products a k8 step: one commit group
  auto issue_pv = [&](int it) {
    gemm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      gemm90::fence_regs(ph[kk]);
      gemm90::fence_regs(pl[kk]);
    }
    gemm90::wgmma_fence();
    const uint32_t vt = stage0 + (it % S) * stage_bytes + 2 * C::kKPlane;
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t vo = (kk / 4) * DV * 128;
      const uint64_t vh = gemm90::kmajor_desc(vt + vo, kk % 4), vl = gemm90::kmajor_desc(vt + C::kVPlane + vo, kk % 4);
      gemm90::wgmma_tf32_rs<DV>(o, ph[kk], vl);
      gemm90::wgmma_tf32_rs<DV>(o, pl[kk], vh);
      gemm90::wgmma_tf32_rs<DV>(o, ph[kk], vh);
    }
    gemm90::wgmma_commit();
  };

  if (ntiles > 0) {
    gemm90::mbar_wait(q_full, 0);
    float s[BN / 2], corr[2];
    if constexpr (!kTurns) {
      for (int it = 0; it < ntiles; ++it) {
        gemm90::mbar_wait(full0 + 8 * (it % S), (it / S) & 1);
        issue_s(s, it);
        gemm90::wgmma_wait<0>();  // S, and the previous tile's PV product, are done
        gemm90::fence_regs(s);
        gemm90::fence_regs(o);
        if (it > 0) release(it - 1);
        softmax(s, it, corr);
        pack(s);
        rescale(corr);
        issue_pv(it);
      }
      gemm90::wgmma_wait<0>();
    } else {
      // turns as in fa_wgmma_kernel (named barriers 1 and 2, warpgroup 0 first)
      gemm90::mbar_wait(full0, 0);
      issue_s(s, 0);
      gemm90::wgmma_wait<0>();
      gemm90::fence_regs(s);
      softmax(s, 0, corr);
      pack(s);
      if (wg == 1) gemm90::named_barrier_arrive(1, 2 * kWG);
      for (int it = 0; it < ntiles; ++it) {
        const bool next = it + 1 < ntiles;
        rescale(corr);
        if (next) gemm90::mbar_wait(full0 + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
        gemm90::named_barrier(1 + wg, 2 * kWG);  // this warpgroup's turn
        if (next) issue_s(s, it + 1);
        issue_pv(it);
        gemm90::named_barrier_arrive(2 - wg, 2 * kWG);  // the other's turn
        gemm90::wgmma_wait<0>();
        gemm90::fence_regs(s);
        gemm90::fence_regs(o);
        release(it);
        if (next) {
          softmax(s, it + 1, corr);
          pack(s);
        }
      }
    }
    gemm90::fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row < p.M) store_row<float>(p, o, r, b, h, row, 0, tq, l, m_r[r] * cs, splits, split, part, true);
  }
}

// the pre-pass of a tf32x3 launch: Q's, K's and V^T's hi and lo planes into ws
cudaError_t tf32_split(const Params& p, float* ws, cudaStream_t stream) {
  const TfPlanes w = tf_planes(p);
  const long long qn = static_cast<long long>(p.M) * p.D, kn = static_cast<long long>(p.N) * p.D;
  if (qn > 0)
    fa_tf32_split_rows<<<dim3(static_cast<unsigned>((qn / 4 + 255) / 256), p.H, p.B), 256, 0, stream>>>(
        static_cast<const float*>(p.q), p.sqb, p.sqh, p.sqm, p.H, p.M, p.D, ws + w.q);
  if (kn > 0)
    fa_tf32_split_rows<<<dim3(static_cast<unsigned>((kn / 4 + 255) / 256), p.Hkv, p.B), 256, 0, stream>>>(
        static_cast<const float*>(p.k), p.skb, p.skh, p.skn, p.Hkv, p.N, p.D, ws + w.k);
  const int cb = (p.Dv + 31) / 32;
  if (w.np > 0)
    fa_tf32_split_vt<<<dim3(w.np / 32, p.Hkv * cb, p.B), dim3(32, 8), 0, stream>>>(
        static_cast<const float*>(p.v), p.svb, p.svh, p.svn, p.Hkv, cb, p.N, p.Dv, w.np, ws + w.v);
  return cudaGetLastError();
}

template <int DQ, int DV, bool MASK>
cudaError_t launch_tf32(const Params& p, const float* ws, int splits, float* part, cudaStream_t stream) {
  using C = FaTfCfg<DQ, DV, MASK>;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && (MASK || part == nullptr)) ||
      static_cast<long long>(p.B) * splits > 65535)
    return cudaErrorInvalidValue;
  auto kernel = fa_tf32_kernel<DQ, DV, MASK>;
  static cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::smem_bytes(MASK ? 4 : 0));
  if (attr != cudaSuccess) return attr;
  const int elt = MASK ? (p.mask_dtype == 0 ? 4 : 2) : 0;
  const dim3 grid((p.M + C::kBM - 1) / C::kBM, p.H, p.B * splits);
  kernel<<<grid, C::kThreads, C::smem_bytes(elt), stream>>>(p, ws, C::stage_bytes(elt), C::kBN * elt + 16, splits,
                                                            part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fa_combine_kernel<float><<<dim3(p.M, p.H, p.B), 128, 0, stream>>>(p, splits, part);
  return cudaGetLastError();
}

// the pre-pass, then the kernel at the tile widths of the head dims: 40 and
// 80 (the SD1.5 UNet) their own, others 64 or 128, zero past the real ones
cudaError_t launch_tf32_for(const Params& p, float* ws, int splits, float* part, cudaStream_t stream) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = tf32_split(p, ws, stream);
  if (err != cudaSuccess) return err;
  const bool small = p.D <= 64 && p.Dv <= 64;
  if (p.mask)
    return small ? launch_tf32<64, 64, true>(p, ws, splits, part, stream)
                 : launch_tf32<128, 128, true>(p, ws, splits, part, stream);
  if (p.D == 40 && p.Dv == 40) return launch_tf32<40, 40, false>(p, ws, splits, part, stream);
  if (p.D == 80 && p.Dv == 80) return launch_tf32<80, 80, false>(p, ws, splits, part, stream);
  return small ? launch_tf32<64, 64, false>(p, ws, splits, part, stream)
               : launch_tf32<128, 128, false>(p, ws, splits, part, stream);
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

// 16-byte vector loads and pair stores of whole head rows need every row
// start aligned: base pointers and strides (elt bytes an element) to 16
// bytes. K only when it is read by rows (unit column stride).
bool rows_aligned16(const Params& p, long long elt) {
  unsigned long long ptrs = reinterpret_cast<unsigned long long>(p.q) |
                            reinterpret_cast<unsigned long long>(p.v) |
                            reinterpret_cast<unsigned long long>(p.o);
  long long strides = p.sqb | p.sqh | p.sqm | p.svb | p.svh | p.svn | p.sob | p.soh | p.som;
  if (p.skd == 1) {
    ptrs |= reinterpret_cast<unsigned long long>(p.k);
    strides |= p.skb | p.skh | p.skn;
  }
  return ptrs % 16 == 0 && strides * elt % 16 == 0;
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

// The variants that are not wgmma ones: bf16 / fp16 take the tensor cores
// where the rows are aligned and the head dims fit the 128-wide tiles.
// Otherwise the FMA kernel, with tile shapes by padded head dim: its float32
// accumulator (RM x KD/8 per thread) stays at or under 64 registers, and
// shared memory at or under 103 KB. Head dims above 256 only without a mask:
// the SD VAE's 1 x 512 head is the one such site, and it has none (it takes
// the wide wgmma variant; a K given transposed at such a head dim comes here).
template <typename T, bool MASK>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  const int kd = p.D > p.Dv ? p.D : p.Dv;
  if constexpr (!std::is_same<T, float>::value) {
    if (rows_aligned16(p, 2)) {
      if (kd <= 64) return launch_mma<T, 64, MASK>(p, stream);
      if (kd <= 128) return launch_mma<T, 128, MASK>(p, stream);
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

// the wgmma variants, for both entries: operands whose rows are whole 16-byte
// pieces, K read by rows, and head dims up to 128 with no mask or one whose
// rows are 16-byte granular (staged by 16-byte copies): fa_wgmma_kernel in 16
// bits, fa_tf32_kernel in float32; or 16-bit head dims 257..512 with no mask.
// Mirrored by flash_variant in kernels/flash_attention.py.
bool mask_staged(const Params& p) {
  const long long elt = p.mask_dtype == 0 ? 4 : 2;
  return p.smn == 1 && reinterpret_cast<unsigned long long>(p.mask) % 16 == 0 && (p.smb * elt) % 16 == 0 &&
         (p.smh * elt) % 16 == 0 && (p.smm * elt) % 16 == 0 && (p.N * elt) % 16 == 0;
}
bool use_wgmma(const Params& p, long long elt) {
  return p.skd == 1 && rows_aligned16(p, elt) && p.D <= 128 && p.Dv <= 128 && (p.mask == nullptr || mask_staged(p));
}
bool use_wgmma_wide(const Params& p) {
  const int kd = p.D > p.Dv ? p.D : p.Dv;
  return p.skd == 1 && rows_aligned16(p, 2) && p.mask == nullptr && kd > 256 && kd <= 512;
}

// the tile widths of a wgmma launch: the SD1.5 UNet's head dims 40 and 80
// have their own (S over 48 and 80 columns, PV 40 and 80 wide); other head
// dims run over 64 or 128, zero past the real ones
template <typename T>
cudaError_t launch_wgmma_for(const Params& p, int splits, float* part, cudaStream_t stream) {
  const bool small = p.D <= 64 && p.Dv <= 64;
  if (p.mask)
    return small ? launch_wgmma<T, 64, 64, 64, true>(p, splits, part, stream)
                 : launch_wgmma<T, 128, 128, 128, true>(p, splits, part, stream);
  if (p.D == 40 && p.Dv == 40) return launch_wgmma<T, 64, 48, 40, false>(p, splits, part, stream);
  if (p.D == 80 && p.Dv == 80) return launch_wgmma<T, 128, 80, 80, false>(p, splits, part, stream);
  return small ? launch_wgmma<T, 64, 64, 64, false>(p, splits, part, stream)
               : launch_wgmma<T, 128, 128, 128, false>(p, splits, part, stream);
}

// the wgmma variants where they take the operands (wgmma != 0), else the
// variants that came before them
template <typename T>
cudaError_t dispatch_all(const Params& p, int wgmma, int splits, float* part, float* ws, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (wgmma && use_wgmma(p, 4)) return launch_tf32_for(p, ws, splits, part, stream);
  } else {
    if (wgmma && use_wgmma(p, 2)) return launch_wgmma_for<T>(p, splits, part, stream);
    if (wgmma && use_wgmma_wide(p)) return launch_wgmma_wide<T>(p, splits, part, stream);
  }
  return dispatch_mask<T>(p, stream);
}

}  // namespace

// wgmma: 1 = every variant (both wrappers), 0 = none of the wgmma ones (the
// variants that came before them, for timing side by side). dtype: 0 =
// float32, 1 = float16, 2 = bfloat16 (q, k, v and o share it); mask_dtype
// likewise, read only when mask is not null. strides holds 17 element
// strides: q (batch, head, row), k (batch, head, key, column), v (batch,
// head, row), o (batch, head, row), mask (batch, head, row, column). splits
// and part: the key split of an unmasked wgmma launch and its float32
// workspace of splits * B * H * M * (Dv + 2) values (null for one split).
// ws: the float32 workspace of a tf32x3 launch (tf_planes; null for every
// other variant). Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ostt_flash_attention(int wgmma, int dtype, const void* q, const void* k, const void* v,
                                    void* o, const void* mask, int mask_dtype, int B, int M,
                                    int N, int H, int Hkv, int D, int Dv,
                                    const long long* strides, float scale_log2, int causal,
                                    int splits, void* part, void* ws, void* stream) {
  if (wgmma < 0 || wgmma > 1 || B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D % 8 || Dv % 8 ||
      D <= 0 || Dv <= 0 || mask_dtype < 0 || mask_dtype > 2 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Params p{q,     k,     v,     o,     mask,  B,     M,     N,     H,         Hkv,
                 D,     Dv,    s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],      s[7],
                 s[8],  s[9],  s[10], s[11], s[12], s[13], s[14], s[15], s[16],     mask_dtype,
                 scale_log2, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  float* tw = static_cast<float*>(ws);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch_all<float>(p, wgmma, splits, pt, tw, st));
    case 1: return static_cast<int>(dispatch_all<__half>(p, wgmma, splits, pt, nullptr, st));
    case 2: return static_cast<int>(dispatch_all<__nv_bfloat16>(p, wgmma, splits, pt, nullptr, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
