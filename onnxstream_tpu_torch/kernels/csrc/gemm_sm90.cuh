// Building blocks of the Hopper (sm_90a) matrix-product pipeline shared by
// csrc/matmul.cu (kernel 9), csrc/qmatmul.cu (kernel 5, w8_matmul, and
// kernel 6, the s8 form with both operands K-major at the end of this file),
// csrc/qlinear.cu (kernel 3, the u8 x u8 -> s32 form), csrc/gn_conv.cu
// (kernel 8, the 16-bit form with both operands K-major) and
// csrc/flash_attention.cu (kernels 1 and 2's wgmma variants: the ring,
// barriers, K-major tiles, the 16-bit wgmma forms with a K-major B or A in
// registers, and the TF32 forms of their float32 variant).
//
// Kernels 9 and 5 are a 16-bit product A (M, K) x B (K, N) with B contiguous
// along N, summed in float32. One block is a loading warpgroup, for kernel 5 a
// converting warpgroup, and one or two consumer warpgroups around a ring of
// stages in dynamic shared memory:
//
//  * Staging. The loading threads fill a stage with 16-byte cp.async copies
//    (zero-filled past the edges of A and B) as soon as it is free; the
//    hardware arrives on the stage's `full` mbarrier when a thread's copies
//    have landed, so as many tiles are in flight as the ring has free stages.
//    Consumers arrive on the stage's `empty` mbarrier once the wgmma group
//    that read it has retired. Kernel 5 puts a converting warpgroup between
//    the two: it turns the landed uint8 tile into a 16-bit B tile in a ring
//    of its own (plain shared-memory stores, then fence.proxy.async; the
//    converters have no copies in flight for the fence to wait on). cp.async
//    was taken rather than TMA: it needs no tensor map (no
//    cuTensorMapEncodeTiled to resolve at run time, no per-call encode on
//    host-bound paths), every shape the predicates admit is 16-byte
//    granular, and kernel 5 has to touch its weight bytes anyway to convert
//    them.
//  * Layout. An A tile is K-major, 64 k (128 bytes) per row, under the
//    128-byte swizzle: 16-byte piece c of row r lies at r * 128 +
//    ((c ^ (r & 7)) << 4). A B tile stays MN-major as it lies in device
//    memory: per chunk of SWZ / 2 columns, 64 k rows of SWZ bytes, piece i of
//    row k at k * SWZ + ((i ^ x) << 4) with x = k & 7 (SWZ = 128) or
//    (k >> 1) & 3 (SWZ = 64). wgmma reads it through the transpose bit of
//    the instruction, so nothing is transposed while it is staged.
//  * Product. wgmma.mma_async m64nNk16 from shared memory on both sides, f32
//    accumulators in registers, one group per k-tile, one group in flight
//    while the next tile's barrier is awaited.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace gemm90 {

#define G90_DEV __device__ __forceinline__

constexpr int kBK = 64;                 // k-tile: 64 16-bit values, one 128-byte row of A
constexpr int kWG = 128;                // threads of a warpgroup
constexpr int kATileBytes = 64 * 128;   // the A tile of one consumer warpgroup

G90_DEV uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

// ---- mbarrier -------------------------------------------------------------
G90_DEV void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
G90_DEV void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
G90_DEV void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// spins until the phase of the given parity has completed (parity 1 passes at
// once on a barrier that was just initialised)
G90_DEV void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- cp.async -------------------------------------------------------------
// 16 bytes global -> shared, or 16 zero bytes when !valid (src is not read)
G90_DEV void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
// the mbarrier at `bar` gets one arrival for this thread once all the cp.async
// copies it has started so far have landed; the thread does not wait
G90_DEV void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
G90_DEV void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// this thread's st.shared writes become visible to the async proxy that wgmma
// reads through
G90_DEV void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

G90_DEV uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}
G90_DEV void st_shared4(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
G90_DEV void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// ---- wgmma ----------------------------------------------------------------
G90_DEV void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
G90_DEV void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
G90_DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the async ops
template <int N>
G90_DEV void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
G90_DEV void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
G90_DEV void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets in 16-byte units, swizzle mode (1 = 128 B, 2 = 64 B, 0 = none)
G90_DEV uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

// A tile, K-major under the 128-byte swizzle: rows of 128 bytes, groups of 8
// rows 1024 bytes apart; k16 step ks starts 32 bytes further into the row
G90_DEV uint32_t a_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }
G90_DEV uint64_t a_desc(uint32_t tile, int ks) { return make_desc(tile + ks * 32, 16, 1024, 1); }

// B tile, MN-major: chunks of SWZ / 2 columns, each DEPTH k rows of SWZ bytes
// (DEPTH = 64 for the k-tiles of kernels 9 and 5; kernel 2's V tile is as deep
// as its key tile). The descriptor's leading offset steps from chunk to chunk
// along N, its stride offset from one group of 8 k rows to the next; k16 step
// ks starts 16 rows further down.
template <int SWZ, int DEPTH = kBK>
struct BTile {
  static_assert(SWZ == 128 || SWZ == 64, "swizzle width");
  static constexpr int kChunkCols = SWZ / 2;
  static constexpr int kChunkBytes = DEPTH * SWZ;
  // byte offset of the 16-byte piece holding columns n .. n + 7 of row k
  G90_DEV static uint32_t offset(int k, int n) {
    const int chunk = n / kChunkCols, i = (n % kChunkCols) / 8;
    const int x = SWZ == 128 ? (k & 7) : ((k >> 1) & 3);
    return chunk * kChunkBytes + k * SWZ + ((i ^ x) << 4);
  }
  G90_DEV static uint64_t desc(uint32_t tile, int ks) {
    return make_desc(tile + ks * 16 * SWZ, kChunkBytes, 8 * SWZ, SWZ == 128 ? 1 : 2);
  }
};

// D (64 x N, f32, in registers) += A (64 x 16, shared, K-major) x B (16 x N,
// shared; MN-major for the wide forms, K-major for n8). Thread t of the
// warpgroup holds, for j = 0 .. N / 8 - 1, d[4 j + 0 .. 1] = row 16 (t / 32) +
// (t % 32) / 4, columns 8 j + 2 (t % 4) and + 1, and d[4 j + 2 .. 3] the same
// columns of the row 8 below.
template <typename T>
G90_DEV void wgmma_m64n8k16(float (&d)[4], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
}

template <typename T>
G90_DEV void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
}

template <typename T>
G90_DEV void wgmma_m64n160k16(float (&d)[80], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(1));
  }
}

template <typename T, int BN>
G90_DEV void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 128 || BN == 160, "tile width");
  if constexpr (BN == 128) wgmma_m64n128k16<T>(d, da, db);
  else wgmma_m64n160k16<T>(d, da, db);
}

// ---- the pipeline ---------------------------------------------------------
// Barriers of stage s: full0 + 8 s and empty0 + 8 s (shared-memory addresses).
// `full` counts the threads that hand a stage over, `empty` those that
// release it.
template <int STAGES>
G90_DEV void init_barriers(uint32_t full0, uint32_t empty0, int full_count, int empty_count) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full0 + 8 * s, full_count);
    mbar_init(empty0 + 8 * s, empty_count);
  }
}

// The loading threads' sweep over `nkt` k-tiles. start(it, s) starts the
// cp.async copies of k-tile `it` into stage s as soon as the stage is free;
// the hardware arrives on the stage's `full` barrier for this thread when its
// copies have landed (cp.async.mbarrier.arrive.noinc), so handing a tile over
// never waits for the loader to get a later tile started, and up to STAGES
// tiles of copies are in flight. No proxy fence stands between a landed
// cp.async and the wgmma that reads it: the mbarrier orders them. Every
// loading thread calls it.
template <int STAGES, typename Start>
G90_DEV void produce(int nkt, uint32_t full0, uint32_t empty0, Start start) {
  for (int it = 0; it < nkt; ++it) {
    const int s = it % STAGES;
    mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
    start(it, s);
    cp_async_arrive(full0 + 8 * s);
  }
  cp_async_wait_all();  // nothing of this thread is in flight when it leaves
}

// One consumer warpgroup's sweep: acc += A tile x B tile over `nkt` k-tiles.
// The A tile of k-tile i lies at a0 + (i % STAGES) * a_stride and is handed
// over and released through full0 / empty0. BSTAGES == 0: its B tile lies in
// the same stage, at b0 + (i % STAGES) * b_stride. BSTAGES > 0 (kernel 5):
// the converted B tiles have a ring of their own, b0 + (i % BSTAGES) *
// b_stride, with barriers bfull0 / bempty0. ROWSUM: rs += A tile x ones (an
// n8 wgmma on a 16 x 8 tile of ones at `ones`), so rs[0] / rs[2] end as the
// row sums of A for the thread's two rows.
template <typename T, int BN, int SWZ, int STAGES, int BSTAGES, bool ROWSUM>
G90_DEV void consume(float (&acc)[BN / 2], float (&rs)[4], int nkt, uint32_t a0, uint32_t a_stride, uint32_t b0,
                     uint32_t b_stride, uint32_t ones, uint32_t full0, uint32_t empty0, uint32_t bfull0,
                     uint32_t bempty0) {
  constexpr int kBRing = BSTAGES > 0 ? BSTAGES : STAGES;
  const uint64_t ones_desc = make_desc(ones, 128, 256, 0);
  fence_regs(acc);
  fence_regs(rs);
  for (int it = 0; it < nkt; ++it) {
    const int s = it % STAGES, sb = it % kBRing;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    if constexpr (BSTAGES > 0) mbar_wait(bfull0 + 8 * sb, (it / BSTAGES) & 1);
    const uint32_t a = a0 + s * a_stride, b = b0 + sb * b_stride;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wgmma_tile<T, BN>(acc, a_desc(a, ks), BTile<SWZ>::desc(b, ks));
      if constexpr (ROWSUM) wgmma_m64n8k16<T>(rs, a_desc(a, ks), ones_desc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's group has retired: its stages are free
    if (it > 0) {
      mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      if constexpr (BSTAGES > 0) mbar_arrive(bempty0 + 8 * ((it - 1) % BSTAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(rs);
}

// cp.async copies of the A tile of CWG consumer warpgroups (64 CWG rows x 64
// k) by thread t of the loading warpgroup: rows m0.., columns k0.., zero past
// M and K
template <typename T, int CWG>
G90_DEV void load_a_tile(uint32_t dst, const T* a, int m0, int k0, int M, int K, int t) {
#pragma unroll
  for (int i = 0; i < 64 * CWG * 8 / kWG; ++i) {
    const int r = t / 8 + (kWG / 8) * i, c = t % 8;
    const int m = m0 + r, k = k0 + 8 * c;
    const bool ok = m < M && k < K;
    cp_async16(dst + a_offset(r, c), ok ? a + static_cast<size_t>(m) * K + k : a, ok);
  }
}

// cp.async copies of a 64 x BN tile of `B` (K, N), ELT bytes per element, by
// thread t of the loading warpgroup, zero past K and N. ELT = 2: into the
// swizzled MN-major B tile. ELT = 1: into a plain 64 x BN byte tile, piece i
// at 16 i (thread t copies the pieces i = t + 128 j).
template <int ELT, int BN, int SWZ>
G90_DEV void load_b_tile(uint32_t dst, const void* b, int k0, int n0, int K, int N, int t) {
  constexpr int kCols = 16 / ELT;  // columns per 16-byte piece
  constexpr int kPerRow = BN / kCols;
  static_assert(kBK * kPerRow % kWG == 0, "16-byte pieces divide over the warpgroup");
#pragma unroll
  for (int j = 0; j < kBK * kPerRow / kWG; ++j) {
    const int i = t + kWG * j;
    const int r = i / kPerRow, n = kCols * (i % kPerRow);
    const bool ok = k0 + r < K && n0 + n < N;
    const char* src = static_cast<const char*>(b);
    if (ok) src += (static_cast<size_t>(k0 + r) * N + n0 + n) * ELT;
    cp_async16(dst + (ELT == 2 ? BTile<SWZ>::offset(r, n) : 16u * i), src, ok);
  }
}

// ---- the epilogue ---------------------------------------------------------
// A consumer warpgroup's 64 x BN output tile goes through shared memory so
// that it leaves as whole 16-byte pieces of a row (a thread's own accumulator
// pairs would leave as 4-byte stores, 8 rows a warp instruction). Rows are
// 16 bytes longer than the tile so that the pair stores of a warp (8 rows x 4
// pairs) hit 32 banks.
template <int BN, int ELT>  // ELT: bytes per output element
struct OutTile {
  static constexpr int kPitch = BN * ELT + 16;
  static constexpr int kBytes = 64 * kPitch;
  G90_DEV static uint32_t at(uint32_t tile, int r, int c) { return tile + r * kPitch + c * ELT; }
  // the tile's rows m0.., columns n0.. to `out` (M, N) row-major, by thread t
  // of the warpgroup; N a multiple of 16 / ELT, out 16-byte aligned
  G90_DEV static void flush(uint32_t tile, void* out, int m0, int n0, int M, int N, int t) {
    constexpr int kPerRow = BN * ELT / 16;
#pragma unroll
    for (int j = 0; j < 64 * kPerRow / kWG; ++j) {
      const int i = t + kWG * j;
      const int r = i / kPerRow, c = (i % kPerRow) * (16 / ELT);
      if (m0 + r < M && n0 + c < N)
        *reinterpret_cast<uint4*>(static_cast<char*>(out) + (static_cast<size_t>(m0 + r) * N + n0 + c) * ELT) =
            ld_shared16(at(tile, r, c));
    }
  }
};
// barrier `id` (1 .. 15) over `threads` threads: the consumer warpgroups among
// themselves, without the producers
G90_DEV void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive on barrier `id` without waiting (the other side waits in
// named_barrier with the same thread count)
G90_DEV void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the first address at or above `addr` that is a multiple of 1024 (the swizzle
// patterns repeat every 1024 bytes of shared-memory address)
G90_DEV uint32_t align1024(uint32_t addr) { return (addr + 1023u) & ~1023u; }

// ---- K-major tiles ----------------------------------------------------------
// A K-major B tile (N rows of 128 bytes under the 128-byte swizzle) has the A
// tile's form, so its descriptor is a_desc's: 8-row groups 1024 bytes apart,
// step ks (k16 of a 16-bit type, k32 of an 8-bit one) 32 bytes into the rows.
// It is the only B layout the 8-bit wgmma reads (no transpose bit for 8-bit
// types), and the layout of kernel 2's K tile.
G90_DEV uint64_t kmajor_desc(uint32_t tile, int ks) { return a_desc(tile, ks); }

// cp.async copies of a ROWS x 128-byte K-major tile by thread t of the
// loading warpgroup: bytes kb0 .. kb0 + 127 of rows r0 .. r0 + ROWS - 1 of a
// row-major byte matrix (`ld` bytes from row to row, `rows` rows, the first
// `kb` bytes of each row valid) into the 128-byte-swizzled layout of
// a_offset, zero past `rows` and `kb`. kb0, kb, ld and `base` are multiples
// of 16.
template <int ROWS>
G90_DEV void load_kmajor_tile(uint32_t dst, const void* base, long long ld, int r0, int rows, int kb0, int kb, int t) {
  static_assert(ROWS * 8 % kWG == 0, "16-byte pieces divide over the warpgroup");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / kWG; ++i) {
    const int r = t / 8 + (kWG / 8) * i, c = t % 8;
    const int row = r0 + r, k = kb0 + 16 * c;
    const bool ok = row < rows && k < kb;
    const char* src = static_cast<const char*>(base);
    if (ok) src += row * ld + k;
    cp_async16(dst + a_offset(r, c), src, ok);
  }
}

// ---- 16-bit wgmma with a K-major B, or with A in registers ----------------
// Register lists of the accumulator forms below (d[0..N / 2 - 1]).
#define G90_F(x) "+f"(x)
#define G90_R(x) "+r"(x)
#define G90_ACC4(c, i) c(d[(i)]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3])
#define G90_ACC8(c, i) G90_ACC4(c, i), G90_ACC4(c, (i) + 4)
#define G90_ACC32(c, i) G90_ACC8(c, i), G90_ACC8(c, (i) + 8), G90_ACC8(c, (i) + 16), G90_ACC8(c, (i) + 24)
#define G90_ACC16(c) G90_ACC8(c, 0), G90_ACC8(c, 8)
#define G90_ACC32N(c) G90_ACC32(c, 0)
#define G90_ACC20(c) G90_ACC16(c), G90_ACC4(c, 16)
#define G90_ACC40(c) G90_ACC32(c, 0), G90_ACC8(c, 32)
#define G90_ACC64(c) G90_ACC32(c, 0), G90_ACC32(c, 32)
#define G90_ACC128(c) G90_ACC64(c), G90_ACC32(c, 64), G90_ACC32(c, 96)
#define G90_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define G90_D20 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}"
#define G90_D32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define G90_D40                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
#define G90_D64                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "       \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "   \
  "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define G90_D128                                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                  \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "          \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "          \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// one m64nNk16 wgmma of the given type pair ("f16.f16" or "bf16.bf16"); the
// operand numbers after the R accumulators are given as strings
#define G90_WG_SS(N, DL, ACC, IA, IB, IP, IT, TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                       \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY " " DL ", %" IA ", %" IB            \
               ", p, 1, 1, 0, %" IT ";\n}\n"                                                           \
               : ACC(G90_F) : "l"(da), "l"(db), "r"(acc), "n"(TB))
#define G90_WG_RS(N, DL, ACC, I0, I1, I2, I3, IB, IP, TY)                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                       \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY " " DL ", {%" I0 ", %" I1 ", %" I2 \
               ", %" I3 "}, %" IB ", p, 1, 1, 1;\n}\n"                                                 \
               : ACC(G90_F) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64 x N, f32) (+)= A (64 x 16, shared, K-major) x B (16 x N, shared): TB =
// 0 reads B K-major (N rows), 1 MN-major through the transpose bit. acc = 0
// overwrites D. Accumulator layout as wgmma_m64n8k16's.
template <typename T, int N, int TB>
G90_DEV void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "tile width");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 32 && kHalf) G90_WG_SS(32, G90_D16, G90_ACC16, "16", "17", "18", "19", "f16.f16");
  else if constexpr (N == 32) G90_WG_SS(32, G90_D16, G90_ACC16, "16", "17", "18", "19", "bf16.bf16");
  else if constexpr (N == 64 && kHalf) G90_WG_SS(64, G90_D32, G90_ACC32N, "32", "33", "34", "35", "f16.f16");
  else if constexpr (N == 64) G90_WG_SS(64, G90_D32, G90_ACC32N, "32", "33", "34", "35", "bf16.bf16");
  else if constexpr (kHalf) G90_WG_SS(128, G90_D64, G90_ACC64, "64", "65", "66", "67", "f16.f16");
  else G90_WG_SS(128, G90_D64, G90_ACC64, "64", "65", "66", "67", "bf16.bf16");
}

// D (64 x N, f32) += A (64 x 16, registers) x B (16 x N, shared, MN-major
// through the transpose bit). Warp w of the warpgroup holds rows 16 w .. 16 w
// + 15 of A as mma.m16n8k16 holds its A: a[0] = (row g, columns 2 t, 2 t + 1),
// a[1] = (g + 8, the same), a[2] = (g, 2 t + 8 ..), a[3] = (g + 8, 2 t + 8 ..),
// g = lane / 4, t = lane % 4: two neighbouring n8 blocks of an accumulator
// are one k16 slice of A. N need not fill the B tile's swizzle atom: N = 40
// and 80 read the first 5 and 10 of its 8-column blocks.
template <typename T, int N>
G90_DEV void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 40 || N == 64 || N == 80 || N == 128 || N == 256, "tile width");
  constexpr bool kHalf = std::is_same<T, __half>::value;
  if constexpr (N == 40 && kHalf) G90_WG_RS(40, G90_D20, G90_ACC20, "20", "21", "22", "23", "24", "25", "f16.f16");
  else if constexpr (N == 40) G90_WG_RS(40, G90_D20, G90_ACC20, "20", "21", "22", "23", "24", "25", "bf16.bf16");
  else if constexpr (N == 64 && kHalf) G90_WG_RS(64, G90_D32, G90_ACC32N, "32", "33", "34", "35", "36", "37", "f16.f16");
  else if constexpr (N == 64) G90_WG_RS(64, G90_D32, G90_ACC32N, "32", "33", "34", "35", "36", "37", "bf16.bf16");
  else if constexpr (N == 80 && kHalf) G90_WG_RS(80, G90_D40, G90_ACC40, "40", "41", "42", "43", "44", "45", "f16.f16");
  else if constexpr (N == 80) G90_WG_RS(80, G90_D40, G90_ACC40, "40", "41", "42", "43", "44", "45", "bf16.bf16");
  else if constexpr (N == 128 && kHalf) G90_WG_RS(128, G90_D64, G90_ACC64, "64", "65", "66", "67", "68", "69", "f16.f16");
  else if constexpr (N == 128) G90_WG_RS(128, G90_D64, G90_ACC64, "64", "65", "66", "67", "68", "69", "bf16.bf16");
  else if constexpr (kHalf) G90_WG_RS(256, G90_D128, G90_ACC128, "128", "129", "130", "131", "132", "133", "f16.f16");
  else G90_WG_RS(256, G90_D128, G90_ACC128, "128", "129", "130", "131", "132", "133", "bf16.bf16");
}

// ---- TF32 wgmma (the float32 form of kernels 1 and 2) ---------------------
// TF32 wgmma reads both operands K-major only: the transpose bits exist for
// 16-bit types alone. A k-step is 8 values, 32 bytes, so a K-major TF32 tile
// is byte for byte the 16-bit A tile above (a_desc / kmajor_desc, k-step ks
// 32 bytes into the 128-byte rows).
#define G90_TF_SS(N, DL, ACC, IA, IB, IP)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " DL ", %" IA ", %" IB ", p, 1, 1;\n}\n" \
               : ACC(G90_F) : "l"(da), "l"(db), "r"(acc))
#define G90_TF_RS(N, DL, ACC, I0, I1, I2, I3, IB, IP)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                         \
               "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " DL ", {%" I0 ", %" I1 ", %" I2 \
               ", %" I3 "}, %" IB ", p, 1, 1;\n}\n"                                                      \
               : ACC(G90_F) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64 x N, f32) (+)= A (64 x 8 tf32, shared, K-major) x B (8 x N tf32,
// shared, K-major, N rows); acc = 0 overwrites D. D as wgmma_m64n8k16's.
template <int N>
G90_DEV void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 32 || N == 64, "tile width");
  if constexpr (N == 32) G90_TF_SS(32, G90_D16, G90_ACC16, "16", "17", "18");
  else G90_TF_SS(64, G90_D32, G90_ACC32N, "32", "33", "34");
}

// D (64 x N, f32) += A (64 x 8 tf32, registers) x B (8 x N tf32, shared,
// K-major, N rows). Warp w holds rows 16 w .. 16 w + 15 of A as
// mma.m16n8k8.tf32 holds its A: a[0] = (row g, column t), a[1] = (g + 8, t),
// a[2] = (g, t + 4), a[3] = (g + 8, t + 4), g = lane / 4, t = lane % 4.
template <int N>
G90_DEV void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 40 || N == 64 || N == 80 || N == 128, "tile width");
  if constexpr (N == 40) G90_TF_RS(40, G90_D20, G90_ACC20, "20", "21", "22", "23", "24", "25");
  else if constexpr (N == 64) G90_TF_RS(64, G90_D32, G90_ACC32N, "32", "33", "34", "35", "36", "37");
  else if constexpr (N == 80) G90_TF_RS(80, G90_D40, G90_ACC40, "40", "41", "42", "43", "44", "45");
  else G90_TF_RS(128, G90_D64, G90_ACC64, "64", "65", "66", "67", "68", "69");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// the bits of a float32
G90_DEV uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ---- the u8 x u8 -> s32 product (kernel 3; kernel 4's gather next) --------
// Both operands K-major (the 8-bit wgmma has no transpose bit): a k-tile is
// 128 u8 values, one 128-byte row, so the A tile is byte for byte the 16-bit
// A tile above and B is N rows of that form. The sums are exact in int32.
constexpr int kBK8 = 128;

// D (64 x 8, s32) += A (64 x 32 u8, shared, K-major) x B (32 x 8 u8, shared,
// K-major); D as wgmma_m64n8k16's
G90_DEV void wgmma_m64n8k32_u8(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n8k32.s32.u8.u8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "l"(da), "l"(db), "r"(1));
}
// the same, 64 x 128
G90_DEV void wgmma_m64n128k32_u8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 " G90_D64 ", %64, %65, p;\n}\n"
               : G90_ACC64(G90_R) : "l"(da), "l"(db), "r"(1));
}

// One consumer warpgroup's u8 sweep over `nkt` k-tiles of 128 bytes handed
// over through full0 / empty0 (stage s at + s * stage_bytes of each address):
// acc (64 x 128) += A tile (64 rows at a0) x B tile (128 rows at b0); rs +=
// A tile x ones, the row sums of A (rs[0] / rs[2] for the thread's two rows);
// cs += C tile x ones, where the C tile is 64 rows of the K-major B tile (at
// c0): the column sums of W for those 64 columns, laid out as rs is. `ones`
// holds 512 bytes of 0x01.
template <int STAGES>
G90_DEV void consume_u8(int (&acc)[64], int (&rs)[4], int (&cs)[4], int nkt, uint32_t a0, uint32_t b0, uint32_t c0,
                        uint32_t stage_bytes, uint32_t ones, uint32_t full0, uint32_t empty0) {
  const uint64_t ones_desc = make_desc(ones, 128, 256, 0);
  fence_regs(acc);
  fence_regs(rs);
  fence_regs(cs);
  for (int it = 0; it < nkt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t off = s * stage_bytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK8 / 32; ++ks) {
      wgmma_m64n128k32_u8(acc, a_desc(a0 + off, ks), kmajor_desc(b0 + off, ks));
      wgmma_m64n8k32_u8(rs, a_desc(a0 + off, ks), ones_desc);
      wgmma_m64n8k32_u8(cs, a_desc(c0 + off, ks), ones_desc);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's group has retired: its stage is free
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(rs);
  fence_regs(cs);
}

// ---- both operands K-major: kernel 8 (16-bit) and kernel 6 (s8) -----------
// D (64 x 128, s32) += A (64 x 32 s8, shared, K-major) x B (32 x 128 s8,
// shared, K-major); D as wgmma_m64n8k16's
G90_DEV void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " G90_D64 ", %64, %65, p;\n}\n"
               : G90_ACC64(G90_R) : "l"(da), "l"(db), "r"(1));
}

// One consumer warpgroup's sweep over `nkt` k-tiles handed over through
// full0 / empty0 (stage s at + s * stage_bytes of each address), both tiles
// 128-byte K-major rows under the 128-byte swizzle: the A tile's 64 rows at
// a0, the B tile at b0. A k-tile is 128 bytes deep, four k-steps of 32 bytes
// (k16 of a 16-bit type, k32 of an 8-bit one); mma(acc, da, db) issues one
// step's product. One group in flight while the next stage is awaited, and
// nothing reads the accumulators in between.
template <int STAGES, typename Acc, typename Mma>
G90_DEV void consume_kmajor(Acc& acc, int nkt, uint32_t a0, uint32_t b0, uint32_t stage_bytes, uint32_t full0,
                            uint32_t empty0, Mma mma) {
  fence_regs(acc);
  for (int it = 0; it < nkt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t off = s * stage_bytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma(acc, a_desc(a0 + off, ks), kmajor_desc(b0 + off, ks));
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's group has retired: its stage is free
    if (it > 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

}  // namespace gemm90
